"""Protobuf messages of the gRPC caption service.

``caption_pb2.py`` is generated from ``caption.proto`` and committed, so
that no test needs ``protoc``:

    cd rtvc_tpu_torch/proto && protoc --python_out=. caption.proto

Both files are those of ``rtvc_tpu/proto``: the same file name and package
(``caption.proto``, ``rtvc``), so that the two packages' messages resolve
to the same classes in one process and speak the same wire format.
"""

from . import caption_pb2  # noqa: F401

__all__ = ["caption_pb2"]
