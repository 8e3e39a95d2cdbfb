"""rtvc_tpu_torch — the caption step and its serving surface (in-process,
HTTP, gRPC, exported and compiled programs), the frozen GIT-Large teacher,
the distillation train step and its training loop, and the evaluation path
(COCO metrics, the MSRVTT loader, checkpoint scoring, pruning) of
``rtvc_tpu`` in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper
(``sm_90a``).

The JAX package ``rtvc_tpu`` is the reference; every module here has a
counterpart of the same name there:

- ``config``            ➜ ``rtvc_tpu/config.py`` + the model configs'
                          defaults (copied: importing ``rtvc_tpu`` imports jax)
- ``ops.preprocess``    ➜ ``rtvc_tpu/ops/preprocess.py`` (with
                          ``preprocess_clip_batch``)
- ``ops.masking``       ➜ ``rtvc_tpu/ops/masking.py``
- ``ops.layernorm``     ➜ ``rtvc_tpu/ops/layernorm.py`` (kernels K2, K6;
                          K2 is the operator ``rtvc::layer_norm``)
- ``ops.attention``     ➜ ``rtvc_tpu/ops/attention.py`` (kernels K1, K4, K5,
                          K8; K1 is the operator ``rtvc::window_attention``)
- ``ops.depthwise``     ➜ ``rtvc_tpu/ops/depthwise.py`` (kernel K9)
- ``ops.quantization``  ➜ ``rtvc_tpu/ops/quantization.py``
- ``ops.int8_gemm``     ➜ ``rtvc_tpu/ops/int8_gemm.py`` (kernels K3, K7)
- ``models.*``          ➜ ``rtvc_tpu/models/*`` (TinyViT, student, CLIP
                          ViT, GIT teacher, weight bridge)
- ``decode``            ➜ ``rtvc_tpu/decode.py`` (greedy, student beam,
                          teacher beam)
- ``serving``           ➜ ``rtvc_tpu/serving.py`` (the caption step, greedy
                          or beam; ``BatchCaptionServer``; loading and the
                          CLI demo)
- ``serving_http``      ➜ ``rtvc_tpu/serving_http.py`` (the HTTP front)
- ``serving_grpc``, ``proto`` ➜ ``rtvc_tpu/serving_grpc.py``,
                          ``rtvc_tpu/proto/`` (the gRPC front; the same
                          messages; grpcio needed only to serve)
- ``export``            ➜ ``rtvc_tpu/export.py`` (``torch.export`` bundles
                          and AOTInductor packages of the caption step)
- ``real_time_inference`` ➜ ``rtvc_tpu/real_time_inference.py``
- ``tokenization``      ➜ ``rtvc_tpu/tokenization/`` (copied: pure Python)
- ``data.io``           ➜ ``rtvc_tpu/data/io.py`` (checkpoints as
                          ``torch.save``d state dicts, the meta sidecar,
                          the distillation-head strip, pruned checkpoints,
                          the background checkpoint writer)
- ``data.teacher_cache`` ➜ ``rtvc_tpu/data/teacher_cache.py`` (the
                          teacher-output caches, their replay feed)
- ``data.dataset``      ➜ ``rtvc_tpu/data/dataset.py`` (the labels CSV,
                          ``CaptionDataset``, ``collate_batch``,
                          ``DeviceLoader``; no pandas)
- ``data.video_handlers``, ``data.frame_sampling`` ➜ the same modules
                          (copied; ``cv2`` imported where they decode)
- ``metrics``           ➜ ``rtvc_tpu/metrics.py`` (copied: pure Python)
- ``utils.profiling``   ➜ ``rtvc_tpu/utils/profiling.py`` (``StepTimer``,
                          ``profile_trace``)
- ``utils.logging``     ➜ ``rtvc_tpu/utils/logging.py`` (copied:
                          ``RunLogger``)
- ``distill``           ➜ ``rtvc_tpu/distill.py`` (the six losses)
- ``train``             ➜ ``rtvc_tpu/train.py`` (``train()`` and its CLI,
                          the train step, Adam, the schedulers,
                          ``evaluate``)
- ``evaluate``          ➜ ``rtvc_tpu/evaluate.py`` (``evaluate_checkpoint``)
- ``inference``         ➜ ``rtvc_tpu/inference.py``
- ``pruning``, ``pruning_test`` ➜ the same modules (global L1 pruning in
                          JAX's tie order, the pruned model's test epoch)

``profile_teacher`` has no counterpart: it prints the teacher's device time
by op on a card; nor has ``ops.dropout``, the train step's random draws
from an explicit CPU ``torch.Generator``. Kernels live in ``csrc/`` and are compiled by ``_build``
with ``nvcc`` at their first launch. A wrapper given CPU tensors runs its
plain PyTorch version; given CUDA tensors it launches the kernel or raises.
This package imports neither jax, flax, pandas nor, at import time, cv2
(the JPEG/PNG codec, the video decoders and the video loop import it where
they run).
"""

__version__ = "0.1.0"
