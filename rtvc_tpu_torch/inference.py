"""Offline inference entry (reference src/inference.py:21-106).

Counterpart of ``rtvc_tpu/inference.py``: loads the newest checkpoint of a
run, decodes ONE test batch and prints ground truth and prediction side by
side (the reference stopped after the first batch, inference.py:58).

CLI: ``python -m rtvc_tpu_torch.inference <run_name> [--beam K]``. The
data paths of the config are relative to the working directory.
"""

from __future__ import annotations

import sys
from typing import Iterable, List, Optional

from . import decode as decode_lib
from .config import Config, cfg as default_cfg
from .models.student import StudentCandidateV1


def inference(config: Config, test_loader: Iterable, tokenizer,
              run_name: str, student: Optional[StudentCandidateV1] = None,
              max_len: int = 25, beam_size: int = 0,
              device="cuda") -> List[str]:
    """Decode the first batch of ``test_loader`` with the newest checkpoint
    of ``run_name`` (``<save_dir>/run/<run_name>``) in ``config``'s student
    on ``device``, or with ``student`` as it is; print ``GT:`` and ``Pred:``
    lines and return the predictions. ``beam_size > 0`` decodes with the
    student's beam search instead of greedy."""
    if student is None:
        from .evaluate import resolve_checkpoint
        from .serving import build_serving_student
        student = build_serving_student(
            resolve_checkpoint(config, run_name, None), device=device,
            config=config)

    preds: List[str] = []
    for batch in test_loader:
        y = batch["caption"].cpu().numpy()
        if beam_size > 0:
            tokens = decode_lib.student_beam(student, batch["frames"],
                                             max_len=max_len, k=beam_size)
        else:
            tokens = decode_lib.student_greedy(student, batch["frames"],
                                               max_len=max_len)
        tokens = tokens.cpu().numpy()
        caps = [tokenizer.decode(c, skip_special_tokens=True) for c in y]
        preds = [tokenizer.decode(t, skip_special_tokens=True)
                 for t in tokens]
        for gt, pred in zip(caps, preds):
            print(f"GT:   {gt}")
            print(f"Pred: {pred}")
        break  # first batch only (reference inference.py:58)
    return preds


def main(argv: Optional[List[str]] = None) -> None:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: python -m rtvc_tpu_torch.inference <run_name> "
              "[--beam K] [--device cuda]", file=sys.stderr)
        sys.exit(2)
    run_name = argv[0]
    beam_size = 0
    if "--beam" in argv:
        beam_size = int(argv[argv.index("--beam") + 1])
    device = "cuda"
    if "--device" in argv:
        device = argv[argv.index("--device") + 1]

    from .evaluate import split_loader
    from .tokenization import BertWordPieceTokenizer

    config = default_cfg
    loader = split_loader(config, "test", device=device)
    inference(config, loader, BertWordPieceTokenizer(), run_name,
              beam_size=beam_size, device=device)


if __name__ == "__main__":
    main()
