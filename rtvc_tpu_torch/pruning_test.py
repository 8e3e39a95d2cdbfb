"""Pruned-model evaluation entry (reference src/pruning_test.py:30-173).

Counterpart of ``rtvc_tpu/pruning_test.py``: loads a pruned student
checkpoint (``pruning.main`` wrote it), prints its sparsity, and runs the
test epoch only (decode, BLEU-4, transcripts to the run file). The
reference's ``callback_args`` leak from module scope into ``test()``
(pruning_test.py:89) is not carried over.

CLI: ``python -m rtvc_tpu_torch.pruning_test [--ckpt DIR] [--device
cuda]``. The data paths of the config are relative to the working
directory.
"""

from __future__ import annotations

import argparse
import os
from typing import Iterable, Optional

from .config import Config, cfg as default_cfg
from .data.io import load_pruned_params
from .models.student import StudentCandidateV1
from .pruning import sparsity_report
from .train import evaluate
from .utils.logging import RunLogger


def test(config: Config, test_loader: Iterable, tokenizer, ckpt_path: str,
         student: Optional[StudentCandidateV1] = None,
         run_name: str = "pruned", annotations=None,
         device="cuda") -> float:
    """BLEU-4 of the pruned checkpoint ``ckpt_path`` on ``test_loader``'s
    batches (split ``"Test"``), its transcripts (and with ``annotations``
    its COCO sweep) written to ``<save_dir>/run/<run_name>``. The student
    is ``config``'s on ``device`` (GELU variant from the sidecar, which
    the sweep carries forward), or the given ``student``; either way it
    gets the checkpoint's weights."""
    from .serving import build_serving_student, load_student_weights

    if student is None:
        student = build_serving_student(ckpt_path, device=device,
                                        config=config)
    else:
        load_student_weights(student, ckpt_path)
    report = sparsity_report(load_pruned_params(ckpt_path)["state_dict"])
    print(f"pruned model sparsity: {report['sparsity']:.3f} "
          f"({report['zeros']}/{report['total']} zeros)")

    run_dir = os.path.join(config.logger.save_dir, "run", run_name)
    logger = RunLogger(run_dir, run_name)
    bleu, _ = evaluate(student, test_loader, tokenizer, logger,
                       epoch=0, split="Test", annotations=annotations)
    print(f"Test BLEU@4: {bleu}")
    return bleu


def main(argv=None) -> None:
    from .evaluate import split_loader
    from .tokenization import BertWordPieceTokenizer

    parser = argparse.ArgumentParser(prog="rtvc_tpu_torch.pruning_test")
    parser.add_argument("--ckpt", default="results/pruned/pruned_0.5")
    parser.add_argument("--device", default="cuda",
                        help="the student's device (cpu for a run without "
                             "a card)")
    args = parser.parse_args(argv)

    config = default_cfg
    loader = split_loader(config, "test", device=args.device)
    test(config, loader, BertWordPieceTokenizer(), args.ckpt,
         device=args.device)


if __name__ == "__main__":
    main()
