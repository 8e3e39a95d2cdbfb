"""Standalone checkpoint evaluation: the full COCO metric sweep on demand.

Counterpart of ``rtvc_tpu/evaluate.py``. The reference computed its metric
sweep only inside training (epoch-end ``calculate_score``, reference
src/models/model.py:1040-1060 via src/metrics.py:16-39). This entry loads
any checkpoint the port wrote, decodes the chosen split (greedy, or beam
via ``--beam K``) and reports the reference's full metric set, BLEU-1..4,
METEOR, ROUGE_L, CIDEr ×100, plus its corpus BLEU-4 (src/metrics.py:42-68),
as one JSON object.

CLI::

    python -m rtvc_tpu_torch.evaluate <run_name> [--ckpt PATH]
        [--split test] [--beam K] [--out scores.json]
        [--annotations MSR_VTT.json] [--verbose] [--device cuda]

``<run_name>`` resolves the newest checkpoint under
``<save_dir>/run/<run_name>`` as ``rtvc_tpu_torch.inference`` does;
``--ckpt`` names a checkpoint directory instead (e.g. a pruned model).
The data paths of the config are relative to the working directory.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, Iterable, List, Optional, Tuple

from . import metrics as metrics_lib
from .config import Config, cfg as default_cfg
from .data.io import latest_checkpoint
from .models.student import StudentCandidateV1


def resolve_checkpoint(config: Config, run_name: Optional[str],
                       ckpt: Optional[str]) -> str:
    """``ckpt``, or the newest checkpoint of ``run_name``'s run directory
    (``<save_dir>/run/<run_name>``)."""
    if ckpt is not None:
        return ckpt
    if run_name is None:
        raise ValueError("need run_name, ckpt, or student")
    run_dir = os.path.join(config.logger.save_dir, "run", run_name)
    found = latest_checkpoint(run_dir)
    if found is None:
        raise FileNotFoundError(f"no checkpoint under {run_dir}")
    return found


def evaluate_checkpoint(config: Config, loader: Iterable, tokenizer,
                        run_name: Optional[str] = None,
                        ckpt: Optional[str] = None,
                        split: str = "test",
                        beam_size: int = 0,
                        annotations: Optional[Dict[str, List[str]]] = None,
                        student: Optional[StudentCandidateV1] = None,
                        max_len_extra: int = 5,
                        verbose: bool = False,
                        device="cuda",
                        ) -> Tuple[Dict[str, float], List[dict]]:
    """Score one checkpoint on one split.

    The student is ``config``'s, in ``config.dtype`` on ``device``, built
    with the GELU variant the checkpoint's sidecar records
    (``student_matching_checkpoint``), its weights from the checkpoint
    without the distillation heads (``load_kd_student_params``). A given
    ``student`` is used as it is when no checkpoint is named, else the
    checkpoint's weights are loaded into it.

    Returns ``(scores, outputs)``: ``scores`` holds ``corpus_bleu4`` (the
    reference's per-epoch monitor, ×100) and, when ``annotations`` maps
    image_id → reference captions, the COCO sweep ×100 under the
    reference's metric names; ``outputs`` is the COCO-format
    ``[{image_id, caption}]`` prediction list.
    """
    from .serving import build_serving_student, load_student_weights

    if student is None:
        student = build_serving_student(
            resolve_checkpoint(config, run_name, ckpt), device=device,
            config=config)
    elif ckpt is not None or run_name is not None:
        load_student_weights(student, resolve_checkpoint(config, run_name,
                                                         ckpt))

    from .train import _NullLogger, evaluate
    bleu4, outputs = evaluate(student, loader, tokenizer, _NullLogger(),
                              epoch=0, split=split,
                              max_len_extra=max_len_extra,
                              annotations=None, verbose=verbose,
                              beam_size=beam_size)
    scores: Dict[str, float] = {"corpus_bleu4": float(bleu4)}
    if annotations:
        raw = metrics_lib.evaluate_captions(outputs, annotations)
        scores.update({k: v * 100 for k, v in raw.items()})
    return scores, outputs


def split_loader(config: Config, split: str, device="cuda"):
    """The labels, the ``split``'s videos in first-seen order as a
    :class:`~rtvc_tpu_torch.data.dataset.CaptionDataset` (captions chosen
    from ``config.seed``) and its unshuffled ``DeviceLoader`` at
    ``config.train.batch_size``, on ``device``: the loader of every
    evaluation entry point."""
    from .data.dataset import CaptionDataset, DeviceLoader, load_labels

    data, encoded = load_labels(config.data.captions_path,
                                config.data.encoded_caption_ids)
    ds = CaptionDataset(config.data.videos_path, data.video_ids(split),
                        data, encoded, num_frames=config.data.num_frames,
                        random_state=config.seed)
    return DeviceLoader(ds, config.train.batch_size, device=device,
                        prefetch_depth=config.data.prefetch_depth)


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    from .tokenization import BertWordPieceTokenizer

    parser = argparse.ArgumentParser(prog="rtvc_tpu_torch.evaluate")
    parser.add_argument("run_name", nargs="?", default=None,
                        help="run whose newest checkpoint to score "
                             "(under <save_dir>/run/<run_name>)")
    parser.add_argument("--ckpt", default=None,
                        help="explicit checkpoint directory (overrides "
                             "run_name resolution)")
    parser.add_argument("--split", default="test",
                        choices=("train", "validate", "test"))
    parser.add_argument("--beam", type=int, default=0,
                        help="beam size (0 = greedy, the reference's "
                             "eval decode)")
    parser.add_argument("--annotations", default=None,
                        help="MSR_VTT.json-format COCO annotation file "
                             "(default: cfg.data.annotation_path if it "
                             "exists; without it only corpus BLEU-4 runs)")
    parser.add_argument("--out", default=None,
                        help="write the scores JSON here (and the "
                             "COCO-format predictions next to it as "
                             "<out>.preds.json)")
    parser.add_argument("--verbose", action="store_true",
                        help="print per-batch GT/prediction transcripts")
    parser.add_argument("--device", default="cuda",
                        help="the student's device (cpu for a run without "
                             "a card)")
    args = parser.parse_args(argv)
    if args.run_name is None and args.ckpt is None:
        parser.error("need a run_name or --ckpt")

    config = default_cfg
    try:
        loader = split_loader(config, args.split, device=args.device)
    except FileNotFoundError as e:
        print(f"evaluation data not found ({e}); see README for data setup",
              file=sys.stderr)
        sys.exit(1)

    ann_path = args.annotations or config.data.annotation_path
    annotations = None
    if ann_path and os.path.exists(ann_path):
        annotations = metrics_lib.load_coco_annotations(ann_path)
    elif args.annotations:  # explicitly requested but absent: hard error
        print(f"annotation file not found: {args.annotations}",
              file=sys.stderr)
        sys.exit(1)
    else:
        print(f"no annotation file at {ann_path!r}; reporting corpus "
              f"BLEU-4 only", file=sys.stderr)

    scores, outputs = evaluate_checkpoint(
        config, loader, BertWordPieceTokenizer(),
        run_name=args.run_name, ckpt=args.ckpt, split=args.split,
        beam_size=args.beam, annotations=annotations, verbose=args.verbose,
        device=args.device)
    print(json.dumps(scores))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(scores, f)
        with open(args.out + ".preds.json", "w") as f:
            json.dump(outputs, f)


if __name__ == "__main__":
    main()
