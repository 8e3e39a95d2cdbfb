"""The caption step: a uint8 window batch → caption token rows.

Counterpart of ``make_caption_step``, ``with_vocab_w8`` and
``truncate_at_sep`` in ``rtvc_tpu/serving.py``. The step is the program
behind every serving surface of the JAX package: CLIP preprocess on the
device, the TinyViT encode, and greedy decode. ``BatchCaptionServer`` and
the beam option are not ported yet.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .decode import student_greedy
from .models.student import StudentCandidateV1
from .ops.preprocess import clip_preprocess
from .ops.quantization import quantize_vocab_head

SEP_TOKEN_ID = 102  # BERT [SEP], the reference's stop token


def truncate_at_sep(row: np.ndarray, sep_id: int = SEP_TOKEN_ID) -> np.ndarray:
    """Tokens up to (excluding) the first SEP: the part of a greedy row that
    does not depend on which other rows shared its batch."""
    hits = np.nonzero(row == sep_id)[0]
    return row[: hits[0]] if hits.size else row


def with_vocab_w8(student: StudentCandidateV1) -> StudentCandidateV1:
    """Attach the weight-only int8 pack of the vocab projection
    (``student.vocab_w8``) for the ``vocab_int8`` caption step. The pack is
    made here, once per weight set, from the current ``linear`` weights."""
    student.vocab_w8 = quantize_vocab_head(student.linear)
    return student


def make_caption_step(student: StudentCandidateV1, *, max_len: int = 25,
                      crop_size: int = 224, vocab_int8: bool = False
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    """``step(frames_u8)`` maps uint8 ``[B, W, H, Wd, 3]`` frames (BGR, on
    the student's device) to int32 ``[B, 1 + max_len]`` token rows.

    ``vocab_int8`` runs the decode loop's vocab projection on kernel K3;
    the student must have been through :func:`with_vocab_w8`. Its logits
    move by about the int8 rounding, so its rows need not equal the default
    step's."""
    if vocab_int8 and getattr(student, "vocab_w8", None) is None:
        raise ValueError("vocab_int8 needs a student from with_vocab_w8()")

    @torch.inference_mode()
    def step(frames_u8: torch.Tensor) -> torch.Tensor:
        b, w = frames_u8.shape[:2]
        proc = clip_preprocess(frames_u8.reshape((b * w,) + frames_u8.shape[2:]),
                               crop_size=crop_size)
        proc = proc.reshape((b, w) + proc.shape[1:])
        return student_greedy(student, proc, max_len=max_len,
                              vocab_w8=student.vocab_w8 if vocab_int8 else None)

    return step
