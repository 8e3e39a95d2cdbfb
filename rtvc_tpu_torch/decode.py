"""Greedy captioning over the student's KV cache.

Counterpart of ``student_greedy`` in ``rtvc_tpu/decode.py`` (reference
model.py:156-187). The JAX ``lax.while_loop`` becomes a Python loop over
:meth:`StudentCandidateV1.decode_step` with caches preallocated at
``1 + max_len`` slots. The semantics are the reference's:

- the self-attention key mask is ``(pos <= i) & (tokens != 0)``: a
  generated pad id 0 drops out of later steps, as the reference's
  full-recompute decoder masks ``y == 0``;
- decoding stops early only when every row emits SEP at the same step;
  rows that ended earlier keep generating.

The stop test reads one boolean back from the device per token.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .models.student import StudentCandidateV1


@torch.inference_mode()
def student_greedy(model: StudentCandidateV1, frames: torch.Tensor,
                   max_len: int = 10,
                   vocab_w8: Optional[Dict[str, torch.Tensor]] = None
                   ) -> torch.Tensor:
    """Frames ``[B, F, H, W, 3]`` → int32 ``[B, 1 + max_len]``: CLS, the
    generated ids, 0 after an early stop."""
    _, memory = model.forward_image_enc(frames)
    b = frames.shape[0]
    total = 1 + max_len
    caches = model.init_cache(b, total, memory)
    tokens = torch.zeros((b, total), dtype=torch.int32, device=memory.device)
    tokens[:, 0] = model.cls_token_id
    pos = torch.arange(total, device=memory.device)[None, :]
    for i in range(max_len):
        kv_mask = (pos <= i) & (tokens != 0)
        logits, caches = model.decode_step(tokens[:, i], i, caches, kv_mask,
                                           vocab_w8=vocab_w8)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        tokens[:, i + 1] = nxt
        if bool((nxt == model.sep_token_id).all()):
            break
    return tokens
