"""Mask construction: ``rtvc_tpu/ops/masking.py`` (the reference's
src/utils/masking.py:4-26) in torch.

Standalone functions for API parity and tests; inside the models the masks
are folded into the attention as additive biases or key masks.
"""

from __future__ import annotations

import torch


def create_padding_mask(seq: torch.Tensor,
                        padding_token: int = 0) -> torch.Tensor:
    """True where ``seq`` holds padding (reference masking.py:4-15)."""
    return seq == padding_token


def create_causal_mask(size: int) -> torch.Tensor:
    """Upper-triangular (strict) bool mask ``[size, size]``; True =
    disallowed attention (reference masking.py:17-26, including its
    'casual' spelling alias)."""
    row = torch.arange(size)[:, None]
    col = torch.arange(size)[None, :]
    return col > row


# The reference's spelling, kept for drop-in compatibility.
create_casual_mask = create_causal_mask
