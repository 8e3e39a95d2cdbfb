"""The general traffic generator: seeded windows, captions and arrivals,
from the parameters of a workload file.

- :func:`windows`: distinct uint8 BGR windows ``[n, frames, H, W, 3]``,
  smooth random scenes (a coarse grid upsampled) plus pixel noise, each
  at its own brightness (the smoke script's ``make_windows``), made on the
  device. Every seed gets the same set of brightness levels, in its own
  order;
- :func:`captions`: ``[n, length]`` int64 rows, CLS, seeded word ids,
  SEP, then pad 0; every seed gets the same set of lengths, in its own
  order;
- :func:`order`: a seeded cycle through a pool.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from . import seeds

CLS, SEP = 101, 102
FIRST_WORD = 1000  # word ids start past BERT's special and unused ids
#                   (past SEP + 1 in a vocabulary too small for that)


def windows(n: int, frames: int, hw, seed: int, device) -> torch.Tensor:
    h, w = int(hw[0]), int(hw[1])
    gen = torch.Generator(device=device)
    gen.manual_seed(seeds.sub_seed(seed, seeds.WINDOWS))
    coarse = torch.rand(n * frames, 3, 12, 16, generator=gen, device=device)
    scene = F.interpolate(coarse, size=(h, w), mode="bilinear",
                          align_corners=False)
    noise = torch.rand(n * frames, 3, h, w, generator=gen, device=device)
    levels = np.linspace(0.3, 1.0, n)[seeds.rng(seed, seeds.ORDER)
                                      .permutation(n)]
    level = torch.tensor(levels, dtype=torch.float32,
                         device=device).repeat_interleave(frames)
    img = (0.8 * scene + 0.2 * noise) * level[:, None, None, None] * 255
    return (img.clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)
            .reshape(n, frames, h, w, 3).contiguous())


def caption_lengths(n: int, shortest: int, longest: int, seed: int
                    ) -> np.ndarray:
    """``n`` lengths (CLS and SEP included) evenly over [shortest,
    longest], in a seeded order."""
    lengths = np.rint(np.linspace(shortest, longest, n)).astype(np.int64)
    return lengths[seeds.rng(seed, seeds.CAPTIONS).permutation(n)]


def captions(n: int, width: int, shortest: int, longest: int, vocab: int,
             seed: int, device) -> torch.Tensor:
    lengths = caption_lengths(n, shortest, longest, seed)
    low = FIRST_WORD if vocab > 2 * FIRST_WORD else SEP + 2
    r = seeds.rng(seed, seeds.CAPTIONS, 1)
    rows = np.zeros((n, width), np.int64)
    for i, length in enumerate(lengths):
        rows[i, 0] = CLS
        rows[i, 1:length - 1] = r.integers(low, vocab, length - 2)
        rows[i, length - 1] = SEP
    return torch.from_numpy(rows).to(device)


def order(pool: int, count: int, seed: int, tag: int = 0) -> List[int]:
    """``count`` pool indices: seeded permutations of the pool, one after
    another."""
    r = seeds.rng(seed, seeds.ORDER, tag + 1)
    out: List[int] = []
    while len(out) < count:
        out.extend(int(i) for i in r.permutation(pool))
    return out[:count]
