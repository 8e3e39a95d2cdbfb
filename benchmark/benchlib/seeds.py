"""Every random choice of a run, derived from ``--seed``.

A run's seed is any whole number; each use draws its own stream from
``numpy.random.SeedSequence((seed, tag))``, so that two uses never share
bits and a seed above 2**32 is as good as a small one."""

from __future__ import annotations

import numpy as np

WEIGHTS, WINDOWS, ORDER, DROPOUT, CAPTIONS, SAMPLE = range(1, 7)


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for the stream ``tags`` of run seed ``seed``."""
    state = np.random.SeedSequence([int(seed) % (2 ** 64), *tags]
                                   ).generate_state(2, np.uint32)
    return int(state[0]) << 31 ^ int(state[1])


def rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, *tags))


def step_generator(seed: int, step: int):
    """The CPU generator of train step ``step``'s dropout draws, a
    function of (seed, step) alone, made the way the training loop makes
    it (``SeedSequence((seed, step))``'s first 64-bit word)."""
    import torch
    mixed = np.random.SeedSequence((int(seed), int(step))).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(mixed))
