"""Random draws of the train step: dropout, DropPath and attention seeds.

JAX draws from ``jax.random`` keys; the port draws from one explicit CPU
``torch.Generator`` that the train step owns. Its bits cannot equal JAX's,
so the tests compare distributions. A draw never synchronises the device:

- :func:`draw_seed` takes a host ``int`` in [0, 2^31 - 1) from the CPU
  generator (``jax.random.randint(rng, (1,), 0, int32 max)`` in JAX), as
  the seed of the flash kernel's counter hash;
- :func:`uniform` fills a tensor on the CPU from the generator itself, and
  on a card from a device generator seeded with :func:`draw_seed`, so no
  mask crosses the bus.

:func:`dropout` is flax's ``nn.Dropout`` (keep where ``u < 1 - rate``,
kept values divided by ``1 - rate``); :func:`drop_path` is the JAX
``DropPath``: one draw per sample, the whole branch kept or dropped.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

SEED_BOUND = 2 ** 31 - 1


def _cpu_generator(generator: Optional[torch.Generator]) -> torch.Generator:
    if generator is None:
        raise ValueError("dropout > 0 in train mode needs a generator")
    if generator.device.type != "cpu":
        raise ValueError("dropout draws take a CPU torch.Generator, got one "
                         f"on {generator.device}")
    return generator


def draw_seed(generator: Optional[torch.Generator]) -> int:
    return int(torch.randint(0, SEED_BOUND, (),
                             generator=_cpu_generator(generator)))


def uniform(shape: Sequence[int], generator: Optional[torch.Generator],
            device: torch.device) -> torch.Tensor:
    """float32 U[0, 1) of ``shape`` on ``device``."""
    if torch.device(device).type == "cpu":
        return torch.rand(shape, generator=_cpu_generator(generator))
    dev_gen = torch.Generator(device=device)
    dev_gen.manual_seed(draw_seed(generator))
    return torch.rand(shape, generator=dev_gen, device=device)


def _drop(x: torch.Tensor, rate: float, generator, shape) -> torch.Tensor:
    if rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = uniform(shape, generator, x.device) < keep
    return torch.where(mask, x / keep, x.new_zeros(()))


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    return _drop(x, rate, generator, x.shape)


def drop_path(x: torch.Tensor, rate: float,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    return _drop(x, rate, generator, (x.shape[0],) + (1,) * (x.dim() - 1))
