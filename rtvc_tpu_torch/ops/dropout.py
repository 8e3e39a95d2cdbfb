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

Under data parallelism (:func:`global_rows`, entered by the train step on
a mesh with dp > 1) every draw is made at the global batch's shape, the
local leading dim times dp, and a rank keeps its own rows: each rank
draws what one process draws for the whole batch, and dp = 2 drops what
dp = 1 drops. Every tensor drawn for has the batch (or batch-major
flattened rows) as its leading dim.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple

import torch

SEED_BOUND = 2 ** 31 - 1

# (this rank's index, the number of ranks) along dp while a dp step draws
_ROWS: Optional[Tuple[int, int]] = None


@contextlib.contextmanager
def global_rows(index: int, count: int):
    """Draw at the global batch's shape and keep rows ``index`` of
    ``count`` equal parts inside the block."""
    global _ROWS
    prev, _ROWS = _ROWS, (int(index), int(count))
    try:
        yield
    finally:
        _ROWS = prev


def sharded_draws() -> bool:
    """True inside :func:`global_rows` with more than one rank."""
    return _ROWS is not None and _ROWS[1] > 1


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
    """float32 U[0, 1) of ``shape`` on ``device`` (this rank's rows of the
    global draw inside :func:`global_rows`)."""
    if sharded_draws():
        index, count = _ROWS
        rows = shape[0]
        full = _uniform((rows * count,) + tuple(shape[1:]), generator, device)
        return full[index * rows:(index + 1) * rows]
    return _uniform(shape, generator, device)


def _uniform(shape: Sequence[int], generator: Optional[torch.Generator],
             device: torch.device) -> torch.Tensor:
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
