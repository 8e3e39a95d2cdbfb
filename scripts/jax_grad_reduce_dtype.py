"""Which dtype JAX's dp-sharded train step all-reduces in.

Lowers ``rtvc_tpu.train.make_train_step`` for tests/test_train.py's tiny
pair, the student computing in bfloat16 over float32 params (the default
config's mix), on a dp = 2 mesh of virtual CPU devices, compiles it, and
counts the all-reduce and reduce-scatter instructions of the optimised HLO
by the element type of their results. The PyTorch port's train step
matches what this prints (``rtvc_tpu_torch/train.py``: one flat float32
all-reduce of the gradients over dp).

    JAX_PLATFORMS=cpu python scripts/jax_grad_reduce_dtype.py
"""

import os
import re
import sys
from collections import Counter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "tests"), ROOT]

import conftest  # noqa: E402,F401  (8 virtual CPU devices)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from rtvc_tpu.parallel.mesh import (make_mesh, place_params,  # noqa: E402
                                    replicate, shard_batch)
from rtvc_tpu.train import (TrainState, create_train_state,  # noqa: E402
                            make_train_step)
from test_train import synth_batch, tiny_pair  # noqa: E402


def main() -> None:
    student, teacher = tiny_pair()
    student = student.clone(dtype=jnp.bfloat16)
    batch = synth_batch()
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=1e-3)
    state = create_train_state(student, jax.random.PRNGKey(0), batch, tx)
    tvars = teacher.init(jax.random.PRNGKey(1), batch["frames"][:1],
                         batch["caption"][:1])
    mesh = make_mesh((2, 1), devices=jax.devices()[:2])
    state = TrainState(params=place_params(state.params, mesh),
                       batch_stats=replicate(state.batch_stats, mesh),
                       opt_state=replicate(state.opt_state, mesh),
                       step=state.step)
    step = make_train_step(student, teacher, tx, donate=False)
    hlo = step.lower(state, replicate(tvars, mesh), shard_batch(batch, mesh),
                     jax.random.PRNGKey(2)).compile().as_text()
    ops = [line for line in hlo.splitlines()
           if re.search(r"\b(all-reduce|all-reduce-start|reduce-scatter)\(",
                        line)]
    dtypes = Counter(m.group(1) for line in ops
                     for m in [re.search(r"=\s*\(?([a-z]+[0-9]*)\[", line)]
                     if m)
    print(f"{len(ops)} all-reduce / reduce-scatter instructions by result "
          f"dtype: {dict(dtypes)}")


if __name__ == "__main__":
    main()
