"""The port's training loop against the JAX package's: ``train()``, the
OneCycle schedule, the beam-KD step, ``remat_encoder``, the preemption
checkpoint and the schedule-completing resume, the background checkpoint
writer and ``python -m rtvc_tpu_torch.train``.

The pair is tests/test_train.py's tiny student and teacher (64-pixel
frames, vocab 173) with dropout 0 (the two packages draw other bits), the
teacher's weights from ``make_git_sd(random=True)`` on both sides, the
student's initial weights JAX's own ``create_train_state`` init carried by
the weight bridge. JAX runs at ``default_matmul_precision("highest")`` on
one device, the port in float32 on the CPU (plain versions). Limits, as
tests/test_torch_train.py's for the step:

- each epoch's train loss, each step's losses and ``grad_norm`` within
  1e-5 relative;
- each gradient leaf (read from Adam's first moment, 0.1·g after one step)
  within 1e-4 of max(1, max|g|); BatchNorm statistics within 1e-5 of
  max(1, max|x|);
- the final master weights of a run within 1e-4 · max(1, max|w|), but
  for the elements whose gradient the limit above leaves undecided: zero
  in exact arithmetic (``rounding_noise``), or of opposite signs in the
  two packages at the first step, where Adam moves each by ±lr on the
  sign alone; those are held within steps · lr of the start;
- validation and test BLEU, and the plateau learning rates, equal;
- OneCycle rates within 1e-6 of the peak rate: XLA's float32 cosine and
  division differ from torch's in the last bits (a few ulp).

The resume, the cache replay and ``remat_encoder`` against the plain step
are held port against port, bit for bit.
"""

import dataclasses
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from rtvc_tpu import config as jconfig
from rtvc_tpu import distill as jdistill
from rtvc_tpu import train as jtrain
from rtvc_tpu.parallel.mesh import make_mesh
from rtvc_tpu.tokenization import BertWordPieceTokenizer as JaxTokenizer
from rtvc_tpu_torch import config as pconfig
from rtvc_tpu_torch import distill
from rtvc_tpu_torch import train
from rtvc_tpu_torch.data import io
from rtvc_tpu_torch.data.teacher_cache import TeacherBeamCache
from rtvc_tpu_torch.models.convert import student_state_dict_from_jax
from rtvc_tpu_torch.models.layers import DropPath
from rtvc_tpu_torch.tokenization import BertWordPieceTokenizer

from test_convert_fullsize import make_git_sd
from test_torch_evaluate import lively
from test_torch_teacher import teacher_pair
from test_torch_train import (_port_student, _rel_close, _scaled_close, _t,
                              config_from)
from test_train import GIT64, synth_batch, tiny_pair

B = 4
EPOCHS = 2
PEAK = 1e-4  # OneCycle's peak rate
LR = 1e-4  # the reference's rate (config.py:72)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The models are tiny, so torch's intra-op threads only contend with
    the other test workers' for the cores: under six workers on eight
    cores the resume test ran 30× slower with them than without."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def jax_batches(seeds, tag="v"):
    return [synth_batch(b=B, seed=s) | {
        "vid-id": [f"{tag}{s}_{i}" for i in range(B)],
        "caption-id": list(range(B))} for s in seeds]


def port_batches(jbatches):
    return [{k: _t(v) if k in ("frames", "caption") else v
             for k, v in b.items()} for b in jbatches]


def sharp_sd():
    """GIT64 weights with the output layer and visual projection scaled up:
    random logits are otherwise near-flat and the beam's choices tie."""
    sd = make_git_sd(GIT64, random=True)
    sd["textual.output.weight"] = sd["textual.output.weight"] * 15
    sd["textual.visual_projection.0.weight"] = (
        sd["textual.visual_projection.0.weight"] * 10)
    return sd


@pytest.fixture(scope="module")
def pair():
    """The JAX student (dropout 0), its initial variables for a first
    batch of ``B`` rows (its init from config seed 5, made lively), and
    the teachers on both sides."""
    jstudent = tiny_pair()[0].clone(dropout=0.0)
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=LR)
    init = jtrain.create_train_state(jstudent, jax.random.PRNGKey(5),
                                     synth_batch(b=B, seed=0), tx)
    # the vocab projection and the cross-attention output ×10: at the
    # init's scales the greedy decode's choices tie within rounding
    variables = lively({"params": init.params,
                        "batch_stats": init.batch_stats})
    jteacher, tvars, pteacher = teacher_pair(GIT64, sharp_sd())
    return dict(jstudent=jstudent, variables=variables, jteacher=jteacher,
                tvars=tvars, pteacher=pteacher)


def port_config(tmp, **train_over):
    return config_from({
        "logger": {"save_dir": str(tmp)}, "compute_dtype": "float32",
        "wandb": {"mode": "disabled"},
        "train": {"lr": LR, "batch_size": B,
                  "trainer": {"max_epochs": EPOCHS}, **train_over}})


def jax_config(tmp, **train_over):
    return jconfig.from_dict({
        "logger": {"save_dir": str(tmp)}, "wandb": {"mode": "disabled"},
        "train": {"lr": LR, "batch_size": B,
                  "trainer": {"max_epochs": EPOCHS}, **train_over}})


def rounding_noise(student, name, shape) -> np.ndarray:
    """The elements of a trained entry whose gradient is zero in exact
    arithmetic, where each package's rounding noise, which Adam turns into
    steps of ±lr, decides the value at every step
    (``chip_smoke.rounding_noise``, by which phase 10 compares runs: the
    key bias of every attention, the MLP output bias of every stage but
    the last, and the running means of the BatchNorms those feed)."""
    return chip_smoke.rounding_noise(student, name, shape)


def scalars(save_dir, run):
    with open(os.path.join(save_dir, "run", run, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


# ---------------------------------------------------------------------------
# train() against JAX's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["plateau", "onecycle"])
def runs(request, pair, tmp_path_factory):
    """Two epochs of two batches on both sides, one scheduler each."""
    sched = request.param
    over = dict(scheduler=sched, onecycle_max_lr=PEAK,
                plateau_patience=0)  # anneal on any epoch that fails
    tmp = tmp_path_factory.mktemp(f"loop_{sched}")
    train_j = jax_batches([0, 1])
    val_j, test_j = jax_batches([10], "e"), jax_batches([20], "t")
    variables = pair["variables"]

    def start_state(student, rng, example, tx):
        params = jax.tree.map(jnp.asarray, variables["params"])
        return jtrain.TrainState(
            params=params,
            batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
            opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))

    with jax.default_matmul_precision("highest"), \
            pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrain, "create_train_state", start_state)
        jstate, jhist = jtrain.train(
            jax_config(tmp / "jax", **over), train_j, val_j, test_j,
            JaxTokenizer(), run_name="r", student=pair["jstudent"],
            teacher=pair["jteacher"], teacher_vars=pair["tvars"],
            mesh=make_mesh((1, 1)))
    student = _port_student(pair["variables"])
    state, hist = train.train(
        port_config(tmp / "port", **over), port_batches(train_j),
        port_batches(val_j), port_batches(test_j), BertWordPieceTokenizer(),
        run_name="r", student=student, teacher=pair["pteacher"],
        device="cpu")
    return dict(sched=sched, tmp=tmp, jstate=jstate, jhist=jhist,
                state=state, hist=hist, student=student,
                variables=pair["variables"])


@pytest.fixture(scope="module")
def first_step_flips(pair):
    """Each side's gradient at ``train()``'s first step (the start weights,
    batch 0), held to the step's limit (1e-4 of max(1, max|g|) a leaf);
    returns, by parameter, where the two gradients' signs differ: there
    Adam's first step moves the element by lr on the sign alone, and a
    sign inside the limit decides nothing."""
    variables = pair["variables"]
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=LR)
    params = jax.tree.map(jnp.asarray, variables["params"])
    jstate = jtrain.TrainState(
        params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
    batch = {k: v for k, v in jax_batches([0])[0].items()
             if k in ("frames", "caption")}
    with jax.default_matmul_precision("highest"):
        jstep = jtrain.make_train_step(pair["jstudent"], pair["jteacher"],
                                       tx, donate=False)
        new_j, _ = jstep(jstate, pair["tvars"], batch, jax.random.PRNGKey(3))
    want = student_state_dict_from_jax(new_j.opt_state.inner_state[0].mu, {})
    student = _port_student(variables)
    opt = train.Adam(LR)
    state = train.create_train_state(student, opt, torch.float32)
    train.make_train_step(student, pair["pteacher"], opt)(
        state, {k: _t(v) for k, v in batch.items()},
        torch.Generator().manual_seed(0))
    flips = {}
    for (name, _), mu in zip(student.named_parameters(), state.opt_state.mu):
        g, w = mu.numpy() / 0.1, want[name].numpy() / 0.1
        _scaled_close(g, w, 1e-4, name)
        flips[name] = np.sign(g) != np.sign(w)
    return flips


def test_train_matches_jax(runs, first_step_flips):
    jhist, hist = runs["jhist"], runs["hist"]
    assert len(hist["train_loss"]) == len(jhist["train_loss"]) == EPOCHS
    for got, want in zip(hist["train_loss"], jhist["train_loss"]):
        _rel_close(got, want, 1e-5, "epoch train loss")
    assert hist["val_loss"] == jhist["val_loss"]
    assert hist["test_loss"] == jhist["test_loss"]
    assert hist["epoch_n_steps"] == jhist["epoch_n_steps"] == [2, 2]
    assert runs["state"].step == int(runs["jstate"].step) == 4
    want = student_state_dict_from_jax(runs["jstate"].params,
                                       runs["jstate"].batch_stats)
    start = student_state_dict_from_jax(runs["variables"]["params"],
                                        runs["variables"]["batch_stats"])
    got = train.train_state_tree(runs["state"])["state_dict"]
    steps = runs["state"].step
    for name, w in want.items():
        g, w = got[name].numpy(), w.numpy()
        noise = rounding_noise(runs["student"], name, w.shape)
        noise |= first_step_flips.get(name, False)
        if (~noise).any():
            _scaled_close(g[~noise], w[~noise], 1e-4, name)
        if name.endswith("running_mean"):
            continue
        # Adam moves an element by at most lr a step, noise or not
        moved = np.abs(g[noise] - start[name].numpy()[noise])
        assert (moved <= steps * LR * 1.001).all(), name


def test_train_lr_trajectory_matches_jax(runs):
    got = [r["lr"] for r in scalars(runs["tmp"] / "port", "r")]
    want = [r["lr"] for r in scalars(runs["tmp"] / "jax", "r")]
    assert len(got) == len(want) == EPOCHS
    if runs["sched"] == "plateau":
        assert got == want
        assert got[-1] < LR  # the scheduler annealed: the test sees it
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * PEAK)


def test_train_history_keys_match_jax(runs):
    missing = set(runs["jhist"]) - set(runs["hist"])
    assert missing == set()
    assert len(runs["hist"]["epoch_eval_s"]) == EPOCHS
    assert [len(d) for d in runs["hist"]["epoch_dispatch_ms"]] == [2, 2]


@pytest.mark.parametrize("n,peak", [(4, 0.01), (12, 0.01), (37, 3e-3),
                                    (200, 0.01)])
def test_onecycle_matches_optax(n, peak):
    """The rate each update applies: optax reads its schedule at the count
    of updates before this one, inside the jitted update."""
    want = jax.jit(optax.cosine_onecycle_schedule(transition_steps=n,
                                                  peak_value=peak))
    got = train.cosine_onecycle_schedule(n, peak)
    for c in range(n + 3):
        assert abs(got(c) - float(want(jnp.int32(c)))) <= 1e-6 * peak, c
    with pytest.raises(ValueError):
        train.cosine_onecycle_schedule(0, peak)


def test_adam_over_a_schedule_matches_optax():
    """``optax.adam(learning_rate=schedule)``: three updates."""
    rng = np.random.default_rng(3)
    params = [rng.normal(size=(4, 3)).astype(np.float32)]
    grads = [[rng.normal(size=(4, 3)).astype(np.float32)] for _ in range(3)]
    tx = optax.adam(learning_rate=optax.cosine_onecycle_schedule(5, 0.1))
    jp = [jnp.asarray(params[0])]
    js = tx.init(jp)
    opt = train.Adam(learning_rate=train.cosine_onecycle_schedule(5, 0.1))
    pp = [_t(params[0])]
    ps = opt.init(pp)
    assert ps.hyperparams == {}
    for g in grads:
        upd, js = jax.jit(tx.update)([jnp.asarray(g[0])], js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update([_t(g[0])], ps, pp)
    np.testing.assert_allclose(pp[0].numpy(), np.asarray(jp[0]), atol=1e-6,
                               rtol=0)


# ---------------------------------------------------------------------------
# the beam-KD step against JAX's
# ---------------------------------------------------------------------------

BEAM_KD = distill.LossWeights(ce_teacher=1.0, kd_source="beam_consensus")


def _jax_beam_targets(pair, batch):
    """JAX's beam over the batch: predictions and full consensus rows, as
    the beam cache's miss path stores them."""
    from rtvc_tpu import decode as jdecode
    out = jdecode.teacher_beam(pair["jteacher"], pair["tvars"],
                               batch["frames"], beam_size=4, max_steps=15,
                               length_penalty=0.6)
    steps = out.logits.shape[0]
    kd, _ = jdecode.teacher_kd_targets(
        out, jnp.full((out.predictions.shape[0],), steps, jnp.int32))
    return np.asarray(out.predictions), np.asarray(kd, np.float32)


@pytest.fixture(scope="module")
def beam_steps(pair):
    """One beam-KD step on each side: live, and from full-vocab and top-K
    beam-cache entries (the miss path's targets, written by JAX's beam)."""
    from rtvc_tpu_torch import decode as pdecode
    batch = synth_batch(b=B, seed=7)
    with jax.default_matmul_precision("highest"):
        preds, kd = _jax_beam_targets(pair, batch)
    port_out = pdecode.teacher_beam(pair["pteacher"], _t(batch["frames"]),
                                    beam_size=4, max_steps=15)
    # the live branches agree only if the two beams chose the same words
    np.testing.assert_array_equal(port_out.predictions.numpy(), preds)
    k = 16
    cache = TeacherBeamCache.__new__(TeacherBeamCache)
    cache.top_k = k
    vals, idx = cache.compress(kd)
    modes = {
        "live": ({}, {}),
        "cache": (dict(teacher_beam_predictions=preds,
                       teacher_kd_logits=kd),
                  dict(external_teacher_beam=True)),
        "cache_top_k": (dict(teacher_beam_predictions=preds,
                             teacher_kd_vals=vals, teacher_kd_idx=idx),
                        dict(external_teacher_beam=True,
                             beam_cache_top_k=k)),
    }
    out = {}
    for mode, (extra, kw) in modes.items():
        jb = dict(batch, **{n: jnp.asarray(v) for n, v in extra.items()})
        variables = pair["variables"]
        tx = optax.inject_hyperparams(optax.adam)(learning_rate=LR)
        params = jax.tree.map(jnp.asarray, variables["params"])
        jstate = jtrain.TrainState(
            params=params,
            batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
            opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
        with jax.default_matmul_precision("highest"):
            jstep = jtrain.make_train_step(
                pair["jstudent"], pair["jteacher"], tx,
                jdistill.LossWeights(ce_teacher=1.0,
                                     kd_source="beam_consensus"),
                donate=False, **kw)
            new_j, jm = jstep(jstate, pair["tvars"], jb,
                              jax.random.PRNGKey(3))
        student = _port_student(variables)
        opt = train.Adam(LR)
        state = train.create_train_state(student, opt, torch.float32)
        step = train.make_train_step(student, pair["pteacher"], opt,
                                     BEAM_KD, **kw)
        m = step(state, {n: _t(v) for n, v in jb.items()},
                 torch.Generator().manual_seed(0))
        out[mode] = (new_j, jm, state, m, student)
    return out


@pytest.mark.parametrize("mode", ["live", "cache", "cache_top_k"])
def test_beam_kd_step_matches_jax(beam_steps, mode):
    new_j, jm, state, m, student = beam_steps[mode]
    assert set(m) == set(jm)
    for k in jm:
        _rel_close(m[k], jm[k], 1e-5, k)
    want = student_state_dict_from_jax(new_j.opt_state.inner_state[0].mu,
                                       new_j.batch_stats)
    names = [n for n, _ in student.named_parameters()]
    for name, mu in zip(names, state.opt_state.mu):
        w = want[name].numpy() / 0.1
        np.testing.assert_allclose(
            mu.numpy() / 0.1, w, rtol=0,
            atol=1e-4 * max(1.0, float(np.abs(w).max())), err_msg=name)
    buffers = dict(student.named_buffers())
    for name, value in want.items():
        if name.endswith(("running_mean", "running_var")):
            _scaled_close(buffers[name].numpy(), value.numpy(), 1e-5, name)


def test_beam_kd_cache_replays_the_live_step(beam_steps):
    """The full-vocab entries are the live branch's targets: one loss."""
    live, cached = beam_steps["live"][3], beam_steps["cache"][3]
    for k in live:
        _rel_close(cached[k], live[k], 1e-6, k)


GUARDS = [
    dict(weights=dict(fmap=1.0), kw=dict(external_teacher_logits=True)),
    dict(weights=dict(ce_teacher=1.0), kw=dict(external_teacher_logits=True)),
    dict(weights=dict(), kw=dict(external_teacher_beam=True)),
]


@pytest.mark.parametrize("case", GUARDS, ids=["taps", "no_beam_cache",
                                              "unused_beam_cache"])
def test_make_train_step_guards_raise_jax_errors(pair, case):
    jtx = optax.adam(1e-3)
    with pytest.raises(ValueError) as want:
        jtrain.make_train_step(pair["jstudent"], pair["jteacher"], jtx,
                               jdistill.LossWeights(**case["weights"]),
                               **case["kw"])
    student = _port_student(pair["variables"])
    with pytest.raises(ValueError) as got:
        train.make_train_step(student, pair["pteacher"], train.Adam(),
                              distill.LossWeights(**case["weights"]),
                              **case["kw"])
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# remat_encoder
# ---------------------------------------------------------------------------

def _one_step(pair, remat, rate=0.0, path_rate=0.0, grad_accum=1):
    student = _port_student(pair["variables"])
    student.remat_encoder = remat
    for layer in student.decoder["layers"]:
        layer.dropout = rate
    for mod in student.modules():
        if isinstance(mod, DropPath):
            mod.rate = path_rate
    opt = train.Adam(LR)
    state = train.create_train_state(student, opt, torch.float32)
    step = train.make_train_step(student, pair["pteacher"], opt,
                                 grad_accum=grad_accum)
    batch = {k: _t(v) for k, v in synth_batch(b=B, seed=3).items()}
    m = step(state, batch, torch.Generator().manual_seed(9))
    stats = {n: b.clone() for n, b in student.named_buffers()
             if n.endswith(("running_mean", "running_var",
                            "num_batches_tracked"))}
    return m, state.opt_state.mu, stats


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_remat_encoder_gives_the_plain_step(pair, grad_accum):
    """With dropout and DropPath drawing: the recompute replays the
    forward's bits and leaves the BatchNorm statistics to the forward, so
    the losses, the gradients and the statistics are the plain step's."""
    plain = _one_step(pair, False, 0.3, 0.2, grad_accum)
    remat = _one_step(pair, True, 0.3, 0.2, grad_accum)
    for k in plain[0]:
        assert torch.equal(plain[0][k], remat[0][k]), k
    for a, b in zip(plain[1], remat[1]):
        assert torch.equal(a, b)
    assert plain[2].keys() == remat[2].keys()
    for k in plain[2]:
        assert torch.equal(plain[2][k], remat[2][k]), k


def test_remat_encoder_step_matches_jax(pair):
    """The port's checkpointed step against JAX's ``nn.remat`` student."""
    jstudent = pair["jstudent"].clone(remat_encoder=True)
    variables = pair["variables"]
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=LR)
    params = jax.tree.map(jnp.asarray, variables["params"])
    jstate = jtrain.TrainState(
        params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
    batch = synth_batch(b=B, seed=3)
    with jax.default_matmul_precision("highest"):
        jstep = jtrain.make_train_step(jstudent, pair["jteacher"], tx,
                                       donate=False)
        new_j, jm = jstep(jstate, pair["tvars"], batch,
                          jax.random.PRNGKey(3))
    m, mu, stats = _one_step(pair, True)
    for k in ("kl", "ce", "total", "grad_norm"):
        _rel_close(m[k], jm[k], 1e-5, k)
    want = student_state_dict_from_jax(new_j.opt_state.inner_state[0].mu,
                                       new_j.batch_stats)
    student = _port_student(variables)
    for (name, _), got in zip(student.named_parameters(), mu):
        w = want[name].numpy() / 0.1
        np.testing.assert_allclose(
            got.numpy() / 0.1, w, rtol=0,
            atol=1e-4 * max(1.0, float(np.abs(w).max())), err_msg=name)
    for name, value in want.items():
        if name.endswith(("running_mean", "running_var")):
            _scaled_close(stats[name].numpy(), value.numpy(), 1e-5, name)


def test_config_remat_encoder_builds_a_checkpointed_student():
    from rtvc_tpu_torch.models.student import student_from_config
    cfg = dataclasses.replace(pconfig.cfg, remat_encoder=True)
    assert student_from_config(cfg, device="cpu").remat_encoder
    assert not student_from_config(pconfig.cfg, device="cpu").remat_encoder


# ---------------------------------------------------------------------------
# the port's own loop: caches, preemption, resume, the checkpoint writer
# ---------------------------------------------------------------------------

class ShuffledLoader:
    """A loader speaking the ``set_epoch`` protocol, each pass shuffled by
    its pass counter as ``DeviceLoader`` shuffles; optionally SIGTERMs this
    process before batch ``kill[1]`` of pass ``kill[0]`` (``train()``'s
    first pass, before its loop, is pass 0)."""

    def __init__(self, kill=None):
        self._epoch = 0
        self.kill = kill
        self.seen_set_epoch = []

    def set_epoch(self, epoch):
        self.seen_set_epoch.append(int(epoch))
        self._epoch = int(epoch)

    def __len__(self):
        return 4

    def __iter__(self):
        e = self._epoch
        self._epoch += 1
        order = np.random.default_rng(100 + e).permutation(4)
        for j, i in enumerate(order):
            if self.kill == (e, j):
                os.kill(os.getpid(), signal.SIGTERM)
            yield port_batches(jax_batches([int(i)]))[0]


def _dropout_student(pair):
    """The pair's port student with its decoder dropout at 0.1: the resume
    must replay each step's draws."""
    student = _port_student(pair["variables"])
    for layer in student.decoder["layers"]:
        layer.dropout = 0.1
    return student


def _assert_states_equal(a, b):
    ta, tb = train.train_state_tree(a), train.train_state_tree(b)
    assert ta["step"] == tb["step"]
    assert ta["opt_state"]["count"] == tb["opt_state"]["count"]
    assert ta["opt_state"]["hyperparams"] == tb["opt_state"]["hyperparams"]
    for part in ("mu", "nu"):
        for k, v in ta["opt_state"][part].items():
            assert torch.equal(v, tb["opt_state"][part][k]), (part, k)
    for k, v in ta["state_dict"].items():
        assert torch.equal(v, tb["state_dict"][k]), k


def test_resume_schedule_bitwise_continuation(pair, tmp_path):
    """A preempted 3-epoch run resumed with ``resume_schedule=True`` ends
    with the uninterrupted run's master weights, Adam moments and
    BatchNorm statistics, bit for bit; so does a resume from an epoch-end
    checkpoint."""
    def cfg():
        return config_from({
            "logger": {"save_dir": str(tmp_path)},
            "compute_dtype": "float32", "wandb": {"mode": "disabled"},
            "callback": {"save_top_k": 3},  # keep ckpt_01 for the resume
            "train": {"lr": LR, "batch_size": B, "plateau_patience": 0,
                      "trainer": {"max_epochs": 3}}})

    def run(name, loader, **kw):
        return train.train(cfg(), loader, port_batches(jax_batches([10],
                                                                   "e")),
                           port_batches(jax_batches([20], "t")),
                           BertWordPieceTokenizer(), run_name=name,
                           student=_dropout_student(pair),
                           teacher=pair["pteacher"], device="cpu", **kw)

    state_a, hist_a = run("a", ShuffledLoader())
    assert state_a.step == 12

    prev = signal.getsignal(signal.SIGTERM)
    state_b, hist_b = run("b", ShuffledLoader(kill=(2, 2)))
    assert hist_b["preempted"] is True and hist_b["test_loss"] is None
    assert state_b.step == 6               # epoch 0 (4) + 2 of epoch 1
    assert signal.getsignal(signal.SIGTERM) is prev
    ckpt = str(tmp_path / "run" / "b" / "ckpt_preempt")
    meta = io.checkpoint_meta(ckpt)
    assert meta["epoch"] == 1 and meta["steps_into_epoch"] == 2
    assert meta["preempted"] is True
    assert meta["plateau"]["lr"] == pytest.approx(LR)
    text = (tmp_path / "run" / "b" / "_results_and_metrics.txt").read_text()
    assert "SIGTERM: checkpointed" in text

    loader_c = ShuffledLoader()
    state_c, hist_c = run("c", loader_c, resume_from=ckpt,
                          resume_schedule=True)
    assert loader_c.seen_set_epoch == [2]  # epoch 1 is the loader's pass 2
    assert len(hist_c["train_loss"]) == 2
    _assert_states_equal(state_a, state_c)

    e_ckpt = str(tmp_path / "run" / "a" / "ckpt_01")
    assert io.checkpoint_meta(e_ckpt)["epoch"] == 1
    loader_d = ShuffledLoader()
    state_d, hist_d = run("d", loader_d, resume_from=e_ckpt,
                          resume_schedule=True)
    assert loader_d.seen_set_epoch == [3]
    assert len(hist_d["train_loss"]) == 1
    _assert_states_equal(state_a, state_d)
    assert hist_d["test_loss"] == hist_a["test_loss"]

    # without resume_schedule: max_epochs more, from the checkpoint's step
    state_e, _ = run("e", ShuffledLoader(), resume_from=ckpt, max_epochs=1)
    assert state_e.step == 6 + 4
    with pytest.raises(ValueError, match="needs resume_from"):
        run("f", ShuffledLoader(), resume_schedule=True)


def test_one_device_mesh_is_the_default_run(pair, tmp_path):
    """``train(mesh=make_mesh((1, 1)))`` runs as the default (a mesh of
    one device, no process group) does, bit for bit; a mesh of two devices
    of one process raises (the port runs one process per rank)."""
    from rtvc_tpu_torch.parallel import make_mesh

    def run(name, **kw):
        return train.train(
            port_config(tmp_path, trainer={"max_epochs": 1}),
            port_batches(jax_batches([0])), [], [], BertWordPieceTokenizer(),
            run_name=name, student=_port_student(pair["variables"]),
            teacher=pair["pteacher"], device="cpu", **kw)

    state_a, hist_a = run("a")
    state_b, hist_b = run("b", mesh=make_mesh((1, 1), devices=["cpu"]))
    assert hist_b["train_loss"] == hist_a["train_loss"]
    _assert_states_equal(state_a, state_b)
    with pytest.raises(ValueError, match="one process per rank"):
        run("c", mesh=make_mesh((2, 1), devices=["cpu"] * 2))


@pytest.mark.parametrize("top_k", [0, 8])
def test_cached_run_equals_uncached(pair, tmp_path, top_k):
    """Epoch 1 misses and runs the live teacher, epoch 2 replays: at full
    vocab every loss is the uncached run's; at top-K the miss and the hit
    epoch see the same truncated targets."""
    def run(name, cache):
        return train.train(
            port_config(tmp_path, teacher_cache_top_k=top_k),
            port_batches(jax_batches([0, 1])),
            port_batches(jax_batches([10], "e")),
            port_batches(jax_batches([20], "t")), BertWordPieceTokenizer(),
            run_name=name, student=_dropout_student(pair),
            teacher=pair["pteacher"], device="cpu", teacher_cache=cache)

    _, live = run("live", None)
    state, cached = run("cached", str(tmp_path / "cache"))
    assert cached["teacher_cache"] == {"hits": 2 * B, "misses": 2 * B}
    files = os.listdir(tmp_path / "cache")
    assert len(files) == 2 * B
    assert all(f.endswith(f".top{top_k}.npz" if top_k else ".npy")
               for f in files)
    if top_k:
        assert all(np.isfinite(cached["train_loss"]))
        assert cached["train_loss"] != live["train_loss"]
    else:
        assert cached["train_loss"] == live["train_loss"]


def test_beam_cache_run_replays_the_live_beam(pair, tmp_path):
    """Beam-KD through a top-K beam cache: epoch 1 runs the live beam
    (outside the step) and stores it, epoch 2 replays it without the
    teacher; both epochs' losses are finite."""
    from rtvc_tpu_torch import decode as pdecode
    calls = []
    real = pdecode.teacher_beam

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    pdecode.teacher_beam = counting
    try:
        _, hist = train.train(
            port_config(tmp_path, teacher_beam_cache_top_k=16),
            port_batches(jax_batches([0, 1])),
            port_batches(jax_batches([10], "e")),
            port_batches(jax_batches([20], "t")), BertWordPieceTokenizer(),
            run_name="beam", student=_port_student(pair["variables"]),
            teacher=pair["pteacher"], device="cpu", loss_weights=BEAM_KD,
            teacher_beam_cache=str(tmp_path / "beams"))
    finally:
        pdecode.teacher_beam = real
    assert len(calls) == 2  # epoch 1's two batches
    assert hist["teacher_beam_cache"] == {"hits": 2 * B, "misses": 2 * B}
    assert all(np.isfinite(hist["train_loss"]))
    with pytest.raises(ValueError, match="no beam-KD loss"):
        train.train(port_config(tmp_path), [], [], [],
                    BertWordPieceTokenizer(),
                    student=_port_student(pair["variables"]),
                    teacher=pair["pteacher"], device="cpu",
                    teacher_beam_cache=str(tmp_path / "beams"))


def test_a_one_pass_loader_gives_its_first_batch_to_the_first_pass(
        pair, tmp_path):
    """A generator is its own (only) pass: the batch ``train()`` reads
    before its loop is gone, as JAX's example batch is, and the loop trains
    on the rest; a re-iterable loader trains on every batch."""
    def run(loader):
        return train.train(
            port_config(tmp_path), loader,
            port_batches(jax_batches([10], "e")),
            port_batches(jax_batches([20], "t")), BertWordPieceTokenizer(),
            student=_port_student(pair["variables"]),
            teacher=pair["pteacher"], device="cpu")

    state, hist = run(b for b in port_batches(jax_batches([0, 1, 2])))
    assert state.step == 2 and hist["epoch_n_steps"] == [2, 0]
    state, hist = run(port_batches(jax_batches([0, 1, 2])))
    assert state.step == 6 and hist["epoch_n_steps"] == [3, 3]


def test_ragged_batch_trimmed_for_grad_accum(pair, tmp_path):
    batches = jax_batches([0]) + [synth_batch(b=3, seed=4) | {
        "vid-id": ["r0", "r1", "r2"], "caption-id": [0, 1, 2]}]
    _, hist = train.train(
        port_config(tmp_path, grad_accum_steps=2), port_batches(batches),
        port_batches(jax_batches([10], "e")),
        port_batches(jax_batches([20], "t")), BertWordPieceTokenizer(),
        run_name="rag", student=_port_student(pair["variables"]),
        teacher=pair["pteacher"], device="cpu", max_epochs=1)
    assert np.isfinite(hist["train_loss"][0])
    text = (tmp_path / "run" / "rag" / "_results_and_metrics.txt").read_text()
    assert "trimming ragged batch 3 -> 2" in text


def test_async_saver_writes_the_state_at_save(tmp_path):
    """An in-place write after ``save()`` does not reach the file: the
    saver copied every tensor before its thread started. Its buffers are
    reused by the next save, which waits for the first write."""
    saver = io.AsyncCheckpointSaver()
    w = torch.arange(6, dtype=torch.float32)
    tree = {"state_dict": {"w": w}, "opt_state": {"mu": {"w": w * 2}},
            "step": 3}
    done = []
    saver.save(str(tmp_path / "a"), tree, meta={"epoch": 0},
               on_done=lambda: done.append("a"))
    w.add_(100.0)                    # the next step's in-place update
    saver.save(str(tmp_path / "b"), tree)
    w.add_(100.0)
    saver.wait()
    a = io.restore_checkpoint(str(tmp_path / "a"))
    b = io.restore_checkpoint(str(tmp_path / "b"))
    assert torch.equal(a["state_dict"]["w"], torch.arange(6.0))
    assert torch.equal(b["state_dict"]["w"], torch.arange(6.0) + 100)
    assert a["step"] == 3 and done == ["a"]
    assert io.checkpoint_meta(str(tmp_path / "a")) == {"epoch": 0}

    def fail():
        raise RuntimeError("disk full")

    saver.save(str(tmp_path / "c"), tree, on_done=fail)
    with pytest.raises(RuntimeError, match="disk full"):
        saver.wait()


def test_train_state_checkpoint_loads_for_evaluation(pair, tmp_path):
    """The state_dict of a train-state checkpoint is the master weights in
    the reference layout: ``load_kd_student_params`` reads it, without the
    distillation heads, and a resume restores every part of the state."""
    student = _port_student(pair["variables"])
    opt = train.Adam(LR)
    state = train.create_train_state(student, opt, torch.float32)
    step = train.make_train_step(student, pair["pteacher"], opt)
    batch = {k: _t(v) for k, v in synth_batch(b=B, seed=3).items()}
    step(state, batch, train.step_generator(7, 0))
    io.save_checkpoint(str(tmp_path / "ck"), train.train_state_tree(state))
    sd = io.load_kd_student_params(str(tmp_path / "ck"))["state_dict"]
    assert not any(k.startswith(io.DISTILL_HEADS) for k in sd)
    fresh = _port_student(pair["variables"])
    fresh.load_state_dict(sd, strict=False)
    for (name, p), master in zip(student.named_parameters(), state.params):
        if not name.startswith(io.DISTILL_HEADS):
            assert torch.equal(dict(fresh.named_parameters())[name], master)
    other = train.create_train_state(_port_student(pair["variables"]),
                                     train.Adam(LR), torch.float32)
    train.load_train_state(other, io.restore_checkpoint(
        str(tmp_path / "ck")))
    _assert_states_equal(state, other)


def test_step_generator_is_a_function_of_seed_and_step():
    def draw(seed, step):
        return torch.rand(4, generator=train.step_generator(seed, step))
    assert torch.equal(draw(7, 3), draw(7, 3))
    assert not torch.equal(draw(7, 3), draw(7, 4))
    assert not torch.equal(draw(7, 3), draw(8, 3))


def test_preemption_guard_sets_its_flag_and_restores():
    prev = signal.getsignal(signal.SIGTERM)
    guard = train.PreemptionGuard()
    assert not guard.triggered
    os.kill(os.getpid(), signal.SIGTERM)
    assert guard.triggered
    guard.restore()
    assert signal.getsignal(signal.SIGTERM) is prev


# ---------------------------------------------------------------------------
# python -m rtvc_tpu_torch.train, then evaluate on its checkpoint
# ---------------------------------------------------------------------------

def test_main_then_evaluate_its_checkpoint(tmp_path, monkeypatch, capsys):
    """``main()`` on an MSRVTT-format tree (train, validate and test
    splits) with a tiny 224-pixel student and teacher in place of the
    full-size ones, two epochs; then ``evaluate.main`` scores the run's
    newest checkpoint: its texts are the test epoch's and its corpus BLEU-4
    the test epoch's."""
    from rtvc_tpu_torch import evaluate, serving
    from rtvc_tpu_torch.models.git_teacher import GITTeacher
    from rtvc_tpu_torch.models.student import StudentCandidateV1, random_init_
    from test_torch_data import write_msrvtt
    from test_torch_models import FRAMES, port_encoder_config

    tree = write_msrvtt(str(tmp_path / "data"), n_videos=15, seed=6,
                        splits=("train", "validate", "test"))
    config = config_from({
        "data": {"videos_path": tree["videos"],
                 "captions_path": tree["labels"],
                 "encoded_caption_ids": tree["encoded"],
                 "annotation_path": tree["annotations"],
                 "num_frames": FRAMES},
        "logger": {"save_dir": str(tmp_path / "results")},
        "compute_dtype": "float32", "wandb": {"mode": "disabled"},
        "train": {"batch_size": B, "lr": LR, "trainer": {"max_epochs": 2}}})
    vocab = len(BertWordPieceTokenizer().vocab)  # the captions' ids

    def tiny_student():
        return random_init_(StudentCandidateV1(
            d_model=32, n_head=4, d_ffn=64, num_decoder_layers=2,
            vocab_size=vocab, max_pos_len=64,
            encoder_config=port_encoder_config(True), input_size=224,
            num_frames=FRAMES, teacher_visual_dim=32, teacher_num_tokens=34,
            teacher_hidden=16), torch.Generator().manual_seed(config.seed))

    clip = pconfig.CLIPViTConfig(image_size=224, patch_size=56, width=32,
                                 layers=2, heads=2)
    teacher = GITTeacher(pconfig.GITConfig(
        vocab_size=vocab, hidden_size=16, num_layers=2, attention_heads=2,
        feedforward_size=32, visual_feature_size=32, max_caption_length=64,
        num_image_with_embedding=FRAMES, clip=clip))
    built = []

    def build_models(cfg, device):
        built.append(device)
        return tiny_student(), teacher

    def build_serving(ckpt=None, device="cuda", config=None):
        return serving.load_student_weights(tiny_student(), ckpt).eval()

    monkeypatch.setattr(train, "default_cfg", config)
    monkeypatch.setattr(train, "_build_models", build_models)
    monkeypatch.setattr(evaluate, "default_cfg", config)
    monkeypatch.setattr(serving, "build_serving_student", build_serving)
    state, hist = train.main(["--device", "cpu"])
    assert built == ["cpu"] and state.step == 2 * (5 // B)
    assert len(hist["train_loss"]) == 2 and all(
        np.isfinite(hist["train_loss"]))
    run_dirs = os.listdir(tmp_path / "results" / "run")
    assert len(run_dirs) == 1
    run_dir = tmp_path / "results" / "run" / run_dirs[0]
    ckpts = sorted(p.name for p in run_dir.iterdir()
                   if p.name.startswith("ckpt_") and p.is_dir())
    assert ckpts == ["ckpt_01"]           # save_top_k 1
    capsys.readouterr()
    out = str(tmp_path / "scores.json")
    evaluate.main([run_dirs[0], "--out", out, "--device", "cpu"])
    scores = json.loads(open(out).read())
    preds = json.loads(open(out + ".preds.json").read())
    assert preds == hist["test_outputs"]
    assert scores["corpus_bleu4"] == hist["test_loss"]
    # --multihost without a process group's environment trains in this
    # one process, as JAX's does
    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
                "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    state_m, hist_m = train.main(["--multihost", "--device", "cpu"])
    assert state_m.step == state.step
    assert hist_m["train_loss"] == hist["train_loss"]



