"""The port's distillation train step against the JAX package's.

Inputs and perturbed weights come from numpy seeds; the JAX side runs
under ``default_matmul_precision("highest")``, the port its plain versions
in float32 on the CPU, with the same weights through the weight bridge
(``student_state_dict_from_jax`` for the student, the reference
``model.pt`` layout of ``make_git_sd`` for the teacher). Tolerances:

- 1e-6 relative for each loss on the same logits: one float32 reduction
  summed in another order;
- 1e-5 of max(1, max|x|) for the train-mode TinyViT's stage maps and its
  updated BatchNorm statistics, and 1e-5 relative for the train step's kl,
  ce and total: float32 through a few layers whose sums run in another
  order (train-mode BatchNorm over the 12 values per channel of the tiny
  last stage amplifies them: E[x²] − E[x]² cancels);
- each gradient leaf within 1e-4 of max(1, max|g|) and the new BatchNorm
  statistics within 1e-5: the backward adds its own sums to the forward's;
- 1e-6 for Adam's params after three steps: the same float32 update.

Dropout and DropPath draw other bits than JAX's, so they are tested by
distribution.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rtvc_tpu import config as jconfig
from rtvc_tpu import distill as jdistill
from rtvc_tpu import train as jtrain
from rtvc_tpu.models import tinyvit as jtinyvit
from rtvc_tpu_torch import config as pconfig
from rtvc_tpu_torch import distill, train
from rtvc_tpu_torch.models.convert import student_state_dict_from_jax
from rtvc_tpu_torch.models.layers import DropPath
from rtvc_tpu_torch.models.student import StudentCandidateV1
from rtvc_tpu_torch.models.tinyvit import TinyViT
from rtvc_tpu_torch.ops import dropout as pdropout

from test_convert_fullsize import make_git_sd
from test_models import TINY_ENC
from test_torch_models import randomize
from test_torch_teacher import teacher_pair
from test_train import ENC, GIT64, synth_batch, tiny_pair

LOSS_TOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def config_from(overrides, base=None) -> pconfig.Config:
    """The port's Config with a nested dict of field overrides, as
    ``rtvc_tpu.config.from_dict`` builds JAX's."""
    def merge(dc, over):
        return dataclasses.replace(dc, **{
            k: merge(getattr(dc, k), v) if isinstance(v, dict) else v
            for k, v in over.items()})
    return merge(base or pconfig.Config(), overrides)


def _rel_close(got, want, tol, what=""):
    got, want = float(got), float(want)
    assert abs(got - want) <= tol * max(1.0, abs(want)), (what, got, want)


def _scaled_close(got, want, tol, what=""):
    """max |got - want| <= tol · max(1, max |want|)."""
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), (what, err)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _loss_inputs():
    rng = np.random.default_rng(0)
    b, t, v = 3, 6, 50
    s_logits = rng.normal(size=(b, t, v)).astype(np.float32) * 3
    t_logits = rng.normal(size=(b, t, v)).astype(np.float32) * 3
    targets = rng.integers(1, v, size=(b, t)).astype(np.int32)
    targets[0, 4:] = 0
    valid = rng.random((b, t)) > 0.3
    means = [rng.normal(size=(b * 2, 8)).astype(np.float32) for _ in range(4)]
    taps = [rng.normal(size=(b, 2, 8)).astype(np.float32) for _ in range(4)]
    vis_s, vis_t = (rng.normal(size=(b, 10, 8)).astype(np.float32)
                    for _ in range(2))
    hid_s = [rng.normal(size=(b, t, 8)).astype(np.float32) for _ in range(2)]
    hid_t = [rng.normal(size=(b, 10 + t, 8)).astype(np.float32)
             for _ in range(3)]
    return dict(s=s_logits, t=t_logits, y=targets, valid=valid, means=means,
                taps=taps, vis_s=vis_s, vis_t=vis_t, hid_s=hid_s, hid_t=hid_t)


LOSSES = {
    "kl": lambda m, d: m.kl_divergence_loss(d["s"], d["t"], 2.0),
    "masked_kl": lambda m, d: m.masked_kl_divergence_loss(
        d["s"], d["t"], d["valid"], 2.0),
    "ce": lambda m, d: m.cross_entropy_loss(d["s"], d["y"]),
    "fmap": lambda m, d: m.fmap_distillation_loss(d["means"], d["taps"]),
    "final_enc": lambda m, d: m.final_encoding_loss(d["vis_s"], d["vis_t"]),
    "ce_teacher": lambda m, d: m.teacher_token_ce_loss(d["s"], d["y"]),
    "decoder": lambda m, d: m.decoder_distillation_loss(d["hid_s"],
                                                        d["hid_t"], 10),
}


def _tree(d, convert):
    return {k: [convert(x) for x in v] if isinstance(v, list) else convert(v)
            for k, v in d.items()}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_losses_match_jax(name):
    d = _loss_inputs()
    want = LOSSES[name](jdistill, _tree(d, jnp.asarray))
    got = LOSSES[name](distill, _tree(d, _t))
    assert got.dtype == torch.float32 and got.dim() == 0
    _rel_close(got, want, LOSS_TOL, name)


def test_distillation_losses_total_matches_jax():
    d = _loss_inputs()
    w = dict(kl=1.0, ce=0.5, fmap=2.0, final_enc=0.25, ce_teacher=0.1,
             decoder=3.0, temperature=1.5)

    def run(mod, conv):
        return mod.distillation_losses(
            student_logits=conv(d["s"]), teacher_logits=conv(d["t"]),
            targets=conv(d["y"]), weights=mod.LossWeights(**w),
            student_proj_means=[conv(x) for x in d["means"]],
            teacher_cls_taps=[conv(x) for x in d["taps"]],
            student_visual=conv(d["vis_s"]), teacher_visual=conv(d["vis_t"]),
            teacher_tokens=conv(d["y"]),
            student_hidden_proj=[conv(x) for x in d["hid_s"]],
            teacher_hidden=[conv(x) for x in d["hid_t"]],
            teacher_prefix_len=10)

    want, got = run(jdistill, jnp.asarray), run(distill, _t)
    assert set(got) == set(want)
    for k in want:
        _rel_close(got[k], want[k], LOSS_TOL, k)


RAISING = [
    dict(weights=dict(), drop="teacher_logits"),
    dict(weights=dict(fmap=1.0), drop="teacher_cls_taps"),
    dict(weights=dict(final_enc=1.0), drop="student_visual"),
    dict(weights=dict(ce_teacher=1.0), drop="teacher_tokens"),
    dict(weights=dict(decoder=1.0), drop="teacher_hidden"),
    dict(weights=dict(kd_source="beam_consensus"), drop="teacher_kd_logits"),
    dict(weights=dict(kd_source="nonsense"), drop=None),
]


@pytest.mark.parametrize("case", RAISING,
                         ids=[c["drop"] or "bad_kd_source" for c in RAISING])
def test_distillation_losses_raise_where_jax_raises(case):
    d = _loss_inputs()

    def kwargs(conv):
        kw = dict(student_logits=conv(d["s"]), teacher_logits=conv(d["t"]),
                  targets=conv(d["y"]),
                  student_proj_means=[conv(x) for x in d["means"]],
                  teacher_cls_taps=[conv(x) for x in d["taps"]],
                  student_visual=conv(d["vis_s"]),
                  teacher_visual=conv(d["vis_t"]),
                  teacher_tokens=conv(d["y"]),
                  student_hidden_proj=[conv(x) for x in d["hid_s"]],
                  teacher_hidden=[conv(x) for x in d["hid_t"]],
                  teacher_kd_logits=conv(d["t"]),
                  teacher_kd_valid=conv(d["valid"]))
        if case["drop"]:
            kw[case["drop"]] = None
        return kw

    for mod, conv in ((jdistill, jnp.asarray), (distill, _t)):
        with pytest.raises(ValueError):
            mod.distillation_losses(weights=mod.LossWeights(**case["weights"]),
                                    **kwargs(conv))


# ---------------------------------------------------------------------------
# train-mode TinyViT: flax BatchNorm
# ---------------------------------------------------------------------------

def _port_enc_config(cfg) -> pconfig.TinyViTConfig:
    return pconfig.TinyViTConfig(
        embed_dims=cfg.embed_dims, depths=cfg.depths,
        num_heads=cfg.num_heads, window_sizes=cfg.window_sizes,
        drop_path_rate=cfg.drop_path_rate,
        gelu_approximate=cfg.gelu_approximate)


def test_tinyvit_train_mode_matches_jax():
    """Stage maps and the updated ``batch_stats`` of a train-mode forward
    against ``apply(..., train=True, mutable=["batch_stats"])``. The
    running variance takes flax's biased batch variance: with
    ``nn.BatchNorm2d``'s unbiased one it would be off by ~1% here."""
    model = jtinyvit.TinyViT(TINY_ENC)
    x = np.random.default_rng(21).normal(size=(3, 64, 64, 3)).astype(
        np.float32)
    variables = randomize(jax.jit(model.init)(jax.random.PRNGKey(0),
                                              jnp.asarray(x)), seed=22)
    with jax.default_matmul_precision("highest"):
        want, mutated = jax.jit(lambda v, x: model.apply(
            v, x, True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
    port = TinyViT(_port_enc_config(TINY_ENC), input_size=64)
    sd = {k[len("image_encoder.model."):]: v
          for k, v in student_state_dict_from_jax(
              {"image_encoder": variables["params"]},
              {"image_encoder": variables["batch_stats"]}).items()}
    port.load_state_dict(sd, strict=False)
    got = port.train()(_t(x))
    for s, (g, w) in enumerate(zip(got, want)):
        _scaled_close(g.detach().numpy(), w, 1e-5, f"stage {s}")
    new = {k[len("image_encoder.model."):]: v
           for k, v in student_state_dict_from_jax(
               {}, {"image_encoder": mutated["batch_stats"]}).items()}
    state = port.state_dict()
    assert len(new) == 2 * sum(k.endswith("running_mean") for k in state)
    for k, v in new.items():
        _scaled_close(state[k].numpy(), v.numpy(), 1e-5, k)


def test_batch_norm_statistics_stay_float32():
    port = TinyViT(_port_enc_config(TINY_ENC), input_size=64)
    port.to(torch.bfloat16)
    bn = port.patch_embed.conv1.bn
    assert bn.weight.dtype == torch.bfloat16
    assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32
    port.train()(torch.randn(2, 64, 64, 3))
    assert bn.running_var.dtype == torch.float32
    assert bool((bn.running_var != 1.0).any())


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _port_student(variables) -> StudentCandidateV1:
    model = StudentCandidateV1(
        d_model=32, n_head=4, d_ffn=64, dropout=0.0, num_decoder_layers=2,
        vocab_size=173, max_pos_len=64, encoder_config=_port_enc_config(ENC),
        input_size=64, num_frames=2, teacher_visual_dim=32,
        teacher_num_tokens=2 * 17, teacher_hidden=16)
    sd = student_state_dict_from_jax(variables["params"],
                                     variables["batch_stats"])
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert unexpected == []
    assert all(k.endswith("num_batches_tracked") for k in missing), missing
    return model


@pytest.fixture(scope="module")
def step_pair():
    """The JAX tiny pair of tests/test_train.py with dropout 0 and
    DropPath 0, its variables perturbed from a seed, and the port's pair
    on the same weights."""
    jstudent, _ = tiny_pair()
    jstudent = jstudent.clone(dropout=0.0)
    batch = synth_batch()
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=1e-3)
    state = jtrain.create_train_state(jstudent, jax.random.PRNGKey(0),
                                      batch, tx)
    variables = randomize({"params": state.params,
                           "batch_stats": state.batch_stats}, seed=23)
    jteacher, tvars, pteacher = teacher_pair(GIT64,
                                             make_git_sd(GIT64, random=True))
    return dict(jstudent=jstudent, jteacher=jteacher, tvars=tvars,
                pteacher=pteacher, variables=variables, batch=batch, tx=tx)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_matches_jax(step_pair, grad_accum):
    """One step of the port's ``make_train_step`` against JAX's on the same
    weights and batch: the losses, every gradient leaf (read back from
    Adam's first moment, which is 0.1·g after one step from zero) and the
    new ``batch_stats``."""
    p = step_pair
    variables = p["variables"]
    jstate = jtrain.TrainState(
        params=jax.tree.map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=p["tx"].init(jax.tree.map(jnp.asarray,
                                            variables["params"])),
        step=jnp.zeros((), jnp.int32))
    with jax.default_matmul_precision("highest"):
        jstep = jtrain.make_train_step(p["jstudent"], p["jteacher"], p["tx"],
                                       donate=False, grad_accum=grad_accum)
        new_jstate, jmetrics = jstep(jstate, p["tvars"], p["batch"],
                                     jax.random.PRNGKey(3))

    student = _port_student(variables)
    optimizer = train.Adam(learning_rate=1e-3)
    state = train.create_train_state(student, optimizer, torch.float32)
    step = train.make_train_step(student, p["pteacher"], optimizer,
                                 grad_accum=grad_accum)
    batch = {k: _t(v) for k, v in p["batch"].items()}
    metrics = step(state, batch, torch.Generator().manual_seed(0))
    assert state.step == 1
    for k in ("kl", "ce", "total"):
        _rel_close(metrics[k], jmetrics[k], 1e-5, k)
    _rel_close(metrics["grad_norm"], jmetrics["grad_norm"], 1e-5,
               "grad_norm")

    jmu = new_jstate.opt_state.inner_state[0].mu
    want = student_state_dict_from_jax(jmu, new_jstate.batch_stats)
    names = [n for n, _ in student.named_parameters()]
    assert len(names) == len(state.opt_state.mu)
    for name, mu in zip(names, state.opt_state.mu):
        g, w = mu / 0.1, want[name].numpy() / 0.1
        tol = 1e-4 * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy(), w, atol=tol, rtol=0,
                                   err_msg=name)
    buffers = dict(student.named_buffers())
    n_stats = 0
    for name, value in want.items():
        if name.endswith(("running_mean", "running_var")):
            n_stats += 1
            _scaled_close(buffers[name].numpy(), value.numpy(), 1e-5, name)
    assert n_stats == sum(n.endswith("running_mean") for n in buffers) * 2


def test_train_step_learns_with_dropout(step_pair):
    """Four steps at the student's configured dropout (0.3 in the decoder,
    DropPath 0.2 over the encoder) on one batch: finite metrics, a nonzero
    gradient norm, and a lower loss at the end."""
    p = step_pair
    student = _port_student(p["variables"])
    for layer in student.decoder["layers"]:
        layer.dropout = 0.3
    for mod in student.modules():
        if isinstance(mod, DropPath):
            mod.rate = 0.2
    optimizer = train.Adam(learning_rate=1e-3)
    state = train.create_train_state(student, optimizer, torch.float32)
    step = train.make_train_step(student, p["pteacher"], optimizer)
    batch = {k: _t(v) for k, v in p["batch"].items()}
    gen = torch.Generator().manual_seed(1)
    totals = []
    for _ in range(4):
        m = step(state, batch, gen)
        assert all(bool(torch.isfinite(v)) for v in m.values())
        assert float(m["grad_norm"]) > 0
        totals.append(float(m["total"]))
    assert totals[-1] < totals[0]
    for p_model, master in zip(student.parameters(), state.params):
        assert master.dtype == torch.float32
        assert torch.equal(p_model, master)


def test_make_train_step_refuses_what_is_not_ported(step_pair, tmp_path):
    """The beam-KD losses and replayed teacher outputs are ported
    (tests/test_torch_train_loop.py holds them against JAX): the step
    builds for each. A mesh of several devices in one process is not a
    parallel run (the port runs one process per rank,
    tests/test_torch_parallel.py): ``train()`` refuses it."""
    p = step_pair
    student = _port_student(p["variables"])
    opt = train.Adam()
    for kw in (dict(weights=distill.LossWeights(ce_teacher=1.0)),
               dict(weights=distill.LossWeights(kd_source="beam_consensus")),
               dict(external_teacher_logits=True)):
        assert callable(train.make_train_step(student, p["pteacher"], opt,
                                              **kw))
    config = config_from({"logger": {"save_dir": str(tmp_path)},
                          "compute_dtype": "float32"})
    from rtvc_tpu_torch.parallel import make_mesh
    with pytest.raises(ValueError, match="one process per rank"):
        train.train(config, [], [], [], None, student=student,
                    teacher=p["pteacher"],
                    mesh=make_mesh((2, 1), devices=["cpu"] * 2),
                    device="cpu")


def test_create_train_state_keeps_float32_masters():
    student = StudentCandidateV1(
        d_model=32, n_head=4, d_ffn=64, num_decoder_layers=1, vocab_size=50,
        max_pos_len=16, encoder_config=_port_enc_config(TINY_ENC),
        input_size=64, num_frames=2, teacher_visual_dim=32,
        teacher_num_tokens=10, teacher_hidden=16)
    before = [p.detach().clone() for p in student.parameters()]
    state = train.create_train_state(student, train.Adam(), torch.bfloat16)
    assert state.model is student and state.step == 0
    for p, master, b in zip(student.parameters(), state.params, before):
        assert p.dtype == torch.bfloat16 and master.dtype == torch.float32
        assert torch.equal(master, b)
    for name, buf in student.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            assert buf.dtype == torch.float32, name


# ---------------------------------------------------------------------------
# Adam, the learning rate and the plateau scheduler
# ---------------------------------------------------------------------------

def test_adam_matches_optax():
    """Three steps of the same gradients, the learning rate changed by
    ``set_learning_rate`` after the first, on both sides."""
    rng = np.random.default_rng(24)
    shapes = [(5, 3), (7,), (2, 2, 2)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(size=s) * 10 ** rng.uniform(-3, 1)).astype(
        np.float32) for s in shapes] for _ in range(3)]
    lrs = [1e-3, 5e-4, 5e-4]
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=lrs[0])
    jparams = [jnp.asarray(a) for a in params]
    jstate = tx.init(jparams)
    opt = train.Adam(learning_rate=lrs[0])
    pparams = [_t(a) for a in params]
    pstate = opt.init(pparams)
    for lr, g in zip(lrs, grads):
        jstate = jtrain.set_learning_rate(jstate, lr)
        assert train.set_learning_rate(pstate, lr) is pstate
        upd, jstate = tx.update([jnp.asarray(a) for a in g], jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        opt.update([_t(a) for a in g], pstate, pparams)
    assert pstate.count == 3
    for got, want in zip(pparams, jparams):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=0)


def test_plateau_scheduler_matches_jax():
    monitored = [5.0, 4.0, 4.5, 4.2, 4.1, 4.3, 4.4, 4.0, 3.9, 4.0, 4.0,
                 4.0, 4.0, 4.0, 4.0, 4.0, 4.0, 4.0, 4.0]
    ours = train.PlateauScheduler(lr=1e-4)
    theirs = jtrain.PlateauScheduler(lr=1e-4)
    got = [ours.update(m) for m in monitored]
    assert got == [theirs.update(m) for m in monitored]
    assert got[-1] < 1e-4


# ---------------------------------------------------------------------------
# dropout and DropPath, by distribution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_dropout_keeps_its_share_and_scales(rate):
    x = torch.ones(1000, 1000)
    out = pdropout.dropout(x, rate, torch.Generator().manual_seed(2))
    kept = out != 0
    assert abs(float(kept.float().mean()) - (1 - rate)) < 0.01
    np.testing.assert_allclose(out[kept].numpy(), 1 / (1 - rate), rtol=1e-6)
    again = pdropout.dropout(x, rate, torch.Generator().manual_seed(2))
    assert torch.equal(out, again)
    other = pdropout.dropout(x, rate, torch.Generator().manual_seed(3))
    assert not torch.equal(out, other)


def test_drop_path_drops_whole_samples():
    x = torch.ones(100_000, 3, 2)
    module = DropPath(0.2).train()
    out = module(x, torch.Generator().manual_seed(4))
    per_sample = out.reshape(len(x), -1)
    kept = per_sample[:, 0] != 0
    assert torch.equal(per_sample != 0, kept[:, None].expand_as(per_sample))
    assert abs(float(kept.float().mean()) - 0.8) < 0.01
    np.testing.assert_allclose(per_sample[kept].numpy(), 1 / 0.8, rtol=1e-6)
    assert torch.equal(out, module(x, torch.Generator().manual_seed(4)))
    assert torch.equal(module.eval()(x), x)


def test_dropout_needs_a_cpu_generator():
    with pytest.raises(ValueError, match="generator"):
        pdropout.dropout(torch.ones(3), 0.5, None)
    assert torch.equal(pdropout.dropout(torch.ones(3), 0.0, None),
                       torch.ones(3))
    seed = pdropout.draw_seed(torch.Generator().manual_seed(5))
    assert isinstance(seed, int) and 0 <= seed < 2 ** 31 - 1


def test_train_config_equals_jax():
    jcfg = jconfig.Config()
    ours = dataclasses.asdict(pconfig.TrainConfig())
    theirs = dataclasses.asdict(jcfg.train)
    trainer = ours.pop("trainer")
    assert trainer == {k: theirs["trainer"][k] for k in trainer}
    assert set(trainer) == {"max_epochs", "precision",
                            "enable_checkpointing"}
    assert ours == {k: theirs[k] for k in ours}
    assert set(theirs) - set(ours) - {"trainer"} == {
        "student_model_def", "teacher_model_def"}
    assert pconfig.CallbackConfig().save_top_k == jcfg.callback.save_top_k
    assert dataclasses.asdict(pconfig.WandbConfig()) == dataclasses.asdict(
        jcfg.wandb)
    assert pconfig.Config().remat_encoder == jcfg.tpu.remat_encoder
    assert pconfig.Config().train == pconfig.TrainConfig()
    assert pconfig.Config().compute_dtype == jcfg.tpu.compute_dtype
    for name in ("mesh_shape", "mesh_axes", "multihost"):
        assert getattr(pconfig.Config(), name) == getattr(jcfg.tpu, name)
