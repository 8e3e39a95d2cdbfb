"""The port's parallel layer (``rtvc_tpu_torch.parallel``) against JAX's
``rtvc_tpu.parallel`` and against itself on one rank.

Multi-rank cases start their ranks as ``python -m
rtvc_tpu_torch.parallel.dryrun`` processes (``dryrun.spawn``): gloo over
the loopback (``GLOO_SOCKET_IFNAME=lo``), a ``file://`` rendezvous under
``tmp_path``, one torch thread a rank, each rank waited for with its own
timeout. Limits:

- the port's 2-rank ``train()`` against JAX's ``train(mesh=make_mesh((2,
  1)))`` on the same weights and batches (dropout 0, JAX under "highest"
  matmul precision): each epoch's loss at rtol 2e-4, as
  tests/test_multihost.py holds JAX's two processes to one; the BatchNorm
  statistics, which JAX's sharded step takes over the global batch,
  within 1e-4 of max(1, max|x|) after two steps (the float32 sums run in
  other orders, and the second step starts from weights that Adam moved
  by ±lr on the sign of rounding noise where a gradient is zero in exact
  arithmetic);
- the port's dp = 2 (and tp = 2) against its own single rank on the
  same global batches, dropout and DropPath on, dp's second step from the
  one rank's state after its first (``chip_smoke.compare_runs``
  at ``chip_smoke.PAR_LIMITS``, the limits phase 10 holds the card to):
  each step's kl, ce and total within 1e-5 relative, its gradient norm
  within 1e-4 relative and each step's gradient leaves within 1e-4 of
  max(its max, 1e-4 × the largest): under dp the BatchNorm takes flax's
  E[x²] - E[x]² variance from the summed moments where one rank's
  ``F.batch_norm`` centres first, and the cancellation moves the
  encoder's gradients by ~1e-5 of their scale (measured up to 1.5e-5 on
  the gradient norm at the second step, with grad_accum 2); the
  BatchNorm statistics within 1e-5 of max(1, max|x|); the final master
  weights, as tests/test_torch_train_loop.py holds them, within 1e-4 of
  max(1, max|w|) less the elements whose gradients differ in sign between
  the runs at some step (at most 1% of the elements, each within Adam's
  reach, 2 · steps · lr, of the other run); all less
  ``chip_smoke.rounding_noise``'s elements, whose gradient is zero in
  exact arithmetic and which Adam moves on the sign of rounding noise
  (and the running means those feed).

The device choice of ``initialize_distributed`` (each rank's card and
the group's backend, from what the ranks report at the rendezvous) is
held on faked machines: two ranks sharing a card take gloo, ranks that
each own a card take nccl, on one host or several.
"""

import collections
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rtvc_tpu import train as jtrain
from rtvc_tpu.config import from_dict as jax_from_dict
from rtvc_tpu.models.convert import (git_teacher_params_from_torch,
                                     student_params_from_torch)
from rtvc_tpu.parallel import mesh as jmesh
from rtvc_tpu.parallel import multihost as jmultihost
from rtvc_tpu.tokenization import BertWordPieceTokenizer as JaxTokenizer
import chip_smoke
from rtvc_tpu_torch import parallel
from rtvc_tpu_torch.parallel import dryrun, multihost
from rtvc_tpu_torch.parallel.mesh import Mesh, make_mesh, param_shardings
from rtvc_tpu_torch.parallel.multihost import (host_batch_slice,
                                               initialize_distributed,
                                               shard_host_local_batch)
from rtvc_tpu_torch.models.convert import student_state_dict_from_jax

from test_torch_train import (_port_enc_config, _port_student,
                              _scaled_close)
from test_torch_train_loop import pair  # noqa: F401  (a fixture)
from test_train import ENC, synth_batch

TIMEOUT = 240.0
LR = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# the pure parts
# ---------------------------------------------------------------------------

def test_exports_are_jax_s_nine():
    from rtvc_tpu import parallel as jparallel
    assert parallel.__all__ == jparallel.__all__
    assert len(parallel.__all__) == 9
    assert all(callable(getattr(parallel, n)) for n in parallel.__all__)


@pytest.mark.parametrize("shape", [(-1, 1), (2, -1), (-1, 3), (2, 4),
                                   (1, 1), (-1, 2)])
def test_make_mesh_shape_resolution_matches_jax(shape):
    want = jmesh.make_mesh(shape).shape
    got = make_mesh(shape, devices=["cpu"] * len(jax.devices()))
    assert dict(got.shape) == dict(want)
    assert got.size == int(np.prod(list(want.values())))
    assert not got.distributed and got.index("dp") == 0


@pytest.mark.parametrize("args", [(32, 0, 4), (32, 3, 4), (8, 1, 2),
                                  (6, 2, 3), (1, 0, 1)])
def test_host_batch_slice_copy_equals_jax(args):
    assert host_batch_slice(*args) == jmultihost.host_batch_slice(*args)


def test_host_batch_slice_indivisible_raises_as_jax():
    with pytest.raises(ValueError, match="not divisible"):
        jmultihost.host_batch_slice(30, 0, 4)
    with pytest.raises(ValueError, match="not divisible"):
        host_batch_slice(30, 0, 4)


def test_initialize_distributed_without_env_stays_single(monkeypatch):
    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
                "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_distributed() is False
    assert jmultihost.initialize_distributed() is False
    with pytest.raises(ValueError, match="together"):
        initialize_distributed("127.0.0.1:1234")


@pytest.mark.parametrize("machines,cards,backend", [
    # two ranks on one host with one card (chip_smoke's phase 10)
    ([("h", 1)] * 2, [0, 0], "gloo"),
    # four ranks on one host of four cards
    ([("h", 4)] * 4, [0, 1, 2, 3], "nccl"),
    # sixteen ranks on two hosts of eight cards
    ([("a", 8)] * 8 + [("b", 8)] * 8, list(range(8)) * 2, "nccl"),
    # the same, each process seeing only its own card
    ([(f"{h}|{i}", 1) for h in "ab" for i in range(8)], [0] * 16, "nccl"),
    # three ranks on two cards: the third shares card 0
    ([("h", 2)] * 3, [0, 1, 0], "gloo"),
    # no card
    ([("h", 0)] * 2, [None, None], "gloo"),
])
def test_placement_cards_and_backend(machines, cards, backend):
    for r in range(len(machines)):
        assert multihost.placement(machines, r) == (cards[r], backend)


@pytest.mark.parametrize("n_cards,devices,backend", [
    (1, ["cuda:0", "cuda:0"], "gloo"),
    (2, ["cuda:0", "cuda:1"], "nccl"),
])
def test_initialize_distributed_picks_card_and_backend(
        n_cards, devices, backend, tmp_path, monkeypatch):
    """Two ranks started with JAX's variables on a faked host of
    ``n_cards`` cards meet at the store, report their machines and take
    the card and backend ``placement`` gives (the process group's own
    start is recorded, not made)."""
    import threading

    import torch.distributed as dist

    monkeypatch.setenv("COORDINATOR_ADDRESS", f"file://{tmp_path}/store")
    monkeypatch.setenv("NUM_PROCESSES", "2")
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setattr(multihost, "_DEVICE", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n_cards)
    cards, groups, errors = {}, {}, []
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: cards.__setitem__(
        threading.current_thread().name, str(d)))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: groups.__setitem__(
                            kw["rank"], (backend, kw.get("device_id"))))
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)

    def rank(r):
        try:
            assert multihost.initialize_distributed(process_id=r) is True
        except Exception as e:  # noqa: BLE001  (raised below)
            errors.append(e)

    threads = [threading.Thread(target=rank, args=(r,), name=str(r))
               for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    assert [cards[str(r)] for r in range(2)] == devices
    assert [groups[r][0] for r in range(2)] == [backend] * 2
    assert [str(groups[r][1]) if groups[r][1] is not None else None
            for r in range(2)] == (devices if backend == "nccl"
                                   else [None, None])


def test_initialize_distributed_reads_torchrun_env(monkeypatch):
    """torchrun's variables: a one-rank group through the ``env://``
    rendezvous (a store on the loopback), on a faked host of one card."""
    import socket

    import torch.distributed as dist

    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
                "CUDA_VISIBLE_DEVICES"):
        monkeypatch.delenv(var, raising=False)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(port))
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setattr(multihost, "_DEVICE", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    seen = {}
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: seen.update(backend=backend,
                                                          **kw))
    monkeypatch.setattr(dist, "get_world_size", lambda: 1)
    assert multihost.initialize_distributed() is False
    assert (seen["backend"], seen["rank"], seen["world_size"]) == (
        "nccl", 0, 1)
    assert str(seen["device_id"]) == "cuda:0"
    assert str(multihost.rank_device()) == "cuda:0"


def test_shard_host_local_single_process_is_shard_batch():
    mesh = make_mesh((1, 1), devices=["cpu"])
    batch = {"frames": np.ones((8, 2, 8, 8, 3), np.float32),
             "caption": np.zeros((8, 5), np.int32)}
    placed = shard_host_local_batch(batch, mesh)
    assert placed["frames"].shape == (8, 2, 8, 8, 3)
    assert placed["caption"].dtype == torch.int32


def _fake_mesh(dp: int, tp: int, index: int = 0) -> Mesh:
    """A mesh as rank ``index`` along dp of a (dp, tp) process group sees
    it, without a group (for the parts that make no collective)."""
    return Mesh(collections.OrderedDict(dp=dp, tp=tp), torch.device("cpu"),
                {"dp": index, "tp": 0}, {"tp": object()} if tp > 1 else {},
                None, True)


def _tagged(model) -> dict:
    """The state dict (the reference's keys) of a copy of ``model`` whose
    every parameter is filled with its own index + 1."""
    model = copy.deepcopy(model)
    with torch.no_grad():
        for i, p in enumerate(model.parameters()):
            p.fill_(float(i + 1))
    return model.state_dict()


def _jax_names_by_port(tree, names) -> dict:
    """JAX leaf path → the port parameter names whose index fills it."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        ids = {int(v) for v in np.unique(np.asarray(leaf))}
        out[jax.tree_util.keystr(path)] = {names[i - 1] for i in ids
                                           if 0 < i <= len(names)}
    return out


@pytest.mark.parametrize("tp", [1, 2])
def test_param_shardings_match_jax_through_the_converters(pair, tp):
    """Every parameter of the tiny pair's student and teacher gets the
    spec JAX's ``param_shardings`` gives the leaf the converters map it
    to: a split vocab axis lands on dim 0 of torch's [V, d] (JAX's [d, V]
    kernel on its last axis), everything else replicated."""
    jm = jmesh.make_mesh((len(jax.devices()) // tp, tp))
    pm = _fake_mesh(len(jax.devices()) // tp, tp)
    student = _port_student(pair["variables"])
    teacher = pair["pteacher"]
    tc = teacher.config
    converters = (
        (student, lambda sd: student_params_from_torch(
            sd, encoder_depths=ENC.depths)[0]),
        (teacher, lambda sd: git_teacher_params_from_torch(
            sd, num_layers=tc.num_layers, clip_layers=tc.clip.layers,
            num_frames=tc.num_image_with_embedding)[0]))
    for model, convert in converters:
        names = [n for n, _ in model.named_parameters()]
        jtree = convert({k: v.numpy() for k, v in _tagged(model).items()})
        jspecs = jax.tree_util.tree_map(lambda s: s.spec,
                                        jmesh.param_shardings(jtree, jm))
        specs = param_shardings(model, pm)
        owners = _jax_names_by_port(jtree, names)
        flat = dict((jax.tree_util.keystr(p), s) for p, s in
                    jax.tree_util.tree_flatten_with_path(jspecs)[0])
        split = set()
        for path, spec in flat.items():
            assert owners[path], path  # every leaf from some parameter
            jsplit = tuple(spec) != ()
            for name in owners[path]:
                if jsplit:
                    split.add(name)
                    # a torch Linear weight is the transposed kernel
                    want = (tuple(reversed(tuple(spec)))
                            if path.endswith("['kernel']") else tuple(spec))
                    assert specs[name] == want, (name, path, spec)
                else:
                    assert specs[name] == (), (name, path)
        assert {n for n, s in specs.items() if s} == split
        if tp == 2:
            assert split  # the vocab layers of each model
        else:
            assert not split


def test_place_params_at_vocab_30522_tp4_raises_as_jax():
    """30522 rows do not split over tp = 4: JAX's ``place_params`` raises
    in ``device_put``, and so does the port's."""
    from rtvc_tpu_torch.models.student import StudentCandidateV1
    from rtvc_tpu_torch.config import TinyViTConfig

    jm = jmesh.make_mesh((2, 4))
    params = {"linear": {"kernel": np.zeros((8, 30522), np.float32),
                         "bias": np.zeros((30522,), np.float32)},
              "embed": {"embedding": np.zeros((30522, 8), np.float32)}}
    with pytest.raises(ValueError, match="30522"):
        jmesh.place_params(params, jm)
    student = StudentCandidateV1(
        d_model=8, n_head=2, d_ffn=16, num_decoder_layers=1,
        vocab_size=30522, max_pos_len=16, encoder_config=TinyViTConfig(
            embed_dims=(8, 8, 8, 8), depths=(1, 1, 1, 1),
            num_heads=(1, 1, 1, 1), window_sizes=(2, 2, 2, 2)),
        input_size=64, num_frames=2, teacher_visual_dim=8,
        teacher_num_tokens=4, teacher_hidden=8)
    with pytest.raises(ValueError, match="30522 rows .* divisible by tp=4"):
        parallel.place_params(student, _fake_mesh(2, 4))


def test_shard_batch_rows_and_data_parallel_shardings():
    batch = {"frames": torch.arange(8 * 3).reshape(8, 3),
             "vid-id": [f"v{i}" for i in range(8)]}
    parts = [parallel.shard_batch(batch, _fake_mesh(2, 1, i))
             for i in range(2)]
    assert torch.equal(torch.cat([p["frames"] for p in parts]),
                       batch["frames"])
    assert parts[1]["vid-id"] == batch["vid-id"][4:]
    with pytest.raises(ValueError, match="does not split"):
        parallel.shard_batch({"x": torch.zeros(5)}, _fake_mesh(2, 1))
    local = parallel.shard_batch(torch.arange(4),
                                 make_mesh((2, 1), devices=["cpu"] * 2))
    assert [p.tolist() for p in local] == [[0, 1], [2, 3]]
    ex = {"frames": np.zeros((8, 2, 3)), "caption": np.zeros((8, 5))}
    jspec = jmesh.data_parallel_shardings(jmesh.make_mesh((2, 4)), ex)
    assert parallel.data_parallel_shardings(_fake_mesh(2, 4), ex) == {
        k: tuple(v.spec) for k, v in jspec.items()}


# ---------------------------------------------------------------------------
# multi-rank: train() against JAX's, and the port against its one rank
# ---------------------------------------------------------------------------

def _save_models(pair, tmp) -> None:
    """The pair's port student and teacher as the worker loads them."""
    student = _port_student(pair["variables"])
    kwargs = dict(d_model=32, n_head=4, d_ffn=64, dropout=0.0,
                  num_decoder_layers=2, vocab_size=173, max_pos_len=64,
                  encoder_config=_port_enc_config(ENC), input_size=64,
                  num_frames=2, teacher_visual_dim=32,
                  teacher_num_tokens=2 * 17, teacher_hidden=16)
    torch.save((kwargs, student.state_dict()), tmp / "student.pt")
    teacher = pair["pteacher"]
    torch.save((teacher.config, teacher.state_dict()), tmp / "teacher.pt")


@pytest.fixture(scope="module")
def dp_train_runs(pair, tmp_path_factory):
    """Two global batches of 8, one epoch: JAX's ``train()`` on a dp = 2
    mesh of the virtual CPU devices, the port's on two gloo ranks, both
    from the same weights (JAX's init patched to them)."""
    tmp = tmp_path_factory.mktemp("dp_train")
    variables = pair["variables"]
    batches = [synth_batch(b=8, seed=s) for s in (0, 1)]

    def start_state(student, rng, example, tx):
        params = jax.tree.map(jnp.asarray, variables["params"])
        return jtrain.TrainState(
            params=params,
            batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
            opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))

    overrides = {"logger": {"save_dir": str(tmp / "jax")},
                 "wandb": {"mode": "disabled"},
                 "train": {"lr": LR, "batch_size": 8,
                           "trainer": {"max_epochs": 1,
                                       "enable_checkpointing": False}}}
    with jax.default_matmul_precision("highest"), \
            pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrain, "create_train_state", start_state)
        jstate, jhist = jtrain.train(
            jax_from_dict(overrides), batches, [], [], JaxTokenizer(),
            run_name="j", student=pair["jstudent"],
            teacher=pair["jteacher"], teacher_vars=pair["tvars"],
            mesh=jmesh.make_mesh((2, 1)), max_epochs=1, use_orbax=False)
    _save_models(pair, tmp)
    torch.save({"train": [{k: torch.from_numpy(np.asarray(v))
                           for k, v in b.items()} for b in batches],
                "val": [], "test": []}, tmp / "batches.pt")
    port_over = dict(overrides, logger={"save_dir": str(tmp / "port")},
                     tpu={"compute_dtype": "float32"})
    job = {"kind": "train", "mesh": (2, 1), "device": "cpu",
           "config": port_over,
           "models": {"student": str(tmp / "student.pt"),
                      "teacher": str(tmp / "teacher.pt")},
           "batches": str(tmp / "batches.pt"), "max_epochs": 1}
    ranks = dryrun.spawn(job, 2, str(tmp / "work"), TIMEOUT)
    local = dryrun.spawn(dict(job, host_slice=True), 2, str(tmp / "local"),
                         TIMEOUT)
    return dict(jstate=jstate, jhist=jhist, ranks=ranks, local=local)


def test_dp2_train_matches_jax_dp2_train(dp_train_runs):
    jhist = dp_train_runs["jhist"]
    for rank in dp_train_runs["ranks"]:
        np.testing.assert_allclose(rank["history"]["train_loss"],
                                   jhist["train_loss"], rtol=2e-4)
        assert rank["history"]["epoch_n_steps"] == [2]
        assert rank["step"] == 2


def test_dp2_train_on_host_local_rows_equals_global_batches(dp_train_runs):
    """A loader that yields each rank's rows (``main --multihost``'s
    host-sliced ``DeviceLoader``) trains as the global batches do."""
    for rank, local in zip(dp_train_runs["ranks"], dp_train_runs["local"]):
        assert local["history"] == rank["history"]
        for name, w in rank["params"].items():
            assert torch.equal(local["params"][name], w), name


def test_dp2_batchnorm_statistics_match_jax_sharded_step(dp_train_runs):
    """JAX's BatchNorm under its dp-sharded jit normalises over the global
    batch; so does the port's on its two ranks (each holds its half)."""
    want = student_state_dict_from_jax(
        {}, jax.tree.map(np.asarray, dp_train_runs["jstate"].batch_stats))
    ranks = dp_train_runs["ranks"]
    assert ranks[0]["bn"]
    for name, got in ranks[0]["bn"].items():
        _scaled_close(got.numpy(), want[name].numpy(), 1e-4, name)
        assert torch.equal(got, ranks[1]["bn"][name])  # every rank alike


def _step_job(**kw):
    job = {"kind": "step", "models": "dryrun", "seed": 3, "lr": LR,
           "steps": 2, "device": "cpu", "batches": dict(seed=5, n=2, batch=8, frames=2,
                                       size=64, caption_len=8,
                                       vocab=dryrun.VOCAB)}
    job.update(kw)
    return job


def _assert_runs_equal(got, want, what):
    limits = chip_smoke.PAR_LIMITS
    errs = chip_smoke.compare_runs(got, want, dryrun.dryrun_models()[0], LR)
    bad = {k: v for k, v in errs.items()
           if k in limits and not v <= limits[k]}
    assert not bad, (what, bad, errs)


@pytest.mark.parametrize("case", ["dropout", "grad_accum", "beam_replay"])
def test_dp2_equals_dp1(case, tmp_path):
    """dp = 2 on two ranks against one rank on the whole batches, with
    dropout 0.1 and DropPath 0.1 drawn at the global batch's shape; with
    ``grad_accum`` 2 (the global batch ordered so that each rank's i-th
    microbatch is its share of the global i-th); and on replayed beam-KD
    targets cut with the batch. The ranks take step 2 from the one rank's
    state after step 1, as phase 10 (b) of chip_smoke does: run free,
    Adam's ±lr first steps on the elements whose gradient sign is the
    noise's move the later gradients apart (4.7e-4 of their scale at step
    2 with grad_accum 2)."""
    kw = dict(dropout=0.1, drop_path=0.1)
    if case == "grad_accum":
        kw["grad_accum"] = 2
    if case == "beam_replay":
        rng = np.random.default_rng(3)
        batches = dryrun.synth_batches(5, 2, 8, 2, 64, 8, dryrun.VOCAB)
        for b in batches:
            preds = rng.integers(3, dryrun.VOCAB, size=(8, 8)).astype(
                np.int32)
            preds[:, 6:] = 102
            b["teacher_beam_predictions"] = torch.from_numpy(preds)
            b["teacher_kd_logits"] = torch.from_numpy(rng.normal(
                size=(8, 8, dryrun.VOCAB)).astype(np.float32))
        torch.save(batches, tmp_path / "batches.pt")
        kw.update(batches=str(tmp_path / "batches.pt"),
                  external_teacher_beam=True,
                  weights=dict(ce_teacher=0.5, kd_source="beam_consensus"))
    job = _step_job(**kw)
    states = str(tmp_path / "one_rank_state")
    one = dryrun.run_job(dict(job, save_states=states))
    ranks = dryrun.spawn(dict(job, mesh=(2, 1), load_states=states), 2,
                         str(tmp_path), TIMEOUT)
    for rank in ranks:
        _assert_runs_equal(rank, one, case)
    for name, w in ranks[0]["params"].items():
        assert torch.equal(w, ranks[1]["params"][name])  # replicas alike


def test_tp2_equals_tp1(tmp_path):
    """tp = 2: each rank holds its vocab half of the student's projection
    and embedding and of the teacher's output head and word embeddings;
    the losses, gradients and whole weights are those of one rank."""
    job = _step_job(dropout=0.1, drop_path=0.1)
    ranks = dryrun.spawn(dict(job, mesh=(1, 2)), 2, str(tmp_path), TIMEOUT)
    one = dryrun.run_job(job)
    half = dryrun.VOCAB // 2
    for rank in ranks:
        shapes = rank["local_shapes"]
        assert shapes["linear.weight"][0] == shapes["embed.weight"][0] \
            == shapes["linear.bias"][0] == half
        _assert_runs_equal(rank, one, "tp")
        assert rank["params"]["linear.weight"].shape[0] == dryrun.VOCAB


def test_ragged_batch_trim_and_split_error(pair, tmp_path):
    """A global batch of 5 on dp = 2 is trimmed to 4 (logged, as JAX
    logs it); a batch of 1 cannot be split over dp and raises."""
    _save_models(pair, tmp_path)

    def data(*sizes):
        path = tmp_path / f"data{sizes}.pt"
        torch.save({"train": [{k: torch.from_numpy(np.asarray(v))
                               for k, v in synth_batch(b=n, seed=n).items()}
                              for n in sizes], "val": [], "test": []}, path)
        return str(path)

    job = {"kind": "train", "mesh": (2, 1), "max_epochs": 1,
           "device": "cpu",
           "models": {"student": str(tmp_path / "student.pt"),
                      "teacher": str(tmp_path / "teacher.pt")},
           "config": {"logger": {"save_dir": str(tmp_path / "runs")},
                      "wandb": {"mode": "disabled"},
                      "tpu": {"compute_dtype": "float32"},
                      "train": {"lr": LR, "batch_size": 6,
                                "trainer": {"enable_checkpointing": False}}}}
    ranks = dryrun.spawn(dict(job, batches=data(6, 5), run_name="rag"), 2,
                         str(tmp_path / "a"), TIMEOUT)
    assert ranks[0]["history"]["epoch_n_steps"] == [2]
    text = (tmp_path / "runs" / "run" / "rag"
            / "_results_and_metrics.txt").read_text()
    assert "trimming ragged batch 5 -> 4 for dp=2/grad_accum=1" in text
    with pytest.raises(RuntimeError, match="cannot be split over dp=2"):
        dryrun.spawn(dict(job, batches=data(1), run_name="rag2"), 2,
                     str(tmp_path / "b"), TIMEOUT)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip(n, tmp_path):
    out = dryrun.dryrun_multichip(n, workdir=str(tmp_path), device="cpu",
                                  timeout=TIMEOUT)
    assert np.isfinite(out["loss"])
    assert (out["dp"], out["tp"]) == ((2, 1) if n == 2 else (2, 2))
    assert out["rows"].shape == (4, 7)
    vocab = out["local_shapes"]["linear.weight"][0]
    assert vocab == dryrun.VOCAB // out["tp"]
