"""The multi-rank dry run and the worker that runs one rank of a job.

Counterpart of ``__graft_entry__.dryrun_multichip``:
:func:`dryrun_multichip` starts ``n`` ranks of

    python -m rtvc_tpu_torch.parallel.dryrun --job JOB --rank R --world N \\
        --init file:///path/store

lays them out as a ``(dp, tp)`` mesh (tp = 2 where n >= 4 and even),
places the dry run's tiny student and teacher (vocab 256) with the tp
rules, runs one full distillation step on the mesh, and runs
``serving.make_caption_step`` on each dp rank's rows, whose rows gathered
over dp must equal the whole, unsharded student's on the whole batch.

The same worker runs the other jobs the tests and ``chip_smoke.py`` start
(``JOB`` is a ``torch.save``'d dict, its ``"kind"`` one of):

- ``"dryrun"``: the above;
- ``"step"``: ``make_train_step`` on the mesh for ``steps`` steps over
  global batches (given, or made from a seed), the models the dry run's,
  built full-width from a seed, or given as saved ``(StudentCandidateV1
  keyword arguments, state dict)`` and ``(GITConfig, state dict)``; with
  ``bn_sums`` on one rank of a group, its BatchNorms take the dp path's
  statistics over a group of itself; with ``save_states`` (a path
  prefix) it saves its train state before each step after the first, and
  with ``load_states`` it starts each such step from the state saved
  there (so a run and its reference take every step from one state);
  returns each step's losses and
  float32 gradient (read from Adam's first moment), the whole master
  weights, Adam moments and BatchNorm statistics at the end (tp shards
  gathered), the local shape of each parameter, the launch counts of the
  kernel wrappers ``kernels`` names, and timings, the dp collectives'
  among them;
- ``"train"``: ``train()`` on the mesh over given global batches (or,
  with ``host_slice``, each rank's rows of them, as a host-sliced loader
  yields them); returns the history and the whole final state;
- ``"nccl"``: the mesh's all-reduce, all-gather and broadcast on bf16 and
  float32 tensors of a group, each checked exactly.

Each rank writes its result to ``<job>.rank<R>.pt``; an error is raised
(the process exits non-zero). :func:`spawn` starts the ranks and waits for
each with a timeout; :func:`run_job` runs a job in this process, where one
rank (no process group) is the single-process reference.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

VOCAB = 256  # divisible by tp for the tensor-parallel vocab head


# ---------------------------------------------------------------------------
# models and batches
# ---------------------------------------------------------------------------

def dryrun_models():
    """The dry run's tiny student and teacher: TinyViT dims 8/16/24/32 at
    64 px, a 2-layer d=32 decoder, CLIP 64 px / patch 16 / width 32, a
    2-layer hidden-16 joint decoder, vocab 256 (``__graft_entry__``'s
    shapes), random weights from fixed seeds, float32, on the CPU."""
    from ..config import CLIPViTConfig, GITConfig, TinyViTConfig
    from ..models import git_teacher
    from ..models.student import StudentCandidateV1, random_init_

    enc = TinyViTConfig(embed_dims=(8, 16, 24, 32), depths=(1, 1, 1, 1),
                        num_heads=(1, 2, 2, 2), window_sizes=(4, 4, 4, 4),
                        drop_path_rate=0.0)
    clip = CLIPViTConfig(image_size=64, patch_size=16, width=32, layers=2,
                         heads=2)
    git = GITConfig(vocab_size=VOCAB, hidden_size=16, num_layers=2,
                    attention_heads=2, feedforward_size=32,
                    visual_feature_size=32, max_caption_length=64,
                    num_image_with_embedding=2, clip=clip)
    student = random_init_(StudentCandidateV1(
        d_model=32, n_head=4, d_ffn=64, dropout=0.1, num_decoder_layers=2,
        vocab_size=VOCAB, max_pos_len=64, encoder_config=enc, input_size=64,
        num_frames=2, teacher_visual_dim=32, teacher_num_tokens=2 * 17,
        teacher_hidden=16), torch.Generator().manual_seed(0))
    teacher = git_teacher.random_init_(git_teacher.GITTeacher(git),
                                       torch.Generator().manual_seed(1))
    return student, teacher


def full_models(seed: int, depth_cut: bool = False):
    """The config's full-width student and teacher on the CPU, float32,
    random weights from ``seed`` (the teacher cut to 2 CLIP blocks and 2
    joint layers with ``depth_cut``)."""
    from ..config import GITConfig, cfg, clip_vit_l14_config
    from ..models import git_teacher, student as student_lib

    g = torch.Generator().manual_seed(seed)
    student = student_lib.random_init_(
        student_lib.student_from_config(cfg, device="cpu"), g)
    if depth_cut:
        tcfg = GITConfig(clip=clip_vit_l14_config(layers=2), num_layers=2)
        teacher = git_teacher.GITTeacher(tcfg)
    else:
        teacher = git_teacher.teacher_from_config(
            dataclasses.replace(cfg, quantize_teacher=False), device="cpu")
    return student, git_teacher.random_init_(teacher, g)


def synth_batches(seed: int, n: int, batch: int, frames: int, size: int,
                  caption_len: int, vocab: int) -> List[Dict[str, Any]]:
    """``n`` global batches of preprocessed-range frames ``[batch, frames,
    size, size, 3]`` and captions (CLS, a seeded valid length from 2 up,
    pad 0 after), from ``seed``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.normal(size=(batch, frames, size, size, 3)).astype(np.float32)
        caps = np.zeros((batch, caption_len), np.int32)
        caps[:, 0] = 101
        lens = rng.integers(2, caption_len + 1, size=batch)
        for i in range(batch):
            caps[i, 1:lens[i]] = rng.integers(3, vocab, size=lens[i] - 1)
        out.append({"frames": torch.from_numpy(x),
                    "caption": torch.from_numpy(caps)})
    return out


def set_dropout(student, rate: Optional[float], path_rate: Optional[float]):
    """Set the decoder's dropout and every DropPath's rate where given."""
    from ..models.layers import DropPath
    from ..models.student import TransformerDecoderLayer
    for mod in student.modules():
        if rate is not None and isinstance(mod, TransformerDecoderLayer):
            mod.dropout = float(rate)
        if path_rate is not None and isinstance(mod, DropPath):
            mod.rate = float(path_rate)


def _load_models(job: Dict[str, Any]):
    models = job.get("models", "dryrun")
    if models == "dryrun":
        return dryrun_models()
    if models in ("full", "full_cut"):
        return full_models(job.get("seed", 0), models == "full_cut")
    from ..models.git_teacher import GITTeacher
    from ..models.student import StudentCandidateV1
    kwargs, sd = torch.load(models["student"], weights_only=False)
    student = StudentCandidateV1(**kwargs)
    student.load_state_dict(sd)
    config, sd = torch.load(models["teacher"], weights_only=False)
    teacher = GITTeacher(config)
    teacher.load_state_dict(sd)
    return student, teacher.eval()


def _batches(job: Dict[str, Any]) -> List[Dict[str, Any]]:
    b = job["batches"]
    if isinstance(b, str):
        return torch.load(b, weights_only=False)
    return synth_batches(**b)


# ---------------------------------------------------------------------------
# the kernels' launch counts
# ---------------------------------------------------------------------------

def counted_wrappers(job: Dict[str, Any]) -> Dict[str, Any]:
    """The kernel wrappers whose launches a job counts: ``job["kernels"]``
    maps a name to ``"module:function"`` (none by default)."""
    import importlib
    out = {}
    for name, path in job.get("kernels", {}).items():
        module, attr = path.split(":")
        out[name] = getattr(importlib.import_module(module), attr)
    return out


# ---------------------------------------------------------------------------
# jobs
# ---------------------------------------------------------------------------

def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _whole_state(state, mesh) -> Dict[str, Any]:
    """The master weights, Adam moments (tp shards gathered) and BatchNorm
    statistics of a train state, on the CPU."""
    from ..train import _gathered_tree
    tree = _gathered_tree(state, mesh)
    names = [n for n, _ in state.model.named_parameters()]
    sd, opt = tree["state_dict"], tree["opt_state"]

    def copy(t):  # a snapshot: on the CPU .cpu() returns the live tensor
        return t.detach().to("cpu", copy=True)

    return {"params": {n: copy(sd[n]) for n in names},
            "mu": {n: copy(opt["mu"][n]) for n in names},
            "nu": {n: copy(opt["nu"][n]) for n in names},
            "bn": {n: copy(b) for n, b in state.model.named_buffers()
                   if n.endswith(("running_mean", "running_var"))},
            "step": state.step}


def _first_moment(state, mesh) -> Dict[str, torch.Tensor]:
    """Adam's first moment of a train state (tp shards gathered), on the
    CPU."""
    from ..train import _gathered_tree
    mu = _gathered_tree(state, mesh)["opt_state"]["mu"]
    return {n: m.detach().to("cpu", copy=True) for n, m in mu.items()}


def _collective_ms(mesh, n_grads: int) -> Dict[str, float]:
    """Wall ms (synchronised, median of 5) of the dp step's collectives
    on their own: the flat float32 all-reduce of ``n_grads`` gradients,
    and a small one (a BatchNorm's 2·576 + 1 sums). Empty without dp."""
    import statistics
    from .mesh import all_reduce_
    group = mesh.group("dp")
    if group is None:
        return {}
    out = {}
    for name, n in (("grads", n_grads), ("bn_sums", 2 * 576 + 1)):
        buf = torch.zeros(n, device=mesh.device)
        times = []
        for _ in range(5):
            _sync(mesh.device)
            t0 = time.perf_counter()
            all_reduce_(buf, group)
            _sync(mesh.device)
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = statistics.median(times)
    return out


def step_job(job: Dict[str, Any], mesh) -> Dict[str, Any]:
    """``make_train_step`` on ``mesh`` for each global batch ``steps``
    times (see the module docstring)."""
    from ..distill import LossWeights
    from ..parallel.mesh import place_params, replicate, shard_batch
    from ..train import (Adam, _microbatch_order, create_train_state,
                         load_train_state, make_train_step, step_generator,
                         train_state_tree)

    dev = mesh.device
    if "tf32" in job:
        torch.backends.cuda.matmul.allow_tf32 = bool(job["tf32"])
        torch.backends.cudnn.allow_tf32 = bool(job["tf32"])
    t_build = time.perf_counter()
    student, teacher = _load_models(job)
    set_dropout(student, job.get("dropout"), job.get("drop_path"))
    student, teacher = student.to(dev), teacher.to(dev)
    dtype = getattr(torch, job.get("dtype", "float32"))
    teacher = teacher.to(dtype) if dtype != torch.float32 else teacher
    grouped = mesh.distributed
    if grouped:
        place_params(student, mesh)
        place_params(teacher, mesh)
        replicate(student, mesh)
    elif job.get("bn_sums"):
        # one rank whose BatchNorms take the dp path's statistics (flax's
        # E[x²] - E[x]² from summed moments) over a group of itself: the
        # reference a dp run must equal up to the order of its sums
        import torch.distributed as dist
        from ..models.tinyvit import BatchNorm2d
        group = dist.new_group([dist.get_rank()])
        for mod in student.modules():
            if isinstance(mod, BatchNorm2d):
                mod.dp_group = group
    opt = Adam(job.get("lr", 1e-4))
    state = create_train_state(student, opt, dtype)
    grad_accum = job.get("grad_accum", 1)
    step = make_train_step(student, teacher, opt,
                           LossWeights(**job.get("weights", {})),
                           grad_accum=grad_accum,
                           external_teacher_beam=job.get(
                               "external_teacher_beam", False),
                           mesh=mesh if grouped else None)
    batches = _batches(job)
    dp = mesh.shape.get("dp", 1)
    build_s = time.perf_counter() - t_build
    steps, ms, grads = [], [], []
    wrappers = counted_wrappers(job)
    _sync(dev)
    for fn in wrappers.values():
        fn.launches = 0
    first_at = time.time()
    save, load = job.get("save_states"), job.get("load_states")
    prev = None
    for i in range(job.get("steps", 1)):
        if i and save:
            torch.save(train_state_tree(state), f"{save}.{i}.pt")
        if i and load:  # step i from the reference's state, not our own
            load_train_state(state, torch.load(
                f"{load}.{i}.pt", map_location=dev, weights_only=False))
            prev = _first_moment(state, mesh)
        batch = batches[i % len(batches)]
        if grad_accum > 1 and dp > 1:
            batch = _microbatch_order(batch, dp, grad_accum)
        local = shard_batch(batch, mesh) if grouped else \
            {k: v.to(dev) for k, v in batch.items()}
        t0 = time.perf_counter()
        m = step(state, local, step_generator(job.get("seed", 0) + 2,
                                              state.step))
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        steps.append({k: float(v) for k, v in m.items()})
        # this step's float32 gradient, from Adam's first moment
        mu = _first_moment(state, mesh)
        grads.append({n: (v - opt.b1 * prev[n]) / (1 - opt.b1)
                      if prev is not None else v / (1 - opt.b1)
                      for n, v in mu.items()})
        prev = mu
    launches = {k: fn.launches for k, fn in wrappers.items()}
    collective_ms = _collective_ms(mesh, sum(p.numel() for p in state.params))
    out = {"steps": steps, "step_ms": ms, "build_s": build_s,
           "collective_ms": collective_ms, "grads": grads,
           "first_step_at": first_at, "launches": launches,
           "device": str(dev), "backend": (
               torch.distributed.get_backend() if grouped else None),
           "local_shapes": {n: tuple(p.shape)
                            for n, p in student.named_parameters()},
           "teacher_local_shapes": {n: tuple(p.shape)
                                    for n, p in teacher.named_parameters()}}
    out.update(_whole_state(state, mesh))
    return out


def train_job(job: Dict[str, Any], mesh) -> Dict[str, Any]:
    """``train()`` on ``mesh`` over the job's global batches (one list per
    split), with ``config`` a ``from_dict`` override tree."""
    from ..config import from_dict
    from ..tokenization import BertWordPieceTokenizer
    from ..train import train

    student, teacher = _load_models(job)
    set_dropout(student, job.get("dropout"), job.get("drop_path"))
    data = torch.load(job["batches"], weights_only=False)
    train_data = data["train"]
    if job.get("host_slice"):
        # this rank's rows of each global batch, as a host-sliced
        # DeviceLoader yields them (main --multihost)
        from .mesh import shard_batch

        class HostRows(list):
            host_slice = True

        train_data = HostRows(shard_batch(b, mesh) for b in train_data)
    state, hist = train(from_dict(job["config"]), train_data,
                        data["val"], data["test"], BertWordPieceTokenizer(),
                        run_name=job.get("run_name", "mesh"),
                        student=student.to(mesh.device),
                        teacher=teacher.to(mesh.device), mesh=mesh,
                        max_epochs=job.get("max_epochs"),
                        device=mesh.device)
    out = {"history": {k: v for k, v in hist.items()
                       if k in ("train_loss", "val_loss", "test_loss",
                                "epoch_n_steps")}}
    out.update(_whole_state(state, mesh))
    return out


def dryrun_job(job: Dict[str, Any], mesh) -> Dict[str, Any]:
    """One full distillation step of the dry run's pair on ``mesh``, then
    the caption step on each dp rank's rows against the whole student on
    the whole batch."""
    import torch.distributed as dist

    from ..parallel.mesh import (all_gather, place_params, replicate,
                                 shard_batch, unshard)
    from ..serving import make_caption_step
    from ..train import Adam, create_train_state, make_train_step

    dev = mesh.device
    dp, tp = mesh.shape["dp"], mesh.shape.get("tp", 1)
    student, teacher = (m.to(dev) for m in dryrun_models())
    place_params(student, mesh)
    place_params(teacher, mesh)
    replicate(student, mesh)
    batch = synth_batches(0, 1, 2 * dp, 2, 64, 8, VOCAB)[0]
    opt = Adam(1e-4)
    state = create_train_state(student, opt, torch.float32)
    step = make_train_step(student, teacher, opt, mesh=mesh)
    metrics = step(state, shard_batch(batch, mesh),
                   torch.Generator().manual_seed(2))
    total = float(metrics["total"])
    if not np.isfinite(total):
        raise AssertionError(f"non-finite loss {total}")
    if state.step != 1:
        raise AssertionError(f"state.step {state.step}")

    windows = torch.from_numpy(np.random.default_rng(7).integers(
        0, 255, size=(2 * dp, 2, 64, 64, 3), dtype=np.uint8))
    student.eval()
    serve = make_caption_step(student, max_len=6, crop_size=64)
    with torch.no_grad():
        mine = serve(shard_batch(windows, mesh))
    rows_mesh = all_gather(mine, mesh.group("dp"), 0).cpu()
    whole = unshard(student)
    with torch.no_grad():
        rows_one = make_caption_step(whole, max_len=6, crop_size=64)(
            windows.to(dev)).cpu()
    if not torch.equal(rows_mesh, rows_one):
        raise AssertionError("dp-sharded caption rows differ from the "
                             "whole student's")
    if dist.get_rank() == 0:
        print(f"dryrun_multichip({mesh.size}): mesh dp={dp} tp={tp}, "
              f"loss={total:.4f}, decode dp-sharded == single-device "
              f"({rows_mesh.shape[0]} captions) OK", flush=True)
    return {"loss": total, "rows": rows_mesh, "dp": dp, "tp": tp,
            "local_shapes": {n: tuple(p.shape)
                             for n, p in student.named_parameters()}}


def nccl_job(job: Dict[str, Any], mesh) -> Dict[str, Any]:
    """The mesh's all-reduce, all-gather and broadcast over the whole
    group, on bf16 and float32 tensors, each against its exact result."""
    import torch.distributed as dist

    from ..parallel.mesh import all_gather, all_reduce_, broadcast_

    group = dist.group.WORLD
    n, r = dist.get_world_size(), dist.get_rank()
    out = {"backend": dist.get_backend(), "world": n,
           "device": str(mesh.device)}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        base = torch.arange(1024, device=mesh.device).to(dtype)
        t0 = time.perf_counter()
        s = all_reduce_(base * (r + 1), group)
        g = all_gather(base + r, group, 0)
        b = broadcast_(base + 7 * r, group)
        _sync(mesh.device)
        ms = (time.perf_counter() - t0) * 1e3
        want_s = base * sum(range(1, n + 1))
        want_g = torch.cat([base + i for i in range(n)])
        if not (torch.equal(s, want_s) and torch.equal(g, want_g)
                and torch.equal(b, base)):
            raise AssertionError(f"{out['backend']} collectives on {name} "
                                 f"disagree with their exact results")
        out[f"{name}_ms"] = ms
    return out


JOBS = {"dryrun": dryrun_job, "step": step_job, "train": train_job,
        "nccl": nccl_job}


def run_job(job: Dict[str, Any], mesh=None) -> Dict[str, Any]:
    """Run ``job`` in this process; without a mesh, on one rank (the
    single-process reference) on the device a worker of the job takes
    (``job["device"]``, else :func:`~.multihost.rank_device`'s)."""
    from .mesh import make_mesh
    from .multihost import rank_device
    if mesh is None:
        mesh = make_mesh(job.get("mesh", (1, 1)),
                         devices=[rank_device(job.get("device"))])
    return JOBS[job["kind"]](job, mesh)


# ---------------------------------------------------------------------------
# processes
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="rtvc_tpu_torch.parallel.dryrun")
    ap.add_argument("--job", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True,
                    help="the rendezvous: file:///path or tcp://host:port")
    args = ap.parse_args(argv)
    job = torch.load(args.job, weights_only=False)
    torch.set_num_threads(job.get("threads", 1))
    import torch.distributed as dist

    from .mesh import make_mesh
    from .multihost import initialize_distributed
    initialize_distributed(args.init, args.world, args.rank,
                           device=job.get("device"))
    try:
        mesh = make_mesh(job.get("mesh", (-1, 1)))
        out = JOBS[job["kind"]](job, mesh)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(out, f"{args.job}.rank{args.rank}.pt")
    return 0


def spawn(job: Dict[str, Any], world: int, workdir: str,
          timeout: float = 600.0, env: Optional[Dict[str, str]] = None
          ) -> List[Dict[str, Any]]:
    """Run ``job`` on ``world`` ranks, each a ``python -m
    rtvc_tpu_torch.parallel.dryrun`` process meeting at a file store in
    ``workdir``; wait up to ``timeout`` s for each (then kill them all and
    raise), raise if any exits non-zero (with the end of its log), and
    return each rank's result."""
    os.makedirs(workdir, exist_ok=True)
    path = tempfile.mkstemp(prefix=f"{job['kind']}_", suffix=".job",
                            dir=workdir)[1]
    torch.save(job, path)
    store = path + ".store"
    child_env = dict(os.environ)
    child_env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    child_env.update(env or {})
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    logs = [open(f"{path}.rank{r}.log", "w") for r in range(world)]
    launched_at = time.time()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "rtvc_tpu_torch.parallel.dryrun", "--job",
         path, "--rank", str(r), "--world", str(world), "--init",
         f"file://{store}"], cwd=root, env=child_env, stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(world)]
    deadline = time.monotonic() + timeout
    codes = []
    try:
        for p in procs:
            codes.append(p.wait(timeout=max(1.0, deadline - time.monotonic())))
    except subprocess.TimeoutExpired:
        codes = None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    tails = "\n".join(
        f"--- rank {r} ---\n" + open(f"{path}.rank{r}.log").read()[-3000:]
        for r in range(world))
    if codes is None:
        raise TimeoutError(f"{job['kind']} job on {world} ranks passed "
                           f"{timeout} s\n{tails}")
    if any(codes):
        raise RuntimeError(f"{job['kind']} job on {world} ranks exited "
                           f"{codes}\n{tails}")
    results = [torch.load(f"{path}.rank{r}.pt", weights_only=False)
               for r in range(world)]
    for out in results:
        if "first_step_at" in out:
            out["start_to_first_step_s"] = out["first_step_at"] - launched_at
    return results


def dryrun_multichip(n_devices: int, workdir: Optional[str] = None,
                     device: Optional[str] = None,
                     timeout: float = 600.0) -> Dict[str, Any]:
    """``n_devices`` ranks on a ``(dp, tp)`` mesh, tp = 2 where n >= 4 and
    even: one full distillation step, and the dp-sharded caption step
    equal to the whole student's rows (see the module docstring). Returns
    rank 0's result."""
    tp = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    job = {"kind": "dryrun", "mesh": (n_devices // tp, tp)}
    if device is not None:
        job["device"] = device
    with tempfile.TemporaryDirectory() as tmp:
        return spawn(job, n_devices, workdir or tmp, timeout)[0]


if __name__ == "__main__":
    sys.exit(main())
