"""The distillation training loop and its train step.

Counterpart of ``rtvc_tpu/train.py`` on one card:

- :class:`TrainState`: the student's compute copy (bfloat16 under the
  default config, BatchNorm statistics float32), float32 master weights,
  the Adam state and the step count. JAX keeps float32 params and casts
  them to bfloat16 inside every layer; the port keeps both copies instead:
  gradients are taken on the compute copy, cast to float32 and handed to a
  float32 Adam, and the master weights are copied back into the compute
  copy after the update (Adam's 1e-4 steps would round away in bfloat16
  params). :func:`train_state_tree` / :func:`load_train_state` put it on
  disk and back (``data.io``);
- :class:`Adam` is ``optax.inject_hyperparams(optax.adam)`` at a float
  learning rate, and :func:`set_learning_rate` its ``hyperparams`` splice,
  or ``optax.adam`` over a schedule of its count, such as
  :func:`cosine_onecycle_schedule`;
- :class:`PlateauScheduler` is the reference's ReduceLROnPlateau;
- :func:`make_train_step` builds the step, which updates the state in
  place and returns its metrics (the losses and ``grad_norm``): the
  teacher-forced kl + ce by default, the beam-KD losses (``ce_teacher``,
  ``kd_source="beam_consensus"``) over the teacher's beam search, and
  teacher outputs replayed from the caches of ``data.teacher_cache``;
- :func:`make_eval_step` and :func:`evaluate`: the validation/test epoch
  (greedy or beam decode to the caption bucket + 5 tokens, per-batch
  corpus BLEU-4, transcripts, the COCO sweep), and :class:`_NullLogger`;
- :func:`train`: the epoch loop with an evaluation each epoch, the plateau
  scheduler on BLEU (the reference's quirk) or OneCycle, a checkpoint each
  epoch (in the background with ``async_checkpointing``), a checkpoint at
  the next step boundary after SIGTERM (:class:`PreemptionGuard`), and a
  resume that completes the original schedule bit for bit; :func:`main`
  is ``python -m rtvc_tpu_torch.train``.

Each step's dropout draws come from a generator seeded with ``(seed + 2,
step)`` (:func:`step_generator`), as JAX folds its dropout key with the
step, so a resumed run draws what the uninterrupted one drew.

On a mesh (``rtvc_tpu_torch.parallel``) each rank is a process holding
its dp rows of every global batch: the step sums the float32 gradients
over dp in one flat all-reduce and takes the mean (JAX's sharded step
reduces in float32 too), draws its dropout at the global batch's shape and
keeps its rows, and reports the ranks' mean losses; with tp > 1 the vocab
layers are split (``parallel.place_params``). ``train()`` and ``main
--multihost`` run one such process per rank; rank 0 logs, checkpoints and
evaluates.

Not ported: ``steps_per_dispatch`` (a scan over batches that measured
slower on the TPU).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
import sys
import time
from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch
from torch import nn

from . import decode as decode_lib
from . import metrics as metrics_lib
from .config import Config, cfg as default_cfg
from .data.teacher_cache import densify_topk
from .distill import LossWeights, distillation_losses
from .ops.dropout import global_rows
from .parallel import mesh as mesh_lib
from .parallel.multihost import shard_host_local_batch
from .utils.profiling import span

# teacher encoder blocks tapped for the fmap loss (reference model.py:844)
TEACHER_TAP_BLOCKS = (0, 6, 12, 18)
EOS = 102  # SEP doubles as the teacher's pad (reference model.py:487)

Schedule = Callable[[int], float]


@dataclasses.dataclass
class AdamState:
    """optax's ``ScaleByAdamState`` with ``inject_hyperparams``'
    ``hyperparams``: float32 moments in the order of the params."""

    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    hyperparams: Dict[str, float]


class Adam:
    """optax's Adam at its default b1, b2 and eps: the same moments, bias
    correction and update, in float32, on lists of tensors
    (``torch._foreach`` ops), params updated in place.

    A float ``learning_rate`` is ``optax.inject_hyperparams(optax.adam)``:
    the rate lives in ``hyperparams`` and :func:`set_learning_rate` changes
    it. A schedule is ``optax.adam(learning_rate=schedule)``: each update
    reads ``schedule(count)`` at the count of updates before it."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, learning_rate: Union[float, Schedule] = 1e-4):
        self.learning_rate = (learning_rate if callable(learning_rate)
                              else float(learning_rate))

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        hyper = ({} if callable(self.learning_rate)
                 else {"learning_rate": self.learning_rate})
        return AdamState(count=0,
                         mu=[torch.zeros_like(p) for p in params],
                         nu=[torch.zeros_like(p) for p in params],
                         hyperparams=hyper)

    def current_lr(self, state: AdamState) -> float:
        """The rate the next update applies."""
        if callable(self.learning_rate):
            return self.learning_rate(state.count)
        return state.hyperparams["learning_rate"]

    def update(self, grads: List[torch.Tensor], state: AdamState,
               params: List[torch.Tensor]) -> None:
        b1, b2 = self.b1, self.b2
        lr = self.current_lr(state)
        state.count += 1
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, torch._foreach_mul(grads, 1 - b1))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1 - b2)
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_add_(state.nu, sq)

        def correction(decay: float) -> float:  # 1 - decay^count, float32
            return float(1 - torch.tensor(decay) ** state.count)

        denom = torch._foreach_div(state.nu, correction(b2))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        step = torch._foreach_div(state.mu, correction(b1))
        torch._foreach_div_(step, denom)
        torch._foreach_mul_(step, -lr)
        torch._foreach_add_(params, step)


def set_learning_rate(opt_state: AdamState, lr: float) -> AdamState:
    """Set the injected learning rate (the plateau scheduler's output)."""
    opt_state.hyperparams["learning_rate"] = float(lr)
    return opt_state


def cosine_onecycle_schedule(transition_steps: int, peak_value: float,
                             pct_start: float = 0.3,
                             div_factor: float = 25.0,
                             final_div_factor: float = 1e4) -> Schedule:
    """optax's ``cosine_onecycle_schedule`` (not torch's ``OneCycleLR``):
    from ``peak / div_factor`` up to ``peak`` at ``int(pct_start · steps)``
    and down to ``peak / (div_factor · final_div_factor)`` at ``steps``,
    cosine between, constant after. Computed as optax computes it inside a
    jitted update: the bounds and the segment values in float64 on the
    host, the interpolation in float32."""
    if transition_steps <= 0:
        raise ValueError("A linear onecycle schedule was set with a "
                         "non-positive `transition_steps`")
    bounds = np.array([0, int(pct_start * transition_steps),
                       int(transition_steps)])
    values = np.cumprod([peak_value / div_factor, div_factor,
                         1.0 / (div_factor * final_div_factor)])
    lo = torch.tensor(bounds[:-1], dtype=torch.int32)
    hi = torch.tensor(bounds[1:], dtype=torch.int32)
    half = torch.tensor((values[:-1] - values[1:]) / 2.0,
                        dtype=torch.float32)
    end = torch.tensor(values[1:], dtype=torch.float32)
    last = torch.tensor(values[-1], dtype=torch.float32)

    def schedule(count: int) -> float:
        c = torch.tensor(int(count), dtype=torch.int32)
        indicator = ((lo <= c) & (c < hi)).float()
        pct = (c - lo) / (hi - lo)
        interp = end + half * (torch.cos(math.pi * pct) + 1)
        return float((indicator * interp).sum()
                     + (int(bounds[-1]) <= int(count)) * last)

    return schedule


@dataclasses.dataclass
class PlateauScheduler:
    """ReduceLROnPlateau (reference model.py:1105-1110): factor 0.5,
    patience 4, min_lr 1e-8, mode 'min'."""

    lr: float
    factor: float = 0.5
    patience: int = 4
    min_lr: float = 1e-8
    best: float = float("inf")
    bad_epochs: int = 0

    def update(self, monitored: float) -> float:
        if monitored < self.best:
            self.best = monitored
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad_epochs = 0
        return self.lr


class _NullLogger:
    """No-op logger for non-zero hosts in multi-host runs: one writer
    (process 0) owns the run file / scalars / wandb channel."""

    def write(self, text: str) -> None:
        pass

    def log_scalars(self, step: int, scalars) -> None:
        pass

    def log_epoch_transcript(self, *a, **k) -> None:
        pass

    def finish(self) -> None:
        pass


def _prune_checkpoints(run_dir: str, keep: int) -> None:
    """Keep only the newest ``keep`` checkpoints (reference ModelCheckpoint
    save_top_k=1 monitoring 'epoch' == keep-latest, config.py:47-54)."""
    import shutil
    ckpts = sorted(d for d in os.listdir(run_dir) if d.startswith("ckpt_")
                   and os.path.isdir(os.path.join(run_dir, d)))
    for stale in ckpts[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(run_dir, stale), ignore_errors=True)
        try:  # the checkpoint's sidecar metadata goes with it
            os.remove(os.path.join(run_dir, stale + ".meta.json"))
        except OSError:
            pass


def plot_loss(values, label: str, out_path: str) -> None:
    """Loss-curve plot (reference train.py:28-39), headless (Agg).
    matplotlib is imported here: ``train()`` never calls this, and a
    machine without it runs everything else."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    ax.plot(range(len(values)), values, label=label)
    ax.set_xlabel("Epoch")
    ax.set_ylabel(label)
    ax.legend()
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)


class PreemptionGuard:
    """SIGTERM → a flag; ``train()`` checkpoints the full train state to
    ``ckpt_preempt`` at the next step boundary and returns.

    The handler only sets the flag; the loop, which owns the state, does
    the rest. Handlers are installed only where that is possible (the main
    thread); elsewhere the guard stays a no-op. ``restore()`` reinstates
    the previous handlers."""

    def __init__(self, signals=None):
        import signal as _signal

        self._flag = False
        self._prev = {}
        for s in (signals or (_signal.SIGTERM,)):
            try:
                self._prev[s] = _signal.signal(s, self._handle)
            except ValueError:  # not the main thread
                pass

    def _handle(self, signum, frame):
        self._flag = True

    @property
    def triggered(self) -> bool:
        return self._flag

    def restore(self) -> None:
        import signal as _signal

        for s, h in self._prev.items():
            _signal.signal(s, h)
        self._prev = {}


@dataclasses.dataclass
class TrainState:
    """``model`` is the compute copy the step runs; ``params`` its float32
    master weights, in ``model.parameters()`` order."""

    model: nn.Module
    params: List[torch.Tensor]
    opt_state: AdamState
    step: int = 0


def create_train_state(student: nn.Module, optimizer: Adam,
                       dtype: torch.dtype = torch.bfloat16) -> TrainState:
    """The master weights are float32 copies of ``student``'s parameters;
    ``student`` itself is then cast to ``dtype``, in place, and becomes the
    compute copy (its BatchNorm statistics stay float32)."""
    params = [p.detach().float().clone() for p in student.parameters()]
    return TrainState(model=student.to(dtype), params=params,
                      opt_state=optimizer.init(params))


def train_state_tree(state: TrainState) -> Dict[str, Any]:
    """The train state as a checkpoint tree (its tensors alias the live
    ones): ``state_dict`` is the student's state dict with the float32
    master weights in place of the compute copy's parameters, so the
    evaluation entry points load it as any checkpoint; ``opt_state`` holds
    Adam's ``count``, ``mu`` and ``nu`` by parameter name and
    ``hyperparams``; ``step``."""
    names = [n for n, _ in state.model.named_parameters()]
    sd = state.model.state_dict()
    sd.update(zip(names, state.params))
    opt = state.opt_state
    return {"state_dict": sd,
            "opt_state": {"count": opt.count,
                          "mu": dict(zip(names, opt.mu)),
                          "nu": dict(zip(names, opt.nu)),
                          "hyperparams": dict(opt.hyperparams)},
            "step": state.step}


@torch.no_grad()
def load_train_state(state: TrainState, tree: Dict[str, Any]) -> TrainState:
    """Restore ``state`` in place from :func:`train_state_tree`'s tree (as
    ``data.io.restore_checkpoint`` returns it): the compute copy gets the
    master weights in its dtype, the BatchNorm statistics as they are."""
    names = [n for n, _ in state.model.named_parameters()]
    sd = tree["state_dict"]
    state.model.load_state_dict(sd)
    opt = tree["opt_state"]
    for name, master, mu, nu in zip(names, state.params, state.opt_state.mu,
                                    state.opt_state.nu):
        master.copy_(sd[name])
        mu.copy_(opt["mu"][name])
        nu.copy_(opt["nu"][name])
    state.opt_state.count = int(opt["count"])
    state.opt_state.hyperparams = dict(opt["hyperparams"])
    state.step = int(tree["step"])
    return state


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of step ``step``'s dropout draws: a function of
    ``(seed, step)`` alone, as JAX's ``fold_in(key, step)``."""
    mixed = np.random.SeedSequence((int(seed), int(step))).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(mixed))


def _float_grads(params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each parameter's gradient in float32 (zeros where the loss does not
    reach it, as ``jax.grad`` gives), then cleared."""
    grads = []
    for p in params:
        grads.append(torch.zeros_like(p, dtype=torch.float32)
                     if p.grad is None else p.grad.float())
        p.grad = None
    return grads


def _mean_over(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """The mean of ``tensors`` over the ranks of ``group``, in one flat
    all-reduce of their float32 concatenation."""
    n = mesh_lib.group_size(group)
    if n == 1:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    mesh_lib.all_reduce_(flat, group).div_(n)
    return [f.view_as(t) for f, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def _global_norm(grads: List[torch.Tensor], sharded: Sequence[int],
                 tp_group) -> torch.Tensor:
    """optax's ``global_norm`` of the whole gradient: the tp-sharded
    leaves' squares summed over tp, the replicated ones counted once."""
    norms = torch.stack(torch._foreach_norm(grads))
    if not sharded or tp_group is None:
        return torch.linalg.vector_norm(norms)
    sq = norms * norms
    mask = torch.zeros_like(sq, dtype=torch.bool)
    mask[list(sharded)] = True
    part = mesh_lib.all_reduce_(torch.where(mask, sq, 0.0).sum(), tp_group)
    return torch.sqrt(torch.where(mask, 0.0, sq).sum() + part)


def make_train_step(student: nn.Module, teacher: nn.Module, optimizer: Adam,
                    weights: LossWeights = LossWeights(),
                    grad_accum: int = 1, kd_beam_size: int = 4,
                    kd_max_steps: int = 15, kd_length_penalty: float = 0.6,
                    external_teacher_logits: bool = False,
                    cache_top_k: int = 0,
                    external_teacher_beam: bool = False,
                    beam_cache_top_k: int = 0,
                    mark: Optional[Callable[[str], None]] = None,
                    mesh=None):
    """The distillation step ``step(state, batch, generator) -> metrics``
    for the compute copy ``student`` (``state.model``) and the frozen
    ``teacher``. ``batch`` holds ``frames [B, F, H, W, 3]`` and ``caption
    [B, T]``; ``generator`` is the CPU ``torch.Generator`` every dropout
    draw of the step comes from. The teacher runs under ``torch.no_grad()``.

    The teacher's targets, as in JAX:

    - teacher-forced logits from the live forward, or with
      ``external_teacher_logits`` from the batch: ``teacher_logits [B, T,
      V]`` float32, or at ``cache_top_k`` the pair ``teacher_topk_vals`` /
      ``teacher_topk_idx``, densified here (:func:`densify_topk`);
    - with ``weights.ce_teacher`` or ``kd_source="beam_consensus"``, the
      teacher's beam search (``decode.teacher_beam``, ``kd_beam_size`` beams,
      ``kd_max_steps`` steps), or with ``external_teacher_beam`` its
      predictions ``teacher_beam_predictions`` and consensus rows
      (``teacher_kd_logits``, or ``teacher_kd_vals`` / ``teacher_kd_idx`` at
      ``beam_cache_top_k``) from the batch. Loss 5 takes the beam's tokens
      cut or SEP-padded to the caption length; the consensus KL takes the
      rows of the words before the first EOS, cut to the caption length.
      The forced forward runs only where a loss needs it.

    ``grad_accum = M > 1`` splits the batch, cached targets included, into
    M equal microbatches, runs the whole per-batch computation (teacher
    included) on each, threads the BatchNorm statistics through them in
    order, and applies one update with the float32 mean of their gradients;
    the metrics are the mean of theirs.

    ``mark(name)``, when given, is called as each part of a step starts:
    ``"teacher"``, ``"student"`` (forward, losses, backward), ``"optimizer"``
    and, when the step is done, ``"end"``.

    ``mesh`` (a ``parallel.make_mesh`` mesh over the ranks of a process
    group; ``student`` and ``teacher`` placed on it with
    ``parallel.place_params``): ``batch`` holds this rank's dp rows (every
    cached target too, as ``parallel.shard_batch`` cuts them). The ce
    divides by the global count of valid tokens, TinyViT's BatchNorm takes
    the global batch's statistics, dropout and DropPath draw at the global
    batch's shape from ``generator`` and keep this rank's rows, and the
    float32 gradients are averaged over dp in one flat all-reduce before
    Adam; the metrics are the ranks' mean. With ``grad_accum = M`` each
    rank splits its rows into M microbatches, and microbatch i of the
    global batch is the ranks' i-th microbatches together (``train()``
    orders a global batch so that this is the global batch's i-th
    M-th, as in JAX)."""
    need_fmap = weights.fmap != 0.0
    need_visual = weights.final_enc != 0.0
    need_decoder = weights.decoder != 0.0
    need_beam = (weights.ce_teacher != 0.0
                 or weights.kd_source == "beam_consensus")
    # the forced forward is needed unless the consensus KL replaces it and
    # no intermediate-activation loss wants its byproducts
    need_forced = (weights.kd_source == "teacher_forced" or need_fmap
                   or need_visual or need_decoder)
    if external_teacher_logits and (need_fmap or need_visual or need_decoder):
        raise ValueError(
            "external_teacher_logits (teacher-output caching) supports only "
            "the kl+ce teacher-forced path; intermediate-activation losses "
            "need the live teacher forward's taps in the step")
    if external_teacher_logits and need_beam and not external_teacher_beam:
        raise ValueError(
            "beam-KD losses with a forced-logit cache also need the beam "
            "cache (external_teacher_beam=True / "
            "cfg.train.teacher_beam_cache_dir) — the beam targets are "
            "cacheable too (they depend only on the video)")
    if external_teacher_beam and not need_beam:
        raise ValueError(
            "external_teacher_beam set but no loss consumes beam targets "
            "(weights.ce_teacher == 0 and kd_source != 'beam_consensus')")
    taps = TEACHER_TAP_BLOCKS if need_fmap else None
    vocab = teacher.config.vocab_size
    teacher.eval().requires_grad_(False)
    mark = mark or (lambda name: None)
    dp_group = mesh.group("dp") if mesh is not None else None
    tp_group = mesh.group("tp") if mesh is not None else None
    dp = mesh_lib.group_size(dp_group)
    draws = functools.partial(
        global_rows, mesh.index("dp") if mesh is not None else 0, dp)
    split = mesh_lib.sharded_dims(student)
    sharded = [i for i, (n, _) in enumerate(student.named_parameters())
               if n in split]

    @torch.no_grad()
    def teacher_targets(batch) -> Dict[str, Any]:
        frames, captions = batch["frames"], batch["caption"]
        out: Dict[str, Any] = {"teacher_logits": None, "prefix_len": 0}
        if external_teacher_logits:
            if cache_top_k:
                out["teacher_logits"] = densify_topk(
                    batch["teacher_topk_vals"], batch["teacher_topk_idx"],
                    vocab)
            else:
                out["teacher_logits"] = batch["teacher_logits"]
        elif need_forced:
            t_logits, t_visual, t_hidden, t_taps = \
                teacher.forward_output_logits(frames, captions, taps)
            out.update(teacher_logits=t_logits, prefix_len=t_visual.shape[1],
                       teacher_visual=t_visual if need_visual else None,
                       teacher_hidden=t_hidden if need_decoder else None,
                       teacher_cls_taps=t_taps if need_fmap else None)
        if not need_beam:
            return out
        t_len = captions.shape[1]
        kd_all = beam = None
        if external_teacher_beam:
            preds = batch["teacher_beam_predictions"]
            if weights.kd_source == "beam_consensus":
                kd_all = (densify_topk(batch["teacher_kd_vals"],
                                       batch["teacher_kd_idx"], vocab)
                          if beam_cache_top_k
                          else batch["teacher_kd_logits"])
        else:
            beam = decode_lib.teacher_beam(
                teacher, frames, beam_size=kd_beam_size,
                max_steps=kd_max_steps, length_penalty=kd_length_penalty)
            preds = beam.predictions.clone()  # out of inference mode
        if weights.ce_teacher != 0.0:
            # loss 5: the teacher's tokens cut or SEP-padded to the
            # caption length (reference model.py:946-961)
            out["teacher_tokens"] = (
                preds[:, :t_len] if preds.shape[1] >= t_len
                else torch.nn.functional.pad(
                    preds, (0, t_len - preds.shape[1]), value=EOS))
        if weights.kd_source == "beam_consensus":
            words = preds[:, 1:]
            is_eos = words == EOS
            first_eos = torch.argmax(is_eos.int(), dim=1)
            n_words = torch.where(is_eos.any(dim=1), first_eos,
                                  words.shape[1])
            if kd_all is None:
                kd_all, valid_all = decode_lib.teacher_kd_targets(
                    beam, n_words)
            else:
                steps = kd_all.shape[1]
                n = torch.clamp(n_words, max=steps)
                valid_all = (torch.arange(steps, device=n.device)[None, :]
                             < n[:, None])
            s = min(t_len, kd_all.shape[1])
            out["teacher_kd_logits"] = kd_all[:, :s]
            out["teacher_kd_valid"] = valid_all[:, :s]
        return out

    def batch_losses(batch, generator) -> Dict[str, torch.Tensor]:
        """Forward, losses and backward of one (micro)batch; the gradients
        land in the parameters' ``.grad``."""
        frames, captions = batch["frames"], batch["caption"]
        mark("teacher")
        with span("rtvc.train.teacher"):
            t = teacher_targets(batch)
        mark("student")
        with span("rtvc.train.student_forward"), draws():
            outs = student.distill_forward(
                frames, captions, generator=generator, need_fmap=need_fmap,
                need_visual=need_visual, need_decoder=need_decoder)
        with span("rtvc.train.losses"):
            losses = distillation_losses(
                student_logits=outs["logits"],
                teacher_logits=t["teacher_logits"],
                targets=captions, weights=weights,
                student_proj_means=outs.get("proj_means"),
                teacher_cls_taps=t.get("teacher_cls_taps"),
                student_visual=outs.get("student_visual"),
                teacher_visual=t.get("teacher_visual"),
                teacher_tokens=t.get("teacher_tokens"),
                teacher_kd_logits=t.get("teacher_kd_logits"),
                teacher_kd_valid=t.get("teacher_kd_valid"),
                student_hidden_proj=outs.get("hidden_proj"),
                teacher_hidden=t.get("teacher_hidden"),
                teacher_prefix_len=t["prefix_len"], dp_group=dp_group)
        with span("rtvc.train.backward"):
            losses["total"].backward()
        return {k: v.detach() for k, v in losses.items()}

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: torch.Generator) -> Dict[str, torch.Tensor]:
        if state.model is not student:
            raise ValueError("state.model is not the student this step "
                             "was built for")
        with span("rtvc.train.step"):
            student.train()
            params = list(student.parameters())
            for p in params:
                p.grad = None
            if grad_accum <= 1:
                losses = batch_losses(batch, generator)
                with span("rtvc.train.grad_cast"):
                    grads = _float_grads(params)
            else:
                bsz = batch["frames"].shape[0]
                if bsz % grad_accum:
                    raise ValueError(f"grad_accum={grad_accum} must divide "
                                     f"batch size {bsz}")
                size = bsz // grad_accum
                grads, losses = None, {}
                for i in range(grad_accum):
                    micro = {k: v[i * size:(i + 1) * size]
                             for k, v in batch.items()}
                    for k, v in batch_losses(micro, generator).items():
                        losses[k] = losses[k] + v if k in losses else v
                    with span("rtvc.train.grad_cast"):
                        g = _float_grads(params)
                        grads = (g if grads is None
                                 else torch._foreach_add(grads, g))
                inv = 1.0 / grad_accum
                torch._foreach_mul_(grads, inv)
                losses = {k: v * inv for k, v in losses.items()}
            mark("optimizer")
            if dp > 1:
                with span("rtvc.train.allreduce"):
                    grads = _mean_over(grads, dp_group)
                    names = sorted(losses)
                    means = _mean_over([torch.stack([losses[k].float()
                                                     for k in names])],
                                       dp_group)[0]
                    losses = dict(zip(names, means.unbind(0)))
            with span("rtvc.train.adam"):
                grad_norm = _global_norm(grads, sharded, tp_group)
                optimizer.update(grads, state.opt_state, state.params)
            with span("rtvc.train.copy_back"), torch.no_grad():
                for p, master in zip(params, state.params):
                    p.copy_(master)
            state.step += 1
            mark("end")
            return dict(losses, grad_norm=grad_norm)

    return step


def make_eval_step(student: nn.Module, max_len: int
                   ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Greedy-decode eval step (reference validation_step, model.py:1006):
    preprocessed frames ``[B, F, 224, 224, 3]`` → int32 rows ``[B, 1 +
    max_len]``."""
    def eval_fn(frames: torch.Tensor) -> torch.Tensor:
        return decode_lib.student_greedy(student, frames, max_len=max_len)
    return eval_fn


def evaluate(student: nn.Module, loader: Iterable, tokenizer, logger,
             epoch: int, split: str, max_len_extra: int = 5,
             annotations: Optional[Dict[str, List[str]]] = None,
             verbose: bool = True,
             beam_size: int = 0) -> Tuple[float, List[dict]]:
    """Validation/test epoch (reference model.py:1006-1102): decode every
    batch of ``loader`` (a :class:`~rtvc_tpu_torch.data.dataset.
    DeviceLoader`'s batches) to ``max_len`` = the caption bucket +
    ``max_len_extra`` (model.py:1010), greedy or, with ``beam_size > 0``,
    with the student's beam search; per-batch corpus BLEU-4 against the
    batch's own captions, transcripts to ``logger``, and with
    ``annotations`` (image_id → reference captions) the COCO sweep, logged.
    The student carries its weights and runs in eval mode. Returns (the
    mean of the batches' BLEU-4, the COCO-format outputs ``[{image_id,
    caption}]``).

    Two phases, as in JAX: every batch is decoded first, its rows left on
    the device, so the decode never waits on the host's detokenize and
    BLEU; then the rows are fetched and scored."""
    student.eval()
    all_bleu: List[float] = []
    outputs: List[dict] = []
    pending: List[Tuple[torch.Tensor, np.ndarray, Any]] = []
    for batch in loader:
        y = batch["caption"].cpu().numpy()
        max_len = int(y.shape[-1]) + max_len_extra  # model.py:1010
        if beam_size > 0:
            tokens = decode_lib.student_beam(student, batch["frames"],
                                             max_len=max_len, k=beam_size)
        else:
            tokens = decode_lib.student_greedy(student, batch["frames"],
                                               max_len=max_len)
        pending.append((tokens, y, batch["vid-id"]))
    for tokens, y, vid_ids in pending:
        tokens = tokens.cpu().numpy()
        preds = [tokenizer.decode(t, skip_special_tokens=True) for t in tokens]
        caps = [tokenizer.decode(c, skip_special_tokens=True) for c in y]
        caps_wrapped = [[c] for c in caps]
        bleu4 = metrics_lib.calculate_bleu_score_corpus(caps_wrapped, preds)
        all_bleu.append(bleu4)
        if verbose:  # reference printed per step (model.py:1023-1025)
            print(f"Ground-Truth Captions: {caps_wrapped}")
            print(f"Student Predictions: {preds}")
            print(f"BLEU@4: {bleu4}")
        logger.log_epoch_transcript(split, epoch, caps_wrapped, preds, bleu4)
        for vid, pred in zip(vid_ids, preds):
            outputs.append({"image_id": str(vid), "caption": pred})
    mean_bleu = float(np.mean(all_bleu)) if all_bleu else 0.0
    if annotations:
        scores = metrics_lib.evaluate_captions(outputs, annotations)
        logger.write("\n\n" + split + " COCO metrics: "
                     + str({k: v * 100 for k, v in scores.items()}) + "\n")
        logger.log_scalars(epoch, {f"{split}_{k}": v * 100
                                   for k, v in scores.items()})
    return mean_bleu, outputs


def _build_models(config: Config, device) -> Tuple[nn.Module, nn.Module]:
    """The config's student and teacher with random weights, the student's
    from ``config.seed`` and the teacher's from ``config.seed + 1`` (W8A8
    packed from its float weights under ``quantize_teacher``), on
    ``device``; the student float32 (``create_train_state`` casts it)."""
    from .models import git_teacher
    from .models.student import random_init_, student_from_config

    student = random_init_(student_from_config(config, device="cpu"),
                           torch.Generator().manual_seed(config.seed))
    teacher = git_teacher.random_init_(
        git_teacher.teacher_from_config(
            dataclasses.replace(config, quantize_teacher=False),
            device=device),
        torch.Generator().manual_seed(config.seed + 1))
    if config.quantize_teacher:
        teacher = git_teacher.quantize_teacher_variables(teacher)
    return student.to(device), teacher


def _any_host_triggered(local: bool, device) -> bool:
    """Any rank's preemption flag: an all-reduce of the ranks' flags, which
    every rank joins at the epoch barrier."""
    import torch.distributed as dist

    flag = torch.tensor([int(bool(local))], dtype=torch.int32, device=device)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item())


def _eval_on_main(student, loader, tokenizer, logger, epoch, split,
                  annotations, beam_size, is_main: bool, device
                  ) -> Tuple[float, List[dict]]:
    """Rank 0 evaluates the whole split on its copy of the weights; the
    BLEU is then broadcast as float32 (JAX's ``broadcast_one_to_all``), so
    that every rank's plateau scheduler steps alike. Other ranks return no
    outputs."""
    import torch.distributed as dist

    bleu, outputs = 0.0, []
    if is_main:
        bleu, outputs = evaluate(student, loader, tokenizer, logger, epoch,
                                 split, annotations=annotations,
                                 beam_size=beam_size)
    t = torch.tensor([bleu], dtype=torch.float32, device=device)
    dist.broadcast(t, src=0)
    return float(t.item()), outputs


def _microbatch_order(arrays: Dict[str, Any], dp: int, grad_accum: int
                      ) -> Dict[str, Any]:
    """Reorder a global batch's rows so that rank r's i-th of its
    ``grad_accum`` microbatches is the r-th dp share of the global batch's
    i-th ``grad_accum``-th (JAX's microbatch over a dp-sharded batch)."""
    def order(x):
        n = len(x)
        idx = np.arange(n).reshape(grad_accum, dp, -1).transpose(1, 0, 2)
        idx = idx.reshape(-1)
        if isinstance(x, torch.Tensor):
            return x[torch.as_tensor(idx, device=x.device)]
        return [x[i] for i in idx]
    return {k: order(v) for k, v in arrays.items()}


def _rows_are_local(loader) -> bool:
    """A loader that yields this rank's rows of each global batch (a
    ``DeviceLoader`` with ``host_slice`` or ``mesh``), not the whole."""
    return (getattr(loader, "host_slice", None) is not None
            or getattr(loader, "mesh", None) is not None)


def _gathered_tree(state: TrainState, mesh) -> Dict[str, Any]:
    """:func:`train_state_tree` with every tp-sharded tensor (weights, Adam
    moments) gathered whole (every rank of the tp group calls), so that a
    checkpoint loads into a one-card run."""
    tree = train_state_tree(state)
    split = mesh_lib.sharded_dims(state.model)
    group = mesh.group("tp") if mesh is not None else None
    if not split or group is None:
        return tree
    sd = dict(tree["state_dict"])
    opt = tree["opt_state"]
    mu, nu = dict(opt["mu"]), dict(opt["nu"])
    for name, dim in split.items():
        sd[name] = mesh_lib.all_gather(sd[name].detach(), group, dim)
        mu[name] = mesh_lib.all_gather(mu[name], group, dim)
        nu[name] = mesh_lib.all_gather(nu[name], group, dim)
    return dict(tree, state_dict=sd, opt_state=dict(opt, mu=mu, nu=nu))


def train(config: Config, train_loader: Iterable, val_loader, test_loader,
          tokenizer, run_name: str = "run",
          annotations: Optional[Dict[str, List[str]]] = None,
          student: Optional[nn.Module] = None,
          teacher: Optional[nn.Module] = None,
          loss_weights: LossWeights = LossWeights(),
          mesh=None, max_epochs: Optional[int] = None,
          resume_from: Optional[str] = None,
          resume_schedule: bool = False,
          teacher_cache=None, teacher_beam_cache=None,
          device="cuda") -> Tuple[TrainState, Dict[str, Any]]:
    """A full distillation run (reference train.py:42-157), JAX's
    ``train()`` on one card. ``student`` and ``teacher`` default to the
    config's with random weights on ``device`` (:func:`_build_models`); a
    given student is trained in place, on its own device, and becomes the
    state's compute copy in ``config.dtype``. Each epoch trains over
    ``train_loader`` (iterated once before the loop, as JAX takes its
    example batch, so epoch e shuffles as the loader's pass 1 + e), then
    evaluates on ``val_loader`` and steps the scheduler; the test epoch
    follows the last.

    ``resume_from``: a checkpoint this function wrote; params, BatchNorm
    statistics, Adam's state and the step are restored, and the run trains
    ``max_epochs`` more. With ``resume_schedule=True`` it completes the
    original schedule instead: the loop continues at the checkpoint's
    recorded position (``ckpt_preempt`` redoes the interrupted epoch from
    its first untrained batch; an epoch-end ``ckpt_NN`` starts at epoch N +
    1), the plateau scheduler's state is restored, and a loader with
    ``set_epoch`` (``DeviceLoader``) is realigned, so the run ends with the
    uninterrupted run's weights, bit for bit.

    ``teacher_cache`` (a :class:`~.data.teacher_cache.TeacherLogitsCache`
    or its directory; kl + ce only) and ``teacher_beam_cache``
    (:class:`~.data.teacher_cache.TeacherBeamCache` or its directory; the
    beam-KD losses only): the teacher's outputs are computed on a miss,
    stored, and replayed on later epochs through
    :class:`~.data.teacher_cache.CacheReplayFeed`; on a miss and on a hit
    the step sees the same float32 targets.

    Returns the state and ``history``: JAX's keys (``train_loss``,
    ``val_loss``, ``test_loss``, ``epoch_step_ms``, ``epoch_dispatch_ms``,
    ``epoch_fetch_s``, ``epoch_first_dispatch_s``, ``epoch_n_steps``,
    ``timing``, the caches' ``stats()``, ``preempted``), plus
    ``epoch_step_device_ms`` (each step's span on the card's stream, CUDA
    events; empty on the CPU), ``epoch_eval_s`` (each validation epoch's
    wall time), ``ckpt_wait_s`` and ``ckpt_snapshot_s`` (the loop's waits
    on the background checkpoint writer, and its copies to the host) and
    ``test_outputs`` (the test epoch's COCO-format captions).

    ``mesh``: where it spans the ranks of a process group
    (``parallel.make_mesh`` after ``parallel.initialize_distributed``),
    this process is one rank of a data- (and tensor-) parallel run; by
    default the mesh is ``config.mesh_shape`` / ``mesh_axes`` over the
    group's ranks, or over ``device`` alone without a group. Each rank
    builds (or is given) the same models, which are placed on the mesh
    (``parallel.place_params``, then dp-rank 0's weights broadcast), and
    runs the step on its dp rows: of each global batch, which ``train()``
    trims to a multiple of dp × ``grad_accum`` (logged; fewer rows raise
    ``cannot be split over dp``) and cuts; or, from a loader that already
    yields this rank's rows (``DeviceLoader`` with ``host_slice`` or
    ``mesh``), as they are. Rank 0 logs, checkpoints and evaluates; its
    BLEU is broadcast, and a SIGTERM on any rank stops every rank at the
    epoch's end. JAX refuses tp > 1 across hosts because its evaluation
    fetches a host-local replica; here the tp shards are gathered to every
    rank before an evaluation or a checkpoint, so a checkpoint holds whole
    tensors and loads into a one-card run, and tp > 1 runs across
    processes. JAX's shrinking of the default mesh's dp to divide the
    batch size does not apply: every rank of the group takes part."""
    import torch.distributed as dist

    from .data import teacher_cache as cache_lib
    from .data.io import (AsyncCheckpointSaver, checkpoint_meta,
                          restore_checkpoint, save_checkpoint)
    from .utils.logging import RunLogger
    from .utils.profiling import StepTimer

    if mesh is None:
        grouped = dist.is_initialized() and dist.get_world_size() > 1
        mesh = mesh_lib.make_mesh(
            config.mesh_shape, config.mesh_axes,
            devices=None if grouped else [
                next(student.parameters()).device if student is not None
                else device])
    multihost = mesh.distributed
    if not multihost and mesh.size > 1:
        raise ValueError(
            f"train() on a mesh of {mesh.size} devices of one process: a "
            f"dp or tp run is one process per rank (start the ranks with "
            f"torchrun or parallel.initialize_distributed)")
    is_main = not multihost or dist.get_rank() == 0
    dp = mesh.shape.get("dp", 1)
    tp_group = mesh.group("tp")
    if multihost:
        device = mesh.device
    run_dir = os.path.join(config.logger.save_dir, "run", run_name)
    os.makedirs(run_dir, exist_ok=True)
    if config.data.wordnet_path:  # METEOR synonym stage (metrics.py)
        metrics_lib.set_wordnet_path(config.data.wordnet_path)
    logger = _NullLogger() if not is_main else RunLogger(
        run_dir, run_name, config_dump={
        "Teacher model": "GITTeacher",
        "Teacher model configuration": dataclasses.asdict(config.teacher),
        "Student model": "StudentCandidateV1",
        "Student model configuration": dataclasses.asdict(config.student),
        "Learning Rate": config.train.lr,
        "Number of epochs": config.train.trainer.max_epochs,
        "Batch size": config.train.batch_size,
        "Precision": config.train.trainer.precision,
    }, use_wandb=config.wandb.mode != "disabled")

    if student is None or teacher is None:
        built = _build_models(config, device)
        student = student if student is not None else built[0]
        teacher = teacher if teacher is not None else built[1]
        del built
    if multihost:
        mesh_lib.place_params(student, mesh)
        mesh_lib.place_params(teacher, mesh)
        mesh_lib.replicate(student, mesh)
    # JAX draws its example batch here: one pass of the loader, so that
    # epoch e of the loop is the loader's pass 1 + e in both packages
    first_pass = iter(train_loader)
    next(first_pass, None)
    if first_pass is not train_loader:  # a pass of its own: stop it
        getattr(first_pass, "close", lambda: None)()

    sched = PlateauScheduler(lr=config.train.lr,
                             factor=config.train.plateau_factor,
                             patience=config.train.plateau_patience,
                             min_lr=config.train.plateau_min_lr)
    use_onecycle = config.train.scheduler == "onecycle"
    if use_onecycle:
        # the reference's dead OneCycleLR (model.py:1110-1113) as a
        # working option: a schedule of the optimizer's count
        n_epochs = max_epochs or config.train.trainer.max_epochs
        try:
            steps_per_epoch = len(train_loader)
        except TypeError:
            raise ValueError(
                "cfg.train.scheduler='onecycle' needs a sized train_loader "
                "(len()) to fix total_steps; use 'plateau' with unsized "
                "loaders")
        onecycle = cosine_onecycle_schedule(
            transition_steps=max(1, n_epochs * steps_per_epoch),
            peak_value=config.train.onecycle_max_lr)
        optimizer = Adam(learning_rate=onecycle)
    else:
        optimizer = Adam(learning_rate=config.train.lr)

    state = create_train_state(student, optimizer, config.dtype)
    start_epoch = 0       # first epoch-loop index this run executes
    skip_batches = 0      # already-trained batches to skip in start_epoch
    if resume_schedule and resume_from is None:
        raise ValueError("resume_schedule=True needs resume_from")
    if resume_from is not None:
        load_train_state(state, mesh_lib.local_tree(
            state.model, restore_checkpoint(resume_from)))
        logger.write(f"\nresumed from {resume_from} at step "
                     f"{state.step}\n")
        meta_r = checkpoint_meta(resume_from)
        _g = meta_r.get("gelu_approximate")
        if _g is not None and bool(_g) != config.student.gelu_approximate:
            logger.write(
                f"WARNING: checkpoint was trained with gelu_approximate="
                f"{bool(_g)} but this run uses "
                f"{config.student.gelu_approximate} — set "
                f"cfg.student.gelu_approximate to match\n")
        if resume_schedule:
            if "epoch" not in meta_r:
                raise ValueError(
                    "resume_schedule=True needs a checkpoint that records "
                    "its schedule position ('epoch' in the meta sidecar) — "
                    f"{resume_from} predates that; resume without "
                    "resume_schedule for 'train max_epochs more' semantics")
            if meta_r.get("preempted"):
                # the interrupted epoch never finished: redo it from the
                # first batch that did not train before the SIGTERM
                start_epoch = int(meta_r["epoch"])
                skip_batches = int(meta_r.get("steps_into_epoch", 0))
            else:
                start_epoch = int(meta_r["epoch"]) + 1
            saved = meta_r.get("plateau")
            if saved is not None and not use_onecycle:
                sched.lr = float(saved["lr"])
                sched.best = float(saved["best"])
                sched.bad_epochs = int(saved["bad_epochs"])
            if hasattr(train_loader, "set_epoch"):
                # this run's first pass above counted too: pin the next
                # pass to start_epoch's, as in the uninterrupted run
                train_loader.set_epoch(1 + start_epoch)
            logger.write(
                f"resuming schedule at epoch {start_epoch}"
                + (f" (skipping {skip_batches} already-trained batches)"
                   if skip_batches else "") + "\n")
    dev = state.params[0].device
    on_card = dev.type == "cuda"

    if isinstance(teacher_cache, str):
        teacher_cache = cache_lib.TeacherLogitsCache(
            teacher_cache, top_k=config.train.teacher_cache_top_k)
    kd_beam = (config.teacher.beam_size, config.teacher.max_steps,
               config.teacher.length_penalty)
    need_beam_targets = (loss_weights.ce_teacher != 0.0
                         or loss_weights.kd_source == "beam_consensus")
    if isinstance(teacher_beam_cache, str):
        teacher_beam_cache = cache_lib.TeacherBeamCache(
            teacher_beam_cache, top_k=config.train.teacher_beam_cache_top_k,
            beam_size=kd_beam[0], max_steps=kd_beam[1],
            length_penalty=kd_beam[2],
            store_consensus=loss_weights.kd_source == "beam_consensus")
    if teacher_beam_cache is not None and not need_beam_targets:
        raise ValueError(
            "teacher_beam_cache set but no beam-KD loss is active "
            "(loss_weights.ce_teacher == 0 and kd_source != "
            "'beam_consensus')")
    if (teacher_beam_cache is not None
            and loss_weights.kd_source == "beam_consensus"
            and not teacher_beam_cache.store_consensus):
        raise ValueError(
            "kd_source='beam_consensus' needs a TeacherBeamCache with "
            "store_consensus=True (this one stores predictions only)")
    grad_accum = max(1, int(config.train.grad_accum_steps))
    train_step = make_train_step(
        student, teacher, optimizer, loss_weights,
        kd_beam_size=kd_beam[0], kd_max_steps=kd_beam[1],
        kd_length_penalty=kd_beam[2], grad_accum=grad_accum,
        mesh=mesh if multihost else None,
        external_teacher_logits=teacher_cache is not None,
        cache_top_k=teacher_cache.top_k if teacher_cache is not None else 0,
        external_teacher_beam=teacher_beam_cache is not None,
        beam_cache_top_k=teacher_beam_cache.top_k
        if teacher_beam_cache is not None else 0)

    @torch.no_grad()
    def logits_miss(arrays, keys) -> None:
        """The live teacher for a batch the logits cache misses: stored,
        then replayed in the step as a hit would be (float32, top-K cut)."""
        t_logits = teacher(arrays["frames"], arrays["caption"]).float()
        dense = t_logits.cpu().numpy()
        store(teacher_cache.put_batch, keys, t_logits)
        if teacher_cache.top_k:
            vals, idx = teacher_cache.compress(dense)
            arrays["teacher_topk_vals"] = torch.from_numpy(vals).to(dev)
            arrays["teacher_topk_idx"] = torch.from_numpy(idx).to(dev)
        else:
            arrays["teacher_logits"] = t_logits

    @torch.no_grad()
    def beam_miss(arrays, keys) -> None:
        """The live beam for a batch the beam cache misses: predictions and
        the full consensus rows ``[B, S, V]`` (the step derives the words,
        the valid mask and the cut from them as the live branch does)."""
        out = decode_lib.teacher_beam(
            teacher, arrays["frames"], beam_size=kd_beam[0],
            max_steps=kd_beam[1], length_penalty=kd_beam[2])
        preds = out.predictions.clone()
        arrays["teacher_beam_predictions"] = preds
        if not teacher_beam_cache.store_consensus:
            store(teacher_beam_cache.put_batch, keys, preds)
            return
        steps = out.logits.shape[0]
        kd_all, _ = decode_lib.teacher_kd_targets(
            out, torch.full((preds.shape[0],), steps, device=dev))
        dense = kd_all.float().cpu().numpy()
        store(teacher_beam_cache.put_batch, keys, preds, kd_all.float())
        if teacher_beam_cache.top_k:
            vals, idx = teacher_beam_cache.compress(dense)
            arrays["teacher_kd_vals"] = torch.from_numpy(vals).to(dev)
            arrays["teacher_kd_idx"] = torch.from_numpy(idx).to(dev)
        else:
            arrays["teacher_kd_logits"] = kd_all.float()

    def run_misses(arrays, misses) -> None:
        """The live teacher for the batches a cache missed (``misses``:
        their keys), on ``arrays``' rows."""
        if "_cache_keys" in misses:
            logits_miss(arrays, misses["_cache_keys"])
        if "_beam_cache_keys" in misses:
            beam_miss(arrays, misses["_beam_cache_keys"])

    timer = StepTimer("train_step")
    epochs = max_epochs or config.train.trainer.max_epochs
    history: Dict[str, Any] = {"train_loss": [], "val_loss": [],
                               "epoch_eval_s": [],
                               "epoch_step_device_ms": []}
    ckpt_saver = (AsyncCheckpointSaver()
                  if config.train.async_checkpointing and is_main else None)
    save_ckpts = config.train.trainer.enable_checkpointing
    rows_local = multihost and _rows_are_local(train_loader)
    # the trim's quantum: every rank's rows split into grad_accum equal
    # microbatches
    quant = 1 if rows_local else dp * grad_accum

    def eval_student():
        # the whole student: its tp shards gathered (every rank calls)
        return mesh_lib.unshard(student) if tp_group is not None else student

    def run_eval(model, loader, ep, split):
        if multihost:
            return _eval_on_main(model, loader, tokenizer, logger, ep, split,
                                 annotations, config.train.eval_beam_size,
                                 is_main, device)
        return evaluate(model, loader, tokenizer, logger, ep, split,
                        annotations=annotations,
                        beam_size=config.train.eval_beam_size)

    def store(put, keys, *rows):
        """Write a missed batch's teacher outputs to a cache: every rank
        its own rows where they are its own, else rank 0 the global batch's
        rows gathered over dp."""
        if rows_local or not multihost:
            put(keys, *(r.cpu().numpy() for r in rows))
            return
        whole = [mesh_lib.all_gather(r.contiguous(), mesh.group("dp"))
                 for r in rows]
        if is_main:
            put(keys, *(w.cpu().numpy() for w in whole))

    def plateau_meta() -> Optional[Dict[str, float]]:
        return None if use_onecycle else {
            "lr": sched.lr, "best": sched.best,
            "bad_epochs": sched.bad_epochs}

    guard = (PreemptionGuard() if config.train.checkpoint_on_preemption
             else None)
    preempted = False
    try:
        for epoch in range(start_epoch, epochs):
            # a resumed, preempted epoch: its first batches trained before
            # the SIGTERM; consume them without compute
            epoch_skip = skip_batches if epoch == start_epoch else 0
            to_skip = epoch_skip
            # losses stay on the card until the epoch ends: a fetch a step
            # would make the host wait for each step
            epoch_losses: List[torch.Tensor] = []
            epoch_t0 = time.perf_counter()
            n_steps = 0
            first_dispatch_s = 0.0
            dispatch_ms: List[float] = []
            spans: List[Tuple[Any, Any]] = []
            feed = train_loader
            if teacher_cache is not None or teacher_beam_cache is not None:
                feed = cache_lib.CacheReplayFeed(
                    train_loader, teacher_cache,
                    beam_cache=teacher_beam_cache, device=dev)
            for batch in feed:
                if to_skip > 0:
                    to_skip -= 1
                    continue
                if guard is not None and guard.triggered and not multihost:
                    # one process stops at this step boundary; ranks of a
                    # group stop together at the epoch's end
                    preempted = True
                    break
                arrays = {"frames": batch["frames"],
                          "caption": batch["caption"]}
                misses = {}
                if teacher_cache is not None:
                    hit = [k for k in ("teacher_topk_vals",
                                       "teacher_topk_idx", "teacher_logits")
                           if k in batch]
                    if hit:
                        arrays.update((k, batch[k]) for k in hit)
                    else:
                        misses["_cache_keys"] = batch["_cache_keys"]
                if teacher_beam_cache is not None:
                    if "teacher_beam_predictions" in batch:
                        arrays.update(
                            (k, batch[k]) for k in (
                                "teacher_beam_predictions",
                                "teacher_kd_logits", "teacher_kd_vals",
                                "teacher_kd_idx") if k in batch)
                    else:
                        misses["_beam_cache_keys"] = \
                            batch["_beam_cache_keys"]
                if not multihost:
                    run_misses(arrays, misses)
                if quant > 1:
                    # a ragged tail batch must not hit the step's
                    # divisibility error mid-training: trim it
                    bs = int(arrays["caption"].shape[0])
                    usable = (bs // quant) * quant
                    if usable == 0:
                        raise ValueError(
                            f"batch of {bs} rows cannot be split over "
                            f"dp={dp} x grad_accum={grad_accum}; raise the "
                            f"batch size, shrink the mesh's dp axis, or "
                            f"lower cfg.train.grad_accum_steps")
                    if usable != bs:
                        logger.write(f"\ntrimming ragged batch {bs} -> "
                                     f"{usable} for dp={dp}/grad_accum="
                                     f"{grad_accum} (use drop_last to "
                                     f"avoid)\n")
                        arrays = {k: v[:usable] for k, v in arrays.items()}
                        misses = {k: v[:usable] for k, v in misses.items()}
                if multihost:
                    if rows_local:
                        arrays = shard_host_local_batch(arrays, mesh)
                    else:
                        if dp > 1 and grad_accum > 1:
                            arrays = _microbatch_order(arrays, dp,
                                                       grad_accum)
                            misses = _microbatch_order(misses, dp,
                                                       grad_accum)
                        arrays = mesh_lib.shard_batch(arrays, mesh)
                    run_misses(arrays, misses)
                t_dispatch = time.perf_counter()
                if on_card:
                    ev = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                    ev[0].record()
                m = train_step(state, arrays, step_generator(
                    config.seed + 2, state.step))
                if on_card:
                    ev[1].record()
                    spans.append(ev)
                dispatch_s = time.perf_counter() - t_dispatch
                if n_steps == 0:
                    first_dispatch_s = dispatch_s
                dispatch_ms.append(dispatch_s * 1e3)
                epoch_losses.append(m["total"])
                n_steps += 1
            t_fetch = time.perf_counter()
            losses_np = (torch.stack(epoch_losses).float().cpu().tolist()
                         if epoch_losses else [])
            fetch_s = time.perf_counter() - t_fetch
            epoch_dt = time.perf_counter() - epoch_t0
            if n_steps:
                timer.durations.append(epoch_dt / n_steps)
            history.setdefault("epoch_n_steps", []).append(n_steps)
            history.setdefault("epoch_first_dispatch_s", []).append(
                round(first_dispatch_s, 3))
            history.setdefault("epoch_dispatch_ms", []).append(
                [round(d, 1) for d in dispatch_ms])
            history.setdefault("epoch_fetch_s", []).append(round(fetch_s, 3))
            history["epoch_step_device_ms"].append(
                [a.elapsed_time(b) for a, b in spans])
            mean_loss = float(np.mean(losses_np)) if losses_np else 0.0
            history["train_loss"].append(mean_loss)

            if guard is not None and multihost:
                # every rank reaches this collective each epoch, so a flag
                # raised on any rank stops them all here together
                preempted = _any_host_triggered(guard.triggered, device)
            if preempted:
                tree = _gathered_tree(state, mesh) if save_ckpts else None
                if save_ckpts and is_main:
                    if ckpt_saver is not None:
                        ckpt_saver.wait()  # earlier epochs' pending writes
                    save_checkpoint(
                        os.path.join(run_dir, "ckpt_preempt"), tree,
                        meta={"gelu_approximate":
                              bool(config.student.gelu_approximate),
                              "preempted": True, "epoch": epoch,
                              # trained batches of this epoch, those a
                              # prior resume skipped included
                              "steps_into_epoch": epoch_skip + n_steps,
                              # as of the last completed epoch
                              "plateau": plateau_meta()})
                logger.write(
                    f"\nSIGTERM: checkpointed full train state to "
                    f"ckpt_preempt at epoch {epoch} step {state.step} "
                    f"({epoch_skip + n_steps} steps into the epoch); resume "
                    f"with train(resume_from=<run_dir>/ckpt_preempt, "
                    f"resume_schedule=True) to complete the schedule\n")
                history["preempted"] = True
                break

            t_eval = time.perf_counter()
            val_bleu, _ = run_eval(eval_student(), val_loader, epoch,
                                   "Validation")
            history["epoch_eval_s"].append(time.perf_counter() - t_eval)
            history["val_loss"].append(val_bleu)
            if use_onecycle:
                new_lr = optimizer.current_lr(state.opt_state)
            else:
                # quirk preserved: min-mode plateau on BLEU
                new_lr = sched.update(val_bleu)
                set_learning_rate(state.opt_state, new_lr)

            logger.log_scalars(epoch, {"train_loss": mean_loss,
                                       "val_loss": val_bleu, "lr": new_lr,
                                       **timer.summary()})
            tree = _gathered_tree(state, mesh) if save_ckpts else None
            if save_ckpts and is_main:
                path = os.path.join(run_dir, f"ckpt_{epoch:02d}")
                prune = functools.partial(_prune_checkpoints, run_dir,
                                          config.callback.save_top_k)
                # gelu_approximate: loaders rebuild the student with the
                # activation these weights were trained under; epoch and
                # plateau (after this epoch's update): the schedule
                # position for resume_schedule
                meta = {"gelu_approximate":
                        bool(config.student.gelu_approximate),
                        "epoch": epoch, "plateau": plateau_meta()}
                if ckpt_saver is not None:
                    ckpt_saver.save(path, tree, on_done=prune, meta=meta)
                else:
                    save_checkpoint(path, tree, meta=meta)
                    prune()
    finally:
        if guard is not None:
            guard.restore()

    if ckpt_saver is not None:
        ckpt_saver.wait()  # the last epoch's background write
        history["ckpt_wait_s"] = ckpt_saver.wait_s
        history["ckpt_snapshot_s"] = ckpt_saver.snapshot_s
    if not preempted:
        # the reclaim grace window is for the checkpoint, not a test epoch
        test_bleu, history["test_outputs"] = run_eval(
            eval_student(), test_loader, epochs, "Test")
        history["test_loss"] = test_bleu
    else:
        history["test_loss"] = None
    history["timing"] = timer.summary() if timer.durations else {}
    # one mean step time an epoch: epoch 1 against 2 shows the caches
    history["epoch_step_ms"] = [d * 1e3 for d in timer.durations]
    if teacher_cache is not None:
        history["teacher_cache"] = teacher_cache.stats()
    if teacher_beam_cache is not None:
        history["teacher_beam_cache"] = teacher_beam_cache.stats()
    logger.finish()
    return state, history


def main(argv: Optional[List[str]] = None):
    """``python -m rtvc_tpu_torch.train`` (reference ``python3 -m
    src.train``, train.py:160): trains the config's student, with random
    weights, against the config's teacher on the MSRVTT-format data the
    config's paths name (relative to the working directory), into
    ``<save_dir>/run/<%y%m%d_%H%M%S>``. Returns ``train()``'s (state,
    history).

    ``--multihost`` (or ``config.multihost``): one process per rank, each
    started by torchrun or with JAX's ``COORDINATOR_ADDRESS`` /
    ``NUM_PROCESSES`` / ``PROCESS_ID``; ``parallel.initialize_distributed``
    joins them (and without either environment the run stays in one
    process, as JAX's does), the mesh spans the ranks, and each rank's
    train loader decodes only its dp rows of each global batch."""
    import argparse

    from .data.dataset import CaptionDataset, DeviceLoader, load_labels
    from .tokenization import BertWordPieceTokenizer

    parser = argparse.ArgumentParser(prog="rtvc_tpu_torch.train")
    parser.add_argument("--multihost", action="store_true",
                        help="join a process group and train over all its "
                             "ranks (env: COORDINATOR_ADDRESS, "
                             "NUM_PROCESSES, PROCESS_ID, or torchrun's)")
    parser.add_argument("--resume", metavar="CKPT", default=None,
                        help="checkpoint to restore (params, optimizer "
                             "state, step) before training")
    parser.add_argument("--resume-schedule", action="store_true",
                        help="with --resume: complete the original "
                             "max_epochs schedule from the checkpoint's "
                             "recorded position (a ckpt_preempt redoes the "
                             "interrupted epoch from its first untrained "
                             "batch) instead of training max_epochs more")
    parser.add_argument("--device", default="cuda",
                        help="the card to train on (cpu for a run without "
                             "one)")
    args = parser.parse_args(argv)

    config = default_cfg
    multihost = False
    device = args.device
    if args.multihost or config.multihost:
        from .parallel.multihost import initialize_distributed, rank_device
        rank_dev = None if args.device == "cuda" else args.device
        multihost = initialize_distributed(device=rank_dev)
        if multihost:
            device = rank_device(rank_dev)
    try:
        data, encoded = load_labels(config.data.captions_path,
                                    config.data.encoded_caption_ids)
    except FileNotFoundError as e:
        print(f"training data not found ({e}); see README for data setup",
              file=sys.stderr)
        sys.exit(1)

    mesh, host_slice = None, None
    if multihost:
        from .parallel.mesh import make_mesh
        from .parallel.multihost import host_batch_slice
        mesh = make_mesh(config.mesh_shape, config.mesh_axes)
        # the tp ranks of a dp index share its rows
        host_slice = host_batch_slice(config.train.batch_size,
                                      mesh.index("dp"),
                                      mesh.shape.get("dp", 1))

    splits = {}
    for split in ("train", "validate", "test"):
        # every split's caption choice is seeded: the video→caption pairing
        # is fixed for the run, which makes the teacher caches exact
        ds = CaptionDataset(config.data.videos_path, data.video_ids(split),
                            data, encoded, num_frames=config.data.num_frames,
                            random_state=config.seed)
        # train batches are host-sliced (each rank decodes its rows of the
        # global batch); val/test stay whole: rank 0 evaluates alone
        splits[split] = DeviceLoader(
            ds, config.train.batch_size, shuffle=(split == "train"),
            seed=config.seed, drop_last=(split == "train"),
            prefetch_depth=config.data.prefetch_depth, device=device,
            host_slice=host_slice if split == "train" else None)

    annotations = None
    if config.data.annotation_path and \
            os.path.exists(config.data.annotation_path):
        annotations = metrics_lib.load_coco_annotations(
            config.data.annotation_path)

    run_name = time.strftime("%y%m%d_%H%M%S")
    return train(config, splits["train"], splits["validate"], splits["test"],
                 BertWordPieceTokenizer(), run_name=run_name,
                 annotations=annotations, resume_from=args.resume,
                 resume_schedule=args.resume_schedule,
                 teacher_cache=config.train.teacher_cache_dir or None,
                 teacher_beam_cache=config.train.teacher_beam_cache_dir
                 or None, mesh=mesh, device=device)


if __name__ == "__main__":
    main()
