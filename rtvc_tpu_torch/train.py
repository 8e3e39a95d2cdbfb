"""The distillation train step.

Counterpart of ``rtvc_tpu/train.py`` on its default path: one step runs the
frozen teacher's teacher-forced forward, the student in train mode
(decoder dropout, DropPath, BatchNorm on batch statistics), the configured
distillation losses (kl + ce by default) and one Adam update, optionally
over ``grad_accum`` microbatches.

- :class:`TrainState`: the student's compute copy (bfloat16 under the
  default config, BatchNorm statistics float32), float32 master weights,
  the Adam state and the step count. JAX keeps float32 params and casts
  them to bfloat16 inside every layer; the port keeps both copies instead:
  gradients are taken on the compute copy, cast to float32 and handed to a
  float32 Adam, and the master weights are copied back into the compute
  copy after the update (Adam's 1e-4 steps would round away in bfloat16
  params);
- :class:`Adam` is ``optax.inject_hyperparams(optax.adam)``, and
  :func:`set_learning_rate` its ``hyperparams["learning_rate"]`` splice;
- :class:`PlateauScheduler` is the reference's ReduceLROnPlateau;
- :func:`make_train_step` builds the step, which updates the state in
  place and returns its metrics (the losses and ``grad_norm``);
- :func:`make_eval_step` and :func:`evaluate`: the validation/test epoch
  (greedy or beam decode to the caption bucket + 5 tokens, per-batch
  corpus BLEU-4, transcripts, the COCO sweep), and :class:`_NullLogger`.

Not ported yet (ROADMAP Queue 1 item 13): the beam-KD branches
(``LossWeights.ce_teacher``, ``kd_source="beam_consensus"``), replayed
teacher outputs (``external_teacher_logits``, ``external_teacher_beam``
and their top-K caches), ``steps_per_dispatch``, and the ``train()`` loop
with its checkpoints.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from . import decode as decode_lib
from . import metrics as metrics_lib
from .distill import LossWeights, distillation_losses

# teacher encoder blocks tapped for the fmap loss (reference model.py:844)
TEACHER_TAP_BLOCKS = (0, 6, 12, 18)
NOT_PORTED = "is not ported yet (ROADMAP Queue 1 item 13)"


@dataclasses.dataclass
class AdamState:
    """optax's ``ScaleByAdamState`` with ``inject_hyperparams``'
    ``hyperparams``: float32 moments in the order of the params."""

    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    hyperparams: Dict[str, float]


class Adam:
    """``optax.inject_hyperparams(optax.adam)(learning_rate)`` at optax's
    default b1, b2 and eps: the same moments, bias correction and update,
    in float32, on lists of tensors (``torch._foreach`` ops), params
    updated in place."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, learning_rate: float = 1e-4):
        self.learning_rate = float(learning_rate)

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        return AdamState(count=0,
                         mu=[torch.zeros_like(p) for p in params],
                         nu=[torch.zeros_like(p) for p in params],
                         hyperparams={"learning_rate": self.learning_rate})

    def update(self, grads: List[torch.Tensor], state: AdamState,
               params: List[torch.Tensor]) -> None:
        b1, b2 = self.b1, self.b2
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
        torch._foreach_mul_(step, -state.hyperparams["learning_rate"])
        torch._foreach_add_(params, step)


def set_learning_rate(opt_state: AdamState, lr: float) -> AdamState:
    """Set the injected learning rate (the plateau scheduler's output)."""
    opt_state.hyperparams["learning_rate"] = float(lr)
    return opt_state


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


def _float_grads(params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each parameter's gradient in float32 (zeros where the loss does not
    reach it, as ``jax.grad`` gives), then cleared."""
    grads = []
    for p in params:
        grads.append(torch.zeros_like(p, dtype=torch.float32)
                     if p.grad is None else p.grad.float())
        p.grad = None
    return grads


def make_train_step(student: nn.Module, teacher: nn.Module, optimizer: Adam,
                    weights: LossWeights = LossWeights(),
                    grad_accum: int = 1,
                    external_teacher_logits: bool = False,
                    external_teacher_beam: bool = False,
                    mark: Optional[Callable[[str], None]] = None):
    """The distillation step ``step(state, batch, generator) -> metrics``
    for the compute copy ``student`` (``state.model``) and the frozen
    ``teacher``. ``batch`` holds ``frames [B, F, H, W, 3]`` and ``caption
    [B, T]``; ``generator`` is the CPU ``torch.Generator`` every dropout
    draw of the step comes from. The teacher runs under ``torch.no_grad()``.

    ``grad_accum = M > 1`` splits the batch into M equal microbatches, runs
    the whole per-batch computation (teacher included) on each, threads the
    BatchNorm statistics through them in order, and applies one update with
    the float32 mean of their gradients; the metrics are the mean of theirs.

    ``mark(name)``, when given, is called as each part of a step starts:
    ``"teacher"``, ``"student"`` (forward, losses, backward), ``"optimizer"``
    and, when the step is done, ``"end"``."""
    if weights.ce_teacher != 0.0 or weights.kd_source == "beam_consensus":
        raise NotImplementedError(f"beam-KD training {NOT_PORTED}")
    if external_teacher_logits or external_teacher_beam:
        raise NotImplementedError(f"replayed teacher outputs {NOT_PORTED}")
    need_fmap = weights.fmap != 0.0
    need_visual = weights.final_enc != 0.0
    need_decoder = weights.decoder != 0.0
    taps = TEACHER_TAP_BLOCKS if need_fmap else None
    teacher.eval().requires_grad_(False)
    mark = mark or (lambda name: None)

    def batch_losses(batch, generator) -> Dict[str, torch.Tensor]:
        """Forward, losses and backward of one (micro)batch; the gradients
        land in the parameters' ``.grad``."""
        frames, captions = batch["frames"], batch["caption"]
        mark("teacher")
        with torch.no_grad():
            t_logits, t_visual, t_hidden, t_taps = \
                teacher.forward_output_logits(frames, captions, taps)
        mark("student")
        outs = student.distill_forward(
            frames, captions, generator=generator, need_fmap=need_fmap,
            need_visual=need_visual, need_decoder=need_decoder)
        losses = distillation_losses(
            student_logits=outs["logits"], teacher_logits=t_logits,
            targets=captions, weights=weights,
            student_proj_means=outs.get("proj_means"),
            teacher_cls_taps=t_taps if need_fmap else None,
            student_visual=outs.get("student_visual"),
            teacher_visual=t_visual if need_visual else None,
            student_hidden_proj=outs.get("hidden_proj"),
            teacher_hidden=t_hidden if need_decoder else None,
            teacher_prefix_len=t_visual.shape[1])
        losses["total"].backward()
        return {k: v.detach() for k, v in losses.items()}

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: torch.Generator) -> Dict[str, torch.Tensor]:
        if state.model is not student:
            raise ValueError("state.model is not the student this step "
                             "was built for")
        student.train()
        params = list(student.parameters())
        for p in params:
            p.grad = None
        if grad_accum <= 1:
            losses = batch_losses(batch, generator)
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
                g = _float_grads(params)
                grads = g if grads is None else torch._foreach_add(grads, g)
            inv = 1.0 / grad_accum
            torch._foreach_mul_(grads, inv)
            losses = {k: v * inv for k, v in losses.items()}
        mark("optimizer")
        grad_norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        optimizer.update(grads, state.opt_state, state.params)
        with torch.no_grad():
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
