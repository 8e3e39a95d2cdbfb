"""Knowledge-distillation losses, as pure functions over explicit
intermediates.

Counterpart of ``rtvc_tpu/distill.py`` (the reference's losses 1-6): the
same six losses, ``masked_kl_divergence_loss`` of the beam-consensus mode,
:class:`LossWeights` (default kl + ce, the reference's active sum) and
:func:`distillation_losses`, which raises when a weighted loss lacks its
inputs instead of dropping it from the total. Every loss is computed in
float32 whatever the logits' dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class LossWeights:
    """Loss mixing weights; ``kd_source`` picks the KL's teacher
    distribution: ``"teacher_forced"`` logits over the ground-truth caption,
    or ``"beam_consensus"`` rows of the teacher's beam search."""

    kl: float = 1.0          # loss 2
    ce: float = 1.0          # loss 3
    fmap: float = 0.0        # loss 1
    final_enc: float = 0.0   # loss 4
    ce_teacher: float = 0.0  # loss 5
    decoder: float = 0.0     # loss 6
    temperature: float = 1.0
    kd_source: str = "teacher_forced"


def _kl_terms(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
              temperature: float) -> torch.Tensor:
    s = student_logits.float() / temperature
    t = teacher_logits.float() / temperature
    log_p_t = F.log_softmax(t, dim=-1)
    return torch.softmax(t, dim=-1) * (log_p_t - F.log_softmax(s, dim=-1))


def kl_divergence_loss(student_logits: torch.Tensor,
                       teacher_logits: torch.Tensor,
                       temperature: float = 1.0) -> torch.Tensor:
    """``KLDivLoss(reduction='batchmean')``: the elementwise KL summed over
    everything, padded positions included, divided by the batch size, times
    T²."""
    kl = _kl_terms(student_logits, teacher_logits, temperature).sum()
    return kl / student_logits.shape[0] * temperature ** 2


def masked_kl_divergence_loss(student_logits: torch.Tensor,
                              teacher_logits: torch.Tensor,
                              valid: torch.Tensor,
                              temperature: float = 1.0) -> torch.Tensor:
    """The KL over the positions where ``valid [B, S]`` holds, batchmean."""
    kl = _kl_terms(student_logits, teacher_logits, temperature).sum(dim=-1)
    kl = (kl * valid.float()).sum()
    return kl / student_logits.shape[0] * temperature ** 2


def _nll(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, tokens.long()[..., None])[..., 0]


def cross_entropy_loss(student_logits: torch.Tensor, targets: torch.Tensor,
                       ignore_index: int = 0,
                       dp_group=None) -> torch.Tensor:
    """Shifted CE against the ground truth: predict ``y[:, 1:]`` from
    ``logits[:, :-1]``, ignoring id ``ignore_index``, mean over the rest.

    With ``dp_group`` (the dp ranks of a mesh, each holding its rows of
    the global batch) the count of valid tokens is the global one, and the
    local sum is scaled by the number of ranks: the mean of the ranks'
    losses, and of their gradients, is the global token mean JAX takes
    over its dp-sharded batch, whatever each rank's own count."""
    tgt = targets[:, 1:]
    nll = _nll(student_logits[:, :-1], tgt)
    mask = (tgt != ignore_index).float()
    count = mask.sum()
    ranks = 1
    if dp_group is not None:
        from .parallel.mesh import all_reduce_, group_size
        count = all_reduce_(count.detach().clone(), dp_group)
        ranks = group_size(dp_group)
    return (nll * mask).sum() * ranks / torch.clamp(count, min=1.0)


def fmap_distillation_loss(student_proj_means: Sequence[torch.Tensor],
                           teacher_cls_taps: Sequence[torch.Tensor]
                           ) -> torch.Tensor:
    """Loss 1: MSE between the projected stage means ``[B·F, 1024]`` and
    the teacher's CLS taps reshaped to ``[B·F, 1024]``."""
    s = torch.stack([p.float() for p in student_proj_means])
    t = torch.stack([tap.reshape(-1, tap.shape[-1]).float()
                     for tap in teacher_cls_taps])
    return ((s - t) ** 2).mean()


def final_encoding_loss(student_visual: torch.Tensor,
                        teacher_visual: torch.Tensor) -> torch.Tensor:
    """Loss 4: MSE between the upsampled, projected student memory and the
    teacher's visual features."""
    return ((student_visual.float() - teacher_visual.float()) ** 2).mean()


def teacher_token_ce_loss(student_logits: torch.Tensor,
                          teacher_tokens: torch.Tensor) -> torch.Tensor:
    """Loss 5: CE of the student logits against the teacher's generated
    tokens, no ignore index."""
    return _nll(student_logits, teacher_tokens).mean()


def decoder_distillation_loss(student_hidden_proj: Sequence[torch.Tensor],
                              teacher_hidden: Sequence[torch.Tensor],
                              prefix_len: int) -> torch.Tensor:
    """Loss 6: MSE between each projected student decoder layer and the
    text positions of teacher layer ``round((i + 1) · Lt / Ls) − 1``."""
    ls, lt = len(student_hidden_proj), len(teacher_hidden)
    total = torch.zeros((), dtype=torch.float32,
                        device=student_hidden_proj[0].device)
    for i, s in enumerate(student_hidden_proj):
        j = max(0, round((i + 1) * lt / ls) - 1)
        t = teacher_hidden[j][:, prefix_len:prefix_len + s.shape[1]]
        total = total + ((s.float() - t.float()) ** 2).mean()
    return total / ls


def _require(cond: bool, loss_name: str, what: str) -> None:
    if not cond:
        raise ValueError(
            f"LossWeights.{loss_name} is non-zero but {what} was not "
            f"provided — a weighted loss must never be a silent no-op")


def distillation_losses(
    *,
    student_logits: torch.Tensor,
    teacher_logits: Optional[torch.Tensor],
    targets: torch.Tensor,
    weights: LossWeights = LossWeights(),
    student_proj_means: Optional[Sequence[torch.Tensor]] = None,
    teacher_cls_taps: Optional[Sequence[torch.Tensor]] = None,
    student_visual: Optional[torch.Tensor] = None,
    teacher_visual: Optional[torch.Tensor] = None,
    teacher_tokens: Optional[torch.Tensor] = None,
    teacher_kd_logits: Optional[torch.Tensor] = None,
    teacher_kd_valid: Optional[torch.Tensor] = None,
    student_hidden_proj: Optional[Sequence[torch.Tensor]] = None,
    teacher_hidden: Optional[Sequence[torch.Tensor]] = None,
    teacher_prefix_len: int = 1542,
    dp_group=None,
) -> Dict[str, torch.Tensor]:
    """Every requested loss and ``total``, the weighted sum. A weighted loss
    whose inputs are missing raises. ``dp_group``: see
    :func:`cross_entropy_loss`; the other losses are means over equal row
    counts, whose mean over the ranks is already the global one."""
    w = weights
    out: Dict[str, torch.Tensor] = {}
    if w.kd_source == "beam_consensus":
        _require(teacher_kd_logits is not None and teacher_kd_valid is not None,
                 "kd_source='beam_consensus'", "teacher_kd_logits/valid")
        s = teacher_kd_logits.shape[1]
        out["kl"] = masked_kl_divergence_loss(
            student_logits[:, :s], teacher_kd_logits, teacher_kd_valid,
            w.temperature)
    else:
        if w.kd_source != "teacher_forced":
            raise ValueError(f"unknown kd_source {w.kd_source!r}")
        _require(teacher_logits is not None, "kl", "teacher_logits")
        out["kl"] = kl_divergence_loss(student_logits, teacher_logits,
                                       w.temperature)
    out["ce"] = cross_entropy_loss(student_logits, targets,
                                   dp_group=dp_group)
    total = w.kl * out["kl"] + w.ce * out["ce"]
    if w.fmap:
        _require(student_proj_means is not None and teacher_cls_taps
                 is not None, "fmap", "student_proj_means/teacher_cls_taps")
        out["fmap"] = fmap_distillation_loss(student_proj_means,
                                             teacher_cls_taps)
        total = total + w.fmap * out["fmap"]
    if w.final_enc:
        _require(student_visual is not None and teacher_visual is not None,
                 "final_enc", "student_visual/teacher_visual")
        out["final_enc"] = final_encoding_loss(student_visual, teacher_visual)
        total = total + w.final_enc * out["final_enc"]
    if w.ce_teacher:
        _require(teacher_tokens is not None, "ce_teacher", "teacher_tokens")
        out["ce_teacher"] = teacher_token_ce_loss(student_logits,
                                                  teacher_tokens)
        total = total + w.ce_teacher * out["ce_teacher"]
    if w.decoder:
        _require(student_hidden_proj is not None and teacher_hidden
                 is not None, "decoder", "student_hidden_proj/teacher_hidden")
        out["decoder"] = decoder_distillation_loss(
            student_hidden_proj, teacher_hidden, teacher_prefix_len)
        total = total + w.decoder * out["decoder"]
    out["total"] = total
    return out
