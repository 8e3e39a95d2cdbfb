"""Plain float32 reference of the distillation step: the frozen teacher's
teacher-forced logits, the student's train-mode forward, the reference
repository's kl + ce loss, the backward, and Adam.

- kl: ``KLDivLoss(reduction="batchmean")`` of the student's log-softmax
  against the teacher's softmax at temperature T, summed over every
  position and word, divided by the batch, times T²;
- ce: the shifted cross-entropy of ``logits[:, :-1]`` against
  ``captions[:, 1:]``, ignoring id 0, the mean over the rest;
- Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected, no weight decay) on
  float32 weights.

Where it departs from the program: everything is float32, where the
program computes in bfloat16 on a bfloat16 copy of float32 master weights
and hands Adam float32 gradients of that copy.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .student import Student
from .teacher import Teacher


def kl_ce(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
          captions: torch.Tensor, temperature: float = 1.0
          ) -> Dict[str, torch.Tensor]:
    s = F.log_softmax(student_logits / temperature, dim=-1)
    t = teacher_logits / temperature
    kl = (torch.softmax(t, -1) * (F.log_softmax(t, -1) - s)).sum()
    kl = kl / student_logits.shape[0] * temperature ** 2
    tgt = captions[:, 1:].long()
    logp = F.log_softmax(student_logits[:, :-1], dim=-1)
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    mask = (tgt != 0).float()
    ce = (nll * mask).sum() / mask.sum().clamp(min=1.0)
    return {"kl": kl, "ce": ce}


class Adam:
    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.count = 0
        self.mu: List[torch.Tensor] = []
        self.nu: List[torch.Tensor] = []

    @torch.no_grad()
    def update(self, params: List[torch.Tensor],
               grads: List[torch.Tensor]) -> None:
        if not self.mu:
            self.mu = [torch.zeros_like(p) for p in params]
            self.nu = [torch.zeros_like(p) for p in params]
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        for p, g, m, v in zip(params, grads, self.mu, self.nu):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).add_(g * g, alpha=1.0 - self.b2)
            p.add_(-self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))


def train_step(student: Student, teacher: Teacher, adam: Adam,
               names: List[str], frames: torch.Tensor,
               captions: torch.Tensor, generator: torch.Generator,
               weights: Dict[str, float], temperature: float
               ) -> Tuple[Dict[str, float], List[torch.Tensor]]:
    """One step in place on ``student.p`` (leaves ``names`` updated).
    Returns the losses and the float32 gradients Adam took."""
    with torch.no_grad():
        t_logits = teacher.logits(frames, captions)
    student.train = True
    params = [student.p[n] for n in names]
    for p in params:
        p.requires_grad_(True)
        p.grad = None
    memory = student.encode(frames, generator)
    s_logits = student.decoder_logits(captions, memory, generator)
    losses = kl_ce(s_logits, t_logits, captions, temperature)
    total = sum(weights[k] * losses[k] for k in ("kl", "ce"))
    grads = torch.autograd.grad(total, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g.detach()
             for p, g in zip(params, grads)]
    for p in params:
        p.requires_grad_(False)
    adam.update(params, grads)
    student.train = False
    out = {k: float(v.detach()) for k, v in losses.items()}
    out["total"] = float(total.detach())
    return out, grads
