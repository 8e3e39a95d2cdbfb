"""The check of the distillation step.

Once the window has closed, the check puts the seeded weights back into
the train state the window drove, in place (float32 masters, the bfloat16
compute copy, BatchNorm statistics), with a fresh Adam state, and drives
that same, warm step through three steps on three distinct batches,
through the window's own step call and feed. It keeps:

- each step's loss (kl + ce) and, of the first, the teacher's logits;
- the norm of each parameter's first gradient as Adam got it, worked out
  from Adam's first moment after one step (``mu / (1 - b1)``);
- the norm of each parameter's change over the three steps, read before
  a fourth.

Then the program's state is freed and the float32 reference runs the
same three steps from the same weights, batches and dropout draws. The
numbers, each compared where the cell gives it a limit:

- ``loss_gap_<s>``: the relative gap of step ``s``'s loss (kl + ce);
- ``grad_norm_gap`` and ``update_norm_gap``: over the parameters, the
  largest gap between the program's norm and the reference's, over the
  reference's norm or the median parameter's, whichever is larger;
- ``teacher_err_rms``: the frozen teacher's logits in the first step, as
  the step's call of ``forward_output_logits`` returned them, against the
  reference teacher's on the same batch: the root mean square of the
  difference over that of the reference's logits. A scalar loss hides
  the teacher's precision (its rounding takes either sign); this reads
  it.

What is nought to rounding in the reference is left out, by a rule on
the reference's first gradient and not by name: a parameter whose
gradient norm is below a thousandth of the median parameter's (the
distillation heads, which kl + ce does not reach) from both norm
comparisons, and from the change every element whose gradient is below a
thousandth of the median parameter's root-mean-square gradient (as the
key bias in a packed q|k|v bias, which softmax cancels: Adam moves such
an element by round-off alone, by up to the learning rate in bfloat16
and hardly at all in float32).
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

import torch

from . import program, seeds
from .core import Run, limited, log

from reference.common import strict_float32
from reference.student import Student
from reference.teacher import Teacher
from reference.train import Adam as RefAdam, train_step as ref_train_step

STEPS = 3
FLOOR = 1e-3  # of the median leaf's gradient norm


def _norms(tensors) -> List[float]:
    return [float(torch.linalg.vector_norm(t.float())) for t in tensors]


@torch.no_grad()
def reset(run: Run, st) -> None:
    """The seeded weights back into the train state ``st``, in place: the
    float32 masters, the compute copy and its BatchNorm statistics; Adam's
    moments zeroed and its count, the state's and the feed's at 0."""
    cfg = run.config
    values = program.student_values(cfg["student"], st.student_seed,
                                    run.device)
    model = st.state.model
    for p, master, name in zip(model.parameters(), st.state.params,
                               st.names):
        master.copy_(values[name].float())
        p.copy_(master)
    stats = {k: v for k, v in values.items() if k not in set(st.names)}
    for name, buf in model.named_buffers():
        if name in stats:
            buf.copy_(stats[name])
    opt = st.state.opt_state
    opt.count = 0
    for t in list(opt.mu) + list(opt.nu):
        t.zero_()
    st.state.step = 0
    st.count = 0


def capture_first_steps(st, one_step) -> dict:
    """Run steps 1-3 of the train state ``st`` by ``one_step(st)`` and
    keep what the check compares, with the teacher's logits of step 1."""
    masters = st.state.params
    start = [p.detach().clone() for p in masters]
    losses, first = [], None
    teacher = []
    inner = st.teacher.forward_output_logits

    def tapped(*args, **kwargs):
        out = inner(*args, **kwargs)
        if not teacher:
            teacher.append(out[0].detach().clone())
        return out

    st.teacher.forward_output_logits = tapped
    try:
        m = one_step(st)
    finally:
        del st.teacher.forward_output_logits
    for i in range(STEPS):
        if i:
            m = one_step(st)
        losses.append(float(m["total"]))
        if i == 0:
            b1 = st.opt.b1
            first = [n / (1.0 - b1) for n in _norms(st.state.opt_state.mu)]
    change = [p.detach() - p0 for p, p0 in zip(masters, start)]
    del start
    return {"losses": losses, "grad": first, "change": change,
            "teacher": teacher[0] if teacher else None}


def _as_norms(values) -> List[float]:
    """Norms as they are, or the norms of tensors."""
    return [v if isinstance(v, float) else float(
        torch.linalg.vector_norm(v.float())) for v in values]


def gap(prog: List[float], ref: List[float], keep: List[bool]
        ) -> Tuple[float, int]:
    """The largest |prog - ref| / max(ref, median ref) over the kept
    entries, and where it is."""
    scale = statistics.median([r for r, k in zip(ref, keep) if k])
    worst, at = 0.0, -1
    for i, (p, r, k) in enumerate(zip(prog, ref, keep)):
        if k:
            g = abs(p - r) / max(r, scale)
            if g > worst:
                worst, at = g, i
    return worst, at


def reference_steps(run: Run, st, precision: str = "float32") -> dict:
    """The reference's three steps from the seeded weights, on the same
    batches and dropout draws."""
    from reference.common import Precision

    strict_float32()
    cfg = run.config
    tr = cfg["train"]
    sv = program.student_values(cfg["student"], st.student_seed, run.device)
    sv = {k: v.float() for k, v in sv.items()}
    tv = program.teacher_values(cfg, st.teacher_seed, run.device)
    tv = {k: v.float() for k, v in tv.items()}
    prec = Precision(precision)
    student = Student(cfg["student"], sv, prec)
    teacher = Teacher(cfg, tv, prec)
    adam = RefAdam(float(tr["lr"]), **tr["adam"])
    start = [sv[n].clone() for n in st.names]
    weights = {k: float(v) for k, v in tr["losses"].items()}
    losses, first = [], None
    for i in range(STEPS):
        j = i % st.pool
        out, grads = ref_train_step(
            student, teacher, adam, st.names, st.frames[j], st.captions[j],
            seeds.step_generator(st.dropout_seed, i), weights,
            float(tr["temperature"]))
        losses.append(out["total"])
        if i == 0:
            first = grads
    change = [sv[n] - p0 for n, p0 in zip(st.names, start)]
    with torch.no_grad():
        first_teacher = teacher.logits(st.frames[0], st.captions[0])
    return {"losses": losses, "grad": first, "change": change,
            "teacher": first_teacher}


def kept(ref_grads: List[torch.Tensor]) -> Tuple[List[bool],
                                                 List[torch.Tensor]]:
    """The parameters and, inside each, the elements that the reference's
    first gradient moves by more than round-off."""
    norms = _norms(ref_grads)
    floor = FLOOR * statistics.median(norms)
    rms = statistics.median(n / max(1, g.numel()) ** 0.5
                            for n, g in zip(norms, ref_grads))
    return ([n >= floor for n in norms],
            [g.abs() >= FLOOR * rms for g in ref_grads])


def numbers(prog: dict, ref: dict, names: List[str]) -> Dict[str, float]:
    """Every number the check can compare, by name."""
    out: Dict[str, float] = {}
    for s, (p, r) in enumerate(zip(prog["losses"], ref["losses"]), 1):
        out[f"loss_gap_{s}"] = abs(p - r) / abs(r)
    keep, elements = kept(ref["grad"])
    grad, gi = gap(_as_norms(prog["grad"]), _norms(ref["grad"]), keep)
    change, ci = gap(_norms([c[m] for c, m in zip(prog["change"], elements)]),
                     _norms([c[m] for c, m in zip(ref["change"], elements)]),
                     keep)
    left = sum(int((~m).sum()) for m, k in zip(elements, keep) if k)
    log(f"losses program {prog['losses']} reference {ref['losses']}")
    log(f"{keep.count(False)} of {len(keep)} parameters below the gradient "
        f"floor, {left} elements of the rest; worst gradient "
        f"{names[gi] if gi >= 0 else '-'}, worst change "
        f"{names[ci] if ci >= 0 else '-'}")
    out["grad_norm_gap"] = grad
    out["update_norm_gap"] = change
    out["teacher_err_rms"] = teacher_error(prog["teacher"], ref["teacher"])
    return out


def teacher_error(prog, ref) -> float:
    """``teacher_err_rms`` (above); infinite where the program's first
    step gave no teacher logits of the batch's shape."""
    if prog is None or tuple(prog.shape) != tuple(ref.shape):
        log("no teacher logits of the batch's shape from the first step")
        return float("inf")
    diff = prog.float() - ref
    return float(diff.pow(2).mean().sqrt() / ref.pow(2).mean().sqrt())


def compare(run: Run, prog: dict, ref: dict, names: List[str]
            ) -> Dict[str, Tuple[float, float]]:
    """The numbers the cell gives a limit, each with its limit."""
    return limited(run, numbers(prog, ref, names))


def program_steps(run: Run, st, one_step) -> dict:
    """The program's three steps from the seeded weights, through the
    step the window drove."""
    reset(run, st)
    return capture_first_steps(st, one_step)


def check(run: Run, st, one_step) -> Dict[str, Tuple[float, float]]:
    prog = program_steps(run, st, one_step)
    del st.state, st.step, st.teacher
    if run.on_card:
        torch.cuda.empty_cache()
    ref = reference_steps(run, st)
    return compare(run, prog, ref, st.names)
