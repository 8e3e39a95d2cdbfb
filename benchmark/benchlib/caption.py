"""What the caption drivers share: the student and its window pool, the
tap on the logits its decode chose from, the timing of the caption step's
parts, and the check of what it served against the float32 reference.

The check, once the window has closed, compares two numbers, each over a
sample drawn from the seed with the longest served caption in it:

- ``logit_gap``, over the captions the clients got: each is run through
  the reference, teacher-forced over its own window and served tokens; at
  every served position the reference's best logit minus its logit of
  the served token is a gap, and ``logit_gap`` is the widest. Greedy
  decoding serves the token the program's logits put first, so a sound
  program's gaps are rounding; a token altered where it is produced, a
  window mixed up with another, or a wrong bias, norm or statistic
  upstream opens them.
- ``head_err_rms``, over the logits the program's decode chose those
  tokens from (kept by :class:`LogitTap` in the window), against the
  reference's at the same positions. An error upstream of the vocabulary
  projection moves a position's logits by ``W dh`` for some hidden-state
  error ``dh``; that part is fitted per position by least squares over
  the columns of the reference's ``W`` and a constant, and taken away.
  What is left is the projection's own error: the bfloat16 rounding of
  its weights and output in a sound program, and more where the
  projection runs in a lower precision (the program's ``vocab_int8``) or
  drops its bias. ``head_err_rms`` is its root mean square.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import program, seeds, traffic
from .core import Records, Run, limited, log
from .work import caption_flops

from reference.common import strict_float32
from reference.student import Student


class CaptionState:
    """The student, its tokenizer and the window pool of a caption cell."""

    def __init__(self, run: Run):
        cfg = run.config
        tr = run.workload["traffic"]
        t0 = time.perf_counter()
        self.values_seed = seeds.sub_seed(run.seed, seeds.WEIGHTS)
        values = program.student_values(cfg, self.values_seed, run.device)
        self.student = program.student(cfg, values, run.device)
        del values
        log(f"set-up: student built in {time.perf_counter() - t0:.3f} s, "
            f"{time.perf_counter() - run.t_start:.3f} s from process start")
        self.tokenizer = program.tokenizer()
        self.max_len = int(cfg["max_len"])
        self.sep = int(cfg["decoder"]["sep_token_id"])
        hw = tr["frame"]
        self.windows = traffic.windows(int(tr["pool"]), cfg["num_frames"],
                                       hw, run.seed, run.device)
        self.host_windows = self.windows.cpu().numpy()
        self.closers: List = []
        self.tap = LogitTap(self.student, run.seed,
                            int(run.workload["check"].get("keep_calls", 16)),
                            self.sep)
        self.set_step: Callable = None


class LogitTap:
    """The logits the program's greedy decode chose its tokens from.

    The student's ``decode_step`` is wrapped on the instance, and each
    call's logits are held by reference, not copied. Around each call of
    the caption step (:meth:`around`), while ``armed``, the call's frames,
    rows and logits are kept for ``size`` calls drawn uniformly from the
    seed (a reservoir sample, so the memory held is bounded whatever the
    window's length) and for the first call that served the longest
    caption; the rest are let go. That length is read back from the rows:
    a few small launches and a wait the caller makes anyway a call."""

    def __init__(self, student, seed: int, size: int, sep: int):
        self.size = size
        self.sep = sep
        self.best = -1
        self.seen = 0
        self.rng = seeds.rng(seed, seeds.SAMPLE, 1)
        self.armed = False
        self.fresh: List[torch.Tensor] = []
        self.kept: List[dict] = []
        self.longest: Optional[dict] = None
        inner = student.decode_step

        def decode_step(*args, **kwargs):
            out = inner(*args, **kwargs)
            self.fresh.append(out[0])
            return out

        student.decode_step = decode_step

    def around(self, step: Callable) -> Callable:
        def tapped(frames):
            self.fresh = []
            rows = step(frames)
            if self.armed:
                self._keep(frames, rows)
            self.fresh = []
            return rows

        return tapped

    def _keep(self, frames, rows) -> None:
        entry = {"frames": frames, "rows": rows, "logits": self.fresh}
        gen = torch.as_tensor(rows)[:, 1:]
        served = ((gen != self.sep) & (gen != 0)).int().cumprod(1).sum(1)
        n = int(served.max())
        if n > self.best:
            self.longest, self.best = entry, n
        if len(self.kept) < self.size:
            self.kept.append(entry)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.kept[j] = entry
        self.seen += 1

    def entries(self) -> List[dict]:
        out = list(self.kept)
        if self.longest is not None and all(e is not self.longest
                                            for e in out):
            out.append(self.longest)
        return out

    def clear(self) -> None:
        self.kept, self.longest, self.seen, self.best = [], None, 0, -1


def decode_steps(rows: torch.Tensor, sep_id: int) -> int:
    """Decode iterations a greedy step ran: it stops when every row emits
    SEP at one step."""
    rows = rows.cpu()
    for i in range(1, rows.shape[1]):
        if bool((rows[:, i] == sep_id).all()):
            return i
    return rows.shape[1] - 1


def served_tokens(row: Sequence[int], sep_id: int) -> np.ndarray:
    """The generated tokens of a row (CLS dropped), up to its first SEP or
    pad 0."""
    row = np.asarray(row)[1:]
    stop = np.nonzero((row == sep_id) | (row == 0))[0]
    return row[: stop[0]] if stop.size else row


def request_flops(run: Run, tokens: int) -> float:
    """Model work of one caption: the encoder over its frames and one
    decode step for each token it served, plus the one that ended it."""
    return caption_flops(run.config,
                         min(tokens + 1, int(run.config["max_len"])))


def part_times(run: Run, state: CaptionState, batch: int, reps: int,
               records: Records) -> None:
    """The smoke script's ``part_times`` at the cell's batch: CUDA events
    around ``clip_preprocess`` + the student's ``forward_image_enc``, and
    around the program's caption step (``make_caption_step``, as the
    server and the captioner build it); the decode is the step less the
    encode, over the iterations it ran."""
    from rtvc_tpu_torch.ops.preprocess import clip_preprocess
    from rtvc_tpu_torch.serving import make_caption_step

    frames = state.windows[:batch]
    f = frames.shape[1]
    crop = int(run.config["encoder"]["input_size"])
    step = make_caption_step(state.student, max_len=state.max_len)

    @torch.inference_mode()
    def encode():
        flat = frames.reshape((batch * f,) + frames.shape[2:])
        proc = clip_preprocess(flat, crop_size=crop)
        state.student.forward_image_enc(
            proc.reshape((batch, f) + proc.shape[1:]))

    encode()
    step(frames)
    torch.cuda.synchronize()
    enc, calls = [], []
    for _ in range(reps):
        a = _event()
        encode()
        b = _event()
        torch.cuda.synchronize()
        enc.append(a.elapsed_time(b))
    for _ in range(reps):
        a = _event()
        rows = step(frames)
        b = _event()
        torch.cuda.synchronize()
        calls.append((a.elapsed_time(b), decode_steps(rows, state.sep)))
    mean_enc = sum(enc) / len(enc)
    records.spans["encode_ms"].extend(enc)
    records.spans["decode_ms"].extend(ms - mean_enc for ms, _ in calls)
    records.spans["decode_tokens"].extend(n for _, n in calls)


def _event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def sample(run: Run, served: List[tuple]) -> List[tuple]:
    """The longest of ``served`` (by its tokens, the second field), then
    others drawn from the seed."""
    k = int(run.workload["check"]["sample"])
    if not served:
        return []
    longest = max(range(len(served)), key=lambda i: len(served[i][1]))
    rest = [i for i in range(len(served)) if i != longest]
    r = seeds.rng(run.seed, seeds.SAMPLE)
    picked = [longest] + [rest[i] for i in
                          r.permutation(len(rest))[:max(0, k - 1)]]
    return [served[i] for i in picked]


@torch.inference_mode()
def tapped_requests(st: CaptionState) -> List[tuple]:
    """(window, served tokens, logits ``[tokens, V]``) of every row of the
    calls the tap kept; a row is matched to the pool window its frames
    equal (the server's padding rows match none)."""
    out = []
    pool = st.windows
    for e in st.tap.entries():
        rows = e["rows"].cpu().numpy() if torch.is_tensor(e["rows"]) \
            else np.asarray(e["rows"])
        frames = e["frames"]
        if not torch.is_tensor(frames):
            frames = torch.from_numpy(np.asarray(frames))
        frames = frames.to(pool.device)
        for r in range(rows.shape[0]):
            hit = (pool == frames[r]).flatten(1).all(1).nonzero()
            if hit.numel() == 0:
                continue
            toks = served_tokens(rows[r], st.sep)
            steps = e["logits"][:len(toks)]
            # a row the decode gave no logits for has none to compare
            whole = len(steps) == len(toks) and all(s.shape[0] > r
                                                    for s in steps)
            logits = torch.stack([s[r] for s in steps]) if whole and len(
                toks) else None
            out.append((int(hit[0, 0]), toks, logits))
    return out


def collect(run: Run, st: CaptionState, rec: Records) -> dict:
    """What the check needs from a window, taken before the program is
    freed: a sample of the served captions, and a sample of the tapped
    requests with their logits."""
    served = [(w, served_tokens(t, st.sep)) for w, t in rec.served]
    tapped = tapped_requests(st)
    st.tap.clear()
    return {"served": sample(run, served), "tapped": sample(run, tapped)}


def free(run: Run, st: CaptionState) -> None:
    for close in st.closers:
        close()
    st.closers = []
    del st.student, st.tap
    if run.on_card:
        torch.cuda.empty_cache()


@torch.no_grad()
def reference(run: Run, st: CaptionState):
    """The float32 reference student of this run's seeded weights."""
    strict_float32()
    values = program.student_values(run.config, st.values_seed, run.device)
    return Student(run.config, {k: v.float() for k, v in values.items()})


@torch.no_grad()
def reference_logits(run: Run, st: CaptionState, ref: Student,
                     chosen: List[tuple]) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """The reference's teacher-forced logits over each chosen request's
    window and served tokens: (logits ``[K, L, V]``, rows ``[K, L + 1]``)."""
    dec = run.config["decoder"]
    width = 1 + max(len(c[1]) for c in chosen)
    rows = torch.zeros((len(chosen), width), dtype=torch.long,
                       device=run.device)
    rows[:, 0] = dec["cls_token_id"]
    for j, c in enumerate(chosen):
        rows[j, 1:1 + len(c[1])] = torch.as_tensor(c[1].astype(np.int64))
    idx = torch.as_tensor([c[0] for c in chosen], device=run.device)
    memory = ref.encode_u8(st.windows[idx])
    return ref.decoder_logits(rows[:, :-1], memory), rows


def widest_gap(logits: torch.Tensor, rows: torch.Tensor,
               chosen: List[tuple]) -> float:
    """The widest gap between the best logit and the logit of the served
    token over every served position."""
    best = logits.max(dim=-1).values
    got = torch.gather(logits, -1, rows[:, 1:, None])[..., 0]
    gaps = best - got
    worst = 0.0
    for j, c in enumerate(chosen):
        if len(c[1]):
            worst = max(worst, float(gaps[j, :len(c[1])].max()))
    return worst


def head_errors(ref_logits: torch.Tensor, chosen: List[tuple],
                weight: torch.Tensor) -> Dict[str, float]:
    """The program's logits less the reference's at every served position
    of ``chosen`` (the tapped requests): ``logit_err_rms`` of the whole
    difference, and ``head_err_rms`` of what is left once the
    least-squares fit over the columns of ``weight`` ``[V, d]`` and a
    constant is taken away."""
    if any(c[2] is None for c in chosen if len(c[1])):
        log("served tokens without the logits that chose them")
        return dict.fromkeys(("logit_err_rms", "head_err_rms"),
                             float("inf"))
    prog = torch.cat([c[2].float() for c in chosen if len(c[1])])
    ref = torch.cat([ref_logits[j, :len(c[1])] for j, c in enumerate(chosen)
                     if len(c[1])])
    diff = prog.to(ref.device) - ref
    basis = torch.cat([weight.float(), torch.ones_like(weight[:, :1])], 1)
    q, _ = torch.linalg.qr(basis)
    left = diff - (diff @ q) @ q.T
    return {"logit_err_rms": float(diff.pow(2).mean().sqrt()),
            "head_err_rms": float(left.pow(2).mean().sqrt())}


def numbers(run: Run, st: CaptionState, taken: dict,
            ref: Optional[Student] = None) -> Dict[str, float]:
    """Every number the caption check can compare, by name."""
    served, tapped = taken["served"], taken["tapped"]
    out: Dict[str, float] = {}
    if not any(len(t) for _, t in served):
        log("no served tokens to check")
        return dict.fromkeys(("logit_gap", "logit_err_rms", "head_err_rms"),
                             float("inf"))
    ref = ref or reference(run, st)
    logits, rows = reference_logits(run, st, ref, served)
    out["logit_gap"] = widest_gap(logits, rows, served)
    n = sum(len(t) for _, t in served)
    log(f"checked {len(served)} served captions, {n} tokens")
    if any(len(c[1]) for c in tapped):
        logits, _ = reference_logits(run, st, ref, tapped)
        out.update(head_errors(logits, tapped, ref.p["linear.weight"]))
        n = sum(len(c[1]) for c in tapped)
        log(f"checked the logits of {len(tapped)} tapped requests, {n} "
            f"positions")
    else:
        log("the tap kept no logits")
        out.update(logit_err_rms=float("inf"), head_err_rms=float("inf"))
    return out


def check(run: Run, st: CaptionState) -> Dict[str, Tuple[float, float]]:
    taken = collect(run, st, run.records)
    free(run, st)
    return limited(run, numbers(run, st, taken))
