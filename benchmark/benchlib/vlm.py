"""What the vision-language captioner's cells share: the program's
Kimi-VL-A3B at the configuration's widths with seeded weights
(:mod:`benchlib.weights_vlm`), the seeded prompt and clip pool, the tap on
the logits its greedy decode chose from, and the check against the float32
reference (``reference/kimi_vl.py``).

The check, once the window has closed and the program is freed, takes a
sample of the served clips drawn from the seed (``check.sample``) among the
calls the tap kept, runs each clip's frames, the prompt and its served
tokens through the reference, teacher-forced, in one causal pass, its
weights drawn again a leaf at a time and upcast one layer at a time, and
the program's expert choices replayed (each MoE layer computes the experts
the program chose there, weighted by the reference's own scores: with
random weights a choice flips on rounding and a flip moves every later
layer), and compares:

- ``logit_err_ratio``: the program's logits at every served position (the
  prefill's last position, then each decode step) less the reference's,
  root mean square over that of the reference's. bfloat16 activations
  through 27 layers set it in a sound program; a wrong expert weight, a
  dropped bias, norm or scale, a cache entry at the wrong position or a
  lower-precision product raise it;
- ``logit_gap``: the widest gap between the reference's best logit and its
  logit of the served token. Greedy decoding serves the program's best,
  so a sound program's gaps are rounding; a token altered or a clip mixed
  up with another opens them;
- ``route_differ_share``: the share of (token, MoE layer) sets of chosen
  experts that differ from the reference's own choice at that point, the
  flips rounding causes; a router that drops its correction bias or
  chooses by the wrong scores raises it;
- ``route_margin``: where the program's set differs from the reference's
  own, how far the program's worst-ranked expert falls below the
  reference's k-th choice, in the scores the reference chose by (sigmoid
  plus correction bias), widest. A flip on rounding is a near tie; an
  expert chosen by the wrong scores, or at random, is not. The replay
  feeds the program's choices to the reference, so the logits alone
  cannot see a wrong choice: this and the share above are the router's
  check.

Each is compared where the cell gives it a limit, and logged otherwise.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import seeds, traffic, weights_vlm, work_vlm
from .core import Records, Run, limited, log
from .program import dtype_of

PROMPT = 7  # the seed stream of the prompt's ids
VISION_KEYS = ("image_size", "patch_size", "width", "layers", "heads", "mlp",
               "pos_grid", "merge", "rope_theta", "norm_eps")
LM_KEYS = ("vocab_size", "hidden_size", "intermediate_size",
           "moe_intermediate_size", "num_hidden_layers",
           "num_attention_heads", "n_shared_experts", "n_routed_experts",
           "num_experts_per_tok", "routed_scaling_factor", "n_group",
           "topk_group", "norm_topk_prob", "first_k_dense_replace",
           "kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim",
           "v_head_dim", "rms_norm_eps", "rope_theta",
           "max_position_embeddings", "eos_token_id")


def program_config(cfg: dict):
    """The program's ``KimiVLConfig`` of the configuration file."""
    from rtvc_tpu_torch.config import KimiVLConfig, MoonViTConfig

    return KimiVLConfig(
        vision=MoonViTConfig(**{k: cfg["vision"][k] for k in VISION_KEYS}),
        pixel_mean=tuple(cfg["pixel_mean"]), pixel_std=tuple(cfg["pixel_std"]),
        dtype=dtype_of(cfg), **{k: cfg[k] for k in LM_KEYS})


def prompt_ids(cfg: dict, seed: int) -> List[int]:
    p = cfg["prompt"]
    r = seeds.rng(seed, PROMPT)
    return [int(i) for i in r.integers(p["low"], p["high"], p["length"])]


def build(cfg: dict, seed: int, device):
    """The program's captioner with the weights of ``seed`` and its prompt.
    Imports the program's model first: a program without it fails here,
    at once."""
    from rtvc_tpu_torch.models.kimi_vl import kimi_vl_from_config

    model = kimi_vl_from_config(program_config(cfg), device=device)
    weights_vlm.fill(model, weights_vlm.param_spec(cfg),
                     seeds.sub_seed(seed, seeds.WEIGHTS))
    model.set_prompt(prompt_ids(cfg, seed), cfg["prompt"]["media_at"])
    return model


class VLMState:
    """The captioner, its clip pool and the tap of a VLM cell."""

    def __init__(self, run: Run):
        cfg = run.config
        tr = run.workload["traffic"]
        t0 = time.perf_counter()
        self.model = build(cfg, run.seed, run.device)
        log(f"set-up: captioner built in {time.perf_counter() - t0:.3f} s, "
            f"{time.perf_counter() - run.t_start:.3f} s from process start")
        self.prompt = prompt_ids(cfg, run.seed)
        self.media_at = int(cfg["prompt"]["media_at"])
        self.max_new = int(cfg["max_new_tokens"])
        self.eos = int(cfg["eos_token_id"])
        self.clips = traffic.windows(int(tr["pool"]), cfg["num_frames"],
                                     tr["frame"], run.seed, run.device)
        self.host_clips = self.clips.cpu().numpy()
        self.tap = VLMTap(self.model, run.seed,
                          int(run.workload["check"].get("keep_calls", 2)))
        self.closers: List = []
        self.server = None


class VLMTap:
    """The logits the program's greedy decode chose its tokens from, and
    the experts each MoE layer chose.

    ``prefill`` and ``decode_step`` are wrapped on the instance and each
    call's logits held by reference; while ``armed``, each call's expert
    choices of every MoE layer are copied (``last_routes``, one stack a
    call). Around each call of the caption step (:meth:`around`), the
    call's frames, rows, logits and choices are kept for ``size`` calls
    drawn from the seed (a reservoir sample), the rest let go."""

    def __init__(self, model, seed: int, size: int):
        self.size = size
        self.seen = 0
        self.rng = seeds.rng(seed, seeds.SAMPLE, 1)
        self.armed = False
        self.fresh: List[torch.Tensor] = []
        self.routes: List[torch.Tensor] = []
        self.kept: List[dict] = []
        prefill, step = model.prefill, model.decode_step

        def keep_routes():
            if self.armed:
                self.routes.append(torch.stack(model.last_routes()))

        def tapped_prefill(*args, **kwargs):
            out = prefill(*args, **kwargs)
            self.fresh.append(out[0])
            keep_routes()
            return out

        def tapped_step(*args, **kwargs):
            out = step(*args, **kwargs)
            self.fresh.append(out)
            keep_routes()
            return out

        model.prefill, model.decode_step = tapped_prefill, tapped_step

    def around(self, step: Callable) -> Callable:
        def tapped(frames):
            self.fresh, self.routes = [], []
            rows = step(frames)
            if self.armed:
                self._keep({"frames": frames, "rows": rows,
                            "logits": self.fresh, "routes": self.routes})
            self.fresh, self.routes = [], []
            return rows

        return tapped

    def _keep(self, entry: dict) -> None:
        if len(self.kept) < self.size:
            self.kept.append(entry)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.kept[j] = entry
        self.seen += 1


def served_tokens(row, eos: int) -> np.ndarray:
    """A row's generated ids up to its first EOS or pad 0."""
    row = np.asarray(row)
    stop = np.nonzero((row == eos) | (row == 0))[0]
    return row[: stop[0]] if stop.size else row


def request_flops(run: Run, tokens: int) -> float:
    """One clip: its frames, the prefill and a decode token for each
    token it served, plus the one that ended it."""
    return work_vlm.clip_flops(run.config,
                               min(tokens + 1, int(run.config
                                                   ["max_new_tokens"])))


@torch.inference_mode()
def collect(run: Run, st: VLMState) -> List[dict]:
    """A sample of the tapped rows (``check.sample``, drawn from the seed),
    each with its clip, served tokens, the logits that chose them and the
    experts chosen at each of its positions, taken before the program is
    freed."""
    rows = []
    for e in st.tap.kept:
        frames = e["frames"]
        if not torch.is_tensor(frames):
            frames = torch.from_numpy(np.asarray(frames))
        frames = frames.to(st.clips.device)
        got = e["rows"].cpu().numpy() if torch.is_tensor(e["rows"]) \
            else np.asarray(e["rows"])
        for r in range(got.shape[0]):
            hit = (st.clips == frames[r]).flatten(1).all(1).nonzero()
            if hit.numel() == 0:
                continue  # a padding row
            rows.append((e, r, int(hit[0, 0]), served_tokens(got[r], st.eos)))
    r = seeds.rng(run.seed, seeds.SAMPLE)
    picked = [rows[i] for i in
              sorted(r.permutation(len(rows))[:int(run.workload["check"]
                                                   ["sample"])])]
    out = []
    for e, r, clip, toks in picked:
        n = len(toks)
        logits = e["logits"][:n]
        whole = len(logits) == n and all(s.shape[0] > r for s in logits)
        routes = []
        if e["routes"]:
            b = e["rows"].shape[0]
            pre = e["routes"][0]                      # [layers, B·L, k]
            pre = pre.view(pre.shape[0], b, -1, pre.shape[-1])[:, r]
            steps = [s[:, r, None] for s in e["routes"][1:n]]
            routes = list(torch.cat([pre] + steps, dim=1).cpu())
        out.append({"clip": clip, "tokens": toks,
                    "logits": (torch.stack([s[r] for s in logits]).float()
                               if whole and n else None),
                    "routes": routes})
    st.tap.kept = []
    return out


def free(run: Run, st: VLMState) -> None:
    """Close the server and drop every reference to the program (the tap's
    wrappers and the model refer to each other: a collection frees them)."""
    for close in st.closers:
        close()
    st.closers = []
    st.server = None
    del st.model, st.tap
    gc.collect()
    if run.on_card:
        torch.cuda.empty_cache()


def pixels(frames_u8: torch.Tensor, cfg: dict) -> torch.Tensor:
    """uint8 BGR ``[F, H, W, 3]`` at the model's size → RGB float32,
    normalised by the processor's mean and deviation."""
    size = cfg["vision"]["image_size"]
    if tuple(frames_u8.shape[1:3]) != (size, size):
        raise ValueError(f"frames {tuple(frames_u8.shape)} are not "
                         f"{size} x {size}")
    x = (frames_u8.float() / 255.0).flip(-1)
    mean = torch.tensor(cfg["pixel_mean"], device=x.device)
    std = torch.tensor(cfg["pixel_std"], device=x.device)
    return (x - mean) / std


def reference(run: Run, seed: int, expert_round=None):
    """The float32 reference over this run's seeded weights, drawn again
    a leaf at a time as it reads them."""
    from reference.kimi_vl import KimiVLReference, strict_float32

    strict_float32()
    values = weights_vlm.LazyValues(weights_vlm.param_spec(run.config),
                                    seeds.sub_seed(seed, seeds.WEIGHTS),
                                    run.device, dtype_of(run.config))
    return KimiVLReference(run.config, values, expert_round)


@torch.no_grad()
def teacher_forced(run: Run, st: VLMState, ref, taken: List[dict]
                   ) -> List[dict]:
    """The reference's logits and expert choices over each taken row's
    clip, prompt and served tokens."""
    out = []
    for t in taken:
        if not len(t["tokens"]):
            out.append(None)
            continue
        res = ref.forward(pixels(st.clips[t["clip"]], run.config), st.prompt,
                          st.media_at, [int(i) for i in t["tokens"]],
                          routes=t["routes"] or None)
        out.append({"logits": res["logits"],
                    "routes": [r.cpu() for r in res["routes"]],
                    "scores": [s.cpu() for s in res["scores"]]})
    return out


def route_margin(routes: torch.Tensor, scores: torch.Tensor) -> float:
    """The widest fall of a set's worst-ranked expert (``routes [L, k]``)
    below the k-th best of ``scores [L, E]``; 0 where every set is the
    scores' own top k."""
    m = min(routes.shape[0], scores.shape[0])
    if not m:
        return 0.0
    s = scores[:m].float()
    kth = s.topk(routes.shape[-1], dim=-1).values[:, -1]
    worst = s.gather(1, routes[:m].long()).min(-1).values
    return max(0.0, float((kth - worst).max()))


def numbers(taken: List[dict], refs: List[Optional[dict]],
            prog_logits: Optional[List[torch.Tensor]] = None
            ) -> Dict[str, float]:
    """``logit_err_ratio``, ``logit_gap``, ``route_differ_share`` and
    ``route_margin`` of the taken rows (their logits, or ``prog_logits`` in their place, whose
    best ids then stand for the served tokens)."""
    err = ref2 = 0.0
    gap = 0.0
    differ = total = 0
    margin = 0.0
    n_pos = 0
    for j, (t, r) in enumerate(zip(taken, refs)):
        if r is None:
            continue
        logits = t["logits"] if prog_logits is None else prog_logits[j]
        if logits is None:
            log("served tokens without the logits that chose them")
            return dict.fromkeys(("logit_err_ratio", "logit_gap"),
                                 float("inf"))
        ref = r["logits"]
        logits = logits.to(ref.device)
        err += float((logits - ref).pow(2).sum())
        ref2 += float(ref.pow(2).sum())
        toks = torch.as_tensor(np.asarray(t["tokens"], np.int64),
                               device=ref.device)
        if prog_logits is not None:
            toks = logits.argmax(-1)
        got = ref.gather(1, toks[:, None])[:, 0]
        gap = max(gap, float((ref.max(-1).values - got).max()))
        n_pos += len(toks)
        for a, b in zip(t["routes"], r["routes"]):
            m = min(a.shape[0], b.shape[0])
            same = (a[:m].sort(-1).values == b[:m].sort(-1).values).all(-1)
            differ += int((~same).sum())
            total += m
        for a, s in zip(t["routes"], r.get("scores", [])):
            margin = max(margin, route_margin(a, s))
    if not n_pos:
        log("no served tokens to check")
        return dict.fromkeys(("logit_err_ratio", "logit_gap"), float("inf"))
    out = {"logit_err_ratio": (err / ref2) ** 0.5 if ref2 else float("inf"),
           "logit_gap": gap}
    if total:
        out["route_differ_share"] = differ / total
        out["route_margin"] = margin
    log(f"checked {sum(r is not None for r in refs)} served clips, {n_pos} "
        f"positions")
    return out


def check(run: Run, st: VLMState) -> Dict[str, Tuple[float, float]]:
    taken = collect(run, st)
    free(run, st)
    if not taken:
        log("the tap kept no served clip")
        return limited(run, dict.fromkeys(("logit_err_ratio", "logit_gap"),
                                          float("inf")))
    t0 = time.perf_counter()
    refs = teacher_forced(run, st, reference(run, run.seed), taken)
    log(f"reference: {time.perf_counter() - t0:.1f} s")
    return limited(run, numbers(taken, refs))


def measured(run: Run, st: VLMState, done: List[tuple], end: float,
             seconds: float, rec: Records) -> None:
    """Fill ``rec`` from the clients' results: (clip, submitted, resolved,
    tokens, ok) each."""
    rec.window_s = seconds
    rec.attempted = len(done)
    for w, t_sub, t_done, toks, ok in done:
        if not ok or toks is None:
            rec.failed += 1
            continue
        rec.latencies_s.append(t_done - t_sub)
        if t_done <= end:
            rec.completed += 1
            rec.flops += request_flops(run, len(served_tokens(toks, st.eos)))
        rec.served.append((w, np.asarray(toks, np.int64)))
    load = st.model.expert_load().double()
    if load.sum() > 0:
        rec.spans["moe_load_max_over_mean"].append(
            float((load.max(1).values / load.mean(1)).max()))
