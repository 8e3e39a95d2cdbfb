#!/usr/bin/env python3
"""The readings the vision-language cell's limits are set from, on the
card:

    python benchmark/vlm_control.py --seeds 1,2,3 [--seconds 8]

For each seed, in one process: the cell's set-up, a short window of its
own traffic, a second window with a fault planted in the program (every
MoE layer's correction bias zeroed: the router chooses by the raw
scores), then, with the program freed, the float32 reference
teacher-forced over the sampled served clips of each window
(``benchlib.vlm``), and the reference again with its routed experts'
weights rounded to fp8 (e4m3, one scale a stacked tensor:
``reference.common.Precision``), a precision below the configuration's
bfloat16, put in the program's place. Three faults are then planted in
what the first window served, each checked as a run checks its own:
a served token altered (:func:`token_altered`), each row put on another
clip (:func:`clip_swapped`) and a share of the expert choices replaced at
random (:func:`experts_wrong`). One JSON line a seed and reading, each
judged against the cell's limits as a run judges its own. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
for path in (os.path.dirname(HERE), HERE):
    if path not in sys.path:
        sys.path.insert(0, path)

from benchlib import core, vlm  # noqa: E402

CELL = "kimivl-video16-archive-closed16"
WRONG_SHARE = 0.03  # of (token, MoE layer) pairs, :func:`experts_wrong`


def token_altered(taken: List[dict], vocab: int) -> List[dict]:
    """Each row with its third served token (its last, if shorter) moved
    by one, as a step that alters a token after choosing it would serve."""
    out = []
    for t in taken:
        toks = np.array(t["tokens"], np.int64)
        if len(toks):
            i = min(2, len(toks) - 1)
            toks[i] = (toks[i] + 1) % vocab
        out.append(dict(t, tokens=toks))
    return out


def clip_swapped(taken: List[dict], pool: int) -> List[dict]:
    """Each row's tokens, logits and choices put on another clip: the next
    row's, or the pool's next where the two share one."""
    out = []
    for j, t in enumerate(taken):
        other = taken[(j + 1) % len(taken)]["clip"]
        out.append(dict(t, clip=other if other != t["clip"]
                        else (t["clip"] + 1) % pool))
    return out


def experts_wrong(taken: List[dict], experts: int, share: float,
                  seed: int) -> List[dict]:
    """On ``share`` of each row's (token, MoE layer) pairs, drawn from
    ``seed``, the last of the program's chosen experts replaced by one it
    did not choose, drawn at random."""
    g = torch.Generator().manual_seed(seed % 2 ** 63)
    out = []
    for t in taken:
        routes = []
        for r in t["routes"]:
            r = r.clone()
            hit = torch.rand(r.shape[0], generator=g) < share
            for i in hit.nonzero()[:, 0].tolist():
                chosen = set(r[i].tolist())
                free = [e for e in range(experts) if e not in chosen]
                r[i, -1] = free[int(torch.randint(len(free), (1,),
                                                  generator=g))]
            routes.append(r)
        out.append(dict(t, routes=routes))
    return out


def readings(run: core.Run, seconds: float):
    from reference.common import Precision

    driver = run.module("drivers", run.workload["driver"])
    st = driver.setup(run)
    rec = core.Records()
    driver.measure(run, st, seconds, rec)
    taken = vlm.collect(run, st)
    with torch.no_grad():
        for m in st.model.moe_layers():
            m.gate.e_score_correction_bias.zero_()
    driver.measure(run, st, seconds, core.Records())
    faulty = vlm.collect(run, st)
    vlm.free(run, st)
    ref = vlm.reference(run, run.seed)
    refs = vlm.teacher_forced(run, st, ref, taken)
    fault_refs = vlm.teacher_forced(run, st, ref, faulty)
    fp8 = vlm.teacher_forced(
        run, st, vlm.reference(run, run.seed, Precision("fp8")), taken)
    control = [dict(t, routes=f["routes"]) if f else t
               for t, f in zip(taken, fp8)]
    planted = {
        "fault_token_altered": token_altered(
            taken, int(run.config["vocab_size"])),
        "fault_clip_swapped": clip_swapped(
            taken, int(run.workload["traffic"]["pool"])),
        "fault_experts_wrong": experts_wrong(
            taken, int(run.config["n_routed_experts"]), WRONG_SHARE,
            run.seed)}
    planted = {k: vlm.numbers(v, vlm.teacher_forced(run, st, ref, v))
               for k, v in planted.items()}
    for name, values in (
            ("program", vlm.numbers(taken, refs)),
            ("control_fp8_experts", vlm.numbers(
                control, refs, [f["logits"] if f else None for f in fp8])),
            ("fault_no_correction_bias", vlm.numbers(faulty, fault_refs)),
            *planted.items()):
        checks = core.limited(run, values)
        yield dict(reading=name, correct=core.judge(checks),
                   clips=rec.completed, **values)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    a = p.parse_args()
    if not torch.cuda.is_available():
        core.log("vlm_control.py runs on a card")
        return 3
    for s in (int(x) for x in a.seeds.split(",")):
        t0 = time.perf_counter()
        run = core.Run(CELL, s, a.seconds, False, torch.device("cuda", 0),
                       time.perf_counter())
        for line in readings(run, a.seconds):
            print(json.dumps(dict(workload=CELL, seed=s, **line)),
                  flush=True)
        core.log(f"seed {s}: {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
