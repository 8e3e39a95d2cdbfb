"""The vision-language captioner's cell on the CPU at a tiny size: the
clip pool and the prompt are fixed by the seed; the operation counts
against values worked out by hand; the benchmark's reference copy against
the program's; the cell, its driver and metrics run from their files
alone, correct; the lower-precision reference put in the program's place
is found not correct, and so are a router that ignores its correction
bias and the faults ``vlm_control.py`` plants in what was served."""

import copy
import dataclasses
import json
import math
from pathlib import Path

import pytest
import torch

import tiny
from benchlib import core, traffic, vlm, weights_vlm, work_vlm
from benchlib.trace import Trace
from reference import kimi_vl as ref_copy

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
KIMI = json.loads((CONFIGS / "kimi-vl-a3b-video16.json").read_text())

TINY_VLM = {
    "name": "tiny-vlm", "source": "test", "dtype": "float32",
    "vocab_size": 512, "max_position_embeddings": 4096, "hidden_size": 64,
    "intermediate_size": 96, "moe_intermediate_size": 32,
    "num_hidden_layers": 4, "num_attention_heads": 4, "n_shared_experts": 1,
    "n_routed_experts": 8, "num_experts_per_tok": 2,
    "routed_scaling_factor": 2.446, "n_group": 1, "topk_group": 1,
    "norm_topk_prob": True, "first_k_dense_replace": 1, "kv_lora_rank": 32,
    "qk_nope_head_dim": 16, "qk_rope_head_dim": 16, "v_head_dim": 16,
    "rms_norm_eps": 1e-5, "rope_theta": 800000.0,
    "vision": {"image_size": 112, "patch_size": 14, "width": 48,
               "layers": 2, "heads": 4, "mlp": 96, "pos_grid": 6,
               "merge": 2, "rope_theta": 10000.0, "norm_eps": 1e-5},
    "num_frames": 2, "max_new_tokens": 4, "decode": "greedy",
    "prompt": {"length": 4, "media_at": 2, "low": 10, "high": 500},
    "eos_token_id": 7,
    "pixel_mean": [0.5, 0.5, 0.5], "pixel_std": [0.5, 0.5, 0.5]}

VLM_CELL = {"config": "tiny-vlm", "driver": "vlm_server_closed",
            "traffic": {"loop": "closed", "clients": 4, "pool": 5,
                        "frame": [112, 112, 3], "max_batch": 2,
                        "max_wait_ms": 2.0, "buckets": [1, 2]},
            "trace_seconds": 0.5,
            # float32 on both sides: the program reassociates
            "check": {"sample": 2, "keep_calls": 2,
                      "limits": {"logit_err_ratio": 1e-4,
                                 "logit_gap": 1e-3,
                                 "route_differ_share": 0.01,
                                 "route_margin": 1e-3}}}

VLM_METRICS = ["vlm_vision_ms.throughput", "vlm_prefill_ms.throughput",
               "vlm_decode_ms_per_token.throughput",
               "moe_prefill_roofline_pct.throughput",
               "mla_decode_roofline_pct.throughput",
               "moe_load_max_over_mean.throughput"]


@pytest.fixture
def bench(tmp_path):
    torch.set_num_threads(2)
    wl = dict(tiny.WORKLOADS, **{"tiny-vlm-archive": VLM_CELL})
    cfgs = {"tiny-student": tiny.STUDENT, "tiny-distill": tiny.TEACHER,
            "tiny-vlm": TINY_VLM}
    b = tiny.layout(tmp_path, workloads=wl, configs=cfgs)
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    for m in spec["end_to_end"]:
        if m["name"] == "caption_windows_per_s":
            m["workloads"].append("tiny-vlm-archive")
    spec["per_layer"] = [
        {"name": n, "unit": "x", "better": "lower", "source": "device_trace",
         "layer": "l", "moves": "caption_windows_per_s",
         "workloads": ["tiny-vlm-archive"]} for n in VLM_METRICS]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return b


def test_pool_and_prompt_fixed_by_the_seed():
    a = traffic.windows(3, 2, (112, 112), 5, "cpu")
    assert torch.equal(a, traffic.windows(3, 2, (112, 112), 5, "cpu"))
    assert not torch.equal(a, traffic.windows(3, 2, (112, 112), 6, "cpu"))
    p = vlm.prompt_ids(KIMI, 2 ** 40 + 3)
    assert p == vlm.prompt_ids(KIMI, 2 ** 40 + 3)
    assert p != vlm.prompt_ids(KIMI, 2 ** 40 + 4)
    assert len(p) == 16 and all(1000 <= i < 163584 for i in p)


def test_weights_drawn_a_leaf_at_a_time_are_fixed_by_the_seed():
    spec = weights_vlm.param_spec(TINY_VLM)
    lazy = weights_vlm.LazyValues(spec, 11, "cpu", torch.float32)
    name = "language_model.layers.2.mlp.experts.up_proj"
    assert torch.equal(lazy[name], lazy[name])
    other = weights_vlm.LazyValues(spec, 12, "cpu", torch.float32)
    assert not torch.equal(lazy[name], other[name])
    bias = lazy["language_model.layers.1.mlp.gate.e_score_correction_bias"]
    assert 0.02 < float(bias.std()) < 0.3 and abs(float(bias.mean())) < 0.1
    norm = lazy["language_model.layers.1.input_layernorm.weight"]
    assert abs(float(norm.mean()) - 1.0) < 0.1
    stack = lazy[name]
    assert float(stack.std()) == pytest.approx(64 ** -0.5, rel=0.1)


def test_parameter_count_at_the_published_widths():
    n = sum(math.prod(s) for _, s in weights_vlm.param_spec(KIMI))
    assert 16.3e9 < n < 16.5e9


def test_moonvit_block_by_hand():
    # one 448-px frame: 1024 patches, width 1152, MLP 4304
    #   qkv 1024*1152*3456 = 4,076,863,488; Q.K and P.V 2*1024^2*1152 =
    #   2,415,919,104; wo 1024*1152^2 = 1,358,954,496; MLP 2*1024*1152*4304
    #   = 10,154,409,984 -> 18,006,147,072 MACs
    assert work_vlm.moonvit_block_flops(KIMI) == 2 * 18_006_147_072


def test_moe_layer_at_12_tokens_by_hand():
    # a token: router 2048*64 = 131,072; six experts 6*3*2048*1408 =
    #   51,904,512; shared 3*2048*2816 = 17,301,504 -> 69,337,088 MACs
    assert work_vlm.moe_layer_flops(KIMI, 12) == 2 * 12 * 69_337_088


def test_decode_token_by_hand():
    # attending 4113 cache rows, a layer: q 2048*3072 = 6,291,456, [c, k_pe]
    #   2048*576 = 1,179,648, o 2048*2048 = 4,194,304 (kv_b absorbed:
    #   16*(128*512 + 4113*(576 + 512) + 512*128) = 73,696,256)
    #   -> 85,361,664; 27 layers 2,304,764,928; the dense MLP 3*2048*11264
    #   = 69,206,016 + 26 MoE MLPs 26*69,337,088 = 1,871,970,304; the head
    #   2048*163840 = 335,544,320 -> 4,512,279,552 MACs
    assert work_vlm.decode_token_flops(KIMI, 4113) == 2 * 4_512_279_552


def test_clip_work_near_the_estimate():
    assert work_vlm.prompt_length(KIMI) == 16 * 256 + 16
    frames = 128 * work_vlm.frame_flops(KIMI)
    assert 120e12 < frames < 130e12
    assert 140e12 < 8 * work_vlm.prefill_flops(KIMI, 4112) < 175e12


def test_kernel_bounds_by_hand():
    # 197,376 pairs (32,896 tokens x 6) through [64, 2048, 1408]
    b, f = work_vlm.grouped_mm_work([197376, 2048], [64, 2048, 1408])
    assert f == 2 * 197376 * 2048 * 1408
    assert b == 2 * (197376 * 2048 + 64 * 2048 * 1408 + 197376 * 1408)
    b, f = work_vlm.mla_decode_work(KIMI, 8, 4113)
    assert b == 2 * (13_762_560 + 8 * 4113 * 576 + 2 * 8 * 2048)


def test_reference_copy_equals_the_programs_reference():
    from rtvc_tpu_torch.config import KimiVLConfig, MoonViTConfig
    from rtvc_tpu_torch.models import kimi_vl_reference as repo_ref

    assert Path(ref_copy.__file__).read_text() == \
        Path(repo_ref.__file__).read_text()
    cfg = {k: v for k, v in TINY_VLM.items()}
    spec = weights_vlm.param_spec(cfg)
    values = dict(weights_vlm.draws(spec, 3, "cpu", torch.float32))
    pixels = torch.randn(2, 112, 112, 3,
                         generator=torch.Generator().manual_seed(1))
    a = ref_copy.KimiVLReference(cfg, values).forward(pixels, [20, 30, 40],
                                                      1, [5, 6, 7])
    b = repo_ref.KimiVLReference(cfg, values).forward(pixels, [20, 30, 40],
                                                      1, [5, 6, 7])
    assert torch.equal(a["logits"], b["logits"])
    assert vlm.program_config(TINY_VLM) == dataclasses.replace(
        KimiVLConfig(vision=MoonViTConfig(**TINY_VLM["vision"])),
        **{k: TINY_VLM[k] for k in vlm.LM_KEYS}, dtype=torch.float32)


def test_vlm_cell_runs_from_its_files_and_is_correct(bench):
    out = core.execute(tiny.run(bench, "tiny-vlm-archive", seconds=1.0))
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"setup_s", "caption_windows_per_s"}
    run = tiny.run(bench, "tiny-vlm-archive", seconds=1.0, trace=True)
    out = core.execute(run)
    assert out["correct"] is True, out["checks"]
    # no kernels on the CPU: the device readers report nothing; the
    # counter does
    assert set(out["metrics"]) == {"moe_load_max_over_mean.throughput"}
    assert out["metrics"]["moe_load_max_over_mean.throughput"]["value"] >= 1


def test_vlm_check_finds_a_lower_precision_reference(bench):
    run = tiny.run(bench, "tiny-vlm-archive", seconds=0.8)
    driver = run.module("drivers", "vlm_server_closed")
    st = driver.setup(run)
    rec = core.Records()
    driver.measure(run, st, 0.8, rec)
    taken = vlm.collect(run, st)
    with torch.no_grad():  # a router that ignores its correction bias
        for m in st.model.moe_layers():
            m.gate.e_score_correction_bias.zero_()
    driver.measure(run, st, 0.8, core.Records())
    faulty = vlm.collect(run, st)
    vlm.free(run, st)
    ref = vlm.reference(run, run.seed)
    refs = vlm.teacher_forced(run, st, ref, taken)
    fault = vlm.numbers(faulty, vlm.teacher_forced(run, st, ref, faulty))
    assert fault["route_differ_share"] > 0.05
    assert not core.judge(core.limited(run, fault))
    from reference.common import Precision
    fp8 = vlm.teacher_forced(run, st, vlm.reference(run, run.seed,
                                                    Precision("fp8")), taken)
    good = vlm.numbers(taken, refs)
    assert good["route_differ_share"] == 0.0
    bad = vlm.numbers(taken, refs, [r["logits"] for r in fp8])
    lim = VLM_CELL["check"]["limits"]
    assert core.judge(core.limited(run, good))
    assert not core.judge(core.limited(run, bad))
    assert bad["logit_err_ratio"] > 100 * good["logit_err_ratio"]
    assert good["logit_err_ratio"] < lim["logit_err_ratio"]


def test_vlm_readers_on_a_synthetic_trace(bench):
    run = tiny.run(bench, "tiny-vlm-archive")
    run.config = copy.deepcopy(KIMI)

    def ev(cat, name, ts, dur, tid=1, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "tid": tid, "args": args}

    def kernel(ts, dur, corr):
        return {"ph": "X", "cat": "kernel", "name": "k", "ts": ts,
                "dur": dur, "args": {"correlation": corr}}

    events = [
        ev("user_annotation", "bench::slice", 0, 10_000),
        ev("user_annotation", "rtvc.vlm.prefill", 10, 4000),
        ev("user_annotation", "rtvc.vlm.experts", 100, 500),
        ev("cpu_op", "aten::_grouped_mm", 110, 10,
           **{"Input Dims": [[197376, 2048], [64, 2048, 1408], [64]]}),
        ev("cuda_runtime", "cudaLaunchKernel", 115, 1, correlation=1),
        kernel(200, 2000, 1),
        ev("user_annotation", "rtvc.serve.batch", 1, 9000),
        ev("user_annotation", "rtvc.serve.row", 2, 1),
        ev("user_annotation", "rtvc.serve.row", 4, 1),
        ev("user_annotation", "rtvc.serve.row", 6, 1),
        ev("user_annotation", "rtvc.decode.token", 5000, 1000),
        ev("user_annotation", "rtvc.vlm.mla_decode", 5010, 100),
        ev("cuda_runtime", "cudaGraphLaunch", 5030, 1, correlation=2),
        kernel(5100, 40, 2),
        ev("cuda_runtime", "cudaLaunchKernel", 5500, 1, correlation=3),
        kernel(5600, 60, 3)]
    run.trace_data = Trace(events)
    read = {n: run.module("metrics", n).read(run) for n in VLM_METRICS}
    assert read["vlm_prefill_ms.throughput"] == pytest.approx(2.0)
    assert read["vlm_decode_ms_per_token.throughput"] == pytest.approx(0.1)
    assert read["vlm_vision_ms.throughput"] is None
    b, f = work_vlm.grouped_mm_work([197376, 2048], [64, 2048, 1408])
    bound = max(b / 3.35e12, f / 989e12)
    assert read["moe_prefill_roofline_pct.throughput"] == \
        pytest.approx(100 * bound / 2e-3)
    # three rows padded to the bucket of 4 (the tiny cell's buckets are
    # 1 and 2: the largest serves); the whole cache, 4112 + 64 slots
    b, f = work_vlm.mla_decode_work(KIMI, 2, 4176)
    assert read["mla_decode_roofline_pct.throughput"] == \
        pytest.approx(100 * max(b / 3.35e12, f / 989e12) / 40e-6)
    assert read["moe_load_max_over_mean.throughput"] is None


def test_route_margin_by_hand():
    scores = torch.tensor([[0.9, 0.5, 0.4, 0.1],
                           [0.2, 0.8, 0.7, 0.6]])
    # the scores' own top 2: margin 0
    assert vlm.route_margin(torch.tensor([[1, 0], [2, 1]]), scores) == 0.0
    # row 0 took expert 3 (0.1) for its second (0.5): 0.4; row 1 took
    # expert 3 (0.6) for expert 2 (0.7): 0.1
    assert vlm.route_margin(torch.tensor([[0, 3], [1, 3]]), scores) == \
        pytest.approx(0.4)
    assert vlm.route_margin(torch.tensor([[0, 1], [3, 1]]), scores) == \
        pytest.approx(0.1)
    assert vlm.route_margin(torch.zeros(0, 2, dtype=torch.long),
                            scores) == 0.0


def _planted(run, taken, name):
    import vlm_control

    if name == "token_altered":
        return vlm_control.token_altered(taken, TINY_VLM["vocab_size"])
    if name == "clip_swapped":
        return vlm_control.clip_swapped(taken, VLM_CELL["traffic"]["pool"])
    return vlm_control.experts_wrong(taken, TINY_VLM["n_routed_experts"],
                                     0.3, run.seed)


@pytest.mark.parametrize("fault", ["token_altered", "clip_swapped",
                                   "experts_wrong"])
def test_vlm_check_finds_planted_faults(bench, fault):
    run = tiny.run(bench, "tiny-vlm-archive", seconds=0.8)
    driver = run.module("drivers", "vlm_server_closed")
    st = driver.setup(run)
    driver.measure(run, st, 0.8, core.Records())
    taken = vlm.collect(run, st)
    vlm.free(run, st)
    ref = vlm.reference(run, run.seed)
    good = vlm.numbers(taken, vlm.teacher_forced(run, st, ref, taken))
    assert core.judge(core.limited(run, good)), good
    bad = _planted(run, taken, fault)
    read = vlm.numbers(bad, vlm.teacher_forced(run, st, ref, bad))
    assert not core.judge(core.limited(run, read)), read
    if fault == "token_altered":
        assert read["logit_gap"] > 1e3 * max(good["logit_gap"], 1e-6)
    if fault == "experts_wrong":
        assert read["route_margin"] > 0.01
