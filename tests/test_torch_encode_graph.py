"""The student's encoder graphs (``rtvc_tpu_torch/models/encode_graph.py``).

On the CPU, on a tiny student: every case where the graphs do not apply
(CPU tensors, train mode, grad on, a compiler tracing) runs the eager body
and makes no workspace; a copy of the model starts with no workspace; a
workspace sees a moved or reassigned weight and a replaced submodule but
not an in-place update, and pins the storage it captured; with the graph
stood in, ``EncodeGraphs.run`` keeps one workspace a shape,
captures again only after a weight moved, and sends a call to the eager
body while another holds the workspace.

On the card (marked ``cuda``; skips without one), on the full-width
student in bfloat16: graphed memory and stage maps equal eager ones bit
for bit at batch 1, 2, 4 and 8; in-place ``load_state_dict`` is read
without a capture; ``.to()``, a reassigned parameter and a replaced
submodule each cause one; a call under ``no_grad`` follows one under
``inference_mode`` at the same shape; a second thread runs eager while one holds the workspace; the
kernels' launch counts read as the eager path's; ``make_caption_step``'s
rows equal those of the eager encoder; a graphed call issues a handful of
host launches. The file imports no JAX, so that it runs on the card's
machine:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_encode_graph.py
"""

import collections
import copy
import json
import os
import pickle
import threading
import time

import pytest
import torch

from rtvc_tpu_torch.config import TinyViTConfig
from rtvc_tpu_torch.models import encode_graph
from rtvc_tpu_torch.models.encode_graph import EncodeWorkspace
from rtvc_tpu_torch.models.student import StudentCandidateV1, random_init_

TINY_ENC = TinyViTConfig(embed_dims=(8, 16, 24, 32), depths=(1, 1, 1, 1),
                         num_heads=(1, 2, 2, 2), window_sizes=(4, 4, 4, 4),
                         drop_path_rate=0.0, gelu_approximate=True)


def tiny(seed: int = 0) -> StudentCandidateV1:
    model = StudentCandidateV1(
        d_model=32, n_head=4, d_ffn=64, num_decoder_layers=2,
        vocab_size=211, max_pos_len=64, encoder_config=TINY_ENC,
        input_size=224, num_frames=2, teacher_visual_dim=32,
        teacher_num_tokens=10, teacher_hidden=16)
    return random_init_(model, torch.Generator().manual_seed(seed)).eval()


def _frames(b, seed=0, size=224, frames=2, device="cpu",
            dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((b, frames, size, size, 3), generator=g) * 2 - 1
    return x.to(device, dtype)


def _counts(model):
    g = model.encode_graphs
    return g.replays, g.eager, g.captures


def _assert_same(got, want):
    """Stage maps and memory equal bit for bit, with the same strides."""
    (gmaps, gmem), (wmaps, wmem) = got, want
    assert len(gmaps) == len(wmaps) == 4
    for a, b in zip(gmaps + [gmem], wmaps + [wmem]):
        assert a.shape == b.shape and a.stride() == b.stride()
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


@pytest.fixture
def small():
    return tiny()


@pytest.mark.parametrize("why", ["cpu", "train", "grad", "compiling"])
def test_the_eager_body_runs_where_the_graphs_do_not_apply(small,
                                                           monkeypatch, why):
    frames = _frames(2)
    with torch.no_grad():
        want = small.encode_body(frames)
    if why == "compiling":
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    if why == "train":
        small.train()
    grad = torch.enable_grad() if why == "grad" else torch.no_grad()
    replays, eager, captures = _counts(small)
    with grad:
        got = small.forward_image_enc(frames)
    small.eval()
    if why == "grad":
        assert got[1].requires_grad
    if why != "train":  # train mode normalises with the batch's statistics
        for a, b in zip(got[0] + [got[1]], want[0] + [want[1]]):
            assert torch.equal(a.detach(), b)
    assert _counts(small) == (replays, eager + 1, captures)
    assert len(small.encode_graphs._workspaces) == 0


def test_channels_first_frames_take_the_same_body(small):
    frames = _frames(2, seed=3)
    with torch.inference_mode():
        want = small.forward_image_enc(frames)
        got = small.forward_image_enc(frames.permute(0, 1, 4, 2, 3))
    for a, b in zip(got[0] + [got[1]], want[0] + [want[1]]):
        assert torch.equal(a, b)


def test_a_copy_of_the_model_starts_without_workspaces(small):
    graphs = small.encode_graphs
    graphs.replays, graphs.eager, graphs.captures = 3, 2, 1
    graphs._workspaces["stand-in"] = object()
    try:
        twin = copy.deepcopy(small)
        again = pickle.loads(pickle.dumps(small))
        for other in (twin, again):
            assert other.encode_graphs is not graphs
            assert _counts(other) == (0, 0, 0)
            assert len(other.encode_graphs._workspaces) == 0
    finally:
        graphs._workspaces.clear()
    frames = _frames(1)
    with torch.inference_mode():
        _assert_same(twin.forward_image_enc(frames),
                     small.forward_image_enc(frames))


def test_a_workspace_sees_moved_and_reassigned_weights(small):
    """In place: the same addresses. A reassigned parameter, a ``.to()``
    (parameters and the float32 BatchNorm statistics it moves) and a
    reassigned buffer: new ones."""
    enc = small.image_encoder["model"]
    with torch.inference_mode():
        ws = EncodeWorkspace(_frames(1))
    assert not ws.current()  # nothing captured
    ws.graph = "stand-in"
    ws.remember(enc)
    n_tensors = len(list(enc.parameters())) + len(list(enc.buffers()))
    assert len(ws.tensors) == len(ws.addresses) == n_tensors
    assert ws.current()
    sd = {k: v + 1 if v.is_floating_point() else v
          for k, v in small.state_dict().items()}
    small.load_state_dict(sd)
    with torch.no_grad():
        enc.patch_embed.conv1.bn.running_var.mul_(2)
    assert ws.current()
    stage = enc.stages[1]["blocks"][0]
    stage.mlp.fc1.weight = torch.nn.Parameter(
        stage.mlp.fc1.weight.detach().clone())
    assert not ws.current()
    ws.remember(enc)
    captured = list(ws.addresses)
    small.double()
    assert not ws.current()
    # the captured storage stays pinned: no new tensor can take its address
    assert [t.data_ptr() for t in ws.pinned] == captured
    ws.remember(enc)
    bn = enc.patch_embed.conv2.bn
    bn.running_mean = bn.running_mean.clone()
    assert not ws.current()


def test_a_workspace_sees_a_replaced_submodule(small):
    """A submodule replaced in the tree, its weights shared or not, and a
    parameter reassigned over the same storage."""
    enc = small.image_encoder["model"]
    with torch.inference_mode():
        ws = EncodeWorkspace(_frames(1))
    ws.graph = "stand-in"
    ws.remember(enc)
    block = enc.stages[2]["blocks"][0]
    old = block.mlp
    twin = copy.deepcopy(old)
    twin.load_state_dict(old.state_dict())
    block.mlp = twin  # new weights at new addresses
    assert not ws.current()
    ws.remember(enc)
    shell = copy.copy(twin)  # a new module over the same tensors
    shell._modules = dict(twin._modules)
    block.mlp = shell
    assert not ws.current()
    ws.remember(enc)
    fc2 = shell.fc2
    fc2.weight = torch.nn.Parameter(fc2.weight.data)  # same storage
    assert not ws.current()
    ws.remember(enc)
    assert ws.current()


class _StandIn:
    """``EncodeWorkspace.capture`` / ``replay`` on the CPU: the body run
    eagerly on the static input instead of a graph, so that ``run``'s
    bookkeeping is tested without a card."""

    @staticmethod
    def capture(ws, model):
        ws.graph, ws.model = "stand-in", model
        ws.remember(model.image_encoder["model"])

    @staticmethod
    def replay(ws, x):
        with torch.inference_mode():
            ws.x.copy_(x)
            fmaps, memory = type(ws.model).encode_body(ws.model, ws.x)
        return [m.clone() for m in fmaps], memory.clone()


@pytest.fixture
def stood_in(monkeypatch):
    monkeypatch.setattr(encode_graph, "graphs_apply", lambda *a: True)
    monkeypatch.setattr(EncodeWorkspace, "capture", _StandIn.capture)
    monkeypatch.setattr(EncodeWorkspace, "replay", _StandIn.replay)


def test_run_keeps_a_workspace_a_shape_and_captures_on_a_move(small,
                                                              stood_in):
    one, two = _frames(1, seed=1), _frames(2, seed=2)
    with torch.inference_mode():
        want = {1: small.encode_body(one), 2: small.encode_body(two)}
        for x, b in ((one, 1), (two, 2), (one, 1), (two, 2)):
            _assert_same(small.forward_image_enc(x), want[b])
    assert _counts(small) == (4, 0, 2)
    assert len(small.encode_graphs._workspaces) == 2
    with torch.no_grad():  # the same shape after ``inference_mode``
        _assert_same(small.forward_image_enc(one), want[1])
    assert _counts(small) == (5, 0, 2)
    small.double()
    with torch.inference_mode():
        got = small.forward_image_enc(one)
        _assert_same(got, small.encode_body(one))
    assert got[1].dtype == torch.float64
    assert _counts(small) == (6, 0, 3)


def test_a_held_workspace_sends_a_call_to_the_eager_body(small, stood_in):
    frames = _frames(1, seed=4)
    with torch.inference_mode():
        want = small.forward_image_enc(frames)
    (ws,) = small.encode_graphs._workspaces.values()
    held, release = threading.Event(), threading.Event()

    def hold():
        with ws.lock:
            held.set()
            release.wait(60)

    t = threading.Thread(target=hold)
    t.start()
    try:
        assert held.wait(60)
        replays, eager, captures = _counts(small)
        with torch.inference_mode():
            _assert_same(small.forward_image_enc(frames), want)
        assert _counts(small) == (replays, eager + 1, captures)
    finally:
        release.set()
        t.join(60)
    assert not t.is_alive()
    with torch.inference_mode():
        _assert_same(small.forward_image_enc(frames), want)
    assert _counts(small)[0] == replays + 1


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    """The full-width student in bfloat16 on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rtvc_tpu_torch.config import cfg
    from rtvc_tpu_torch.models.student import student_from_config
    model = student_from_config(cfg, device="cpu")
    random_init_(model, torch.Generator().manual_seed(3))
    return model.to("cuda", torch.bfloat16).eval()


def _card_frames(b, seed=0):
    return _frames(b, seed=seed, frames=6, device="cuda",
                   dtype=torch.bfloat16)


def _eager(model, frames, mode=torch.inference_mode):
    """The eager body's outputs, the graphs turned off."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(encode_graph, "graphs_apply", lambda *a: False)
        with mode():
            out = model.forward_image_enc(frames)
    torch.cuda.synchronize()
    return out


def _graphed(model, frames, mode=torch.inference_mode):
    replays = model.encode_graphs.replays
    with mode():
        out = model.forward_image_enc(frames)
    torch.cuda.synchronize()
    assert model.encode_graphs.replays == replays + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 2, 4, 8])
def test_graphed_maps_and_memory_equal_eager_ones(card, batch):
    frames = _card_frames(batch, seed=batch)
    _assert_same(_graphed(card, frames), _eager(card, frames))
    captures = card.encode_graphs.captures
    other = _card_frames(batch, seed=batch + 10)
    first = _graphed(card, other)
    _assert_same(first, _eager(card, other))
    assert card.encode_graphs.captures == captures  # none after warm-up
    # the outputs are the caller's: a later replay leaves them be
    kept = [t.clone() for t in first[0] + [first[1]]]
    _graphed(card, frames)
    for a, b in zip(first[0] + [first[1]], kept):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_load_state_dict_is_read_without_a_capture(card):
    frames = _card_frames(2, seed=21)
    _graphed(card, frames)
    saved = copy.deepcopy(card.state_dict())
    try:
        g = torch.Generator().manual_seed(9)
        sd = {k: (v + 0.05 * torch.randn(v.shape, generator=g).to(v)
                  if v.is_floating_point() else v) for k, v in saved.items()}
        captures = card.encode_graphs.captures
        card.load_state_dict(sd)
        got = _graphed(card, frames)
        assert card.encode_graphs.captures == captures  # same storage
        _assert_same(got, _eager(card, frames))
    finally:
        card.load_state_dict(saved)
    _assert_same(_graphed(card, frames), _eager(card, frames))


@pytest.mark.cuda
def test_a_move_or_a_reassigned_parameter_captures_once(card):
    frames = _card_frames(2, seed=22)
    _graphed(card, frames)
    fc1 = card.image_encoder["model"].stages[2]["blocks"][0].mlp.fc1
    weight = fc1.weight
    try:
        captures = card.encode_graphs.captures
        fc1.weight = torch.nn.Parameter(weight.detach() * 1.5)
        got = _graphed(card, frames)
        assert card.encode_graphs.captures == captures + 1
        _assert_same(got, _eager(card, frames))
        card.to(torch.float32)
        got = _graphed(card, frames)
        assert card.encode_graphs.captures == captures + 2
        assert got[1].dtype == torch.float32
        _assert_same(got, _eager(card, frames))
        _graphed(card, frames)
        assert card.encode_graphs.captures == captures + 2
    finally:
        card.to(torch.bfloat16)
        fc1.weight = torch.nn.Parameter(weight.detach())
    _assert_same(_graphed(card, frames), _eager(card, frames))


@pytest.mark.cuda
def test_a_replaced_submodule_captures_once(card):
    frames = _card_frames(2, seed=24)
    want = _graphed(card, frames)
    block = card.image_encoder["model"].stages[1]["blocks"][1]
    old = block.mlp
    try:
        twin = copy.deepcopy(old)
        with torch.no_grad():
            twin.fc2.weight.mul_(1.5)
        captures = card.encode_graphs.captures
        block.mlp = twin
        got = _graphed(card, frames)
        assert card.encode_graphs.captures == captures + 1
        _assert_same(got, _eager(card, frames))
        assert not torch.equal(got[1], want[1])
        _graphed(card, frames)
        assert card.encode_graphs.captures == captures + 1
    finally:
        block.mlp = old
    _assert_same(_graphed(card, frames), want)


@pytest.mark.cuda
def test_no_grad_after_inference_mode_at_one_shape(card):
    frames = _card_frames(1, seed=23)
    want = _eager(card, frames)
    _assert_same(_graphed(card, frames, torch.inference_mode), want)
    captures = card.encode_graphs.captures
    got = _graphed(card, frames, torch.no_grad)
    _assert_same(got, want)
    assert not got[1].is_inference()
    got[1].add_(1)  # ordinary tensors: writable outside inference mode
    assert card.encode_graphs.captures == captures


@pytest.mark.cuda
def test_a_held_workspace_sends_another_thread_to_eager(card):
    frames = _card_frames(1, seed=31)
    want = _graphed(card, frames)
    key = (frames.device, frames.dtype, tuple(frames.shape), frames.stride())
    ws = card.encode_graphs._workspaces[key]
    held, release = threading.Event(), threading.Event()

    def hold():
        with ws.lock:
            held.set()
            release.wait(60)

    t = threading.Thread(target=hold)
    t.start()
    try:
        assert held.wait(60)
        replays, eager, captures = _counts(card)
        with torch.inference_mode():
            got = card.forward_image_enc(frames)
        torch.cuda.synchronize()
        _assert_same(got, want)
        assert _counts(card) == (replays, eager + 1, captures)
    finally:
        release.set()
        t.join(60)
    assert not t.is_alive()


@pytest.mark.cuda
def test_launch_counts_read_as_the_eager_paths(card):
    from rtvc_tpu_torch.ops import attention, layernorm
    frames = _card_frames(4, seed=41)

    def counted(run):
        before = (attention.window_attention.launches,
                  layernorm.layer_norm.launches)
        run(card, frames)
        after = (attention.window_attention.launches,
                 layernorm.layer_norm.launches)
        return [a - b for a, b in zip(after, before)]

    eager = counted(_eager)
    _graphed(card, frames)  # captures where the shape is new
    graphed = counted(_graphed)
    n_blocks = sum(card.image_encoder["model"].config.depths[1:])
    assert eager == graphed == [n_blocks, 2 * n_blocks]


@pytest.mark.cuda
def test_caption_rows_equal_those_of_the_eager_encoder(card):
    from rtvc_tpu_torch.serving import make_caption_step
    scaled = [card.linear.weight] + [
        layer.multihead_attn.out_proj.weight
        for layer in card.decoder["layers"]]
    saved = [w.detach().clone() for w in scaled]
    with torch.no_grad():  # rows that depend on the frames
        for w in scaled:
            w.mul_(10)
    try:
        g = torch.Generator().manual_seed(51)
        noise = torch.randint(0, 32, (8, 6, 240, 320, 3), generator=g)
        level = torch.arange(8)[:, None, None, None, None] * 28
        frames = (noise + level).to(torch.uint8).cuda()  # a brightness a row
        for beam in (0, 2):
            step = make_caption_step(card, max_len=12, beam=beam)
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(encode_graph, "graphs_apply", lambda *a: False)
                want = step(frames)
            replays = card.encode_graphs.replays
            got = step(frames)
            assert card.encode_graphs.replays == replays + 1
            assert torch.equal(got, want)
            print(f"beam {beam}: {len({tuple(r) for r in got.tolist()})} "
                  "distinct rows of 8")
    finally:
        with torch.no_grad():
            for w, keep in zip(scaled, saved):
                w.copy_(keep)


@pytest.mark.cuda
@pytest.mark.parametrize("why", ["train", "grad", "compiling"])
def test_the_gates_on_the_card(card, monkeypatch, why):
    frames = _card_frames(1, seed=61)
    _graphed(card, frames)
    workspaces = len(card.encode_graphs._workspaces)
    saved = copy.deepcopy(card.state_dict())
    if why == "compiling":
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    if why == "train":
        card.train()
    try:
        grad = torch.enable_grad() if why == "grad" else torch.no_grad()
        replays, eager, captures = _counts(card)
        with grad:
            card.forward_image_enc(frames, torch.Generator().manual_seed(0))
        assert _counts(card) == (replays, eager + 1, captures)
        assert len(card.encode_graphs._workspaces) == workspaces
    finally:
        card.eval()
        card.load_state_dict(saved)  # train mode moved the statistics


def _is_launch(name):
    """A CUDA API call that puts work on a stream."""
    return any(part in name for part in ("Launch", "Memcpy", "Memset"))


@pytest.mark.cuda
def test_a_graphed_call_issues_a_handful_of_launches(card, tmp_path):
    frames = _card_frames(1, seed=71)
    _graphed(card, frames)
    # the host's time for a graphed call, the card idle at each start,
    # before any profiler has run in the process (printed, not gated)
    times = []
    with torch.inference_mode():
        for _ in range(200):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            card.forward_image_enc(frames)
            times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    print(f"host ms a graphed b1 encode, median of 200: "
          f"{sorted(times)[100]:.4f}")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.inference_mode(), torch.profiler.record_function(
                "test.encode"):
            card.forward_image_enc(frames)
        torch.cuda.synchronize()
    path = os.path.join(str(tmp_path), "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    x = [e for e in events if e.get("ph") == "X"]
    host = [e for e in x if e.get("cat") == "user_annotation"]
    (call,) = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
               for e in host if e["name"] == "test.encode"]
    graphs = [e for e in host if e["name"] == "rtvc.encode.graph"]
    calls = [e for e in x if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and _is_launch(e["name"])
             and call[0] <= float(e["ts"]) <= call[1]]
    names = collections.Counter(e["name"] for e in calls)
    print(f"launch calls inside one graphed encode: {dict(names)}")
    assert len(graphs) == 1
    assert sum(n for name, n in names.items() if "Graph" in name) == 1
    assert len(calls) <= 8  # the input copy, the graph, five clones
