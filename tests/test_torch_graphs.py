"""What the port's CUDA-graph users share (``rtvc_tpu_torch/models/
graphs.py``), for each of the three: the student's decode
(``models/decode_graph.py``), the student's encoder
(``models/encode_graph.py``) and the vision-language model's decode
(``models/kimi_lm.py``'s ``LatentWorkspace``, kept by ``kimi_vl.py``).

On the CPU, on tiny models: a copy of the model starts without
workspaces; the check of what a user's graphs read sees a reassigned
parameter, a ``.to()``, a reassigned buffer, a replaced submodule or root
(and for the student's decode, a new ``vocab_w8`` pack), not an in-place
update, and pins the storage it captured; with the graphs stood in, a
held workspace sends a second caller to the eager body. The card tests of
each user are in its own file. The file imports no JAX.
"""

import copy
import dataclasses
import pickle
import threading
from typing import Callable

import pytest
import torch
from torch import nn

from rtvc_tpu_torch import decode, serving
from rtvc_tpu_torch.config import KimiVLConfig, MoonViTConfig, TinyViTConfig
from rtvc_tpu_torch.models import (decode_graph, encode_graph, graphs,
                                   kimi_lm, kimi_vl)
from rtvc_tpu_torch.models.graphs import Captured
from rtvc_tpu_torch.models.student import StudentCandidateV1, random_init_

TINY_ENC = TinyViTConfig(embed_dims=(8, 16, 24, 32), depths=(1, 1, 1, 1),
                         num_heads=(1, 2, 2, 2), window_sizes=(4, 4, 4, 4),
                         drop_path_rate=0.0, gelu_approximate=True)
SMALL_VLM = KimiVLConfig(
    vision=MoonViTConfig(image_size=112, width=48, layers=2, heads=4,
                         mlp=96, pos_grid=6),
    vocab_size=512, hidden_size=64, intermediate_size=96,
    moe_intermediate_size=32, num_hidden_layers=4, num_attention_heads=4,
    n_shared_experts=1, n_routed_experts=8, num_experts_per_tok=2,
    kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=16,
    v_head_dim=16, eos_token_id=7, dtype=torch.float32)
MAX_LEN = 4


def student() -> StudentCandidateV1:
    model = StudentCandidateV1(
        d_model=32, n_head=4, d_ffn=64, num_decoder_layers=2,
        vocab_size=211, max_pos_len=64, encoder_config=TINY_ENC,
        input_size=224, num_frames=2, teacher_visual_dim=32,
        teacher_num_tokens=10, teacher_hidden=16)
    model = random_init_(model, torch.Generator().manual_seed(0)).eval()
    return serving.with_vocab_w8(model)


def vlm() -> kimi_vl.KimiVLCaptioner:
    model = kimi_vl.kimi_vl_from_config(SMALL_VLM, device="cpu")
    kimi_vl.random_init_(model, torch.Generator().manual_seed(1))
    model.set_prompt(list(range(100, 108)), 4)
    return model


def frames(model, b=1):
    size = 112 if isinstance(model, kimi_vl.KimiVLCaptioner) else 224
    g = torch.Generator().manual_seed(2)
    return torch.rand((b, 2, size, size, 3), generator=g) * 2 - 1


def _student_decode(model):
    """Whether a caption's caches are a workspace's."""
    _, memory = model.encode_body(frames(model))
    with model.decode_caches(1, 1 + MAX_LEN, memory) as caches:
        return isinstance(caches, decode_graph.WorkspaceCaches)


def _student_encode(model):
    """Whether an encoder call replayed."""
    replays = model.encode_graphs.replays
    model.forward_image_enc(frames(model))
    return model.encode_graphs.replays > replays


def _vlm_prefill(model):
    """Whether a prefill took a workspace."""
    _, state = model.prefill(model.encode(frames(model)), MAX_LEN)
    state.release()
    return state.workspace is not None


@dataclasses.dataclass
class User:
    """A graph user on a tiny model: its registry, what its graphs read,
    where a parameter, a buffer, a submodule (and a child of it) and a
    root sit, a call that says whether it took a workspace, and an output
    of the model to compare copies by."""
    build: Callable
    registry: Callable
    reads: Callable
    param: Callable
    buffer: Callable
    child: Callable
    root: Callable
    take: Callable
    output: Callable


def _enc(model):
    return model.image_encoder["model"]


USERS = {
    "student_decode": User(
        build=student, registry=lambda m: m.decode_graphs,
        reads=lambda m: decode_graph.reads(m, m.vocab_w8),
        param=lambda m: (m.decoder["layers"][1].linear1, "weight"),
        buffer=lambda m: (m.pos_enc, "pe"),
        child=lambda m: (m.decoder["layers"], "0", "linear2"),
        root=lambda m: (m, "linear"),
        take=_student_decode,
        output=lambda m: decode.student_greedy(m, frames(m), MAX_LEN)),
    "student_encode": User(
        build=student, registry=lambda m: m.encode_graphs,
        reads=encode_graph.reads,
        param=lambda m: (_enc(m).stages[1]["blocks"][0].mlp.fc1, "weight"),
        buffer=lambda m: (_enc(m).patch_embed.conv2.bn, "running_mean"),
        child=lambda m: (_enc(m).stages[2]["blocks"][0], "mlp", "fc2"),
        root=lambda m: (m.image_encoder, "model"),
        take=_student_encode,
        output=lambda m: m.forward_image_enc(frames(m))[1]),
    "vlm_decode": User(
        build=vlm, registry=lambda m: m.decode_graphs,
        reads=kimi_vl.reads,
        param=lambda m: (m.language_model.layers[1].mlp.experts,
                         "gate_proj"),
        buffer=lambda m: (m.language_model.layers[2].mlp, "load"),
        child=lambda m: (m.language_model.layers[3].mlp, "shared_experts",
                         "down_proj"),
        root=lambda m: (m, "language_model"),
        take=_vlm_prefill,
        output=lambda m: decode.vlm_greedy(m, frames(m), MAX_LEN)),
}


@pytest.fixture(params=list(USERS))
def user(request):
    torch.manual_seed(0)
    return USERS[request.param]


def test_a_copy_of_the_model_starts_without_workspaces(user):
    model = user.build()
    registry = user.registry(model)
    registry.replays, registry.eager, registry.captures = 3, 2, 1
    registry._workspaces["stand-in"] = object()
    try:
        twin = copy.deepcopy(model)
        again = pickle.loads(pickle.dumps(model))
        for other in (twin, again):
            fresh = user.registry(other)
            assert fresh is not registry
            assert (fresh.replays, fresh.eager, fresh.captures) == (0, 0, 0)
            assert len(fresh._workspaces) == 0
    finally:
        registry._workspaces.clear()
    with torch.inference_mode():
        assert torch.equal(user.output(twin), user.output(model))


def _reassign(owner, name, tensor):
    if isinstance(getattr(owner, name), nn.Parameter):
        tensor = nn.Parameter(tensor, requires_grad=False)
    setattr(owner, name, tensor)


def test_the_check_sees_moved_and_reassigned_weights(user):
    """In place: the same addresses. A reassigned parameter, a new int8
    vocab pack, a ``.to()`` and a reassigned buffer: new ones."""
    model = user.build()
    roots, tensors = user.reads(model)
    seen = Captured(roots, tensors)
    under = [t for root in roots
             for t in (*root.parameters(), *root.buffers())]
    assert len(seen.tensors) == len(under) + len(tensors)
    assert seen.current(*user.reads(model))
    with torch.no_grad():
        model.load_state_dict({k: v + 1 if v.is_floating_point() else v
                               for k, v in model.state_dict().items()})
        owner, name = user.buffer(model)
        getattr(owner, name).add_(1)
    assert seen.current(*user.reads(model))
    owner, name = user.param(model)
    _reassign(owner, name, getattr(owner, name).detach().clone())
    assert not seen.current(*user.reads(model))
    if tensors:  # the student decode's int8 vocab pack
        seen = Captured(*user.reads(model))
        serving.with_vocab_w8(model)
        assert not seen.current(*user.reads(model))
    seen = Captured(*user.reads(model))
    captured = list(seen.addresses)
    model.double()
    assert not seen.current(*user.reads(model))
    # the captured storage stays pinned: no new tensor can take its address
    assert [t.data_ptr() for t in seen.pinned] == captured
    seen = Captured(*user.reads(model))
    owner, name = user.buffer(model)
    _reassign(owner, name, getattr(owner, name).clone())
    assert not seen.current(*user.reads(model))


def test_the_check_sees_a_replaced_submodule(user):
    """A submodule replaced in the tree, its weights shared or not; a
    parameter reassigned over the same storage; a root replaced."""
    model = user.build()
    seen = Captured(*user.reads(model))
    parent, name, leaf = user.child(model)
    twin = copy.deepcopy(getattr(parent, name))
    setattr(parent, name, twin)  # new weights at new addresses
    assert not seen.current(*user.reads(model))
    seen = Captured(*user.reads(model))
    shell = copy.copy(twin)  # a new module over the same tensors
    shell._modules = dict(twin._modules)
    setattr(parent, name, shell)
    assert not seen.current(*user.reads(model))
    seen = Captured(*user.reads(model))
    layer = getattr(shell, leaf)
    layer.weight = nn.Parameter(layer.weight.data)  # same storage
    assert not seen.current(*user.reads(model))
    seen = Captured(*user.reads(model))
    assert seen.current(*user.reads(model))
    owner, name = user.root(model)
    setattr(owner, name, copy.copy(getattr(owner, name)))
    assert not seen.current(*user.reads(model))


class _Capture:
    """A workspace's capture on the CPU: a stand-in graph, nothing run."""

    @staticmethod
    def capture(ws, model):
        ws.graphs, ws.model = ["stand-in"], model
        return 1

    @staticmethod
    def replay(ws, x):
        with torch.inference_mode():
            return type(ws.model).encode_body(ws.model, x)


@pytest.fixture
def stood_in(monkeypatch):
    monkeypatch.setattr(graphs, "graphs_apply", lambda *a: True)
    for cls in (decode_graph.DecodeWorkspace, encode_graph.EncodeWorkspace,
                kimi_lm.LatentWorkspace):
        monkeypatch.setattr(cls, "capture", _Capture.capture)
    monkeypatch.setattr(encode_graph.EncodeWorkspace, "replay",
                        _Capture.replay)


def test_a_held_workspace_sends_a_second_caller_to_the_eager_body(
        user, stood_in):
    model = user.build()
    with torch.inference_mode():
        assert user.take(model)
    (ws,) = user.registry(model)._workspaces.values()
    held, release = threading.Event(), threading.Event()

    def hold():
        with ws.lock:
            held.set()
            release.wait(60)

    t = threading.Thread(target=hold)
    t.start()
    try:
        assert held.wait(60)
        with torch.inference_mode():
            assert not user.take(model)
    finally:
        release.set()
        t.join(60)
    assert not t.is_alive()
    with torch.inference_mode():
        assert user.take(model)
    assert len(user.registry(model)._workspaces) == 1
