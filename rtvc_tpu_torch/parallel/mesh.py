"""The device mesh and its collectives, on ``torch.distributed``.

Counterpart of ``rtvc_tpu/parallel/mesh.py``. JAX builds one
``jax.sharding.Mesh`` in a single controller and XLA inserts every
collective. Here each rank is a process; :func:`make_mesh` lays the ranks
of the process group out as a ``(dp, tp)`` grid (tp fastest, as JAX
reshapes its device list) and builds a process group along each axis, and
every collective is written out:

- ``dp``: batch data parallelism. Each rank holds its rows of the global
  batch (:func:`shard_batch`); the train step sums the float32 gradients
  over dp in one flat all-reduce; TinyViT's BatchNorm normalises with the
  global batch's statistics and the ce loss divides by the global count
  of valid tokens, so that a dp step computes what one rank computes on
  the whole batch;
- ``tp``: the vocab dimension of the student's projection and embedding
  and of the teacher's textual output head and word embeddings is split
  over tp (:data:`TP_RULES` on the state-dict names). :func:`place_params`
  swaps those modules for :class:`VocabParallelLinear` (local logits, then
  an all-gather over tp whose gradient is the local slice) and
  :class:`VocabParallelEmbedding` (ids outside the shard masked, a local
  look-up, a sum over tp); the other parameters are replicated. With
  tp = 1 nothing is split.

Tensors stay plain tensors, not DTensors: the port's kernels launch on
``data_ptr()``. The collectives take either backend. Gloo carries CUDA
tensors for all-reduce and broadcast; its all-gather is written here as
an all-reduce of a zero-filled ``[n, ...]`` buffer (exact: every element
is one rank's value plus zeros), NCCL's is used as it is.

Without a process group (or with ``devices`` given) the mesh is local:
its dp axis lists devices of this process, :func:`replicate` makes one
copy per device and :func:`shard_batch` one chunk per device. Only the
data-parallel caption server uses it (``serving.BatchCaptionServer``).
"""

from __future__ import annotations

import collections
import copy
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .multihost import rank_device

PyTree = Any
Spec = Tuple[Optional[str], ...]

# state-dict name → the spec of the weight's axes (torch's layout: a
# Linear's weight is [out, in], so JAX's P(None, "tp") on a [d, V] kernel
# is a split of dim 0 here)
TP_RULES: Tuple[Tuple[str, Spec], ...] = (
    # student vocab projection [vocab, d_model] → shard vocab over tp
    (r"(.*\.)?linear\.weight$", ("tp", None)),
    (r"(.*\.)?linear\.bias$", ("tp",)),
    # embedding tables [vocab, d_model] → shard vocab over tp
    (r"(.*\.)?embed\.weight$", ("tp", None)),
    # teacher textual output head + word embeddings
    (r"(.*\.)?textual\.output\.weight$", ("tp", None)),
    (r"(.*\.)?textual\.output\.bias$", ("tp",)),
    (r"(.*\.)?textual\.embedding\.words\.weight$", ("tp", None)),
)


class Mesh:
    """A named grid of ranks (or, locally, of devices).

    ``shape`` maps axis name → size, in order; ``device`` is where this
    rank computes; ``index(axis)`` is its coordinate and ``group(axis)``
    the process group of the ranks that differ from it only along
    ``axis`` (None where that axis has size 1 or the mesh is local).
    ``devices`` is the local grid (local meshes only)."""

    def __init__(self, shape: "collections.OrderedDict[str, int]",
                 device: torch.device, coords: Dict[str, int],
                 groups: Dict[str, Any], devices: Optional[np.ndarray],
                 distributed: bool):
        self.shape = shape
        self.device = device
        self._coords = coords
        self._groups = groups
        self.devices = devices
        self.distributed = distributed

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    def index(self, axis: str) -> int:
        return self._coords.get(axis, 0)

    def group(self, axis: str):
        return self._groups.get(axis)

    @property
    def dp_devices(self) -> List[torch.device]:
        """A local mesh's devices along dp (at tp index 0)."""
        grid = self.devices.reshape(self.shape.get("dp", 1), -1)
        return list(grid[:, 0])

    def __repr__(self) -> str:
        kind = "ranks" if self.distributed else "devices"
        return (f"Mesh({dict(self.shape)}, {kind}, device={self.device}, "
                f"coords={self._coords})")


def _resolve(mesh_shape: Sequence[int], n: int) -> List[int]:
    shape = list(mesh_shape)
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1]))
        shape[shape.index(-1)] = n // known
    return shape


def _local_devices() -> List[torch.device]:
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_mesh(mesh_shape: Sequence[int] = (-1, 1),
              axes: Sequence[str] = ("dp", "tp"),
              devices: Optional[Sequence[Any]] = None) -> Mesh:
    """Build a mesh; -1 = all remaining.

    Inside a process group of more than one rank (and without
    ``devices``) the mesh spans the group's ranks, which must fill it:
    rank r sits at the row-major coordinate of r, and a process group is
    made along each axis of size > 1 (every rank makes every group, as
    ``torch.distributed.new_group`` requires). Otherwise the mesh spans
    ``devices`` (default: this machine's cards, or the CPU), the first
    ``prod(shape)`` of them, as JAX takes them."""
    axes = tuple(axes)
    grouped = (devices is None and dist.is_initialized()
               and dist.get_world_size() > 1)
    if not grouped:
        devs = [torch.device(d) for d in (devices if devices is not None
                                          else _local_devices())]
        shape = _resolve(mesh_shape, len(devs))
        n = int(np.prod(shape))
        if n < 1 or n > len(devs):
            raise ValueError(f"mesh shape {tuple(mesh_shape)} does not fit "
                             f"{len(devs)} devices")
        grid = np.empty(n, dtype=object)
        grid[:] = devs[:n]
        return Mesh(collections.OrderedDict(zip(axes, shape)), devs[0],
                    {a: 0 for a in axes}, {}, grid.reshape(shape), False)
    world, rank = dist.get_world_size(), dist.get_rank()
    shape = _resolve(mesh_shape, world)
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {tuple(mesh_shape)} -> {tuple(shape)} "
                         f"does not fill the {world} ranks of the process "
                         f"group")
    ranks = np.arange(world).reshape(shape)
    coords = dict(zip(axes, (int(c) for c in np.unravel_index(rank, shape))))
    groups = {}
    for i, axis in enumerate(axes):
        if shape[i] == 1:
            continue
        rows = np.moveaxis(ranks, i, -1).reshape(-1, shape[i])
        for row in rows:
            g = dist.new_group([int(r) for r in row])
            if rank in row:
                groups[axis] = g
    return Mesh(collections.OrderedDict(zip(axes, shape)), rank_device(),
                coords, groups, None, True)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group``, in place; a no-op without one."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim``, in group-rank order
    (NCCL's all-gather; over gloo an all-reduce of a zero-filled buffer,
    which gloo carries for CUDA tensors too); ``t`` itself without a
    group. A group of one rank runs the collective."""
    if group is None:
        return t
    n = group_size(group)
    t = t.contiguous()
    if dist.get_backend(group) == "nccl":
        buf = torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                          device=t.device)
        dist.all_gather_into_tensor(buf, t, group=group)
    else:
        buf = torch.zeros((n,) + tuple(t.shape), dtype=t.dtype,
                          device=t.device)
        buf[dist.get_group_rank(group, dist.get_rank())] = t
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return torch.cat(buf.unbind(0), dim=dim)


def broadcast_(t: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """``t`` from the group's rank ``src`` to the others, in place."""
    if group is not None:
        dist.broadcast(t, src=dist.get_global_rank(group, src), group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    """A sum over the group whose result every rank uses: the gradient of
    each rank's part is the sum of the ranks' gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the backward sums the ranks' gradients (the input
    of a layer whose output each rank computes a part of)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """Sum over the group forward; identity backward (each rank's part
    reaches the output once, and every rank holds the whole gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    """All-gather along the last dim forward; the backward keeps this
    rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.width = x.shape[-1]
        return all_gather(x, group, dim=x.dim() - 1)

    @staticmethod
    def backward(ctx, g):
        i = dist.get_group_rank(ctx.group, dist.get_rank())
        return g[..., i * ctx.width:(i + 1) * ctx.width].contiguous(), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``x`` over ``group`` (identity without one)."""
    return x if group is None else _AllReduceSum.apply(x, group)


# ---------------------------------------------------------------------------
# vocab-parallel layers
# ---------------------------------------------------------------------------

class VocabParallelLinear(nn.Module):
    """``nn.Linear(d, V)`` with rows ``[start, start + V/tp)`` of its weight
    and bias on this rank: local logits, all-gathered over tp along the
    vocab (the full ``[..., V]`` on every rank)."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor],
                 group, start: int, full: int):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.bias = None if bias is None else nn.Parameter(bias)
        self.group, self.start, self.full = group, start, full
        self.out_features, self.in_features = full, weight.shape[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _CopyToGroup.apply(x, self.group)
        return _GatherFromGroup.apply(F.linear(x, self.weight, self.bias),
                                      self.group)


class VocabParallelEmbedding(nn.Module):
    """``nn.Embedding(V, d)`` with rows ``[start, start + V/tp)`` on this
    rank: ids outside them look up zeros, and the ranks' rows are summed
    over tp."""

    def __init__(self, weight: torch.Tensor, group, start: int, full: int):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.group, self.start, self.full = group, start, full
        self.num_embeddings, self.embedding_dim = full, weight.shape[1]

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        local = ids - self.start
        inside = (local >= 0) & (local < self.weight.shape[0])
        out = F.embedding(torch.where(inside, local, 0), self.weight)
        out = out.masked_fill(~inside[..., None], 0)
        return _ReduceFromGroup.apply(out, self.group)


def full_module(mod: nn.Module) -> nn.Module:
    """The plain ``nn.Linear`` / ``nn.Embedding`` of a vocab-parallel
    module, its rows gathered over tp (every rank of the group calls)."""
    w = all_gather(mod.weight.detach(), mod.group)
    if isinstance(mod, VocabParallelEmbedding):
        out = nn.Embedding(mod.full, w.shape[1], device=w.device,
                           dtype=w.dtype)
        out.weight.data.copy_(w)
        return out
    out = nn.Linear(w.shape[1], mod.full, bias=mod.bias is not None,
                    device=w.device, dtype=w.dtype)
    out.weight.data.copy_(w)
    if mod.bias is not None:
        out.bias.data.copy_(all_gather(mod.bias.detach(), mod.group))
    return out


# ---------------------------------------------------------------------------
# shardings and placement
# ---------------------------------------------------------------------------

def _names(params) -> List[str]:
    if isinstance(params, nn.Module):
        return [n for n, _ in params.named_parameters()]
    return list(params)


def param_shardings(params, mesh: Mesh) -> Dict[str, Spec]:
    """Each parameter's spec (a tuple of mesh axes per dim; ``()`` =
    replicated) by state-dict name, for a module or a state dict: the tp
    rules above where the mesh has tp > 1, replicated otherwise."""
    tp = mesh.shape.get("tp", 1) > 1

    def spec_for(name: str) -> Spec:
        if tp:
            for pattern, spec in TP_RULES:
                if re.match(pattern, name):
                    return spec
        return ()

    return {name: spec_for(name) for name in _names(params)}


def data_parallel_shardings(mesh: Mesh, batch_example: PyTree) -> PyTree:
    """A spec per leaf of a batch: leading axis over ``dp``."""
    def spec(x):
        return ("dp",) + (None,) * (np.ndim(x) - 1)
    return _tree_map(spec, batch_example)


def _owner(model: nn.Module, name: str) -> Tuple[nn.Module, str, str]:
    """(the parent of the module holding parameter ``name``, that
    module's attribute name, the parameter's)."""
    *path, pname = name.split(".")
    parent = model
    for part in path[:-1]:
        parent = getattr(parent, part) if not part.isdigit() \
            else parent[int(part)]
    return parent, path[-1], pname


def _set_child(parent: nn.Module, attr: str, child: nn.Module) -> None:
    if attr.isdigit():
        parent[int(attr)] = child
    else:
        setattr(parent, attr, child)


@torch.no_grad()
def place_params(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Place ``model`` on ``mesh``, in place, and return it: with tp > 1
    each module whose weight a tp rule names becomes its vocab-parallel
    counterpart holding this rank's rows (the vocab must divide by tp, as
    JAX's ``device_put`` of the sharding requires); with dp > 1 in a
    process group TinyViT's BatchNorms take the global batch's
    statistics (``BatchNorm2d.dp_group``). Call it before the train state
    takes the float32 masters of the parameters."""
    from ..models.tinyvit import BatchNorm2d

    dp_group = mesh.group("dp")
    for mod in model.modules():
        if isinstance(mod, BatchNorm2d):
            mod.dp_group = dp_group
    tp_group = mesh.group("tp")
    if tp_group is None:
        return model
    tp, i = mesh.shape["tp"], mesh.index("tp")
    specs = param_shardings(model, mesh)
    done = set()
    for name, spec in specs.items():
        if not spec:
            continue
        parent, attr, _ = _owner(model, name)
        key = name.rsplit(".", 1)[0]
        if key in done:
            continue
        done.add(key)
        mod = getattr(parent, attr) if not attr.isdigit() \
            else parent[int(attr)]
        full = mod.weight.shape[0]
        if full % tp:
            raise ValueError(
                f"{name} has {full} rows along the tp axis, which should be "
                f"divisible by tp={tp} (the sharding {spec} splits them "
                f"evenly)")
        rows = full // tp
        sl = slice(i * rows, (i + 1) * rows)
        weight = mod.weight[sl].clone()
        if isinstance(mod, nn.Embedding):
            new = VocabParallelEmbedding(weight, tp_group, i * rows, full)
        else:
            bias = None if mod.bias is None else mod.bias[sl].clone()
            new = VocabParallelLinear(weight, bias, tp_group, i * rows, full)
        _set_child(parent, attr, new.to(weight.device))
    return model


def unshard(model: nn.Module) -> nn.Module:
    """A copy of ``model`` with every vocab-parallel module gathered back
    to its plain counterpart (every rank of the tp group calls): the
    whole model, for an evaluation or a checkpoint on one rank."""
    gathered = {}
    for name, mod in model.named_modules():
        if isinstance(mod, (VocabParallelLinear, VocabParallelEmbedding)):
            gathered[name] = full_module(mod)
    out = deepcopy_module(model)
    for name, full in gathered.items():
        parent, attr, _ = _owner(out, name + ".weight")
        _set_child(parent, attr, full)
    return out


def deepcopy_module(model: nn.Module) -> nn.Module:
    """``copy.deepcopy`` of a placed model: the copy shares the process
    groups its layers name (a group cannot be copied)."""
    memo = {}
    for mod in model.modules():
        for attr in ("group", "dp_group"):
            g = mod.__dict__.get(attr)
            if g is not None:
                memo[id(g)] = g
    return copy.deepcopy(model, memo)


def sharded_dims(model: nn.Module) -> Dict[str, int]:
    """Parameter name → the dim split over tp, for the parameters of the
    vocab-parallel modules."""
    out = {}
    for name, mod in model.named_modules():
        if isinstance(mod, (VocabParallelLinear, VocabParallelEmbedding)):
            prefix = name + "." if name else ""
            out[prefix + "weight"] = 0
            if getattr(mod, "bias", None) is not None:
                out[prefix + "bias"] = 0
    return out


def local_tree(model: nn.Module, tree: Dict[str, Any]) -> Dict[str, Any]:
    """A train-state checkpoint tree (whole tensors) cut to ``model``'s
    placement: this rank's rows of each vocab-parallel weight, bias and
    their Adam moments. Unchanged where nothing is split."""
    rows = {}
    for name, mod in model.named_modules():
        if isinstance(mod, (VocabParallelLinear, VocabParallelEmbedding)):
            prefix = name + "." if name else ""
            sl = slice(mod.start, mod.start + mod.weight.shape[0])
            rows[prefix + "weight"] = sl
            if getattr(mod, "bias", None) is not None:
                rows[prefix + "bias"] = sl
    if not rows:
        return tree

    def cut(d):
        return {k: (v[rows[k]] if k in rows else v) for k, v in d.items()}

    opt = tree["opt_state"]
    return dict(tree, state_dict=cut(tree["state_dict"]),
                opt_state=dict(opt, mu=cut(opt["mu"]), nu=cut(opt["nu"])))


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------

def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _rows(x, start: int, stop: int, device):
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    if isinstance(x, torch.Tensor):
        return x[start:stop].to(device)
    if isinstance(x, list):
        return x[start:stop]
    return x


def _leading(batch) -> int:
    if isinstance(batch, dict):
        for v in batch.values():
            if isinstance(v, (torch.Tensor, np.ndarray)):
                return int(v.shape[0])
        raise ValueError("a batch needs at least one array")
    return int(batch.shape[0])


def place_batch(batch: PyTree, device) -> PyTree:
    """Every array of ``batch`` on ``device``, as it is."""
    def put(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(device) if isinstance(x, torch.Tensor) else x
    return _tree_map(put, batch)


def shard_batch(batch: PyTree, mesh: Mesh) -> PyTree:
    """This rank's dp rows of a global batch (a tensor or a dict of them;
    lists such as ``vid-id`` are cut alike), on its device. The rows must
    split evenly over dp, as JAX's sharding requires. On a local mesh
    with dp > 1, a list of the dp chunks, chunk i on the mesh's i-th dp
    device."""
    dp = mesh.shape.get("dp", 1)
    n = _leading(batch)
    if n % dp:
        raise ValueError(f"a batch of {n} rows does not split over dp={dp}")
    per = n // dp

    def chunk(i, device):
        def cut(x):
            return _rows(x, i * per, (i + 1) * per, device)
        if isinstance(batch, dict):
            return type(batch)((k, cut(v)) for k, v in batch.items())
        return cut(batch)

    if not mesh.distributed and dp > 1:
        return [chunk(i, d) for i, d in enumerate(mesh.dp_devices)]
    return chunk(mesh.index("dp"), mesh.device)


def replicate(tree: PyTree, mesh: Mesh) -> PyTree:
    """Make every dp rank hold dp-rank 0's values: tensors (a module's
    parameters and buffers, or a tree of tensors) are broadcast in place
    over the dp group and returned. On a local mesh with dp > 1, a list
    with one copy per dp device (the first is ``tree`` itself where it
    already lies on that device)."""
    if not mesh.distributed:
        if mesh.shape.get("dp", 1) == 1:
            return tree
        out = []
        for d in mesh.dp_devices:
            here = _device_of(tree)
            twin = (deepcopy_module(tree) if isinstance(tree, nn.Module)
                    else copy.deepcopy(tree))
            out.append(tree if not out and here == d else _to(twin, d))
        return out
    group = mesh.group("dp")
    if group is None:
        return tree
    with torch.no_grad():
        if isinstance(tree, nn.Module):
            for t in list(tree.parameters()) + list(tree.buffers()):
                broadcast_(t.data, group)
        else:
            _tree_map(lambda x: broadcast_(x, group)
                      if isinstance(x, torch.Tensor) else x, tree)
    return tree


def _device_of(tree) -> Optional[torch.device]:
    if isinstance(tree, nn.Module):
        p = next(iter(tree.parameters()), None)
        return None if p is None else p.device
    leaves = []
    _tree_map(lambda x: leaves.append(x) if isinstance(x, torch.Tensor)
              else None, tree)
    return leaves[0].device if leaves else None


def _to(tree, device):
    if isinstance(tree, nn.Module):
        return tree.to(device)
    return place_batch(tree, device)
