"""The port's pruning (rtvc_tpu_torch.pruning, .pruning_test) and its
``RunLogger`` copy against the JAX package's.

``global_prune_params`` on the tiny student of tests/test_models.py (every
head built; the port's state dict from the weight bridge) must give JAX's
pruned weights and masks element for element at ratios 0, 0.3 and 0.5, and
where many magnitudes tie at the threshold: weights rounded to quarters,
and a pruned tree pruned again (its zeros tie). JAX prunes the first
``tie_budget`` ties in its flat traversal (leaves in sorted key order, each
in the flax layout); a naive walk in ``named_parameters`` order, or in the
torch layout, prunes other elements there, which the tie cases show. Then
the ``main`` sweep's checkpoints, ``sparsity_report``, and
``pruning_test.test``'s BLEU-4 and run file on the same pruned weights as
JAX's.
"""

import json
import os
import time

import jax
import numpy as np
import pytest
import torch

from rtvc_tpu import config as jconfig
from rtvc_tpu import pruning as jpruning
from rtvc_tpu import pruning_test as jpruning_test
from rtvc_tpu.data import io as jio
from rtvc_tpu.tokenization import BertWordPieceTokenizer as JaxTokenizer
from rtvc_tpu.utils.logging import RunLogger as JaxRunLogger
from rtvc_tpu_torch import config as pconfig
from rtvc_tpu_torch import pruning, pruning_test
from rtvc_tpu_torch.data import io
from rtvc_tpu_torch.models.convert import (from_jax_layout,
                                           student_jax_path,
                                           student_state_dict_from_jax,
                                           to_jax_layout)
from rtvc_tpu_torch.tokenization import BertWordPieceTokenizer
from rtvc_tpu_torch.utils.logging import RunLogger

from test_torch_beam import assert_jax_greedy_margins, scaled
from test_torch_evaluate import (CROP, MAX_LEN, fresh_port_student,
                                 loaders)
from test_torch_data import write_msrvtt
from test_torch_models import jax_student


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, variables) of the tiny student for 224-pixel frames."""
    return jax_student(size=CROP)


# the port student's state-dict order (named_parameters' for parameters)
TORCH_ORDER = list(fresh_port_student().state_dict())


def port_sd(params, batch_stats=None):
    """The bridge's state dict, in the port student's entry order."""
    sd = student_state_dict_from_jax(params, batch_stats or {})
    return {k: sd[k] for k in TORCH_ORDER if k in sd}


def jax_masks_as_torch(masks, params):
    """JAX's mask tree (None off the prunable leaves) through the bridge;
    None becomes a leaf of -1."""
    filled = jax.tree.map(
        lambda m, p: np.full(np.shape(p), -1.0, np.float32) if m is None
        else np.asarray(m), masks, params, is_leaf=lambda x: x is None)
    return port_sd(filled)


def assert_prunes_like_jax(params, ratio):
    jpruned, jmasks = jpruning.global_prune_params(params, ratio)
    pruned, masks = pruning.global_prune_params(port_sd(params), ratio)
    want = port_sd(jpruned)
    assert set(pruned) == set(want)
    for name, t in want.items():
        assert torch.equal(pruned[name], t), name
    want_masks = jax_masks_as_torch(jmasks, params)
    for name, m in want_masks.items():
        if "weight" in name and ratio > 0:
            assert torch.equal(masks[name], m), name
        else:
            assert masks[name] is None and bool((m == -1).all()), name
    assert (pruning.sparsity_report(pruned)
            == jpruning.sparsity_report(jpruned))
    return pruned, masks


def naive_masks(sd, ratio, order: str, layout: str):
    """global_prune_params's selection walked in ``order`` ("torch": the
    state dict's, which is named_parameters'; "jax") with each entry read
    in ``layout`` ("torch" or "jax"). Returns (boolean masks in the torch
    layout, the threshold)."""
    names = ([n for n in sd if "weight" in n] if order == "torch"
             else [n for _, n in pruning.jax_order(sd)])
    leaf = {n: student_jax_path(n, sd[n].ndim)[-1] for n in names}
    views = {n: to_jax_layout(sd[n], leaf[n]) if layout == "jax" else sd[n]
             for n in names}
    mags = [np.abs(views[n].float().numpy()) for n in names]
    flat = np.concatenate([m.ravel() for m in mags])
    k = int(round(ratio * flat.size))
    threshold = float(np.partition(flat, k - 1)[k - 1])
    budget = k - int((flat < threshold).sum())
    out = {}
    for n, mag in zip(names, mags):
        keep = (mag >= threshold).ravel()
        ties = np.flatnonzero((mag == threshold).ravel())[:budget]
        budget -= len(ties)
        keep[ties] = False
        mask = torch.from_numpy(keep.reshape(mag.shape))
        out[n] = from_jax_layout(mask, leaf[n]) if layout == "jax" else mask
    return out, threshold


def test_jax_paths_and_layouts_invert_the_bridge(tiny):
    """Every prunable entry names its JAX leaf, and its JAX-layout view
    holds that leaf's values; the walk visits them in JAX's order."""
    _, variables = tiny
    params = variables["params"]
    sd = port_sd(params, variables["batch_stats"])
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    leaves = {tuple(k.key for k in path): np.asarray(v) for path, v in flat}
    order = pruning.jax_order(sd)
    assert [p for p, _ in order] == [
        tuple(k.key for k in path) for path, _ in flat
        if path[-1].key in ("kernel", "in_proj_kernel", "embedding",
                            "scale")]
    for path, name in order:
        np.testing.assert_array_equal(
            to_jax_layout(sd[name], path[-1]).numpy(), leaves[path])
    for name, t in sd.items():  # the batch statistics name theirs too
        if "running_" in name:
            np.testing.assert_array_equal(t.numpy(), _get(
                variables["batch_stats"], student_jax_path(name, t.ndim)))


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


@pytest.mark.parametrize("ratio", [0.0, 0.3, 0.5])
def test_global_prune_equals_jax(tiny, ratio):
    _, variables = tiny
    pruned, masks = assert_prunes_like_jax(variables["params"], ratio)
    rep = pruning.sparsity_report(pruned)
    assert rep["zeros"] == round(ratio * rep["total"])


def _quartered(params):
    return jax.tree.map(lambda a: np.round(np.asarray(a) * 4) / 4, params)


@pytest.mark.parametrize("case", ["rounded weights", "pruned again"])
def test_threshold_ties_pruned_in_jax_order(tiny, case):
    _, variables = tiny
    if case == "rounded weights":
        params, ratio = _quartered(variables["params"]), 0.5
    else:
        params = jpruning.global_prune_params(variables["params"], 0.3)[0]
        params, ratio = jax.tree.map(np.asarray, params), 0.2
    pruned, masks = assert_prunes_like_jax(params, ratio)
    sd = port_sd(params)
    mine, threshold = naive_masks(sd, ratio, "jax", "jax")
    flat = np.concatenate([np.abs(t.float().numpy()).ravel()
                           for n, t in sd.items() if "weight" in n])
    k = int(round(ratio * flat.size))
    ties = int((flat == threshold).sum())
    budget = k - int((flat < threshold).sum())
    assert 0 < budget < ties  # some ties go, some stay: order decides
    for name, m in mine.items():
        assert torch.equal(m.float(), masks[name])
    for order, layout in (("torch", "jax"), ("jax", "torch"),
                          ("torch", "torch")):
        other, _ = naive_masks(sd, ratio, order, layout)
        assert any(not torch.equal(other[n].float(), masks[n])
                   for n in other), (order, layout)


def test_apply_masks_reapplies(tiny):
    _, variables = tiny
    sd = port_sd(variables["params"])
    pruned, masks = pruning.global_prune_params(sd, 0.5)
    again = pruning.apply_masks(sd, masks)
    for name in sd:
        assert torch.equal(again[name], pruned[name])
    half = {k: v.to(torch.bfloat16) for k, v in sd.items()}
    for name, t in pruning.apply_masks(half, masks).items():
        assert t.dtype == torch.bfloat16
        if masks[name] is not None:
            assert torch.equal(t == 0, masks[name] == 0)


def test_main_sweep_writes_loadable_checkpoints(tiny, tmp_path, capsys):
    _, variables = tiny
    src = str(tmp_path / "ckpt_00")
    sd = port_sd(variables["params"], variables["batch_stats"])
    io.save_checkpoint(src, {"state_dict": sd, "step": 3},
                       meta={"gelu_approximate": False})
    out_dir = str(tmp_path / "pruned")
    pruning.main(["--ckpt", src, "--out_dir", out_dir, "--ratios", "0.3",
                  "0.5"])
    printed = capsys.readouterr().out.splitlines()
    stripped = io.load_kd_student_params(src)["state_dict"]
    for ratio, line in zip((0.3, 0.5), printed):
        path = os.path.join(out_dir, f"pruned_{ratio}")
        assert line == f"ratio {ratio:.1f}: sparsity {ratio:.3f} → {path}"
        assert io.checkpoint_meta(path) == {"gelu_approximate": False}
        tree = io.load_pruned_params(path)
        assert tree["step"] == 3
        want, _ = pruning.global_prune_params(stripped, ratio)
        assert set(tree["state_dict"]) == set(want)
        assert not any(k.split(".")[0] in io.DISTILL_HEADS
                       for k in tree["state_dict"])
        for name, t in want.items():
            assert torch.equal(tree["state_dict"][name], t), name
        rep = pruning.sparsity_report(tree["state_dict"])
        assert rep["zeros"] == round(ratio * rep["total"])
    assert printed[-1] == "Done"


def test_pruning_test_equals_jax(tiny, tmp_path, monkeypatch, capsys):
    """The same 50%-pruned weights (vocab scaled, as the beam tests): JAX's
    from an orbax checkpoint, the port's from the port's own; the same
    printed lines, BLEU-4, run file and scalars."""
    jmodel, variables = tiny
    variables = scaled(variables)
    pruned, _ = jpruning.global_prune_params(variables["params"], 0.5)
    pruned = jax.tree.map(np.asarray, pruned)
    jckpt, pckpt = str(tmp_path / "jax_pruned"), str(tmp_path / "pruned")
    jio.save_checkpoint(jckpt, {"params": pruned,
                                "batch_stats": variables["batch_stats"]})
    holder = fresh_port_student()
    holder.load_state_dict(port_sd(pruned, variables["batch_stats"]),
                           strict=False)
    io.save_checkpoint(pckpt, {"state_dict": holder.state_dict()})
    tree = write_msrvtt(str(tmp_path / "msrvtt"), n_videos=11, seed=4)
    jloader, ploader = loaders(tree)
    for batch in jloader:
        assert_jax_greedy_margins(jmodel, {"params": pruned, "batch_stats":
                                           variables["batch_stats"]},
                                  np.asarray(batch["frames"]), MAX_LEN)
    jloader, _ = loaders(tree)
    annotations = json.load(open(tree["annotations"]))
    ann = {}
    for a in annotations["annotations"]:
        ann.setdefault(a["image_id"], []).append(a["caption"])
    monkeypatch.chdir(tmp_path)
    with jax.default_matmul_precision("highest"):
        want = jpruning_test.test(jconfig.cfg, jloader, JaxTokenizer(), jckpt,
                                  student=jmodel, run_name="jax",
                                  annotations=ann)
    jout = capsys.readouterr().out
    got = pruning_test.test(pconfig.cfg, ploader, BertWordPieceTokenizer(),
                            pckpt, student=fresh_port_student(),
                            run_name="port", annotations=ann, device="cpu")
    out = capsys.readouterr().out
    assert got == want
    assert out == jout
    assert "pruned model sparsity: 0.50" in out  # heads stripped
    runs = tmp_path / "results" / "run"
    name = "_results_and_metrics.txt"
    assert (runs / "port" / name).read_text() == (runs / "jax" / name
                                                  ).read_text()

    def scalars(run):  # each record but its wall-clock time
        return [{k: v for k, v in json.loads(line).items() if k != "time"}
                for line in (runs / run / "scalars.jsonl").read_text()
                .splitlines()]

    assert scalars("port") == scalars("jax")
    assert set(scalars("port")[0]) > {"step", "Test_Bleu_4", "Test_CIDEr"}


def test_run_logger_equals_original(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1234.5)
    for name, cls in (("jax", JaxRunLogger), ("port", RunLogger)):
        logger = cls(str(tmp_path / name), "t",
                     config_dump={"Learning Rate": 1e-4, "Batch": 8})
        logger.write("hello\n")
        logger.log_scalars(0, {"train_loss": 1.5, "val": np.float32(2.25)})
        logger.log_scalars(1, {"train_loss": 1.25})
        logger.log_epoch_transcript("Validation", 0, [["a cat"]], ["a dog"],
                                    12.3)
        logger.finish()
    for f in ("_results_and_metrics.txt", "scalars.jsonl"):
        assert ((tmp_path / "port" / f).read_text()
                == (tmp_path / "jax" / f).read_text())
    with pytest.warns(UserWarning, match="wandb"):
        monkeypatch.setitem(__import__("sys").modules, "wandb", None)
        RunLogger(str(tmp_path / "w"), use_wandb=True)
