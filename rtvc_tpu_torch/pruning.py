"""Global L1 magnitude pruning of the student's state dict.

Counterpart of ``rtvc_tpu/pruning.py``, itself the reference's
``global_prune_model`` (reference src/utils/pruning.py:15-56): every entry
whose name contains ``weight`` (reference pruning.py:34: Linear and conv
weights, the attention's packed ``in_proj_weight``, the embedding table and
the LayerNorm/BatchNorm scales; JAX selects the same elements by the flax
leaf names ``kernel``, ``in_proj_kernel``, ``embedding`` and ``scale``) is
ranked globally by |w|, and exactly the ``round(ratio · total)`` smallest
are zeroed: all below the k-th smallest magnitude, then as many elements
equal to it as that takes.

Which of the ties at the threshold go is decided by order: JAX takes the
first ones in its flat traversal, which walks the leaves in sorted key
order and each leaf in the flax layout (Dense ``[in, out]``, conv HWIO).
So the port walks the prunable entries in the JAX tree's order, each in
the JAX layout (``models.convert.student_jax_path`` / ``to_jax_layout``),
and prunes the same elements. Ties are common when a pruned checkpoint is
pruned again (its zeros) and among unit norm scales.

CLI (the reference's ratio sweep, pruning.py:58-95)::

    python -m rtvc_tpu_torch.pruning --ckpt DIR [--ratios 0.1 0.5]
        [--out_dir results/pruned]
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .models.convert import from_jax_layout, student_jax_path, to_jax_layout

StateDict = Mapping[str, torch.Tensor]


def _is_prunable(name: str) -> bool:
    # reference pruning.py:34: [p for p in named_parameters() if 'weight' in p[0]]
    return "weight" in name


def jax_order(state_dict: StateDict) -> List[Tuple[Tuple[str, ...], str]]:
    """The prunable entries as (JAX key path, name), in the order JAX's
    ``tree_flatten`` visits their leaves (sorted keys at every level)."""
    return sorted((student_jax_path(name, t.ndim), name)
                  for name, t in state_dict.items() if _is_prunable(name))


def global_prune_params(state_dict: StateDict, ratio: float
                        ) -> Tuple[Dict[str, torch.Tensor],
                                   Dict[str, Optional[torch.Tensor]]]:
    """Zero the globally smallest ``ratio`` fraction of the prunable
    weights. Returns (the pruned state dict, the masks): a float32 mask of
    1.0 for the kept elements of each prunable entry, in its torch layout,
    and None elsewhere. The state dict's tensors are not changed."""
    order = jax_order(state_dict)
    if not order or ratio <= 0.0:
        return dict(state_dict), {name: None for name in state_dict}

    mags = [np.abs(to_jax_layout(state_dict[name], path[-1]).detach()
                   .cpu().float().numpy()) for path, name in order]
    magnitudes = np.concatenate([m.ravel() for m in mags])
    k = int(round(ratio * magnitudes.size))
    if k <= 0:
        threshold, tie_budget = -1.0, 0
    else:
        # exact-k like torch's L1Unstructured: everything strictly below
        # the k-th smallest magnitude, then threshold ties in JAX's order
        threshold = float(np.partition(magnitudes, k - 1)[k - 1])
        below = int((magnitudes < threshold).sum())
        tie_budget = k - below

    masks: Dict[str, Optional[torch.Tensor]] = {
        name: None for name in state_dict}
    remaining_ties = tie_budget
    for (path, name), mag in zip(order, mags):
        keep = (mag >= threshold).ravel()
        if remaining_ties > 0:
            ties = np.flatnonzero((mag == threshold).ravel())
            take = ties[:remaining_ties]
            remaining_ties -= len(take)
            keep[take] = False
        mask = torch.from_numpy(keep.reshape(mag.shape).astype(np.float32))
        masks[name] = from_jax_layout(mask, path[-1]).contiguous()
    return apply_masks(state_dict, masks), masks


def sparsity_report(state_dict: StateDict) -> Dict[str, float]:
    """Exact zeros among the prunable entries' elements."""
    zero = total = 0
    for name, t in state_dict.items():
        if _is_prunable(name):
            zero += int((t == 0).sum())
            total += t.numel()
    return {"zeros": zero, "total": total,
            "sparsity": zero / max(total, 1)}


def apply_masks(state_dict: StateDict,
                masks: Mapping[str, Optional[torch.Tensor]]
                ) -> Dict[str, torch.Tensor]:
    """Each entry times its mask, in the entry's dtype and on its device
    (entries without a mask as they are): re-applies stored masks, e.g.
    after a mask-respecting finetune step."""
    out = {}
    for name, t in state_dict.items():
        m = masks.get(name)
        out[name] = t if m is None else t * m.to(t.device, t.dtype)
    return out


def main(argv=None) -> None:
    """Sweep pruning ratios over a trained checkpoint (reference
    pruning.py:58-95: ratios 0.1-0.5 saved as separate checkpoints,
    ``<out_dir>/pruned_<ratio>``, each with the source's meta sidecar)."""
    from .data.io import (checkpoint_meta, load_kd_student_params,
                          save_checkpoint)

    parser = argparse.ArgumentParser(prog="rtvc_tpu_torch.pruning")
    parser.add_argument("--ckpt", required=True)
    parser.add_argument("--out_dir", default="results/pruned")
    parser.add_argument("--ratios", type=float, nargs="+",
                        default=[0.1, 0.2, 0.3, 0.4, 0.5])
    args = parser.parse_args(argv)

    tree = load_kd_student_params(args.ckpt)
    meta = checkpoint_meta(args.ckpt)  # carry the activation record forward
    for ratio in args.ratios:
        pruned, _ = global_prune_params(tree["state_dict"], ratio)
        report = sparsity_report(pruned)
        out = dict(tree)
        out["state_dict"] = pruned
        path = os.path.join(args.out_dir, f"pruned_{round(ratio, 1)}")
        save_checkpoint(path, out, meta=meta or None)
        print(f"ratio {ratio:.1f}: sparsity {report['sparsity']:.3f} → {path}")
    print("Done")


if __name__ == "__main__":
    main()
