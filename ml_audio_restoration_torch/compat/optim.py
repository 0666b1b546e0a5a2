"""The JAX package's Adam state as torch.optim.Adam state.

The JAX trainer saves its optax state as one flat list of leaves,
`{"leaves": [...]}` (ml_audio_restoration_tpu/train/trainer.py::
_opt_state_to_tree), with no tree structure. Its optimizer is
`optax.inject_hyperparams(base)(learning_rate=lr)`, which flattens to:

- `max_grad_norm > 0` (base = chain(clip_by_global_norm, adam)):
  `[count, learning_rate, adam_count, *mu, *nu]`, 3 + 2N leaves;
- no clipping (base = adam, the default):
  `[count, b1, b2, eps, eps_root, learning_rate, adam_count, *mu, *nu]`,
  7 + 2N leaves,

for N parameter leaves. `mu` and `nu` each follow JAX's flatten order of
the params pytree: dict keys sorted, lists in index order. That order is
built here from the structure `jax_from_state_dict` returns, and each
leaf is tied to its port parameter through the same layout transposes as
the weights (conv [k, in, out] -> [out, in, k], transposed conv
[k, in, out] -> [in, out, k], LSTM [C, 4H] -> [4H, C]).
"""
from __future__ import annotations

import numpy as np
import torch

from .weights import jax_from_state_dict

#: torch.optim.Adam's defaults as optax names them; optax's eps_root has
#: no torch counterpart and must be 0
ADAM_DEFAULTS = {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "eps_root": 0.0}
_HYPER_NO_CLIP = ("b1", "b2", "eps", "eps_root", "learning_rate")


def jax_leaves(tree) -> list:
    """The leaves of a pytree of dicts and lists in JAX's flatten order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in jax_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in jax_leaves(v)]
    return [tree]


class LeafMap:
    """Where each leaf of the JAX params pytree lives among the port
    model's parameters.

    `index[i]` has the shape of JAX leaf i and holds, for each of its
    elements, the position of that element in the concatenation of the
    model's parameters (named_parameters order, each flattened)."""

    def __init__(self, model_name: str, model: torch.nn.Module):
        self.names, self.shapes, offsets = [], [], [0]
        marked = {}
        for name, p in model.named_parameters():
            self.names.append(name)
            self.shapes.append(tuple(p.shape))
            marked[name] = (np.arange(p.numel(), dtype=np.int64)
                            + offsets[-1]).reshape(p.shape)
            offsets.append(offsets[-1] + p.numel())
        self.offsets = offsets
        # buffers ride along so the mapping finds every key it reads
        for name, b in model.named_buffers():
            marked.setdefault(name, np.zeros(tuple(b.shape), np.int64))
        params, _ = jax_from_state_dict(model_name, marked)
        self.index = [np.asarray(leaf) for leaf in jax_leaves(params)]
        covered = np.sort(np.concatenate([i.ravel() for i in self.index]))
        if not np.array_equal(covered, np.arange(offsets[-1])):
            raise ValueError(f"the {model_name} params pytree does not cover "
                             f"the model's parameters once each")

    def __len__(self):
        return len(self.index)

    def to_port(self, leaves, what: str = "leaf") -> dict:
        """JAX leaves in flatten order -> {parameter name: float32 numpy
        array in the port's layout}. Raises on a count or shape that does
        not match."""
        if len(leaves) != len(self.index):
            raise ValueError(f"{len(leaves)} {what}s for {len(self.index)} "
                             f"parameter leaves")
        flat = np.empty(self.offsets[-1], np.float32)
        for i, (leaf, idx) in enumerate(zip(leaves, self.index)):
            leaf = np.asarray(leaf)
            if leaf.shape != idx.shape:
                raise ValueError(f"{what} {i} has shape {leaf.shape}, the "
                                 f"parameter leaf {idx.shape}")
            flat[idx.ravel()] = leaf.ravel()
        return {name: flat[a:b].reshape(shape) for name, shape, a, b in zip(
            self.names, self.shapes, self.offsets, self.offsets[1:])}


def adam_from_jax(leaves, leaf_map: LeafMap, *, clipped: bool, lr: float):
    """The Adam state of a JAX checkpoint's `opt_state["leaves"]`:
    (step, {name: exp_avg}, {name: exp_avg_sq}), numpy in the port's
    layouts. `step` is Adam's own count. Raises ValueError, before anything
    is built, when the leaves are not the layout that `clipped` (the
    trainer's config) gives, when a hyperparameter differs from
    torch.optim.Adam's or the learning rate from `lr`."""
    n = len(leaf_map)
    hyper = ("learning_rate",) if clipped else _HYPER_NO_CLIP
    head = 2 + len(hyper)
    if len(leaves) != head + 2 * n:
        raise ValueError(
            f"optimizer state has {len(leaves)} leaves; Adam "
            f"{'with' if clipped else 'without'} clipping over {n} "
            f"parameter leaves has {head + 2 * n}")
    want = {**ADAM_DEFAULTS, "learning_rate": lr}
    for i, key in enumerate(hyper, start=1):
        got = np.asarray(leaves[i])
        if got.shape != () or np.float32(got) != np.float32(want[key]):
            raise ValueError(f"optimizer leaf {i} ({key}) is {got}, the "
                             f"port's Adam has {want[key]}")
    counts = [np.asarray(leaves[0]), np.asarray(leaves[head - 1])]
    if any(c.shape != () or c.dtype.kind not in "iu" for c in counts):
        raise ValueError(f"optimizer leaves 0 and {head - 1} must be integer "
                         f"step counts, got {counts}")
    mu = leaf_map.to_port(leaves[head:head + n], "first moment")
    nu = leaf_map.to_port(leaves[head + n:], "second moment")
    return int(counts[1]), mu, nu
