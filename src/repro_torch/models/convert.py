"""Carry parameters and serving caches across as numpy arrays.

The port keeps the JAX package's layout (stacked layers, weights
``(d_in, d_out)`` applied as ``x @ w``), so each leaf crosses as one
``torch.from_numpy(...).to(device)``.  On the JAX side the tree is
``jax.tree.map(np.asarray, params)``.
"""
from __future__ import annotations

import numpy as np
import torch

# Leaves read in fp32 at every use (``rms_norm`` scales): casting them would
# change their values, so ``cast_weights`` leaves them as they are.
NORM_KEYS = frozenset({"ln1", "ln2", "final_norm", "q_norm", "k_norm"})


def _leaf(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:              # arrays that JAX hands out
        a = a.copy()
    if a.dtype.name == "bfloat16":         # ml_dtypes: no numpy counterpart
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def params_from_numpy(tree, device="cpu"):
    """A parameter tree of numpy arrays → the same tree of tensors."""
    return _map(tree, lambda a: _leaf(a, device))


def cache_from_numpy(cache: dict, device="cpu") -> dict:
    """A serving cache of numpy arrays → the same cache of tensors."""
    return {k: _leaf(v, device) for k, v in cache.items()}


def cast_weights(params: dict, dtype: torch.dtype, device=None) -> dict:
    """Matrix weights and embeddings cast once to ``dtype`` (the values each
    use would cast them to), norm scales kept, everything moved to
    ``device``."""
    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else
                v.to(device=device,
                     dtype=v.dtype if k in NORM_KEYS else dtype)
                for k, v in tree.items()}
    return walk(params)
