"""Carry parameters, train states and serving caches across as numpy
arrays.

The port keeps the JAX package's layout (stacked layers, weights
``(d_in, d_out)`` applied as ``x @ w``; a train state is ``{"params": ...,
"opt": {"m": ..., "v": ..., "step": int32 scalar}}``), so each leaf crosses
as one ``torch.from_numpy(...).to(device)``, scalars and bf16 leaves
included.  On the JAX side the tree is ``jax.tree.map(np.asarray, tree)``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.tree import tree_map

# Leaves read in fp32 at every use: norm scales (``rms_norm`` widens them:
# the layers', MLA's ``q_a_norm`` / ``kv_a_norm``, whisper's ``ln_x`` and
# ``enc_norm``, the MTP module's ``ln``), the MoE ``router`` (made in fp32
# and read in fp32: a rounded router changes the routing), the SSM's
# ``A_log`` and ``dt_bias``, and the RG-LRU's gates, biases and ``lam``.
# Casting them would change their values, so ``cast_weights`` leaves them
# as they are.
FP32_KEYS = frozenset({"ln1", "ln2", "ln_x", "ln", "final_norm", "enc_norm",
                       "q_norm", "k_norm", "q_a_norm", "kv_a_norm", "norm",
                       "router", "A_log", "dt_bias",
                       "w_r", "w_i", "b_r", "b_i", "lam"})


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    # A copy where torch cannot share the memory (arrays that JAX hands out
    # are read-only); ``copy`` keeps a 0-d array 0-d, where
    # ``np.ascontiguousarray`` would make it 1-d.
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = a.copy(order="C")
    if a.dtype.name == "bfloat16":         # ml_dtypes: no numpy counterpart
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree, device="cuda"):
    """A parameter tree (or a whole train state) of numpy arrays → the same
    tree of tensors."""
    return tree_map(lambda a: _leaf(a, device), tree)


def cache_from_numpy(cache: dict, device="cuda") -> dict:
    """A serving cache of numpy arrays → the same cache of tensors."""
    return {k: _leaf(v, device) for k, v in cache.items()}


def cast_weights(params: dict, dtype: torch.dtype, device=None) -> dict:
    """Matrix weights and embeddings cast once to ``dtype`` (the values each
    use would cast them to), the leaves of ``FP32_KEYS`` kept, everything
    moved to ``device``.  Descends dicts and lists (griffin's ``tail``).

    The cast happens in ``params`` itself, which is returned: each leaf is
    replaced by its copy as the copy is made, so the original is freed at
    once where nothing else holds it, and the device holds the original
    tree and one leaf's copy at most (Qwen2-MoE-A2.7B: 57.3 GB of fp32 and
    8.3 GB of one stacked expert matrix, where a second tree would add
    28.6 GB)."""
    def walk(tree, key=None):
        if isinstance(tree, dict):
            for k in tree:
                tree[k] = walk(tree[k], k)
            return tree
        if isinstance(tree, list):
            for i, v in enumerate(tree):
                tree[i] = walk(v, key)
            return tree
        return tree.to(device=device,
                       dtype=tree.dtype if key in FP32_KEYS else dtype)
    return walk(params)
