"""Host-facing entries for optimistic_lookup: resolve WAL positions for hash
keys through the optimistic index, falling back to the exact oracle for
queries the kernel left unresolved (budget exhausted).

``lookup`` takes tensors and picks by the tensors' device: a CUDA tensor
launches the kernel (``kernel.py``, which raises on what it cannot take), a
CPU tensor takes the plain version (``ref.py``).  ``lookup_indices`` resolves
every query: on the card in one launch of the resolve entry, with no host
sync, on the CPU through the oracle.  ``lookup_indices_batch`` is the numpy-in / numpy-out
entry of the storage engine's batched read path (``TideDB.multi_get``).

``lookup_dispatch_count`` counts ``lookup_indices_batch`` dispatches since
import, on either device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..build import on_card
from ..padding import next_pow2
from .kernel import optimistic_lookup, optimistic_lookup_resolve
from .ref import lookup_indices_ref, optimistic_lookup_ref

_PAD_KEY = np.uint32(0xFFFFFFFF)

lookup_dispatch_count = 0


def lookup(queries: torch.Tensor, keys: torch.Tensor, *, window: int = 512,
           max_iters: int = 4):
    """→ (idx (Q,) int32 [-1 if unresolved], found (Q,) bool,
    iters (Q,) int32) from the kernel or its plain version."""
    if on_card(queries, "optimistic_lookup"):
        return optimistic_lookup(queries, keys, window=window,
                                 max_iters=max_iters)
    return optimistic_lookup_ref(queries, keys, window=window,
                                 max_iters=max_iters)


def lookup_indices(queries: torch.Tensor, keys: torch.Tensor, *,
                   window: int = 512, max_iters: int = 4):
    """queries (Q,) uint32; keys (N,) uint32 sorted.  Returns (idx (Q,)
    int32, found (Q,) bool): idx is the rank of the first key equal to the
    query (insertion point when absent), kernel-resolved with the oracle
    for the queries the rounds left unresolved — the op's own contract."""
    if on_card(queries, "optimistic_lookup_resolve"):
        return optimistic_lookup_resolve(queries, keys, window=window,
                                         max_iters=max_iters)
    return lookup_indices_ref(queries, keys, window=window,
                              max_iters=max_iters)


def lookup_indices_batch(queries: np.ndarray, keys: np.ndarray, *,
                         window: int = 512, max_iters: int = 4,
                         device: str = "cuda") -> tuple[np.ndarray, np.ndarray]:
    """Batched index resolution on ``device``: queries (Q,) u32, keys (N,)
    u32 sorted → (idx (Q,) i32, found (Q,) bool) as numpy.

    Keys are padded with 0xFFFFFFFF sentinels (preserving sort order) to the
    next power of two, at least 4096, exactly as the JAX package pads them:
    the padded length is the N of the kernel's position estimate, so the
    same padding gives the same windows.  Hits landing in the key padding
    are masked out, so callers never observe a sentinel match.  The JAX
    package cut the queries into fixed chunks of 256 to bound its jit
    cache; here every query goes into one launch, and the answers are the
    same because every query resolves on its own.
    """
    q, n = len(queries), len(keys)
    if q == 0 or n == 0:
        return (np.zeros(q, np.int32), np.zeros(q, dtype=bool))
    np_ = max(4096, next_pow2(n))
    if np_ != n:
        keys = np.concatenate([keys, np.full(np_ - n, _PAD_KEY, np.uint32)])
    global lookup_dispatch_count
    lookup_dispatch_count += 1
    qt = torch.from_numpy(np.ascontiguousarray(queries, np.uint32)).to(device)
    kt = torch.from_numpy(np.ascontiguousarray(keys, np.uint32)).to(device)
    idx, found = lookup_indices(qt, kt, window=window, max_iters=max_iters)
    idx = idx.cpu().numpy()
    found = found.cpu().numpy() & (idx < n)
    return idx.astype(np.int32), found
