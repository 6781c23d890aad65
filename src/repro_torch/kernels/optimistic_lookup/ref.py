"""Plain PyTorch versions for optimistic_lookup.

``optimistic_lookup_ref`` is the kernel's own arithmetic in tensor
operations — the float32 estimate in the kernel's order, the window bound
tests, the masked updates and the ±window shifts — so that ``idx``,
``found`` and ``iters`` all equal the kernel's.  ``searchsorted_oracle`` is
the exact answer the ops fall back to for queries the kernel left
unresolved.  The values widen to int64 (``kernels/u32.py``).
"""
from __future__ import annotations

import torch

from ..u32 import widen_u32


def optimistic_lookup_ref(queries: torch.Tensor, keys: torch.Tensor, *,
                          window: int = 512, max_iters: int = 4):
    """queries (Q,) uint32; keys (N,) uint32 sorted, N ≥ 1.
    → (idx (Q,) int32 [-1 if unresolved], found (Q,) bool,
    iters (Q,) int32)."""
    q, kk = widen_u32(queries), widen_u32(keys)
    n = kk.shape[0]
    window = min(window, n)
    # f32(key) · 2⁻³² · N in float32, left to right, truncated toward zero.
    est = (q.to(torch.float32) * (1.0 / 4294967296.0) * float(n)).to(
        torch.int64)
    max_start = max(n - window, 0)
    start = (est - window // 2).clamp(0, max_start)
    done = torch.zeros(q.shape, dtype=torch.bool, device=q.device)
    found = torch.zeros_like(done)
    found_idx = torch.zeros_like(start)
    used = torch.zeros_like(start)
    span = torch.arange(window, device=q.device)
    for _ in range(max_iters):
        w = kk[start[:, None] + span]                    # (Q, window)
        lo_ok = (start == 0) | (w[:, 0] <= q)
        hi_ok = (start + window >= n) | (q <= w[:, -1])
        inside = lo_ok & hi_ok
        rank = (w < q[:, None]).sum(dim=1)
        hit = (w == q[:, None]).any(dim=1)
        newly = inside & ~done
        found_idx = torch.where(newly, start + rank, found_idx)
        found = torch.where(newly, hit, found)
        used += (~done).to(torch.int64)
        done |= inside
        shifted = torch.where(lo_ok, start + window, start - window)
        start = torch.where(done, start, shifted.clamp(0, max_start))
    idx = torch.where(done, found_idx, torch.full_like(found_idx, -1))
    return idx.to(torch.int32), found & done, used.to(torch.int32)


def searchsorted_oracle(queries: torch.Tensor, keys: torch.Tensor):
    """Exact resolution of queries (Q,) uint32, or int32 holding u32 bits:
    (idx (Q,) int32 — the rank of the first key equal to the query, else
    the insertion point — and found (Q,) bool)."""
    q, kk = widen_u32(queries), widen_u32(keys)
    idx = torch.searchsorted(kk, q)
    in_range = idx < kk.shape[0]
    hit = kk[idx.clamp(max=kk.shape[0] - 1)] == q
    return idx.to(torch.int32), in_range & hit
