"""Plain PyTorch versions for optimistic_lookup.

``optimistic_lookup_ref`` is the TPU kernel's arithmetic in tensor
operations — the float32 estimate in the kernel's order, the window bound
tests, the masked updates and the ±window shifts, and the rank as a count
over the whole window — so that ``idx``, ``found`` and ``iters`` all equal
the kernel's.  ``searchsorted_oracle`` is the exact answer for queries the
rounds left unresolved, and ``lookup_indices_ref`` the two together: the
plain version of the resolve entry.

``optimistic_lookup_search`` mirrors the CUDA kernel's own steps in plain
ops: its 32-way pivot steps and last segment load inside the window and,
with ``resolve``, over the whole array.  The tests hold it against the TPU
kernel and the oracle, so the kernel's search is checked on the CPU where
the kernel cannot run.  The values widen to int64 (``kernels/u32.py``).
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


def lookup_indices_ref(queries: torch.Tensor, keys: torch.Tensor, *,
                       window: int = 512, max_iters: int = 4):
    """→ (idx (Q,) int32, found (Q,) bool): the rounds' answer where they
    found the key's window, the oracle's where they ran out."""
    idx, found, _ = optimistic_lookup_ref(queries, keys, window=window,
                                          max_iters=max_iters)
    ridx, rfound = searchsorted_oracle(queries, keys)
    unresolved = idx < 0
    return (torch.where(unresolved, ridx, idx),
            torch.where(unresolved, rfound, found))


_LANES = 32


def _pivot_pos(lo, length, j):
    """The j-th of 32 pivots over [lo, lo + length)."""
    return lo + j * (length - 1) // (_LANES - 1)


def _pivot_step(kk, q, lo, hi, found):
    """One 32-way step of every query over [lo, hi), as a warp takes it:
    the pivots, their ballot ``pivot < key`` (a prefix of c lanes), and
    [lo, hi] narrowed to the entries strictly between pivots c-1 and c.
    → (lo, hi, found, pivots (Q, 32)).  Rows with hi <= lo read clamped
    positions and must be discarded by the caller."""
    length = hi - lo
    lanes = torch.arange(_LANES, device=q.device)
    pos = _pivot_pos(lo[:, None], length[:, None], lanes)
    v = kk[pos.clamp(0, kk.shape[0] - 1)]
    c = (v < q[:, None]).sum(dim=1)
    found = found | (v == q[:, None]).any(dim=1)
    new_lo = torch.where(c == 0, lo, _pivot_pos(lo, length, c - 1) + 1)
    hi = torch.where(c < _LANES, _pivot_pos(lo, length, c), hi)
    return new_lo, hi, found, v


def _lower_bound(kk, q, lo, hi, found):
    """The first entry >= key, given that it lies in [lo, hi]: pivot steps
    while more than 32 entries are left, then one load of those.
    → (index, found)."""
    while True:
        big = hi - lo > _LANES
        if not bool(big.any()):
            break
        nlo, nhi, nfound, _ = _pivot_step(kk, q, lo, hi, found)
        lo, hi = torch.where(big, nlo, lo), torch.where(big, nhi, hi)
        found = torch.where(big, nfound, found)
    lanes = torch.arange(_LANES, device=q.device)
    valid = lanes < (hi - lo)[:, None]
    v = kk[(lo[:, None] + lanes).clamp(0, kk.shape[0] - 1)]
    lo = lo + (valid & (v < q[:, None])).sum(dim=1)
    return lo, found | (valid & (v == q[:, None])).any(dim=1)


def optimistic_lookup_search(queries: torch.Tensor, keys: torch.Tensor, *,
                             window: int = 512, max_iters: int = 4,
                             resolve: bool = False):
    """The CUDA kernel's steps in plain ops.  → (idx (Q,) int32, found (Q,)
    bool, iters (Q,) int32): without ``resolve`` the TPU kernel's answer
    (idx -1 where the rounds ran out), with it those queries resolved by the
    lower bound over the whole array, as the resolve entry does."""
    q, kk = widen_u32(queries), widen_u32(keys)
    n = kk.shape[0]
    window = min(window, n)
    est = (q.to(torch.float32) * (1.0 / 4294967296.0) * float(n)).to(
        torch.int64)
    max_start = max(n - window, 0)
    start = (est - window // 2).clamp(0, max_start)
    done = torch.zeros(q.shape, dtype=torch.bool, device=q.device)
    found = torch.zeros_like(done)
    idx = torch.full_like(start, -1)
    used = torch.zeros_like(start)
    for _ in range(max_iters):
        used += (~done).to(torch.int64)
        lo, hi, hit, v = _pivot_step(kk, q, start, start + window,
                                     torch.zeros_like(done))
        lo_ok = (start == 0) | (v[:, 0] <= q)
        hi_ok = (start + window >= n) | (q <= v[:, -1])
        inside = ~done & lo_ok & hi_ok
        rank, hit = _lower_bound(kk, q, lo, hi, hit)
        idx = torch.where(inside, rank, idx)
        found = torch.where(inside, hit, found)
        done |= inside
        shifted = torch.where(lo_ok, start + window, start - window)
        start = torch.where(done, start, shifted.clamp(0, max_start))
    if resolve:
        rank, hit = _lower_bound(kk, q, torch.zeros_like(start),
                                 torch.full_like(start, n),
                                 torch.zeros_like(done))
        idx = torch.where(done, idx, rank)
        found = torch.where(done, found, hit)
    return idx.to(torch.int32), found, used.to(torch.int32)
