"""Peaks of the card and the least bytes a kernel's inputs need.

The byte counts follow the storage kernels' algorithms, as written for the
port's card checks, in numpy: the Bloom probe stops at its first clear bit,
and the optimistic lookup reads each query's final window and the two bound
keys of every earlier round.  A kernel's roofline share is the least time
its calls could take, bytes over the memory bandwidth or operations over the
float32 rate (whichever is larger), over the device time they took.
"""
from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, at its 700 W limit.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

BLOOM_K = 7
LOOKUP_MAX_ITERS = 4          # the lookup's rounds before the exact fallback
_U32 = np.int64(0xFFFFFFFF)


def least_seconds(nbytes: float, nops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S)


def bloom_words_needed(h1, h2, off, nbits, bits, k: int = BLOOM_K) -> int:
    """Distinct bitset words a probe that stops at its first clear bit must
    read for these queries."""
    a = np.asarray(h1).astype(np.int64) & _U32
    b = np.asarray(h2).astype(np.int64) & _U32
    w = np.asarray(bits).astype(np.int64) & _U32
    nb = np.asarray(nbits).astype(np.int64) & _U32
    base = np.asarray(off).astype(np.int64)
    live = np.ones(a.shape, bool)
    words = []
    for i in range(k):
        idx = ((a + i * b) & _U32) % nb
        word = base + (idx >> 5)
        words.append(word[live])
        live &= ((w[word] >> (idx & 31)) & 1) == 1
    return int(np.unique(np.concatenate(words)).size)


def bloom_probe_bytes(h1, h2, off, nbits, bits, k: int = BLOOM_K) -> float:
    """Reads h1, h2, the word base and modulus (4 B each) a query, the words
    the probe needs; writes one byte a query."""
    q = len(h1)
    return 16 * q + q + 4 * bloom_words_needed(h1, h2, off, nbits, bits, k)


def bloom_probe_ops(q: int, k: int = BLOOM_K) -> float:
    return 6 * k * q


def lookup_windows_needed(queries, keys, window: int,
                          max_iters: int = LOOKUP_MAX_ITERS) -> tuple[int, int]:
    """(distinct keys the lookup must read, queries its rounds leave
    unresolved): each query's final window, plus the two bound keys of every
    earlier round."""
    q = np.asarray(queries).astype(np.int64) & _U32
    kk = np.asarray(keys).astype(np.int64) & _U32
    n = kk.shape[0]
    est = (q.astype(np.float32) * np.float32(1.0 / 4294967296.0)
           * np.float32(n)).astype(np.int64)
    max_start = max(n - window, 0)
    start = np.clip(est - window // 2, 0, max_start)
    done = np.zeros(q.shape, bool)
    extra = 0
    for _ in range(max_iters):
        lo_ok = (start == 0) | (kk[start] <= q)
        hi_ok = (start + window >= n) | (q <= kk[np.minimum(start + window - 1,
                                                             n - 1)])
        inside = lo_ok & hi_ok
        extra += 2 * int((~done & ~inside).sum())
        done |= inside
        shifted = np.where(lo_ok, start + window, start - window)
        start = np.where(done, start, np.clip(shifted, 0, max_start))
    diff = np.zeros(n + 1, np.int64)
    fin = start[done]
    np.add.at(diff, fin, 1)
    np.add.at(diff, np.minimum(fin + window, n), -1)
    covered = int((np.cumsum(diff)[:n] > 0).sum())
    return covered + extra, int((~done).sum())


def lookup_bytes(queries, keys, window: int,
                 max_iters: int = LOOKUP_MAX_ITERS) -> float:
    """The resolve entry: reads the queries and the keys its windows need,
    and for each query the rounds leave unresolved the log2(N) keys of a
    binary search; writes idx (4 B) and found (1 B) a query."""
    q, n = len(queries), len(keys)
    needed, unresolved = lookup_windows_needed(queries, keys, window,
                                               max_iters)
    return 4 * q + 4 * needed + 5 * q + 4 * unresolved * n.bit_length()


def lookup_ops(q: int, window: int) -> float:
    return 2 * window * q


def _least_seconds_of(name: str, call) -> float:
    if name == "bloom_probe":
        h1, h2, off, nbits, bits, k = call
        return least_seconds(bloom_probe_bytes(h1, h2, off, nbits, bits, k),
                             bloom_probe_ops(len(h1), k))
    queries, keys, window = call
    return least_seconds(lookup_bytes(queries, keys, window),
                         lookup_ops(len(queries), window))


def span_roofline(run: dict, name: str) -> float | None:
    """The roofline share, in %, of the kernel calls the harness tapped
    under ``name``: their least time over the device time of every kernel
    launched inside their spans.  None where no call launched a kernel."""
    trace, calls = run.get("trace"), (run.get("kernel_calls") or {}).get(name)
    if trace is None or not calls:
        return None
    device_s = trace.device_s_by_span().get("kernel." + name)
    if not device_s:
        return None
    return 100.0 * sum(_least_seconds_of(name, c) for c in calls) / device_s
