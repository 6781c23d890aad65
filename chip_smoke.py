#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port of Tidehunter's storage path.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--keys N]

It needs nothing but the checkout (the CUDA kernels build from
``src/repro_torch/kernels/csrc`` with ``nvcc``) and imports nothing of JAX or
of the JAX package.  Phases, each of which exits non-zero on any failure:

1. The card (``nvidia-smi`` name and power limit), PyTorch and CUDA versions,
   and the kernel build: one ``nvcc`` per source, started together.
2. Kernels: each CUDA kernel against its plain PyTorch version on the card,
   bit for bit, at the shapes the main path gives it, plus the u32
   wraparound and budget-exhaustion cases; times from CUDA events (median of
   30) beside the plain version, the library call where one exists, and the
   least time the card's memory rate allows for this run's data.
3. The main path, through the engine's public API with ``device="cuda"``:
   ``put_many`` of N uniform 32-byte keys (sha256) with 1 KiB values in
   batches of 4096, ``flush``, ``close``, reopen (cells UNLOADED, nothing
   memoized), ``multi_exists`` on 32768 keys (half present) and
   ``multi_get`` on 8192 present keys.  Every answer is checked against
   what was written, and every launch count is 0 before and above 0 after.
   Then a second, warm read pass runs under torch.profiler (device time of
   each kernel and copy) and a third under cProfile (host time).

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM non-tensor float32 rate; the
                               # integer work here never comes near it
EXISTS_KEYS = 32768
GET_KEYS = 8192
BATCH = 4096


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


# ----------------------------------------------------------------- timing

def time_ms(fn, reps: int = 30) -> float:
    """Median device time of ``fn`` over ``reps`` runs, from CUDA events.
    A spin kernel ahead of each start event keeps the card busy while the
    host enqueues ``fn``, so the events bracket device work only."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- kernels

def _bloom_bits(rng, n_cells, words, n_add, nbits, k=7):
    """Packed bitsets of ``n_cells`` cells with ``n_add`` random hashes
    added to each; returns (bits, per-cell added (h1, h2))."""
    bits = np.zeros(n_cells * words, np.uint32)
    added = []
    for c in range(n_cells):
        h1 = rng.integers(0, 2**32, n_add, dtype=np.uint32)
        h2 = rng.integers(0, 2**32, n_add, dtype=np.uint32) | np.uint32(1)
        cell = bits[c * words:(c + 1) * words]
        for i in range(k):
            idx = (h1 + np.uint32(i) * h2) % np.uint32(nbits)
            np.bitwise_or.at(cell, (idx >> np.uint32(5)).astype(np.int64),
                             np.uint32(1) << (idx & np.uint32(31)))
        added.append((h1, h2))
    return bits, added


def _bloom_queries(rng, added, n_per_cell, words, nbits):
    """Half present, half random queries per cell: h1, h2, off, nbits."""
    h1, h2, off, nb = [], [], [], []
    for c, (a1, a2) in enumerate(added):
        half = n_per_cell // 2
        pick = rng.choice(len(a1), half, replace=half > len(a1))
        h1 += [a1[pick], rng.integers(0, 2**32, n_per_cell - half,
                                      dtype=np.uint32)]
        h2 += [a2[pick], rng.integers(0, 2**32, n_per_cell - half,
                                      dtype=np.uint32) | np.uint32(1)]
        off.append(np.full(n_per_cell, c * words, np.int32))
        nb.append(np.full(n_per_cell, nbits, np.uint32))
    return [np.concatenate(x) for x in (h1, h2, off, nb)]


def _bloom_words_needed(h1, h2, off, nbits, bits, k=7):
    """Distinct bitset words a probe that stops at its first clear bit must
    read for these queries."""
    import torch
    from repro_torch.kernels.u32 import U32_MASK, widen_u32
    a, b, w = widen_u32(h1), widen_u32(h2), widen_u32(bits)
    nb = widen_u32(nbits) if nbits.dim() else int(nbits)
    live = torch.ones_like(a, dtype=torch.bool)
    words = []
    for i in range(k):
        idx = ((a + i * b) & U32_MASK) % nb
        word = off.to(torch.int64) + (idx >> 5)
        words.append(word[live])
        live &= ((w[word] >> (idx & 31)) & 1) == 1
    return int(torch.unique(torch.cat(words)).numel())


def _lookup_windows_needed(queries, keys, window, max_iters):
    """Distinct keys the lookup must read for these queries: each query's
    final window, plus the two bound keys of every earlier round."""
    import torch
    from repro_torch.kernels.u32 import widen_u32
    q, kk = widen_u32(queries), widen_u32(keys)
    n = kk.shape[0]
    est = (q.to(torch.float32) * (1.0 / 4294967296.0) * float(n)).to(
        torch.int64)
    max_start = max(n - window, 0)
    start = (est - window // 2).clamp(0, max_start)
    done = torch.zeros_like(q, dtype=torch.bool)
    extra = 0
    for _ in range(max_iters):
        lo_ok = (start == 0) | (kk[start] <= q)
        hi_ok = (start + window >= n) | (q <= kk[start + window - 1])
        inside = lo_ok & hi_ok
        extra += 2 * int((~done & ~inside).sum())
        done |= inside
        shifted = torch.where(lo_ok, start + window, start - window)
        start = torch.where(done, start, shifted.clamp(0, max_start))
    diff = torch.zeros(n + 1, dtype=torch.int64, device=q.device)
    fin = start[done]
    diff.index_add_(0, fin, torch.ones_like(fin))
    diff.index_add_(0, fin + window, -torch.ones_like(fin))
    return int((diff.cumsum(0)[:n] > 0).sum()) + extra


def _compare(name, got, want):
    """(mismatches, max |difference|) over outputs that must be equal."""
    import torch
    bad, err = 0, 0
    for g, w in zip(got, want):
        d = (g.to(torch.int64) - w.to(torch.int64)).abs()
        bad += int((d != 0).sum())
        err = max(err, int(d.max()) if d.numel() else 0)
    if bad:
        fail(f"{name}: kernel and plain version differ on {bad} outputs")
    return bad, err


def kernel_phase(seed: int, device: str = "cuda") -> dict:
    import torch
    from repro_torch.kernels.bloom_check import kernel as bk
    from repro_torch.kernels.bloom_check.ref import (bloom_check_ragged_ref,
                                                     bloom_check_ref)
    from repro_torch.kernels.optimistic_lookup import kernel as lk
    from repro_torch.kernels.optimistic_lookup.ref import \
        optimistic_lookup_ref
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    cu = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    out = {}

    # B: the existence path's fused probe — 32768 probes over 256 cells of
    # 2048 words (4096 keys a cell at 10 bits a key, rounded to 2^16 bits).
    cells, words, nbits = 256, 2048, 65536
    bits_np, added = _bloom_bits(rng, cells, words, 4096, nbits)
    h1, h2, off, nb = (cu(a) for a in _bloom_queries(
        rng, added, EXISTS_KEYS // cells, words, nbits))
    bits = cu(bits_np)
    args = (h1, h2, off, nb, bits)
    bad, err = _compare("bloom_check_ragged", [bk.bloom_check_ragged(*args)],
                        [bloom_check_ragged_ref(*args)])
    # u32 wraparound: a modulus that is no power of two makes the 2^32 wrap
    # visible in the probe index.
    odd = 40000
    wbits_np, wadded = _bloom_bits(rng, 16, words, 2000, odd)
    wargs = tuple(cu(a) for a in _bloom_queries(rng, wadded, 512, words, odd))
    wargs = wargs + (cu(wbits_np),)
    b2, e2 = _compare("bloom_check_ragged wraparound",
                      [bk.bloom_check_ragged(*wargs)],
                      [bloom_check_ragged_ref(*wargs)])
    q = h1.shape[0]
    nbytes = 16 * q + q + 4 * _bloom_words_needed(h1, h2, off, nb, bits)
    b_ms, b_by = bound(nbytes, 7 * 6 * q)
    out["bloom_check_ragged"] = dict(
        replaces="src/repro/kernels/bloom_check/kernel.py:68",
        shape=f"Q={q} over {cells} cells x {words} words, k=7",
        mismatches=bad + b2, max_abs_err=max(err, e2),
        ms=time_ms(lambda: bk.bloom_check_ragged(*args)),
        plain_ms=time_ms(lambda: bloom_check_ragged_ref(*args)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)

    # A: one cell's bitset, 4096 queries (the single-cell entry).
    cbits = bits[:words].contiguous()
    a1, a2 = (cu(x) for x in _bloom_queries(rng, added[:1], 4096, words,
                                            nbits)[:2])
    bad, err = _compare("bloom_check", [bk.bloom_check(a1, a2, cbits)],
                        [bloom_check_ref(a1, a2, cbits)])
    wb = cu(wbits_np[:words])
    w1, w2 = (cu(x) for x in _bloom_queries(rng, wadded[:1], 4096, words,
                                            odd)[:2])
    b2, e2 = _compare("bloom_check wraparound",
                      [bk.bloom_check(w1, w2, wb, nbits=odd)],
                      [bloom_check_ref(w1, w2, wb, nbits=odd)])
    zero = torch.zeros_like(a1, dtype=torch.int32)
    nbytes = 8 * 4096 + 4096 + 4 * _bloom_words_needed(
        a1, a2, zero, torch.tensor(nbits, dtype=torch.int64), cbits)
    a_ms, a_by = bound(nbytes, 7 * 6 * 4096)
    out["bloom_check"] = dict(
        replaces="src/repro/kernels/bloom_check/kernel.py:34",
        shape=f"Q=4096 over one cell of {words} words, k=7",
        mismatches=bad + b2, max_abs_err=max(err, e2),
        ms=time_ms(lambda: bk.bloom_check(a1, a2, cbits)),
        plain_ms=time_ms(lambda: bloom_check_ref(a1, a2, cbits)),
        bound_ms=a_ms, bound_by=a_by, library_ms=None)

    # C: the read path's lookup — 8192 queries over 2^20 sorted keys,
    # window 800, half of them present.
    n, window = 1 << 20, 800
    keys_np = np.sort(rng.integers(0, 2**32, n, dtype=np.uint32))
    q_np = np.concatenate([rng.choice(keys_np, GET_KEYS // 2),
                           rng.integers(0, 2**32, GET_KEYS // 2,
                                        dtype=np.uint32)])
    keys, queries = cu(keys_np), cu(q_np)
    got = lk.optimistic_lookup(queries, keys, window=window)
    bad, err = _compare("optimistic_lookup", got,
                        optimistic_lookup_ref(queries, keys, window=window))
    # Budget exhaustion: clustered keys, two rounds, idx = -1 for some.
    ck = np.unique(np.concatenate([
        rng.integers(0, 2**32, 60000, dtype=np.uint32),
        np.arange(2**31, 2**31 + 65536, dtype=np.uint32)]))
    cq = np.concatenate([ck[::97], np.arange(2**31, 2**31 + 65536, 64,
                                             dtype=np.uint32)])
    ckeys, cqueries = cu(ck), cu(cq)
    cgot = lk.optimistic_lookup(cqueries, ckeys, window=128, max_iters=2)
    if not bool((cgot[0] < 0).any()):
        fail("budget-exhaustion case left no query unresolved")
    b2, e2 = _compare("optimistic_lookup budget exhaustion", cgot,
                      optimistic_lookup_ref(cqueries, ckeys, window=128,
                                            max_iters=2))
    iters = got[2]
    nbytes = 4 * GET_KEYS + 9 * GET_KEYS + 4 * _lookup_windows_needed(
        queries, keys, window, 4)
    c_ms, c_by = bound(nbytes, 2 * window * GET_KEYS)
    keys64 = keys.to(torch.int64)
    q64 = queries.to(torch.int64)
    out["optimistic_lookup"] = dict(
        replaces="src/repro/kernels/optimistic_lookup/kernel.py:73",
        shape=f"Q={GET_KEYS} over N={n} keys, window {window}, 4 rounds",
        mismatches=bad + b2, max_abs_err=max(err, e2),
        mean_iters=float(iters.float().mean()),
        ms=time_ms(lambda: lk.optimistic_lookup(queries, keys,
                                                window=window)),
        plain_ms=time_ms(lambda: optimistic_lookup_ref(queries, keys,
                                                       window=window)),
        bound_ms=c_ms, bound_by=c_by,
        library_ms=time_ms(lambda: torch.searchsorted(keys64, q64)),
        library="torch.searchsorted on int64 copies of the same inputs")
    return out


# -------------------------------------------------------------- main path

def make_keys(n: int, tag: bytes) -> list[bytes]:
    return [hashlib.sha256(tag + i.to_bytes(8, "little")).digest()
            for i in range(n)]


def main_path(n_keys: int, seed: int, workdir: str,
              device: str = "cuda") -> dict:
    import torch
    from repro_torch.core.tidestore import DbConfig, KeyspaceConfig, TideDB
    from repro_torch.kernels.bloom_check import kernel as bk
    from repro_torch.kernels.optimistic_lookup import kernel as lk
    rep = 1024 // 32                   # value = key x 32: 1 KiB, checkable
    tag = b"tidehunter-smoke-%d:" % seed
    keys = make_keys(n_keys, tag)
    absent = make_keys(EXISTS_KEYS // 2, tag + b"absent")
    rng = np.random.default_rng(seed)
    cfg = DbConfig(keyspaces=[KeyspaceConfig("kv", n_cells=256)],
                   device=device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    res = {"keys": n_keys, "value_bytes": 32 * rep}

    for launches in (bk.launches, lk.launches):
        for name in launches:
            launches[name] = 0
    db = TideDB(workdir, cfg)
    t0 = time.perf_counter()
    for i in range(0, n_keys, BATCH):
        db.put_many([(k, k * rep) for k in keys[i:i + BATCH]], keyspace="kv")
    t1 = time.perf_counter()
    db.flush()
    db.close()
    t2 = time.perf_counter()
    db = TideDB(workdir, cfg)          # reopen: cells UNLOADED
    t3 = time.perf_counter()
    present = [keys[i] for i in rng.choice(n_keys, EXISTS_KEYS // 2,
                                           replace=False)]
    probe = present + absent
    got = db.multi_exists(probe, keyspace="kv")
    sync()
    t4 = time.perf_counter()
    if got != [True] * len(present) + [False] * len(absent):
        fail("multi_exists answers differ from what was written")
    gkeys = [keys[i] for i in rng.choice(n_keys, GET_KEYS, replace=False)]
    t5 = time.perf_counter()
    vals = db.multi_get(gkeys, keyspace="kv")
    sync()
    t6 = time.perf_counter()
    if vals != [k * rep for k in gkeys]:
        fail("multi_get answers differ from what was written")
    res["launches"] = {**bk.launches, **lk.launches}
    res.update(
        put_s=t1 - t0, put_ops_s=n_keys / (t1 - t0),
        flush_close_s=t2 - t1, reopen_s=t3 - t2,
        exists_s=t4 - t3, exists_ops_s=len(probe) / (t4 - t3),
        get_s=t6 - t5, get_ops_s=GET_KEYS / (t6 - t5),
        value_wal_bytes=db.value_wal.tail,
        kernel_lookups=db.stats()["batched_kernel_lookups"])
    if device == "cuda":
        res["profile"] = profile_reads(db, probe, gkeys)
    db.close()
    return res


def profile_reads(db, probe, gkeys) -> dict:
    """Warm read passes: one under torch.profiler (wall time, the device
    time of each kernel and copy, and their sum), one under cProfile (the
    host functions that take the most time of their own)."""
    import cProfile
    import pstats
    import torch
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for name, call in (("multi_exists", lambda: db.multi_exists(
            probe, keyspace="kv")),
            ("multi_get", lambda: db.multi_get(gkeys, keyspace="kv"))):
        db.cache = type(db.cache)(db.cfg.cache_bytes)     # no value hits
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        dev = {}
        for ev in prof.key_averages():
            t = getattr(ev, "device_time_total", 0) or 0
            if t > 0 and not ev.key.startswith(("aten::", "Activity")):
                dev[ev.key[:60]] = t / 1e3
        db.cache = type(db.cache)(db.cfg.cache_bytes)
        host = cProfile.Profile()
        host.runcall(call)
        stats = pstats.Stats(host).stats
        top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:10]
        out[name] = {
            "wall_ms": wall * 1e3,
            "device_busy_ms": sum(dev.values()),
            "device_ms_by_op": dict(sorted(dev.items(),
                                           key=lambda kv: -kv[1])[:8]),
            "host_own_ms_by_function": {
                f"{Path(f).name}:{line}:{fn}": st[2] * 1e3
                for (f, line, fn), st in top}}
    return out


# ------------------------------------------------------------------- main

def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if res.returncode != 0 or not res.stdout.strip():
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--keys", type=int, default=1 << 20,
                    help="keys written on the main path (default 2^20)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA card: torch.cuda.is_available() is False")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"the repro_torch package is missing under {SRC}")
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    say(f"card: {card}")
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    logs = build.build_all()
    say(f"kernel build: {time.perf_counter() - t0:.3f} s "
        f"({', '.join(build.SOURCES)}) into {build.build_dir()}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"  {name}: {line.strip()}")

    kernels = kernel_phase(args.seed)
    say(f"kernel phase: {json.dumps(kernels)}")

    if args.keys < 1 << 20:
        say(f"main path cut to {args.keys} keys (from 2^20)")
    (ROOT / "build").mkdir(exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="tidedb-smoke-", dir=ROOT / "build")
    try:
        path = main_path(args.keys, args.seed, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    say(f"main path [{card}]: {json.dumps(path)}")
    say(f"main path [{card}]: put {path['put_ops_s']:.0f} ops/s, "
        f"multi_exists {path['exists_ops_s']:.0f} ops/s, "
        f"multi_get {path['get_ops_s']:.0f} ops/s")
    for name in ("bloom_check_ragged", "optimistic_lookup"):
        if path["launches"][name] < 1:
            fail(f"the main path never launched {name}")
    if any(m.split(".")[0] in ("jax", "repro") for m in sys.modules):
        fail("the port pulled in jax or the JAX package")

    rows = []
    for name, src in (("bloom_check_ragged", "bloom_check.cu"),
                      ("bloom_check", "bloom_check.cu"),
                      ("optimistic_lookup", "optimistic_lookup.cu")):
        k = kernels[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": k["replaces"],
            "on_main_path": name != "bloom_check",
            "launches": path["launches"][name],
            "mismatches": k["mismatches"], "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"], "shape": k["shape"],
            "card": card})
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
