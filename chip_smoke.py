#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port of Tidehunter: the storage path, the
sharded storage server, the engine comparison against the LSM baselines
(the paper's RocksDB and BlobDB stand-ins), KV-WAL decode serving of
Llama-3-8B and
Qwen2-MoE-A2.7B, Mamba-2 serving, RecurrentGemma decode through the
KV-WAL's window and pruning, DeepSeek-V3's MLA over the latent arena,
whisper's encoder-decoder, Qwen3-0.6B training with its checkpoints in
the port's ``TideDB``, and the scale-out path (DTensor placements, int8
gradient compression, the pipeline, the roofline and one dry-run cell).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--keys N]

It needs nothing but the checkout (the CUDA kernels build from
``src/repro_torch/kernels/csrc`` with ``nvcc``) and imports nothing of JAX or
of the JAX package.  Phases, each of which exits non-zero on any failure:

1. The card (``nvidia-smi`` name and power limit), PyTorch and CUDA versions,
   and the kernel build: one ``nvcc`` per source, started together.
2. Kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the shapes its main path gives it: the storage kernels bit for bit,
   with the u32 wraparound and budget-exhaustion cases (the lookup's two
   entries: the TPU kernel's contract, and the resolve entry the read path
   launches, against the plain rounds followed by the searchsorted oracle),
   cold and warm; tide_attention at
   Llama-3-8B and RecurrentGemma-9B decode shapes in bf16 (2e-2, and 4e-3
   absolute) and fp32 (2e-5), with a pruned row, sliding windows and two
   empty rows that must be exactly 0, the Llama shape in KV blocks of 8
   and 24 positions (tiles that span blocks), and the group-1 shapes of
   Qwen2-MoE-A2.7B (H = KH = 16, d 128) and whisper's decoder (H = KH =
   20, d 64), each with a pruned row and two empty rows; ssd_scan at
   Mamba-2-1.3B widths (8 x 2048, a ragged 1000 with an initial state,
   100 < chunk) in fp32 (3e-4) and bf16 (mean-error rule, and within one
   bf16 ulp of the kernel's rounding mirrored in plain ops).  Times from
   CUDA events (median of 30) beside the plain version, the library call
   where one exists, and the least time the card allows for this run's
   data (its memory rate or its peak rate for the operations' type), and
   the launch floor: the time
   of a launched kernel that does no work (``torch.cuda._sleep(0)``, timed
   the same way, ``floor_ms`` on every row); ssd_scan also at one
   16384-token prompt, with the device time of each of its three passes
   and its fp32-rate bound beside its tensor-core bound.
3. The storage path, through the engine's public API with ``device="cuda"``:
   ``put_many`` of N uniform 32-byte keys (sha256) with 1 KiB values in
   batches of 4096, ``flush``, ``close``, reopen (cells UNLOADED, nothing
   memoized), ``multi_exists`` on 32768 keys (half present) and
   ``multi_get`` on 8192 present keys.  Every answer is checked against
   what was written.  Then a second, warm read pass runs under
   torch.profiler (device time of each kernel and copy, and the kernels the
   wrappers counted; no cub select or reduce kernel may run in
   ``multi_exists``) and a third under cProfile (host time).  Last, the
   routing sweep (``routing_sweep``): at batch sizes 8 to 32768 it captures
   what the engine hands the Bloom probe and the lookup, runs both routes
   on it 21 times each in alternating order (the answers must agree), and
   prints each route's median and interquartile range and the size from
   which the kernel route wins (its median below the host's by more than
   both ranges, there and at every larger size): the evidence for the
   card's routing thresholds (``bloom.kernel_min_batch``,
   ``large_table.kernel_min_queries``).
4. The serving path: ``ServingEngine`` over full-width Llama-3-8B with
   random weights from a seeded generator, 8 slots of 2048 positions, 16
   greedy requests of 16-1024 prompt tokens and 32 new tokens each.  Every
   request must retire with 32 tokens in the vocabulary, every decode step
   must launch tide_attention (split and combine) once per layer, and the
   recycled segments must equal the blocks the requests used.  Then one decode step runs under
   torch.profiler, and one decode step from one cache goes once through the
   kernel and once through its plain version: at bf16 over 32 layers, and
   in fp32 over 4 layers at 2e-4.
5. Mamba-2-1.3B at full width and depth (bf16, random weights):
   ``serve.prefill`` of 8 x 2048 tokens and 32 greedy decode steps (each of
   ssd_scan's passes once a layer in prefill, never in decode), one
   16384-token prefill, the
   profiles of a decode step and a prefill, and one prefill through the
   kernel and through its plain version (bf16 over 48 layers by the
   mean-error rule, fp32 over 4 layers at 2e-4).
6. RecurrentGemma-9B at full width and depth (bf16, random weights, each
   fp32 leaf freed as it is cast): ``serve.prefill`` of 4 x 2560 tokens into
   4096-position arenas and 64 greedy decode steps (tide_attention once per
   attention block a step, window 2048, ``first_live`` ending at 512), the
   profile of a decode step, and one decode step through the kernel and
   through its plain version.
7. RecurrentGemma's SMOKE config on the card (fp32, KV blocks of 8
   positions, window 16): the same path, its decode step held against the
   plain version at 2e-4.
8. The sharded storage server (run right after phase 3): ``KvBatchServer``
   over ``ShardedTideDB(n_shards=4, replication=2)`` with N/2 keys of the
   same kind (each shard's 64 cells then as full as phase 3's 256): every
   key put through the server in batches of 4096, a
   seeded stream of 65536 requests (50% get, 25% exists, half of them on
   absent keys, 20% overwriting put, 5% delete) checked against scalar
   execution, with its ops/s and the p50/p99 of each request's time from
   submit to done; flush, close, then ``multi_exists`` (half absent) and
   ``multi_get``, their present keys drawn shard by shard so that each
   shard's share reaches the lookup's threshold
   (``large_table.kernel_min_queries``: 9216 a shard on the card), each
   route after its own reopen: the default (the host path on a
   multi-shard store) and ``use_kernel=True``, where the 4 shard threads
   launch at once the Bloom probe and the lookup, each once a shard for
   each call (the script fails on any other count).  Then both routes
   named explicitly, alternated 15 times each on the warm store with the
   value caches dropped before each call, every answer checked: the
   evidence for the multi-shard default route.  Then one flipped
   value byte in a key's primary copy: the server's get must fail over to
   the replica, and ``repair()`` must restore the copy and clear the
   quarantine.  Last, phase 3's routing sweep on shard 0's store.
9. Qwen2-MoE-A2.7B at full width and depth through ``ServingEngine`` (60
   routed experts top-4 and 4 shared, GShard capacity dispatch): the
   random fp32 weights cast to bf16 leaf by leaf (router and norm scales
   kept), the peak of device memory below 80 GB, 16 greedy requests of
   16-512 prompt tokens (one of 1024) and 32 new tokens over 8 slots of
   2048 positions, tide_attention once a layer a step (24); a decode step
   under torch.profiler split into D, the batched products (the MoE
   dispatch and expert einsums), the other products and the rest; the bf16
   step against the fp32 step by the mean rule, 4 layers in fp32 at 2e-4;
   and the SMOKE config on the card against the host at 2e-4.
10. DeepSeek-V3 at full width with its depth cut to 1 layer (13.7 B
   parameters with the MTP module; the full model is 1.34 TB at bf16):
   ``serve.prefill`` of 4 x 512 tokens, 16 greedy decode steps through
   MLA's absorbed form over the 576-dim latent arena (no kernel: D stays
   at 0), step times and peak bytes; the SMOKE config on the card against
   the host.
11. Whisper-large-v3 at full width and depth: 8 x 1500 random frames of
   width 1280, a 4-token prompt, ``serve.prefill`` (encoder, decoder
   prompt, cross K/V) and 32 greedy decode steps, tide_attention once a
   decoder layer a step (32); the decode step's profile, kernel against
   plain (bf16 rule), and the SMOKE config on the card against the host.

12. Training: Qwen3-0.6B at full width and depth (28 layers, d 1024,
   vocab 151936, fp32 parameters and AdamW moments, bf16 activations,
   remat on) through the launcher's loop over a pinned two-batch stream
   of 8 x 2048 tokens: a first run saves at steps 0 and 3 into the port's
   ``TideDB`` and fails at step 5; the resumed run restores step 3 (every
   leaf's blake2b equal to the saved one), runs steps 4-7 (step 4's loss
   equal to the printed digits, step 5's at 1e-3) and saves at 6 and 7,
   whose pruning drops step 0's whole segments.  It prints ms a step,
   tokens/s, peak bytes, a profiled step (idle share, device time by
   kernel group, the AdamW update), each save's and the restore's seconds
   and GB/s, and WAL bytes written and pruned; no kernel may launch.
   Then one train step of each family's SMOKE config on the card against
   the host (loss, gradients and updated parameters at 2e-4), and the
   content-addressed sample store over the phase's 16 rows (8 KiB values,
   ingested twice under two epochs).
13. Scale-out and roofline (after phase 12, in its work directory): (a) an
   NCCL process group of one rank over a ``FileStore`` and
   ``make_host_mesh()``, a (1, 1) ("data", "model") mesh; (b) two
   Qwen3-0.6B train steps at phase 12's settings with the state placed by
   ``param_specs`` in ``fsdp`` mode (DTensors, whose backward sums the
   gradients itself) and the error-feedback int8 compressor as
   ``compress_grads``, against the same steps on plain tensors with the
   same compressor (losses and every leaf at phase 12's card-against-host
   tolerances, bit-equality reported); in the plain steps' hook
   ``compressed_psum`` over the mesh's data group, held bit for bit
   against the int8 round trip of one rank, and the hook's device time
   beside its byte bound; (c) phase 12's newest checkpoint restored onto
   the mesh's placements, each
   leaf's blake2b equal to the plain restore's; (d) ``pipeline_forward``
   with one stage against the sequential loop at 1e-5; (e) ``op_cost`` and
   the roofline of phase 12's train step and of the serving phase's
   Llama-3-8B decode step, beside their measured times (MFU, multiple of
   the bound); (f) the dry run's qwen3-0.6b x train_4k cell on a fake
   process group of 256 ranks, mamba2-1.3b's SMOKE train cell on a fake
   (2, 2) mesh (its SSD's cumsums flip in the backward, for which this
   torch's DTensor may lack a rule: the dry run then registers its own),
   mamba2-1.3b x train_4k on 16 x 16 and 2 x 16 x 16, and qwen3-0.6b x
   train_4k on 2 x 16 x 16, each in a subprocess, all at once: status
   ``ok``, no op run replicated but those ``dryrun.REPLICABLE`` names,
   each with the bytes it gathered; in the one-pod qwen3 cell no view
   (every torch gets the dry run's view rule) and a footprint a device
   (arguments plus the trace's high-water mark) at most 1.5x the JAX
   package's peak for the same cell; the two-pod cells' footprints and
   collectives beside the JAX package's on that mesh, mamba2-1.3b's
   footprint at most 1.5x its peak and qwen3-0.6b's at most 5x (ROADMAP
   C.12); two serving cells on 16 x 16 beside the JAX package's:
   qwen3-0.6b x prefill_32k (its cache placed on the mesh, its footprint
   at most 1.7e10 B a device) and phi3-mini-3.8b x decode_32k (its arena
   read where it lies, its collectives at most 1e10 B); and two train
   cells on 16 x 16 held on the reference's terms (the reference's
   argument + temp - alias: the donated state and the outputs that
   replace it left out, ROADMAP C.16): qwen2-moe-a2.7b x train_4k at most
   2x the JAX package's peak, and deepseek-v3-671b x train_4k at 2 layers
   at most the JAX package's peak with no tensor of ``we_down``'s whole
   shape live at its peak (C.17) and no view run replicated;
   deepseek-v3-671b x train_4k on
   2 x 16 x 16 at full depth with no view run replicated and a footprint
   at most 7.55e11 B a device, no stack of its layers' expert gradients
   whole over the data axes live at its peak (C.19); in that cell and
   both mamba2-1.3b x train_4k cells the new parameters and moments come
   out of AdamW placed as their specs (``memory.outputs_placed`` empty)
   and the footprint is at least the arguments and the donated state
   (C.20).  Every cell prints both peaks.
14. The engine comparison (after phase 8): the port's ``TideDB`` (phase
   3's config, its batched reads launching B and C), ``rocksdb(sim)`` and
   ``blobdb(sim)`` (``core/lsm_baseline.py`` with 512-entry memtables,
   leveled and key-value separated) each take 2^18 uniform 32-byte keys
   with 1 KiB values (cut from phase 3's 2^20 for the script's time):
   put ops/s (``put_many`` in batches of 4096 against scalar ``put``),
   flush, the fill rate (puts and flush, as the reference's benchmarks
   time it), write amplification, then 8192 gets and 32768 existence checks
   (half absent) with the value caches dropped, batched against scalar;
   every answer checked.
15. The scrub race (after phase 14): ``scrub_race_phase`` on phase 3's
   layout at 2^14 keys, 5 ``scrub()`` passes racing a thread of
   ``put_many`` of 64 keys and ``prune_step(PruneOptions(
   batch_records=64))``, whose relocation drops segments under the
   scrubber; after each pass the untouched keys read back through
   ``multi_get`` and ``multi_exists`` with ``use_kernel=True`` (B and C
   launch), the churned ones once the thread stops.  No pass may report
   a corruption or quarantine a position, and every answer must be what
   was last written.

Every launch count is set to 0 just before each path and read just after.
The line before the last is ``{"kernels": [...]}``, each kernel with its
launches on every path; the last is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import collections
import hashlib
import json
import os
import re
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
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core rate
L2_BYTES = 50 << 20            # H100 L2 cache
EXISTS_KEYS = 32768
GET_KEYS = 8192
BATCH = 4096
N_SHARDS = 4                   # the reference's sharded engine
REPLICATION = 2                # its self-healing benchmark's setting
SERVER_BATCH = 4096
MIXED_REQUESTS = 65536
SWEEP_SIZES = [8 << i for i in range(13)]     # 8 .. 32768 queries a batch
SWEEP_SAMPLES = 21             # a route and size, in alternating order
ROUTE_PAIRS = 15               # phase 8's alternations of the two routes
ENGINE_KEYS = 1 << 18          # phase 14: cut from phase 3's 2^20


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


# ----------------------------------------------------------------- timing

def time_ms(fn, reps: int = 30, cold: bool = False) -> float:
    """Median device time of ``fn`` over ``reps`` runs, from CUDA events.
    A spin kernel ahead of each start event keeps the card busy while the
    host enqueues ``fn``, so the events bracket device work only.  ``cold``
    overwrites a buffer of four times the L2 cache before each run, so ``fn``
    finds its inputs in device memory, as a decode step finds each layer's
    arena after the weights of the layer before have streamed through."""
    import torch
    flush = torch.empty(4 * L2_BYTES, dtype=torch.uint8, device="cuda") \
        if cold else None
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if flush is not None:
            flush.fill_(1)
        torch.cuda._sleep(20_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, nops: float,
          ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
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
    from repro_torch.kernels.optimistic_lookup.ref import (
        lookup_indices_ref, optimistic_lookup_ref)
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
        cold_ms=time_ms(lambda: bk.bloom_check_ragged(*args), cold=True),
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
        cold_ms=time_ms(lambda: bk.bloom_check(a1, a2, cbits), cold=True),
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
    window_bytes = 4 * _lookup_windows_needed(queries, keys, window, 4)
    # Reads the queries and the windows, writes idx, found and iters.
    c_ms, c_by = bound(4 * GET_KEYS + window_bytes + 9 * GET_KEYS,
                       2 * window * GET_KEYS)
    keys64 = keys.to(torch.int64)
    q64 = queries.to(torch.int64)
    library_ms = time_ms(lambda: torch.searchsorted(keys64, q64))
    raw = lambda: lk.optimistic_lookup(queries, keys, window=window)
    out["optimistic_lookup"] = dict(
        replaces="src/repro/kernels/optimistic_lookup/kernel.py:73",
        shape=f"Q={GET_KEYS} over N={n} keys, window {window}, 4 rounds",
        mismatches=bad + b2, max_abs_err=max(err, e2),
        mean_iters=float(iters.float().mean()),
        ms=time_ms(raw), cold_ms=time_ms(raw, cold=True),
        plain_ms=time_ms(lambda: optimistic_lookup_ref(queries, keys,
                                                       window=window)),
        bound_ms=c_ms, bound_by=c_by, library_ms=library_ms,
        library="torch.searchsorted on int64 copies of the same inputs")

    # C's resolve entry, the one the read path launches: the same rounds,
    # then a lower bound over the whole array where they ran out, against
    # the plain rounds followed by the searchsorted oracle.
    bad, err = _compare("optimistic_lookup_resolve",
                        lk.optimistic_lookup_resolve(queries, keys,
                                                     window=window),
                        lookup_indices_ref(queries, keys, window=window))
    b2, e2 = _compare("optimistic_lookup_resolve budget exhaustion",
                      lk.optimistic_lookup_resolve(cqueries, ckeys,
                                                   window=128, max_iters=2),
                      lookup_indices_ref(cqueries, ckeys, window=128,
                                         max_iters=2))
    # Writes idx and found only; an unresolved query reads at least the
    # log2(N) keys of a binary search besides.
    unresolved = int((got[0] < 0).sum())
    r_ms, r_by = bound(4 * GET_KEYS + window_bytes + 5 * GET_KEYS
                       + 4 * unresolved * n.bit_length(),
                       2 * window * GET_KEYS)
    resolve = lambda: lk.optimistic_lookup_resolve(queries, keys,
                                                   window=window)
    out["optimistic_lookup_resolve"] = dict(
        replaces="src/repro/kernels/optimistic_lookup/kernel.py:73",
        shape=f"Q={GET_KEYS} over N={n} keys, window {window}, 4 rounds, "
              f"{unresolved} unresolved",
        mismatches=bad + b2, max_abs_err=max(err, e2),
        ms=time_ms(resolve), cold_ms=time_ms(resolve, cold=True),
        plain_ms=time_ms(lambda: lookup_indices_ref(queries, keys,
                                                    window=window)),
        bound_ms=r_ms, bound_by=r_by, library_ms=library_ms,
        library="torch.searchsorted on int64 copies of the same inputs")
    return out


# ---------------------------------------------------------- launch counts

def _launch_counts() -> list[dict]:
    from repro_torch.kernels.bloom_check import kernel as bk
    from repro_torch.kernels.optimistic_lookup import kernel as lk
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.tide_attention import kernel as tk
    return [bk.launches, lk.launches, tk.launches, sk.launches]


def reset_launches() -> None:
    for counts in _launch_counts():
        for name in counts:
            counts[name] = 0


def read_launches() -> dict:
    return {k: v for counts in _launch_counts() for k, v in counts.items()}


def _close(got, want, tol: float) -> float:
    """max |got - want|, after checking |got - want| <= tol + tol |want|
    everywhere (torch.testing.assert_close with rtol = atol = tol)."""
    import torch
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        fail("non-finite output")
    d = (g - w).abs()
    if bool((d > tol + tol * w.abs()).any()):
        fail(f"outputs differ beyond rtol = atol = {tol}: max |diff| "
             f"{float(d.max())}")
    return float(d.max())


# ---------------------------------------------------- kernel D: attention

def _tide_shape(rng, dev, B, H, KH, d, NB, blk, lens, live, windows,
                timed_window: int, empty_rows: bool,
                empty=((0, 300, 700), (0, 384, 128))) -> dict:
    """tide_attention at one decode shape: bf16 (rtol 2e-2 and 4e-3
    absolute) and fp32 (2e-5) against the plain version at each window; with
    ``empty_rows``, two empty rows that must be exactly 0 beside a live one
    (``empty``: their seq_lens and first_live); then cold CUDA-event medians
    of kernel, plain version and SDPA at ``timed_window`` beside the byte
    bound of this run's live positions."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import kvwal
    from repro_torch.kernels.tide_attention import kernel as tk
    from repro_torch.kernels.tide_attention.ref import (live_mask,
                                                        tide_attention_ref)
    host = [rng.standard_normal(shape, dtype=np.float32) for shape in
            ((B, H, d), (B, NB, blk, KH, d), (B, NB, blk, KH, d))]
    table = np.stack([rng.permutation(NB) for _ in range(B)])
    ints = [torch.from_numpy(np.asarray(a).astype(np.int32)).to(dev)
            for a in (table, lens, live)]
    cases = {}
    # bf16 is held at rtol = atol = 2e-2 (the JAX package's kernel tests)
    # and, since a typical output here is only ~0.04, at 4e-3 absolute too:
    # a fault in the bf16 loads or rounding alone would pass the first.
    for dtype, tol, atol in ((torch.bfloat16, 2e-2, 4e-3),
                             (torch.float32, 2e-5, 2e-5)):
        args = [torch.from_numpy(a).to(dev, dtype) for a in host] + ints
        for window in windows:
            got = tk.tide_attention(*args, window=window)
            want = tide_attention_ref(*args, window=window)
            err = _close(got, want, tol)
            if err > atol:
                fail(f"tide_attention {dtype} window={window}: max |diff| "
                     f"{err} beyond {atol}")
            cases[f"{dtype}".split(".")[1] + f" window={window}"] = err
        if empty_rows:
            # Two empty rows beside a live one: seq_len = 0, and every
            # position below first_live.  Both must be exactly 0.
            e_args = [a[:3].clone() for a in args[:3]] + [
                ints[0][:3].clone(),
                torch.tensor(empty[0], dtype=torch.int32, device=dev),
                torch.tensor(empty[1], dtype=torch.int32, device=dev)]
            got = tk.tide_attention(*e_args)
            if bool(got[:2].any()):
                fail(f"tide_attention {dtype}: an empty row is not 0")
            _close(got[2], tide_attention_ref(*e_args)[2], tol)

    args = [torch.from_numpy(a).to(dev, torch.bfloat16) for a in host] + ints
    n_pos = NB * blk
    w = timed_window
    mask = live_mask(args[4], args[5], n_pos, w)
    live_pos = int(mask.sum())
    G = H // KH
    nbytes = (live_pos * KH * 2 * d * 2          # live K and V rows, bf16
              + 2 * B * H * d * 2                # q in, out
              + B * NB * 4 + 2 * B * 4)          # table, lengths
    t_ms, t_by = bound(nbytes, live_pos * KH * G * 4 * d, BF16_OPS_PER_S)
    # Library yardstick: one SDPA call on K/V gathered into contiguous
    # (B, KH, S, d) copies beforehand, with the same boolean mask.
    kg = kvwal.gather(args[1], args[3]).permute(0, 2, 1, 3).contiguous()
    vg = kvwal.gather(args[2], args[3]).permute(0, 2, 1, 3).contiguous()
    qs = args[0][:, :, None, :]
    sdpa = lambda: F.scaled_dot_product_attention(
        qs, kg, vg, attn_mask=mask[:, None, None, :], enable_gqa=True)
    lib_err = (sdpa()[:, :, 0].float() - tide_attention_ref(
        *args, window=w).float()).abs().max()
    S, R = tk.plan(*args[:3], w)
    run = lambda: tk.tide_attention(*args, window=w)
    ms, warm_ms = time_ms(run, cold=True), time_ms(run)
    # Device time a call of each of D's two kernels, over 20 warm calls.
    prof = device_profile(lambda: [run() for _ in range(20)], "tide")
    return dict(
        shape=f"B={B} H={H} KH={KH} d={d} blk={blk} NB={NB} window={w} "
              f"bf16, {live_pos} live positions",
        splits=S, tile=R, max_abs_err=cases[f"bfloat16 window={w}"],
        cases=cases,
        ms=ms, warm_ms=warm_ms,
        device_us_by_kernel={k: t * 1e3 / 20 for k, t in
                             prof["device_ms_by_op"].items() if "tide" in k},
        plain_ms=time_ms(lambda: tide_attention_ref(*args, window=w),
                         cold=True),
        bound_ms=t_ms, bound_by=t_by, bytes=nbytes,
        library_ms=time_ms(sdpa, cold=True),
        library="torch scaled_dot_product_attention (enable_gqa) on K/V "
                f"gathered beforehand; max |diff| to plain {float(lib_err)}")


def _tide_any_block(rng, dev) -> dict:
    """tide_attention where the tile does not divide the KV block, so tiles
    span blocks: the Llama-3-8B decode shape cut into blocks of 8 (256 of
    them) and of 24 (86), with a pruned row, at the bf16 (2e-2, and 4e-3
    absolute) and fp32 (2e-5) tolerances of the main shapes."""
    import torch
    from repro_torch.kernels.tide_attention import kernel as tk
    from repro_torch.kernels.tide_attention.ref import tide_attention_ref
    B, H, KH, d = 8, 32, 8, 128
    out = {}
    for blk, NB, window in ((8, 256, 0), (24, 86, 300)):
        lens = rng.integers(1, NB * blk + 1, B)
        live = np.zeros(B, np.int64)
        live[0] = lens[0] // 3
        host = [rng.standard_normal(shape, dtype=np.float32) for shape in
                ((B, H, d), (B, NB, blk, KH, d), (B, NB, blk, KH, d))]
        table = np.stack([rng.permutation(NB) for _ in range(B)])
        ints = [torch.from_numpy(np.asarray(a).astype(np.int32)).to(dev)
                for a in (table, lens, live)]
        case = {}
        for dtype, tol, atol in ((torch.bfloat16, 2e-2, 4e-3),
                                 (torch.float32, 2e-5, 2e-5)):
            args = [torch.from_numpy(a).to(dev, dtype) for a in host] + ints
            err = _close(tk.tide_attention(*args, window=window),
                         tide_attention_ref(*args, window=window), tol)
            if err > atol:
                fail(f"tide_attention {dtype} blk={blk}: max |diff| {err} "
                     f"beyond {atol}")
            case[str(dtype).split(".")[1]] = err
        S, R = tk.plan(*args[:3], window)
        out[f"blk={blk}"] = dict(NB=NB, window=window, splits=S, tile=R,
                                 max_abs_err=case)
    return out


def tide_phase(seed: int, device: str = "cuda") -> dict:
    """tide_attention at the decode shapes that use it.  Llama-3-8B:
    B=8 slots, 32 query heads over 8 kv-heads, head_dim 128, blocks of 128,
    16 blocks = 2048 positions, random permuted tables, lengths 1-2048, row
    0 pruned below position 512, windows 0 and 300, and two empty rows.
    RecurrentGemma-9B: B=4, 16 query heads over 1 kv-head of 256, 32 blocks
    of 128, window 2048, first_live 512, seq_len 2624 (the griffin path's
    last decode step).  Qwen2-MoE-A2.7B: B=8, 16 query heads over 16
    kv-heads of 128 (a group of 1), 16 blocks of 128, as Llama's rows.
    Whisper-large-v3's decoder: B=8, 20 heads over 20 kv-heads of 64, 4
    blocks of 128 (its 448-position context), lengths 1-448, row 0 pruned
    below 128, two empty rows.  The Llama shape's numbers head the row; the
    others sit under ``recurrentgemma``, ``qwen2_moe`` and ``whisper``, and
    the Llama shape in blocks of 8 and 24 positions under ``any_block``."""
    import torch
    dev = torch.device(device)
    rng = np.random.default_rng(seed + 4)
    B, NB, blk = 8, 16, 128
    lens = rng.integers(1, NB * blk + 1, B)
    lens[0] = max(lens[0], 1024)
    live = np.zeros(B, np.int64)
    live[0] = 512
    llama = _tide_shape(rng, dev, B, 32, 8, 128, NB, blk, lens, live,
                        (0, 300), 0, empty_rows=True)
    griffin = _tide_shape(rng, dev, 4, 16, 1, 256, 32, 128, [2624] * 4,
                          [512] * 4, (2048,), 2048, empty_rows=False)
    any_block = _tide_any_block(rng, dev)
    # Group-1 shapes: each CTA's 16-row tile carries one live query head.
    qwen = _tide_shape(rng, dev, B, 16, 16, 128, NB, blk, lens, live,
                       (0, 300), 0, empty_rows=True)
    w_lens = rng.integers(1, 449, B)
    w_lens[0] = max(w_lens[0], 256)
    w_live = np.zeros(B, np.int64)
    w_live[0] = 128
    whisper = _tide_shape(rng, dev, B, 20, 20, 64, 4, blk, w_lens, w_live,
                          (0,), 0, empty_rows=True,
                          empty=((0, 150, 400), (0, 256, 128)))
    return dict(llama, replaces="src/repro/kernels/tide_attention/kernel.py:79",
                max_abs_err=max(x["max_abs_err"] for x in
                                (llama, griffin, qwen, whisper)),
                recurrentgemma=griffin, qwen2_moe=qwen, whisper=whisper,
                any_block=any_block)


# ------------------------------------------------------------ serving path

def serve_path(cfg, seed: int, device: str = "cuda", *, requests: int = 16,
               slots: int = 8, max_seq: int = 2048, new_tokens: int = 32,
               prompt_lens: tuple = (16, 1024), extra_prompts: tuple = ()
               ) -> dict:
    """Serve ``requests`` greedy requests through ``ServingEngine``, prompts
    of ``prompt_lens`` tokens and, in place of the last draws, one of each
    length in ``extra_prompts``; check every answer's shape and range, the
    kernel's launch count and the recycled segments.  Returns the engine
    (still holding its weights) and the measurements, with the device
    memory peak of the engine's start (random fp32 weights, their cast) and
    of the whole run."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ServingEngine
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    _reset_peak(device)
    engine = ServingEngine(cfg, T.init_params(cfg, gen), batch_slots=slots,
                           max_seq=max_seq, seed=seed, device=device)
    init_peak = _peak_bytes(device)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(
        prompt_lens[0], prompt_lens[1] + 1))) for _ in range(requests)]
    for i, n in enumerate(extra_prompts):
        prompts[requests - len(extra_prompts) + i] = rng.integers(
            0, cfg.vocab, n)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    reset_launches()
    t0 = time.perf_counter()
    reqs = [engine.submit(p, max_new_tokens=new_tokens) for p in prompts]
    done = engine.run_until_drained()
    sync()
    wall = time.perf_counter() - t0
    launches = read_launches()

    if len(done) != requests or not all(r.done for r in reqs):
        fail("not every request retired")
    for r in reqs:
        if len(r.out_tokens) != new_tokens or not all(
                0 <= t < cfg.vocab for t in r.out_tokens):
            fail(f"request {r.rid}: {len(r.out_tokens)} tokens, some outside "
                 f"[0, {cfg.vocab})")
    want = cfg.n_layers * engine.decode_steps
    if launches["tide_attention"] != want:
        fail(f"tide_attention launched {launches['tide_attention']} times, "
             f"not {cfg.n_layers} layers x {engine.decode_steps} steps")
    blocks = sum(-(-(len(p) + new_tokens - 1) // cfg.kv_block)
                 for p in prompts)
    if engine.segments_recycled != blocks:
        fail(f"{engine.segments_recycled} segments recycled, the requests "
             f"used {blocks} blocks")
    tokens = requests * new_tokens
    # K/V rows kernel D read over the run: a request's j-th decode step
    # reads its prompt and j tokens; an empty slot reads the one row its
    # step appends.
    busy = requests * (new_tokens - 1)
    kv_reads = sum(len(p) * (new_tokens - 1) + new_tokens * (new_tokens - 1)
                   // 2 for p in prompts) + slots * engine.decode_steps - busy
    return engine, dict(
        arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
        slots=slots, max_seq=max_seq, requests=requests,
        prompt_tokens=sum(len(p) for p in prompts), new_tokens=tokens,
        launches=launches, decode_steps=engine.decode_steps,
        kv_reads=kv_reads, segments_recycled=engine.segments_recycled, wall_s=wall,
        tokens_per_s=tokens / wall, init_peak_bytes=init_peak,
        peak_bytes=_peak_bytes(device),
        prefill_ms_per_request=engine.prefill_s / engine.prefills * 1e3,
        decode_ms_per_step=engine.decode_s / engine.decode_steps * 1e3)


def _fill_slots(engine, seed: int, prompt_lens=(16, 1024)) -> None:
    """Admit one request into every slot (prompts of the given lengths) and
    take one step, so that every slot decodes over its own cache."""
    rng = np.random.default_rng(seed + 1)
    for _ in range(engine.slots):
        n = int(rng.integers(prompt_lens[0], prompt_lens[1] + 1))
        engine.submit(rng.integers(0, engine.cfg.vocab, n),
                      max_new_tokens=1 << 20)
    engine.step()


def kernel_vs_plain(run, module, attr: str, plain, with_fp32: bool) -> dict:
    """``run(wide)`` → logits, once through the kernel, once with
    ``module.attr`` pointed at its plain version and, with ``with_fp32``,
    once more through the plain version with ``wide=True`` (the caller runs
    the same weights and inputs widened to fp32) → {"kernel": logits,
    "plain": logits, "fp32": logits or None}, all as fp32."""
    import torch
    kernel = getattr(module, attr)
    out = {"fp32": None}
    runs = [("kernel", kernel, False), ("plain", plain, False)]
    if with_fp32:
        runs.append(("fp32", plain, True))
    try:
        for name, fn, wide in runs:
            setattr(module, attr, fn)
            with torch.no_grad():
                out[name] = run(wide).float()
    finally:
        setattr(module, attr, kernel)
    return out


def decode_runner(params, cfg, cache: dict, tokens):
    """``run(wide)`` for ``kernel_vs_plain``: one decode step from a copy of
    ``cache`` (its floating-point entries widened to fp32 where ``wide``)."""
    import dataclasses
    import torch
    from repro_torch.models import serve
    cfg32 = dataclasses.replace(cfg, dtype="float32")

    def run(wide):
        step = {k: v.float().clone() if wide and v.is_floating_point()
                else v.clone()
                for k, v in cache.items()}
        return serve.decode_step(params, cfg32 if wide else cfg, step,
                                 tokens)[0]
    return run


def bf16_check(name: str, step: dict, max_rule: bool = True) -> dict:
    """Kernel and plain version are two bf16 computations of one function,
    so each lies within the bf16 error of the same computation in fp32.  A
    maximum over ~1M logits is set by outliers, so the check that binds is
    on the mean: the kernel's mean error against the fp32 run may exceed the
    plain version's by at most a quarter, which a systematic error in the
    kernel would break.  With ``max_rule`` the largest difference between
    kernel and plain must also stay within twice the plain version's own
    largest error against fp32 (the sum of two errors of its size)."""
    import torch
    k, p, ref = step["kernel"], step["plain"], step["fp32"]
    if not torch.isfinite(k).all():
        fail(f"{name}: kernel logits not finite")
    err_plain = float((p - ref).abs().max())
    bf = dict(
        max_abs_err=float((k - p).abs().max()), tol=2 * err_plain,
        kernel_vs_fp32=float((k - ref).abs().max()), plain_vs_fp32=err_plain,
        mean_kernel_vs_fp32=float((k - ref).abs().mean()),
        mean_plain_vs_fp32=float((p - ref).abs().mean()),
        max_abs_logit=float(ref.abs().max()),
        argmax_agree=int((k.argmax(-1) == p.argmax(-1)).sum()),
        rows=k.shape[0])
    bf["mean_tol"] = 1.25 * bf["mean_plain_vs_fp32"]
    say(f"{name}: {json.dumps(bf)}")
    if bf["mean_kernel_vs_fp32"] > bf["mean_tol"]:
        fail(f"{name}: the kernel's mean |diff| to the fp32 run exceeds 1.25 "
             f"times the plain version's")
    if max_rule and bf["max_abs_err"] > bf["tol"]:
        fail(f"{name}: kernel against plain, max |diff| beyond twice the "
             f"plain version's error against fp32")
    return bf


def device_profile(fn, match: str, top: int | None = 10) -> dict:
    """``fn()`` under torch.profiler: wall time, device time by op (the
    ``top`` largest, or every op), the share of the kernels whose name holds
    ``match`` and of the matrix products, and the device's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev, aten = {}, {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", 0) or 0
        # The products by the op that launched them: batched (``einsum``:
        # the MoE dispatch and experts) or two-dimensional (projections).
        if ev.key in ("aten::bmm", "aten::mm", "aten::addmm"):
            aten[ev.key] = t / 1e3
        # Operator and runtime- and driver-API rows (cudaLaunchKernel,
        # cuLaunchKernelEx, "Command Buffer Full") carry device time of the
        # kernels they launch: skip them.
        if t > 0 and not ev.key.startswith(("aten::", "Activity", "cuda",
                                            "cuLaunch", "Command Buffer")):
            dev[ev.key[:70]] = dev.get(ev.key[:70], 0) + t / 1e3
    busy = sum(dev.values())
    hit = sum(t for k, t in dev.items() if match in k)
    mm = sum(t for k, t in dev.items()
             if any(w in k for w in ("gemm", "nvjet", "cutlass", "xmma")))
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall, f"{match}_ms": hit,
            f"{match}_share": hit / busy if busy else 0.0,
            "matmul_ms": mm, "matmul_share": mm / busy if busy else 0.0,
            "device_ms_by_aten": aten,
            "device_ms_by_op": dict(sorted(dev.items(),
                                           key=lambda kv: -kv[1])[:top])}


def profile_step(engine) -> dict:
    """One decode step (every slot active) under torch.profiler: wall time,
    device time by op, the kernel's share and the device's idle share; then
    one under cProfile: the host functions that take the most time of their
    own."""
    prof = device_profile(engine.step, "tide")
    prof["host_own_ms_by_function"] = host_profile(engine.step)
    return prof


def host_profile(fn) -> dict:
    """``fn()`` under cProfile: the host functions that take the most time
    of their own, in ms (cProfile adds a cost to every Python call, so the
    proportions count, not the sums)."""
    import cProfile
    import pstats
    host = cProfile.Profile()
    host.runcall(fn)
    stats = pstats.Stats(host).stats
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:12]
    return {f"{Path(f).name}:{line}:{fn_}": st[2] * 1e3
            for (f, line, fn_), st in top}


def _engine_step(engine):
    """``decode_runner`` over the engine's weights and cache, each slot's
    last token as input."""
    import torch
    tokens = torch.tensor([engine.active[s].out_tokens[-1]
                           for s in range(engine.slots)],
                          dtype=torch.int32, device=engine.device)
    return decode_runner(engine.params, engine.cfg, engine.cache, tokens)


def serve_phase(seed: int, device: str = "cuda", arch: str = "llama3-8b",
                smoke: bool = False) -> dict:
    """The serving path at full width, then the decode-step checks: the
    profile, and kernel against plain in bf16 over every layer and in fp32
    over 4 layers.  A moe model takes prompts of 16-512 tokens and, in
    place of the last, one of 1024: its prefill groups a prompt's tokens
    by 512, and a length above 512 that 512 does not divide raises, as in
    the JAX package.  Its profile splits the step's device time into D,
    the batched products (the MoE dispatch and expert einsums), the other
    products and the rest."""
    import dataclasses
    import gc
    import torch
    from repro_torch.configs.registry import get_config
    cfg = get_config(arch, smoke=smoke)
    name = "serving path" if arch == "llama3-8b" else f"{arch} path"
    small = dict(requests=6, slots=3, max_seq=64, new_tokens=5,
                 prompt_lens=(2, 20)) if smoke else {}
    if cfg.moe is not None and not smoke:
        small = dict(prompt_lens=(16, 512), extra_prompts=(1024,))
    engine, res = serve_path(cfg, seed, device, **small)
    say(f"{name}: {json.dumps(res)}")
    plens = small.get("prompt_lens", (16, 1024))
    _fill_slots(engine, seed, plens)
    if device == "cuda":
        prof = res["profile"] = profile_step(engine)
        # The profiler's host overhead stretches the step it traces; the
        # idle share that describes serving is the device's busy time
        # against the unprofiled mean step.
        prof["idle_share_unprofiled"] = \
            1 - prof["device_busy_ms"] / res["decode_ms_per_step"]
        if cfg.moe is not None:
            by = prof["device_ms_by_aten"]
            bmm = by.get("aten::bmm", 0.0)
            mm = by.get("aten::mm", 0.0) + by.get("aten::addmm", 0.0)
            prof["breakdown_ms"] = {
                "tide_attention": prof["tide_ms"],
                "batched products (MoE dispatch and experts)": bmm,
                "other products": mm,
                "rest": prof["device_busy_ms"] - prof["tide_ms"] - bmm - mm}
        say(f"{name}, decode step profile: {json.dumps(prof)}")
    from repro_torch.kernels.tide_attention.ref import tide_attention_ref
    from repro_torch.models import serve
    step = kernel_vs_plain(_engine_step(engine), serve, "decode_attention",
                           tide_attention_ref, with_fp32=True)
    res["bf16_step"] = bf16_check(f"{name}, bf16 decode step", step)
    del engine, step
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    cfg32 = dataclasses.replace(cfg, n_layers=min(cfg.n_layers, 4),
                                dtype="float32")
    engine, _ = serve_path(cfg32, seed, device, **dict(
        small, requests=1, new_tokens=2, extra_prompts=()))
    _fill_slots(engine, seed, plens)
    step = kernel_vs_plain(_engine_step(engine), serve, "decode_attention",
                           tide_attention_ref, with_fp32=False)
    k, p = step["kernel"], step["plain"]
    res["fp32_step"] = dict(n_layers=cfg32.n_layers,
                            max_abs_err=float((k - p).abs().max()),
                            max_abs_logit=float(p.abs().max()))
    say(f"{name}, fp32 decode step: {json.dumps(res['fp32_step'])}")
    _close(k, p, 2e-4)
    del engine
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return res


# --------------------------------------------------- kernel E: SSD scan

def _ssd_inputs(rng, b, l, h, p, n, dev, init=False):
    """x, dt (after a softplus), A (negative), Bm, Cm and, with ``init``, an
    initial state, fp32 on ``dev``, drawn as the JAX package's
    ``TestSsdScan`` draws them."""
    import torch
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        dev)
    x = t(rng.standard_normal((b, l, h, p), dtype=np.float32))
    dt = t(np.logaddexp(rng.standard_normal((b, l, h)), 0))
    A = t(-np.exp(rng.standard_normal(h) * 0.3))
    Bm = t(rng.standard_normal((b, l, n)) * 0.5)
    Cm = t(rng.standard_normal((b, l, n)) * 0.5)
    s0 = t(rng.standard_normal((b, h, p, n)) * 0.5) if init else None
    return x, dt, A, Bm, Cm, s0


def ssd_cost(b, l, h, p, n, c) -> tuple[float, float, float]:
    """(bytes, tensor-core flops, fp32 flops) of one SSD scan with bf16 x,
    Bm, Cm and y.  Bytes: those four in bf16, dt, A and the final state in
    fp32, each read or written once.  Flops: what the function needs, the
    causal half of each chunk's c x c square (its c(c+1)/2 pairs j <= i).
    C·Bᵀ multiplies two bf16 inputs into fp32, which bf16 tensor cores do
    exactly: 2n a pair a (sequence, chunk).  Every other product takes an
    fp32 operand (the decays, the carried state), so it runs at the fp32
    rate: 2p a pair for the within-chunk term and 4cnp for the cross-chunk
    term and the state update, a (sequence, chunk, head)."""
    nc = -(-l // c)
    pairs = c * (c + 1) // 2
    nbytes = (4 * b * l * h * p + 4 * b * l * n
              + 4 * b * l * h + 4 * h + 4 * b * h * p * n)
    tc_flops = b * nc * 2 * pairs * n
    fp32_flops = b * nc * h * (2 * pairs * p + 4 * c * n * p)
    return nbytes, tc_flops, fp32_flops


def ssd_bounds(b, l, h, p, n, c) -> dict:
    """E's two bounds, each the larger of its operations' time and the
    bytes' time.  ``fp32_bound_ms``: the terms with an fp32 operand at the
    fp32 rate beside the bf16 C·Bᵀ on tensor cores (the slower binds), the
    bound while those terms could not run on tensor cores.  ``bound_ms``:
    every product at the bf16 tensor-core rate, which holds since the
    kernel's split-bf16 products keep the card checks' tolerances."""
    nbytes, tc_flops, fp32_flops = ssd_cost(b, l, h, p, n, c)
    old = max(bound(nbytes, fp32_flops),
              bound(nbytes, tc_flops, BF16_OPS_PER_S))
    new = bound(nbytes, tc_flops + fp32_flops, BF16_OPS_PER_S)
    return dict(bytes=nbytes, bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                fp32_flops=fp32_flops,
                fp32_ms=fp32_flops / FP32_OPS_PER_S * 1e3,
                tensor_core_flops=tc_flops,
                all_flops_tensor_core_ms=(tc_flops + fp32_flops)
                / BF16_OPS_PER_S * 1e3,
                fp32_bound_ms=old[0], fp32_bound_by=old[1],
                bound_ms=new[0], bound_by=new[1])


def ssd_phase(seed: int, device: str = "cuda") -> dict:
    """ssd_scan at Mamba-2-1.3B widths (64 heads of 64, d_state 128, chunk
    256): the prefill shape (8 x 2048), a ragged length (1000, the padding
    path) with an initial state, and l = 100 < chunk.  fp32 against the
    plain version at 3e-4; bf16 by the mean-error rule against the plain
    version run in fp32, and element by element against the kernel's
    rounding mirrored in plain ops (``ssd_scan_passes(split=True)``) within
    one bf16 ulp and 2^-10 of the mean |y|.  Then, in bf16 at the prefill
    shape and at one 16384-token prompt: cold and warm CUDA-event medians,
    the device time of each pass, the plain version, what a call allocates,
    and the fp32 and tensor-core bounds."""
    import torch
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.ssd_scan.ops import ssd
    from repro_torch.kernels.ssd_scan.ref import ssd_scan as ssd_ref
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_passes
    dev = torch.device(device)
    rng = np.random.default_rng(seed + 5)
    h, p, n, c = 64, 64, 128, 256
    cases, worst = {}, 0.0
    for b, l, init in ((8, 2048, False), (2, 1000, True), (2, 100, False)):
        x, dt, A, Bm, Cm, s0 = _ssd_inputs(rng, b, l, h, p, n, dev, init)
        y, st = ssd(x, dt, A, Bm, Cm, chunk=c, init_state=s0)
        yr, sr = ssd_ref(x, dt, A, Bm, Cm, chunk=c, init_state=s0)
        err = max(_close(y, yr, 3e-4), _close(st, sr, 3e-4))
        worst = max(worst, err)
        del y, st, yr, sr
        xb, Bb, Cb = (a.bfloat16() for a in (x, Bm, Cm))
        got = ssd(xb, dt, A, Bb, Cb, chunk=c, init_state=s0)
        plain = ssd_ref(xb, dt, A, Bb, Cb, chunk=c, init_state=s0)
        want = ssd_ref(xb.float(), dt, A, Bb.float(), Cb.float(),
                       chunk=c, init_state=s0)
        # y is rounded to bf16 (and the plain version rounds C.B^T too):
        # the mean-error rule.  The state is fp32 from the same rounded
        # inputs in both, so it is held at the fp32 tolerance.
        mk = float((got[0].float() - want[0]).abs().mean())
        mp = float((plain[0].float() - want[0]).abs().mean())
        # Beyond the split mirror's tolerance: > 0 fails.
        ym = ssd_scan_passes(xb, dt, A, Bb, Cb, chunk=c, init_state=s0,
                             split=True)[0].float()
        beyond = float(((got[0].float() - ym).abs() - 2.0 ** -7 * ym.abs()
                        - 2.0 ** -10 * ym.abs().mean()).max())
        del ym
        case = {"fp32_max_abs_err": err, "bf16_y_mean_err": mk,
                "bf16_y_plain_mean_err": mp,
                "bf16_y_max_abs_diff_to_plain": float(
                    (got[0].float() - plain[0].float()).abs().max()),
                "bf16_state_max_abs_err": _close(got[1], want[1], 3e-4),
                "bf16_y_beyond_split_mirror": beyond}
        if beyond > 0:
            fail(f"ssd_scan bf16 b={b} l={l}: y {beyond} beyond one bf16 "
                 f"ulp and 2^-10 of the mean |y| of the split mirror")
        if not torch.isfinite(got[0].float()).all() or mk > 1.25 * mp:
            fail(f"ssd_scan bf16 b={b} l={l}: y mean error {mk} beyond "
                 f"1.25 x the plain version's {mp}")
        cases[f"b={b} l={l}" + (" init" if init else "")] = case
        del got, plain, want, x, dt, A, Bm, Cm, xb, Bb, Cb
        _free(device)

    timing = {}
    for b, l in ((8, 2048), (1, 16384)):
        x, dt, A, Bm, Cm, _ = _ssd_inputs(rng, b, l, h, p, n, dev)
        xb, Bb, Cb = (a.bfloat16() for a in (x, Bm, Cm))
        del x, Bm, Cm
        run = lambda: sk.ssd_scan(xb, dt, A, Bb, Cb, chunk=c)
        # What one call allocates beyond its inputs: y, the final state and
        # the passes' scratch.
        _free(device)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        run()
        torch.cuda.synchronize()
        transient = torch.cuda.max_memory_allocated() - base
        # Device time a call of each pass, over 10 warm calls.
        prof = device_profile(lambda: [run() for _ in range(10)], "ssd")
        timing[f"b={b} l={l}"] = dict(
            ms=time_ms(run, cold=True), warm_ms=time_ms(run),
            device_us_by_pass={k: t * 1e3 / 10 for k, t in
                               prof["device_ms_by_op"].items() if "ssd" in k},
            plain_ms=time_ms(lambda: ssd_ref(xb, dt, A, Bb, Cb, chunk=c)),
            transient_bytes=transient, **ssd_bounds(b, l, h, p, n, c))
        say(f"ssd_scan b={b} l={l}: {json.dumps(timing[f'b={b} l={l}'])}")
        del xb, Bb, Cb, dt, A
        _free(device)
    main = timing["b=8 l=2048"]
    return dict(
        replaces="src/repro/kernels/ssd_scan/kernel.py:79",
        shape=f"b=8 l=2048 h={h} p={p} n={n} chunk={c}, bf16 x/B/C/y",
        max_abs_err=worst, cases=cases, ms=main["ms"],
        warm_ms=main["warm_ms"], plain_ms=main["plain_ms"],
        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        fp32_bound_ms=main["fp32_bound_ms"], library_ms=None,
        library="none: no single PyTorch call computes the SSD chunk scan",
        timing=timing)


def _peak_bytes(device) -> int:
    import torch
    return torch.cuda.max_memory_allocated() if device == "cuda" else 0


def _reset_peak(device) -> None:
    import torch
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _free(device) -> None:
    import gc
    import torch
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()


def _greedy(params, cfg, cache, logits, steps: int):
    """``steps`` greedy decode steps → (tokens (B, steps), last logits,
    cache)."""
    import torch
    from repro_torch.models import serve
    out = []
    tok = logits.argmax(-1).to(torch.int32)
    for _ in range(steps):
        out.append(tok)
        logits, cache = serve.decode_step(params, cfg, cache, tok)
        tok = logits.argmax(-1).to(torch.int32)
    return torch.stack(out, 1), logits, cache


def _check_outputs(name, cfg, logits, tokens) -> None:
    import torch
    if not torch.isfinite(logits.float()).all():
        fail(f"{name}: logits not finite")
    if logits.shape[-1] != cfg.vocab or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab)).all()):
        fail(f"{name}: tokens outside [0, {cfg.vocab})")


# E's three passes: one call launches each once (the first counts calls).
_SSD_PASSES = ("ssd_scan", "ssd_scan_states", "ssd_scan_pass")


def mamba_phase(seed: int, device: str = "cuda", smoke: bool = False
                ) -> dict:
    """Mamba-2-1.3B at full width and depth, bf16, random weights:
    ``serve.prefill`` of 8 prompts x 2048 tokens, 32 greedy decode steps,
    then one 16384-token prompt, prefill only.  Each of E's passes must
    launch once a layer in each prefill and never in decode.  Then one
    prefill through E and through its plain version: bf16 over every layer
    by the mean-error rule, fp32 over 4 layers at 2e-4."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import serve, ssm
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import cast_weights
    cfg = get_config("mamba2-1.3b", smoke=smoke)
    B, S, steps, long_s = (2, 20, 4, 40) if smoke else (8, 2048, 32, 16384)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = cast_weights(T.init_params(cfg, gen), cfg.adtype, device)
    _free(device)
    rng = np.random.default_rng(seed + 6)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(
        np.int32)).to(device)
    res = dict(arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
               batch=B, prompt_tokens=S, decode_steps=steps)

    _reset_peak(device)
    reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, cache = serve.prefill(params, cfg, {"tokens": tokens},
                                      max_seq=S + steps)
    sync()
    t1 = time.perf_counter()
    pre = read_launches()
    reset_launches()
    with torch.no_grad():
        out, last, cache = _greedy(params, cfg, cache, logits, steps)
    sync()
    t2 = time.perf_counter()
    dec = read_launches()
    _check_outputs("mamba2 prefill", cfg, logits, out)
    _check_outputs("mamba2 decode", cfg, last, out)
    for name in _SSD_PASSES:
        if pre[name] != cfg.n_layers or dec[name] != 0:
            fail(f"{name} launched {pre[name]} times in prefill and "
                 f"{dec[name]} in decode, not {cfg.n_layers} and 0")
    res.update(prefill_ms=(t1 - t0) * 1e3,
               decode_ms_per_step=(t2 - t1) * 1e3 / steps,
               tokens_per_s=B * steps / (t2 - t1),
               launches={k: pre[k] + dec[k] for k in pre},
               launches_prefill=pre, launches_decode=dec,
               peak_bytes=_peak_bytes(device))
    if device == "cuda":
        tok = last.argmax(-1).to(torch.int32)
        step = lambda: serve.decode_step(params, cfg, cache, tok)
        res["decode_profile"] = device_profile(step, "ssd")
        res["decode_profile"]["idle_share_unprofiled"] = 1 - res[
            "decode_profile"]["device_busy_ms"] / res["decode_ms_per_step"]
        res["decode_profile"]["host_own_ms_by_function"] = host_profile(step)
        res["prefill_profile"] = device_profile(
            lambda: serve.prefill(params, cfg, {"tokens": tokens}, S), "ssd")
    del cache
    say(f"mamba2 path: {json.dumps(res)}")

    # One long prompt, prefill only: the long-context case of the family.
    _free(device)
    _reset_peak(device)
    long_tok = torch.from_numpy(rng.integers(0, cfg.vocab, (1, long_s))
                                .astype(np.int32)).to(device)
    reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        lg, cache = serve.prefill(params, cfg, {"tokens": long_tok}, long_s)
    sync()
    t1 = time.perf_counter()
    lo = read_launches()
    _check_outputs("mamba2 long prefill", cfg, lg, lg.argmax(-1))
    for name in _SSD_PASSES:
        if lo[name] != cfg.n_layers:
            fail(f"{name} launched {lo[name]} times in the long prefill")
    res["long_prompt"] = dict(tokens=long_s, prefill_ms=(t1 - t0) * 1e3,
                              launches=lo, peak_bytes=_peak_bytes(device))
    del cache, lg
    _free(device)

    # Kernel against plain: the 8 x 2048 prefill's last-token logits.
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    step = kernel_vs_plain(
        lambda wide: serve.prefill(params, cfg32 if wide else cfg,
                                   {"tokens": tokens}, S)[0],
        ssm, "ssd", ssm.ssd_scan, with_fp32=True)
    res["bf16_prefill"] = bf16_check("mamba2 path, bf16 prefill", step,
                                     max_rule=False)
    del step, params
    _free(device)
    cfg4 = dataclasses.replace(cfg32, n_layers=min(cfg.n_layers, 4))
    params4 = T.init_params(cfg4, gen)
    step = kernel_vs_plain(
        lambda wide: serve.prefill(params4, cfg4, {"tokens": tokens}, S)[0],
        ssm, "ssd", ssm.ssd_scan, with_fp32=False)
    k, p = step["kernel"], step["plain"]
    res["fp32_prefill"] = dict(n_layers=cfg4.n_layers,
                               max_abs_err=_close(k, p, 2e-4),
                               max_abs_logit=float(p.abs().max()))
    say(f"mamba2 path, fp32 prefill: {json.dumps(res['fp32_prefill'])}")
    del params4, step
    _free(device)
    return res


def griffin_phase(seed: int, device: str = "cuda", smoke: bool = False
                  ) -> dict:
    """RecurrentGemma-9B at full width and depth, bf16, random weights:
    ``serve.prefill`` of 4 prompts x 2560 tokens (past the 2048 window) into
    4096-position arenas, then 64 greedy decode steps.  D must launch once
    per attention block a step (12), and first_live must end at the last
    block wholly behind the window.  Then one decode step through D and
    through its plain version, at window 2048 with first_live > 0."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.tide_attention.ref import tide_attention_ref
    from repro_torch.models import serve
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import cast_weights
    cfg = get_config("recurrentgemma-9b", smoke=smoke)
    g = cfg.griffin
    B, S, max_seq, steps = (2, 20, 32, 8) if smoke else (4, 2560, 4096, 64)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    _reset_peak(device)
    params = cast_weights(T.init_params(cfg, gen), cfg.adtype, device)
    init_peak = _peak_bytes(device)
    _free(device)
    _reset_peak(device)
    rng = np.random.default_rng(seed + 7)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(
        np.int32)).to(device)
    n_attn = sum(1 for *_, kind, _ in T.griffin_blocks(params, cfg)
                 if kind == "attn")

    reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, cache = serve.prefill(params, cfg, {"tokens": tokens},
                                      max_seq)
    sync()
    t1 = time.perf_counter()
    pre = read_launches()
    reset_launches()
    with torch.no_grad():
        out, last, cache = _greedy(params, cfg, cache, logits, steps)
    sync()
    t2 = time.perf_counter()
    dec = read_launches()
    _check_outputs("griffin prefill", cfg, logits, out)
    _check_outputs("griffin decode", cfg, last, out)
    if dec["tide_attention"] != n_attn * steps or pre["tide_attention"]:
        fail(f"tide_attention launched {dec['tide_attention']} times in "
             f"{steps} decode steps (and {pre['tide_attention']} in "
             f"prefill), not {n_attn} a step")
    # The step at seq_len s prunes below ((s + 1 - window) // blk) * blk;
    # the last step ran at s = S + steps - 1.
    live = max(S + steps - g.window, 0) // cfg.kv_block * cfg.kv_block
    if live <= 0 and not smoke:
        fail("the griffin path never pruned a block")
    got_live = cache["first_live"].tolist()
    if got_live != [live] * B:
        fail(f"first_live ended at {got_live}, not {live}")
    res = dict(arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
               batch=B, prompt_tokens=S, max_seq=max_seq, decode_steps=steps,
               window=g.window, kv_block=cfg.kv_block, first_live=got_live,
               prefill_ms=(t1 - t0) * 1e3,
               decode_ms_per_step=(t2 - t1) * 1e3 / steps,
               tokens_per_s=B * steps / (t2 - t1),
               launches={k: pre[k] + dec[k] for k in pre},
               init_peak_bytes=init_peak, peak_bytes=_peak_bytes(device))
    tok = last.argmax(-1).to(torch.int32)
    if device == "cuda":
        run = decode_runner(params, cfg, cache, tok)
        prof = res["decode_profile"] = device_profile(lambda: run(False),
                                                      "tide")
        prof["idle_share_unprofiled"] = \
            1 - prof["device_busy_ms"] / res["decode_ms_per_step"]
        prof["host_own_ms_by_function"] = host_profile(lambda: run(False))
    say(f"griffin path: {json.dumps(res)}")
    if cfg.adtype == torch.float32:
        # The SMOKE config runs in fp32: kernel and plain version agree at
        # the fp32 tolerance of the decode-step checks.
        step = kernel_vs_plain(decode_runner(params, cfg, cache, tok), serve,
                               "decode_attention", tide_attention_ref,
                               with_fp32=False)
        k, p = step["kernel"], step["plain"]
        res["fp32_step"] = dict(max_abs_err=_close(k, p, 2e-4),
                                max_abs_logit=float(p.abs().max()))
        say(f"griffin path, fp32 decode step: {json.dumps(res['fp32_step'])}")
    else:
        step = kernel_vs_plain(decode_runner(params, cfg, cache, tok), serve,
                               "decode_attention", tide_attention_ref,
                               with_fp32=True)
        res["bf16_step"] = bf16_check(
            f"griffin path, bf16 decode step (window {g.window}, first_live "
            f"{live})", step)
    del params, cache, step
    _free(device)
    return res


# ----------------------------------------- MLA and whisper: serve directly

def smoke_on_card(arch: str, seed: int, steps: int = 6,
                  device: str = "cuda") -> dict:
    """The architecture's SMOKE config (fp32) on the card against the same
    run on the host: ``serve.prefill`` of 2 x 8 tokens, then ``steps``
    teacher-forced decode steps, logits at 2e-4 at every step.  On the card
    GQA decode goes through D; on the host through its plain version."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import serve
    from repro_torch.models import transformer as T
    cfg = get_config(arch, smoke=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed + 8)
    B, S = 2, 8
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S + steps))
                              .astype(np.int32))
    batch = {"tokens": tokens[:, :S]}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.encoder_seq, cfg.encoder_dim)).astype(np.float32))
    runs = {}
    for dev in ("cpu", device):
        p = _to(params, dev)
        b = {k: v.to(dev) for k, v in batch.items()}
        reset_launches()
        with torch.no_grad():
            logits, cache = serve.prefill(p, cfg, b, S + steps)
            out = [logits]
            for t in range(S, S + steps):
                logits, cache = serve.decode_step(p, cfg, cache,
                                                  tokens[:, t].to(dev))
                out.append(logits)
        runs[dev] = torch.stack(out).cpu()
    launches = read_launches()
    want = 0 if cfg.mla is not None else cfg.n_layers * steps
    if launches["tide_attention"] != want:
        fail(f"{arch} SMOKE on the card: tide_attention launched "
             f"{launches['tide_attention']} times, not {want}")
    return dict(arch=cfg.name, decode_steps=steps,
                tide_attention_launches=launches["tide_attention"],
                max_abs_err=_close(runs[device], runs["cpu"], 2e-4),
                max_abs_logit=float(runs["cpu"].abs().max()))


def _to(tree, device):
    """The same tree with every leaf moved to ``device``."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device)


def deepseek_phase(seed: int, device: str = "cuda", smoke: bool = False
                   ) -> dict:
    """DeepSeek-V3 at full width with its depth cut to 1 layer (the full
    model's 1.34 TB of bf16 weights do not fit one card): MLA with the
    576-dim latent arena, 256 routed experts top-8 and one shared, the MTP
    module's parameters; 13.7 B parameters made in fp32 and cast leaf by
    leaf to bf16.  ``serve.prefill`` of 4 x 512 tokens, then 16 greedy
    decode steps through MLA's absorbed form, which reaches no kernel (D's
    launches must stay 0).  Then the SMOKE config on the card against the
    host."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import serve
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import cast_weights
    cfg = dataclasses.replace(get_config("deepseek-v3-671b", smoke=smoke),
                              n_layers=1)
    B, S, steps = (2, 16, 4) if smoke else (4, 512, 16)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    _reset_peak(device)
    params = cast_weights(T.init_params(cfg, gen), cfg.adtype, device)
    n_params = sum(t.numel() for t in _leaves(params))
    init_peak = _peak_bytes(device)
    _free(device)
    _reset_peak(device)
    rng = np.random.default_rng(seed + 9)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(
        np.int32)).to(device)
    reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, cache = serve.prefill(params, cfg, {"tokens": tokens},
                                      S + steps)
    sync()
    t1 = time.perf_counter()
    step_ms = []
    tok, out = logits.argmax(-1).to(torch.int32), []
    with torch.no_grad():
        for _ in range(steps):
            out.append(tok)
            t = time.perf_counter()
            logits, cache = serve.decode_step(params, cfg, cache, tok)
            tok = logits.argmax(-1).to(torch.int32)
            sync()
            step_ms.append((time.perf_counter() - t) * 1e3)
    launches = read_launches()
    _check_outputs("deepseek-v3 decode", cfg, logits, torch.stack(out, 1))
    if launches["tide_attention"]:
        fail("MLA decode launched tide_attention")
    if cache["arena_k"].shape[-2:] != (1, cfg.mla.kv_lora_rank) or \
            cache["arena_v"].shape[-2:] != (1, cfg.mla.qk_rope_head_dim):
        fail(f"MLA arenas {tuple(cache['arena_k'].shape)} / "
             f"{tuple(cache['arena_v'].shape)}")
    res = dict(arch=cfg.name, reduced="n_layers 61 -> 1", n_layers=1,
               d_model=cfg.d_model, params=n_params, batch=B,
               prompt_tokens=S, decode_steps=steps,
               prefill_ms=(t1 - t0) * 1e3, decode_ms_by_step=step_ms,
               decode_ms_per_step=statistics.median(step_ms),
               tokens_per_s=B * steps / (sum(step_ms) / 1e3),
               launches=launches, init_peak_bytes=init_peak,
               peak_bytes=_peak_bytes(device))
    del params, cache, logits
    _free(device)
    res["smoke_on_card"] = smoke_on_card("deepseek-v3-671b", seed,
                                         device=device)
    return res


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def whisper_phase(seed: int, device: str = "cuda", smoke: bool = False
                  ) -> dict:
    """Whisper-large-v3 at full width and depth (32 encoder and 32 decoder
    layers, d 1280, 20 heads of 64): 8 x 1500 random frames of width 1280
    from the seed, a 4-token decoder prompt, ``serve.prefill`` (encoder,
    decoder prompt, cross K/V) into 448-position arenas, then 32 greedy
    decode steps, D once a decoder layer a step (32).  Then one decode
    step through D and through its plain version (bf16 rule), and the SMOKE
    config on the card against the host."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.tide_attention.ref import tide_attention_ref
    from repro_torch.models import serve
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import cast_weights
    cfg = get_config("whisper-large-v3", smoke=smoke)
    B, S, max_seq, steps = (2, 4, 32, 4) if smoke else (8, 4, 448, 32)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    _reset_peak(device)
    params = cast_weights(T.init_params(cfg, gen), cfg.adtype, device)
    _free(device)
    rng = np.random.default_rng(seed + 10)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))
                                        .astype(np.int32)).to(device),
             "frames": torch.from_numpy(rng.standard_normal(
                 (B, cfg.encoder_seq, cfg.encoder_dim), dtype=np.float32)
                 ).to(device)}
    reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, cache = serve.prefill(params, cfg, batch, max_seq)
    sync()
    t1 = time.perf_counter()
    pre = read_launches()
    reset_launches()
    with torch.no_grad():
        out, last, cache = _greedy(params, cfg, cache, logits, steps)
    sync()
    t2 = time.perf_counter()
    dec = read_launches()
    _check_outputs("whisper prefill", cfg, logits, out)
    _check_outputs("whisper decode", cfg, last, out)
    if dec["tide_attention"] != cfg.n_layers * steps or \
            pre["tide_attention"]:
        fail(f"tide_attention launched {dec['tide_attention']} times in "
             f"{steps} decode steps (and {pre['tide_attention']} in "
             f"prefill), not {cfg.n_layers} a step")
    res = dict(arch=cfg.name, n_layers=cfg.n_layers,
               n_encoder_layers=cfg.n_encoder_layers, d_model=cfg.d_model,
               batch=B, encoder_frames=cfg.encoder_seq, prompt_tokens=S,
               max_seq=max_seq, decode_steps=steps,
               encoder_and_prefill_ms=(t1 - t0) * 1e3,
               decode_ms_per_step=(t2 - t1) * 1e3 / steps,
               tokens_per_s=B * steps / (t2 - t1),
               launches={k: pre[k] + dec[k] for k in pre},
               peak_bytes=_peak_bytes(device))
    tok = last.argmax(-1).to(torch.int32)
    if device == "cuda":
        run = decode_runner(params, cfg, cache, tok)
        prof = res["decode_profile"] = device_profile(lambda: run(False),
                                                      "tide")
        prof["idle_share_unprofiled"] = \
            1 - prof["device_busy_ms"] / res["decode_ms_per_step"]
    say(f"whisper path: {json.dumps(res)}")
    step = kernel_vs_plain(decode_runner(params, cfg, cache, tok), serve,
                           "decode_attention", tide_attention_ref,
                           with_fp32=True)
    res["bf16_step"] = bf16_check("whisper path, bf16 decode step", step)
    del params, cache, step
    _free(device)
    res["smoke_on_card"] = smoke_on_card("whisper-large-v3", seed,
                                         device=device)
    return res


# ---------------------------------------------------------- training path

TRAIN_FAMILIES = ("llama3-8b", "qwen3-0.6b", "qwen2-vl-72b",
                  "qwen2-moe-a2.7b", "deepseek-v3-671b", "mamba2-1.3b",
                  "recurrentgemma-9b", "whisper-large-v3")
CKPT_SEGMENT = 64 << 20          # the checkpoint store's value-WAL segment


def _leaf_bytes(t):
    """A tensor's bytes as a host numpy array (a copy from the card)."""
    import torch
    return t.detach().cpu().contiguous().reshape(-1).view(
        torch.uint8).numpy()


def _leaf_hashes(tree) -> dict:
    """blake2b of every leaf's bytes, by path, 8 leaves at a time (hashlib
    releases the interpreter lock on large buffers)."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.core.tree import leaves_with_path, path_str
    items = [(path_str(p), t) for p, t in leaves_with_path(tree)]
    with ThreadPoolExecutor(8) as pool:
        digests = pool.map(lambda it: hashlib.blake2b(
            _leaf_bytes(it[1])).hexdigest(), items)
        return dict(zip((p for p, _ in items), digests))


def _timed_checkpoints(base, hash_step: int):
    """A ``CheckpointManager`` that times each save (the device→host copy
    and the writer thread's WAL writes, flush and pruning apart) and each
    restore, and hashes the state it saved at ``hash_step`` and every state
    it restores (outside the timed spans)."""
    import torch
    from repro_torch.core.tree import leaves

    class Timed(base):
        made = []

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.saves, self.restores, self.saved_hashes = [], [], None
            self._write_s = self._written = None
            Timed.made.append(self)

        def _sync(self):
            if self.device.type == "cuda":
                torch.cuda.synchronize()

        def save(self, step, state, wait=True):
            nbytes = sum(t.numel() * t.element_size() for t in leaves(state))
            tail = self.stats()["wal_tail"]
            self._sync()
            t0 = time.perf_counter()
            super().save(step, state, wait=True)
            s = time.perf_counter() - t0
            if step == hash_step:
                self.saved_hashes = _leaf_hashes(self._written)
            self._written = None
            st = self.stats()
            self.saves.append(dict(
                step=step, bytes=nbytes, s=s, GB_s=nbytes / s / 1e9,
                copy_s=s - self._write_s, write_s=self._write_s,
                write_GB_s=nbytes / self._write_s / 1e9,
                wal_bytes=st["wal_tail"] - tail,
                segments_pruned=st["segments_pruned"]))

        def _write_step(self, step, host_state):
            t0 = time.perf_counter()
            super()._write_step(step, host_state)
            self._write_s = time.perf_counter() - t0
            self._written = host_state

        def restore(self, like, step=None, shardings=None):
            self._sync()
            t0 = time.perf_counter()
            out, got = super().restore(like, step, shardings)
            self._sync()
            s = time.perf_counter() - t0
            if out is not None:
                nbytes = sum(t.numel() * t.element_size()
                             for t in leaves(out))
                self.restores.append(dict(step=got, bytes=nbytes, s=s,
                                          GB_s=nbytes / s / 1e9,
                                          hashes=_leaf_hashes(out)))
            return out, got

    return Timed


# Kernel-name groups of the profiled train step.  cuBLAS names its fp32
# products (no tensor core: ``sgemm``, ``f32f32_f32f32``) apart from its
# bf16 ones; the only fp32 products of Qwen3's step are attention's score
# products and their backward.  The log-softmax kernels carry a LogSoftMax
# epilogue (cross-entropy), attention's softmax a plain one.
def _kernel_group(name: str) -> str:
    n = name.lower()
    if "logsoftmax" in n:
        return "cross_entropy_log_softmax"
    if "softmax" in n:
        return "attention_softmax"
    if any(w in n for w in ("gemm", "nvjet", "cutlass", "xmma")):
        if "sgemm" in n or "f32f32_f32f32" in n:
            return "attention_fp32_score_products"
        return "bf16_products"
    return "elementwise_copies_and_other"


def _union_ms(spans) -> float:
    """The length of the union of (start, end) µs intervals, in ms."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def train_profile(step_call) -> dict:
    """One train step under torch.profiler → (its result, a summary): wall
    time; the device's busy time, the union of its kernels', copies' and
    memsets' intervals (no user annotation: ``record_function`` ranges have
    a device-side twin that spans kernels and the gaps between them), and
    its idle share; device ms by kernel group (``_kernel_group``); the
    AdamW update's device ms (the device intervals inside the device twin
    of a ``record_function`` range around ``adamw_update``); the top
    kernels, and the top operators by the device time of the kernels each
    launched itself."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.training import step as step_mod
    update = step_mod.adamw_update

    def ranged(*args, **kw):
        with record_function("adamw_update"):
            return update(*args, **kw)

    step_mod.adamw_update = ranged
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = step_call()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        step_mod.adamw_update = update
    spans, kernels, groups, ranges = [], {}, {}, []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        if ev.name == "adamw_update":            # the range's device twin
            ranges.append((ev.time_range.start, ev.time_range.end))
            continue
        if getattr(ev, "is_user_annotation", False):
            continue
        spans.append((ev.time_range.start, ev.time_range.end))
        t = (ev.time_range.end - ev.time_range.start) / 1e3
        kernels[ev.name[:90]] = kernels.get(ev.name[:90], 0) + t
        g = _kernel_group(ev.name)
        groups[g] = groups.get(g, 0) + t
    ops = {ev.key: ev.self_device_time_total / 1e3
           for ev in prof.key_averages()
           if ev.key.startswith("aten::")
           and (ev.self_device_time_total or 0) > 0}
    busy = _union_ms(spans)
    # AdamW: the device intervals inside the range's device twin (None
    # where this torch records no twin).
    adamw = _union_ms([(max(a, ra), min(b, rb)) for a, b in spans
                       for ra, rb in ranges if a < rb and b > ra]) \
        if ranges else None
    top = lambda d, n: dict(sorted(d.items(), key=lambda kv: -kv[1])[:n])
    if busy > wall:
        fail(f"profiled train step: device busy {busy} ms in a {wall} ms "
             f"wall")
    return out, dict(
        wall_ms=wall, device_busy_ms=busy, idle_share=1 - busy / wall,
        device_events=len(spans), device_ms_summed=sum(kernels.values()),
        device_ms_by_group=groups, adamw_update_ms=adamw,
        device_ms_by_kernel=top(kernels, 12),
        device_ms_by_launching_op=top(ops, 16))


def _leaves_close(what: str, got: dict, want: dict, tol: float,
                  ulp_of: dict | None = None) -> float:
    """Hold each leaf of ``got`` against ``want`` (dicts path → tensor) at
    rtol ``tol`` and atol ``tol`` x the leaf's largest |want| (as the port's
    JAX parity test holds gradients), or, with ``ulp_of``, atol one fp32 ulp
    of the same path's leaf there.  → the largest |diff| over its
    allowance (at most 1)."""
    import torch
    if sorted(got) != sorted(want):
        fail(f"{what}: leaves differ: {sorted(set(got) ^ set(want))[:8]}")
    worst = 0.0
    for path, g in got.items():
        g, w = g.double(), want[path].double()
        if not torch.isfinite(g).all():
            fail(f"{what} {path}: non-finite")
        atol = tol * w.abs().max() if ulp_of is None else \
            torch.finfo(torch.float32).eps * ulp_of[path].double().abs()
        d, lim = (g - w).abs(), atol + tol * w.abs()
        if bool((d > lim).any()):
            fail(f"{what} {path}: differs beyond rtol {tol} and atol "
                 f"{'one fp32 ulp' if ulp_of else f'{tol} x max |want|'}: "
                 f"max |diff| {float(d.max())}, max |want| "
                 f"{float(w.abs().max())}")
        ratio = torch.where(d == 0, torch.zeros_like(d), d / lim)
        worst = max([worst] + ([float(ratio.max())] if d.numel() else []))
    return worst


def train_smoke_on_card(arch: str, seed: int, device: str = "cuda") -> dict:
    """One ``make_train_step`` of the SMOKE config (fp32) from the same
    parameters and batch on ``device`` and on the host, no kernel launched.
    The loss agrees at rtol = atol = 2e-4; each gradient leaf at rtol 2e-4
    and atol 2e-4 x the leaf's largest |grad|.  Each parameter's change on
    the card agrees at rtol 2e-4 (and one fp32 ulp of the parameter) with
    the host's AdamW update of the card's own gradients.  The learning rate
    is the full 1e-3 from the first step, so a missing, doubled or
    sign-flipped update fails by far.  (The first step moves most entries
    by lr whatever the gradient's size, so the host's own step is no
    reference for the update: a gradient within rounding of 0 may take
    another sign on each device.)"""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.tree import leaves_with_path, path_str, tree_map
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models import transformer as T
    from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                                adamw_update)
    from repro_torch.training.step import make_train_step
    cfg = get_config(arch, smoke=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(seed))
    batch = make_batch_fn(cfg, 2, 16, "cpu")(seed)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1)
    flat = lambda tree: {path_str(p): t.detach().cpu()
                         for p, t in leaves_with_path(tree)}
    runs = {}
    for dev in ("cpu", device):
        grads = []
        step = make_train_step(cfg, opt, compress_grads=lambda g: grads.append(
            g) or g)
        p = tree_map(lambda t: t.to(dev), params)
        reset_launches()
        new_p, _, m = step(p, adamw_init(p, opt),
                           {k: v.to(dev) for k, v in batch.items()})
        launched = read_launches()
        if any(launched.values()):
            fail(f"{arch} SMOKE train step launched kernels: {launched}")
        runs[dev] = (m["loss"].cpu().reshape(1),
                     tree_map(lambda t: t.cpu(), grads[0]), new_p)
    loss, grads, new_p = runs[device]
    want_p = adamw_update(params, grads, adamw_init(params, opt), opt)[0]
    old = flat(params)
    moved = lambda tree: {k: v.double() - old[k].double()
                          for k, v in flat(tree).items()}
    return dict(arch=cfg.name, loss=float(runs["cpu"][0]),
                values=sum(t.numel() for t in old.values()),
                loss_abs_err=_close(loss, runs["cpu"][0], 2e-4),
                grad_err_over_allowance=_leaves_close(
                    f"{arch} gradient", flat(grads), flat(runs["cpu"][1]),
                    2e-4),
                update_err_over_allowance=_leaves_close(
                    f"{arch} update", moved(new_p), moved(want_p), 2e-4,
                    ulp_of=old))


def train_phase(seed: int, workdir: str, device: str = "cuda",
                smoke: bool = False) -> dict:
    """Qwen3-0.6B at full width and depth through the launcher's loop:
    8 x 2048 tokens a step from a pinned two-batch stream, AdamW with fp32
    moments, remat on; a first run that saves at steps 0 and 3 and fails at
    step 5, a resumed run (steps 4-7, saves at 6 and 7, the fourth save's
    pruning dropping step 0's segments), every restored leaf's blake2b
    against the saved one; then each family's SMOKE train step on the card
    against the host, and the content-addressed sample store."""
    import math
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import ContentAddressedStore
    from repro_torch.launch.train import launcher_opt, make_batch_fn
    from repro_torch.training import loop as loop_mod
    from repro_torch.training.loop import LoopConfig, run
    from repro_torch.training.step import make_train_step
    cfg = get_config("qwen3-0.6b", smoke=smoke)
    B, S, steps = (2, 64, 8) if smoke else (8, 2048, 8)
    n_params = cfg.param_count()
    state_bytes = 3 * 4 * n_params               # fp32 params, m and v
    need = 4.5 * state_bytes                     # four saves, and room
    free = shutil.disk_usage(workdir).free
    if free < need:
        fail(f"{workdir} has {free} B free; four checkpoints of "
             f"{state_bytes} B need about {need:.0f}")
    opt = launcher_opt(1e-3, steps)
    data = make_batch_fn(cfg, B, S, device)
    stream = lambda step: data(step % 2)         # two pinned batches
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    train_step = make_train_step(cfg, opt)
    records, prof = {}, {}

    def timed_step(params, opt_state, batch):
        step = int(opt_state["step"])            # the loop's step index
        call = lambda: train_step(params, opt_state, batch)
        sync()
        t0 = time.perf_counter()
        if step == steps - 1 and device == "cuda":
            out, prof["step"] = train_profile(call)
        else:
            out = call()
        loss = float(out[2]["loss"])
        records[step] = dict(ms=(time.perf_counter() - t0) * 1e3, loss=loss,
                             profiled=step == steps - 1 and device == "cuda")
        return out

    logs = []
    ckpt_dir = os.path.join(workdir, "ckpt")
    base = loop_mod.CheckpointManager
    loop_mod.CheckpointManager = _timed_checkpoints(base, hash_step=3)
    _reset_peak(device)
    reset_launches()
    try:
        try:
            run(cfg, opt, LoopConfig(total_steps=steps, checkpoint_every=3,
                                     fail_at_step=5, log_every=1),
                stream, ckpt_dir, step_fn=timed_step, log_fn=logs.append,
                device=device)
        except RuntimeError as e:
            if "injected failure at step 5" not in str(e):
                raise
        else:
            fail("the first run did not fail at step 5")
        first = dict(records)
        records.clear()
        out = run(cfg, opt, LoopConfig(total_steps=steps, checkpoint_every=3,
                                       log_every=1),
                  stream, ckpt_dir, step_fn=timed_step, log_fn=logs.append,
                  device=device)
        first_mgr, second_mgr = loop_mod.CheckpointManager.made
    finally:
        loop_mod.CheckpointManager = base
    launches = read_launches()
    peak = _peak_bytes(device)
    for line in logs:
        say(f"  {line}")
    if any(launches.values()):
        fail(f"the training path launched kernels: {launches}")
    if out["resumed_from"] != 3:
        fail(f"resumed from {out['resumed_from']}, not step 3")
    if [r["step"] for r in first_mgr.saves] != [0, 3] or \
            [r["step"] for r in second_mgr.saves] != [6, 7]:
        fail(f"saves at {[r['step'] for r in first_mgr.saves]} and "
             f"{[r['step'] for r in second_mgr.saves]}, not [0, 3], [6, 7]")
    restored = second_mgr.restores[0]
    if restored["step"] != 3 or restored["hashes"] != first_mgr.saved_hashes:
        bad = [p for p, h in restored["hashes"].items()
               if first_mgr.saved_hashes.get(p) != h]
        fail(f"restored step {restored['step']}: leaves differ from the "
             f"saved step 3: {bad[:8]}")
    losses = [first[s]["loss"] for s in range(6)] + \
        [records[s]["loss"] for s in range(4, steps)]
    if f"{first[4]['loss']:.4f}" != f"{records[4]['loss']:.4f}":
        fail(f"step 4: {first[4]['loss']:.4f} before the crash, "
             f"{records[4]['loss']:.4f} after the resume")
    if abs(first[5]["loss"] - records[5]["loss"]) > \
            1e-3 * abs(first[5]["loss"]):
        fail(f"step 5: {first[5]['loss']} before the crash, "
             f"{records[5]['loss']} after the resume (rtol 1e-3)")
    if abs(losses[0] - math.log(cfg.vocab)) > 0.5:
        fail(f"step 0 loss {losses[0]}, not within 0.5 of "
             f"ln({cfg.vocab}) = {math.log(cfg.vocab):.4f}")
    if not np.mean(losses[-2:]) < np.mean(losses[:2]):
        fail(f"the loss did not fall: {losses}")
    pruned = second_mgr.saves[-1]["segments_pruned"]
    step0_bytes = first_mgr.saves[0]["bytes"]
    if pruned * CKPT_SEGMENT < step0_bytes - 2 * CKPT_SEGMENT:
        fail(f"the last save pruned {pruned} segments of {CKPT_SEGMENT} B, "
             f"less than step 0's {step0_bytes} B less two segments")
    timed = [r["ms"] for recs in (first, records) for s, r in recs.items()
             if not r["profiled"] and not (recs is first and s == 0)]
    ms = statistics.median(timed)
    res = dict(
        arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
        params=n_params, batch=B, seq=S, tokens_per_step=B * S,
        remat=cfg.remat, opt=dict(lr=opt.lr, warmup_steps=opt.warmup_steps),
        losses=losses, step_ms_first_run=[first[s]["ms"] for s in range(6)],
        step_ms_resumed=[records[s]["ms"] for s in range(4, steps)],
        ms_per_step=ms, tokens_per_s=B * S / (ms / 1e3), peak_bytes=peak,
        saves=first_mgr.saves + second_mgr.saves,
        restore={k: v for k, v in restored.items() if k != "hashes"},
        restored_leaves=len(restored["hashes"]),
        wal_bytes_written=sum(r["wal_bytes"] for r in first_mgr.saves
                              + second_mgr.saves),
        segments_pruned=pruned, bytes_pruned=pruned * CKPT_SEGMENT,
        step0_bytes=step0_bytes, launches=launches, profile=prof.get("step"))
    del out
    _free(device)
    res["smoke_on_card"] = {arch: train_smoke_on_card(arch, seed, device)
                            for arch in TRAIN_FAMILIES}
    # The content-addressed sample store over the phase's two batches:
    # 16 rows of 2048 int32 tokens (8 KiB values), blake2b keys.
    rows = np.concatenate([data(s)["tokens"].cpu().numpy() for s in (0, 1)])
    store = ContentAddressedStore(os.path.join(workdir, "samples"),
                                  background=False, device=device)
    try:
        keys = store.ingest_tokens(rows, epoch=0)
        again = store.ingest_tokens(rows, epoch=1)
        n = len(rows)
        if keys != again or store.inserted != n or store.dedup_hits != n:
            fail(f"sample store: {store.inserted} inserted, "
                 f"{store.dedup_hits} deduplicated of {n} rows twice")
        if store.get(keys[0]) != np.ascontiguousarray(rows[0]).tobytes():
            fail("sample store: a row read back wrong")
        dropped = store.expire_epochs_below(1)
        res["sample_store"] = dict(rows=n, value_bytes=rows[0].nbytes,
                                   inserted=store.inserted,
                                   dedup_hits=store.dedup_hits,
                                   segments_expired=dropped)
    finally:
        store.close()
    return res


# ------------------------------------------------------- scale-out path

SCALEOUT_STEPS = 2


def _ef_hook(group=None, timings: list | None = None,
             device: str = "cuda"):
    """``make_train_step``'s ``compress_grads``: the error-feedback int8
    compressor (its residuals carried from step to step), whose output the
    step applies.  Given a ``group`` (of one rank), ``compressed_psum`` of
    that output over it too, held bit for bit against its definition at
    one rank, the int8 values at their own scale, and not applied: at one
    rank it only requantizes values already on the int8 grid, which moves
    them by rounding, and AdamW's second step amplifies such rounding where
    its momentum cancels, so the steps could not be held against the
    DTensor route's.  With ``timings`` each call's time is appended (device
    ms from CUDA events on the card; ``compressed_psum`` included)."""
    import torch
    from repro_torch.core.tree import leaves
    from repro_torch.distributed.compression import (
        compressed_psum, dequantize_int8, make_error_feedback_compressor,
        quantize_int8)
    compress, init = make_error_feedback_compressor()
    state = {}

    def hook(grads):
        if device == "cuda" and timings is not None:
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            t0.record()
        h0 = time.perf_counter()
        if "r" not in state:
            state["r"] = init(grads)
        out, state["r"] = compress(grads, state["r"])
        summed = compressed_psum(out, group) if group is not None else None
        if timings is not None:
            if device == "cuda":
                t1.record()
                t1.synchronize()
                timings.append(t0.elapsed_time(t1))
            else:
                timings.append((time.perf_counter() - h0) * 1e3)
        if summed is not None:
            for o, got in zip(leaves(out), leaves(summed), strict=True):
                if not torch.equal(got, dequantize_int8(
                        *quantize_int8(o)).to(o.dtype)):
                    fail("compressed_psum over one rank is not the int8 "
                         "round trip of its input")
        return out

    return hook


def _flat_state(tree) -> dict:
    """path → the leaf's whole value (a DTensor gathered)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.core.tree import leaves_with_path, path_str
    return {path_str(p): t.full_tensor() if isinstance(t, DTensor) else t
            for p, t in leaves_with_path(tree)}


def _scaleout_steps(cfg, opt, seed, data, mesh, group, device, sharded,
                    timings):
    """``SCALEOUT_STEPS`` train steps from the seeded init with the
    error-feedback compressor as ``compress_grads`` → (losses, final
    parameters): on DTensors placed by ``param_specs`` in ``fsdp`` mode
    (``sharded``; DTensor sums the gradients over the mesh itself), or on
    plain tensors, whose hook also checks ``compressed_psum`` over
    ``group`` (``_ef_hook``)."""
    import contextlib
    import torch
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.distributed import sharding
    from repro_torch.training.step import init_train_state, make_train_step
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params, opt_state = init_train_state(cfg, opt, gen)
    batches = [data(s % 2) for s in range(SCALEOUT_STEPS)]
    ctx = contextlib.nullcontext()
    if sharded:
        pspec = sharding.param_specs(params, mesh, mode="fsdp")
        params = sharding.distribute(params, pspec, mesh)
        opt_state = sharding.distribute(
            opt_state, sharding.opt_specs(opt_state, pspec), mesh)
        batches = [sharding.distribute(
            b, sharding.input_specs_tree(b, mesh, mode="fsdp"), mesh)
            for b in batches]
        ctx = implicit_replication()
    step = make_train_step(cfg, opt, compress_grads=_ef_hook(
        None if sharded else group, timings, device))
    losses = []
    with ctx:
        for b in batches:
            params, opt_state, m = step(params, opt_state, b)
            loss = m["loss"]
            losses.append(float(loss.full_tensor() if sharded else loss))
    del opt_state
    return losses, _flat_state(params)


def _llama_decode_cost(batch: int, max_seq: int, kv_reads: float):
    """The config and the work of Llama-3-8B's decode step over ``batch``
    slots of ``max_seq`` positions (bf16 weights, as ``ServingEngine``
    serves them) as the serving phase timed it, through kernel D →
    (cfg, the timed program's Cost, the plain step's ``op_cost``).  The
    plain step's D gathers every slot's whole arena, and ``op_cost``
    counts each weight twice (the step's input and a product's operand),
    as the JAX package's ``jaxpr_cost`` does; neither is moved by the
    program that was timed.  Its Cost is the least it must do: FLOPs are
    ``op_cost``'s with D taken out plus D's 4 x live x H x d; bytes are
    each weight read once, the ``kv_reads`` live K and V rows a step (this
    run's mean), the appended rows and the fp32 logits."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import serve
    from repro_torch.models.transformer import param_count_exact
    from repro_torch.roofline.op_cost import Cost, op_cost
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.step import (abstract_train_state,
                                           make_decode_step)
    cfg = dataclasses.replace(get_config("llama3-8b"),
                              param_dtype="bfloat16")
    params, _ = abstract_train_state(cfg, AdamWConfig())
    meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")
    cache = {k: meta(sh, dt) for k, (sh, dt) in
             serve.cache_spec(cfg, batch, max_seq).items()}
    tokens = meta((batch,), torch.int32)
    plain = op_cost(make_decode_step(cfg), params, cache, tokens)
    real_d = serve.decode_attention
    serve.decode_attention = lambda q, *a, **kw: torch.empty_like(q)
    try:
        rest = op_cost(make_decode_step(cfg), params, cache, tokens)
    finally:
        serve.decode_attention = real_d
    H, KH, d, L = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.n_layers
    row = KH * d * 2 * 2                      # one position's K and V, bf16
    nbytes = (param_count_exact(cfg) * 2 + L * (kv_reads + batch) * row
              + batch * cfg.vocab * 4)
    return cfg, Cost(rest.flops + L * 4.0 * kv_reads * H * d, nbytes), plain


def _roofline_line(name, cfg, cost, n_tokens, kind, ms, peak) -> dict:
    """The roofline of a step measured on the card: FLOPs and bytes
    (``op_cost``), its compute and memory terms, the measured step time,
    its MFU (``model_flops`` over time x 989e12) and the time as a multiple
    of the bound."""
    from repro_torch.roofline import analysis
    rf = analysis.Roofline(
        arch=cfg.name, shape=name, mesh="1", chips=1,
        flops_per_device=cost.flops, bytes_per_device=cost.bytes,
        collective_bytes=0.0, peak_memory_per_device=float(peak),
        model_flops=analysis.model_flops(cfg, n_tokens, kind)).to_dict()
    bound_ms = max(rf["t_compute"], rf["t_memory"]) * 1e3
    return dict(step=name, flops=cost.flops, bytes=cost.bytes,
                t_compute_ms=rf["t_compute"] * 1e3,
                t_memory_ms=rf["t_memory"] * 1e3, bound_ms=bound_ms,
                bound_by=rf["bottleneck"], model_flops=rf["model_flops"],
                measured_ms=ms,
                mfu=rf["model_flops"] / (ms / 1e3 * BF16_OPS_PER_S),
                over_bound=ms / bound_ms)


# The JAX package's ``lower_cell("qwen3-0.6b", "train_4k", False)`` on the
# CPU (XLA's buffer assignment and its collectives; PERF.md §6): what
# phase 13 (f)'s cell is held against.
REF_DRYRUN_PEAK = 1.9099226936e10
REF_DRYRUN_COLLECTIVES = 7.4970554408e10
# The same on the 2 x 16 x 16 mesh: ``python -m repro.launch.dryrun --arch
# <arch> --shape train_4k --mesh multi`` on the CPU (peak bytes a device,
# collective bytes), for the two-pod cells of phase 13 (f).
REF_DRYRUN_MULTI = {"qwen3-0.6b": (9.652081464e9, 3.7579382824e10),
                    "mamba2-1.3b": (4.0878689856e10, 5.6008665388e10)}
# The serving cells of phase 13 (f), on 16 x 16 and one on 2 x 16 x 16
# (the third entry: whether on two pods): ``python -m repro.launch.dryrun
# --arch <arch> --shape <shape> --mesh single`` (``multi``) on the CPU
# (peak bytes a device, collective bytes), and the bounds each is held to
# (ROADMAP C.12): the prefill's footprint, the decode's collectives, and
# the prefills' peak on the reference's terms within a multiple of the
# reference's: 2x where the heads split over the model axis (each device
# holds its own query heads' scores), 1.2x for whisper-large-v3, whose 20
# heads split unevenly over the 16-wide axis (3.50x before), and 1.5x for
# mamba2-1.3b on two pods, its whole embedding table looked up on each
# device's rows (1.94x on torch 2.11 before).
# ``python -m repro.launch.dryrun --arch phi3-mini-3.8b --shape
# prefill_32k --mesh single`` on the CPU (peak bytes a device, collective
# bytes).
REF_PHI3_PREFILL_PEAK, REF_PHI3_PREFILL_COLL = 4.272265576e9, 5.234491392e10
# ``python -m repro.launch.dryrun --arch whisper-large-v3 --shape
# prefill_32k --mesh single`` and ``--arch mamba2-1.3b --shape prefill_32k
# --mesh multi`` on the CPU (peak bytes a device, collective bytes).
REF_WHISPER_PREFILL = (4.184540608e9, 4.833738752e10)
REF_MAMBA2_PREFILL_MULTI = (1.390311688e9, 1.6364077056e10)
REF_DRYRUN_SERVING = {
    "dryrun_qwen3_prefill": ("qwen3-0.6b", "prefill_32k", False,
                             (1.233248072e9, 2.0509360128e10)),
    "dryrun_phi3_decode": ("phi3-mini-3.8b", "decode_32k", False,
                           (1.8068707848e10, 1.2684544e7)),
    "dryrun_phi3_prefill": ("phi3-mini-3.8b", "prefill_32k", False,
                            (REF_PHI3_PREFILL_PEAK, REF_PHI3_PREFILL_COLL)),
    "dryrun_whisper_prefill": ("whisper-large-v3", "prefill_32k", False,
                               REF_WHISPER_PREFILL),
    "dryrun_mamba2_prefill_multi": ("mamba2-1.3b", "prefill_32k", True,
                                    REF_MAMBA2_PREFILL_MULTI)}
SERVING_BOUND = {"dryrun_qwen3_prefill": ("footprint_bytes", 1.7e10),
                 "dryrun_phi3_decode": ("collective_bytes", 1e10)}
SERVING_PEAK_BOUND = {"dryrun_qwen3_prefill": 2.0,
                      "dryrun_phi3_prefill": 2.0,
                      "dryrun_whisper_prefill": 1.2,
                      "dryrun_mamba2_prefill_multi": 1.5}
# Ops that the serving cells of phase 13 (f) must not run replicated: the
# head views of whisper's prefill (``sharding.project_heads``), the
# embedding's gather on two pods (``sharding.embed_on_shards``).
SERVING_NOT_REPLICATED = {
    "dryrun_whisper_prefill": ("view", "_unsafe_view"),
    "dryrun_mamba2_prefill_multi": ("index", "index_put")}
# Phase 13 (f)'s bound on a two-pod cell's peak over the reference's:
# mamba2-1.3b's is 1.5x, as the one-pod cell's; qwen3-0.6b's, 1.5x since
# its attention's heads stay split over the model axis (ROADMAP C.12:
# its batch of 8 rows a device row cannot take the 16-wide axis, and its
# head views ran replicated; 5x before).
MULTI_PEAK_BOUND = {"qwen3-0.6b": 1.5, "mamba2-1.3b": 1.5}
# The bounds above hold each cell's footprint (``memory.footprint_bytes``:
# its arguments plus the trace's high-water mark, nothing donated).  Two
# train cells are held on the reference's terms (``memory.
# peak_reference_terms``, the reference's argument + temp - alias, ROADMAP
# C.16): qwen2-moe-a2.7b x train_4k x 16 x 16 within 2x the JAX package's
# peak for it (``python -m repro.launch.dryrun --arch qwen2-moe-a2.7b
# --shape train_4k --mesh single`` on the CPU), and deepseek-v3-671b x
# train_4k x 16 x 16 at 2 layers within the JAX package's peak for it
# (``... --arch deepseek-v3-671b --shape train_4k --mesh single --override
# n_layers=2``), with no tensor of ``we_down``'s whole (experts, ff, d)
# shape live at its peak (C.17).  That cell was held within 5e10 B while
# the trace counted as freed the outputs autograd saves for the backward
# (ROADMAP C.21: 3.572e10 B on torch 2.11 and 2.13, 5.834e10 counted).
REF_DRYRUN_QWEN2_MOE = 1.00991119568e11
QWEN2_MOE_BOUND = 2.0
REF_DRYRUN_DEEPSEEK_2L = 7.0644734096e10
DEEPSEEK_2L_BOUND = 1.0
DEEPSEEK_WE_DOWN = (256, 2048, 7168)
# deepseek-v3-671b x train_4k x 2 x 16 x 16 at full depth: its footprint
# within 7.55e11 B a device, with no stack of the 61 layers' expert
# gradients whole over the data axes in fp32, (61, 16, 7168, 2048) or (61,
# 16, 2048, 7168), live at its peak (ROADMAP C.19: 9.026e11 on torch 2.11
# with three of them live, 7.379e11 with them scattered; PERF.md §6).
DEEPSEEK_MULTI_FOOTPRINT = 7.55e11
DEEPSEEK_EXPERT_STACKS = ((61, 16, 7168, 2048), (61, 16, 2048, 7168))
# qwen2-vl-72b x train_4k x 16 x 16 at 2 layers: no stacked MLP gradient
# whole in fp32 at its peak, (2, 8192, 29568) or (2, 29568, 8192) (ROADMAP
# C.18: the full cell held (80, 29568, 8192) pending a sum, all-reduced).
QWEN2_VL_MLP = ((2, 8192, 29568), (2, 29568, 8192))
# Train cells whose new parameters and moments must come out of AdamW
# placed as their specs (``memory.outputs_placed`` empty), their footprint
# at least the arguments and the donated state (ROADMAP C.20: deepseek's
# ``wq_b`` came out split over the data axis and pending a sum over the
# pod axis, mamba2's whole-table embedding split on its hidden dim).
STATE_PLACED_CELLS = ("dryrun_deepseek_multi", "dryrun_mamba2",
                      "dryrun_mamba2_multi")


def _dryrun_code(arch: str, shape: str, multi_pod: bool, smoke: bool,
                 overrides: dict | None = None) -> str:
    """The program of one dry-run cell: ``lower_cell(arch, shape,
    multi_pod, overrides)`` on the fake group of 256 or 512 ranks, or
    with ``smoke`` the SMOKE config's cell of kind ``shape`` (4 x 64
    tokens) on a fake (2, 2) mesh of 4 ranks, as the CPU tests run it,
    whose record says whether the dry run registered its own ``flip`` rule
    (``flip_rule_registered``).  Each record says whether the dry run's
    view rule was in place (``view_rule_registered``: on every torch)."""
    if smoke:
        cell = ("from torch.distributed.device_mesh import "
                "init_device_mesh\n"
                "from repro_torch.configs.registry import ShapeSpec\n"
                "from repro_torch.launch.mesh import "
                "init_fake_process_group\n"
                "init_fake_process_group(4)\n"
                "mesh = init_device_mesh('cpu', (2, 2), "
                "mesh_dim_names=('data', 'model'))\n"
                "registered = dryrun._ensure_flip_rule()\n"
                f"e = dryrun.lower_cell({arch!r}, ShapeSpec("
                f"{shape + '_smoke'!r}, 64, 4, {shape!r}), False, "
                "mesh=mesh, smoke=True)\n"
                "e['flip_rule_registered'] = registered\n")
    else:
        cell = (f"e = dryrun.lower_cell({arch!r}, {shape!r}, "
                f"multi_pod={multi_pod}, overrides={overrides!r})\n")
    return ("import json, logging\n"
            "import torch\n"
            "from torch.distributed.tensor import DTensor\n"
            "from repro_torch.launch import dryrun\n"
            "logging.getLogger('torch.distributed.tensor')"
            ".setLevel(logging.ERROR)\n" + cell +
            "e['view_rule_registered'] = DTensor._op_dispatcher"
            ".sharding_propagator.op_strategy_funcs.get("
            "torch.ops.aten.view.default) is dryrun._view_strategy\n"
            "print('DRYRUN ' + json.dumps(e))\n")


def dryrun_cells(cells: dict) -> dict:
    """Each cell of ``cells`` (key → ``(arch, shape, multi_pod, smoke)``,
    and the config's overrides where a fifth entry gives them) in a process
    of its own, all at once (the fake group replaces the live one, and this
    process's NCCL group must stay) → key → its record with
    ``subprocess_s``.  Fails on a cell that does not print its record."""
    env = {**os.environ, "PYTHONPATH": str(SRC), "CUDA_VISIBLE_DEVICES": ""}
    out, procs = {}, {}
    with tempfile.TemporaryDirectory() as logs:
        t0 = time.perf_counter()
        try:
            for key, (arch, shape, multi_pod, smoke, *overrides) in \
                    cells.items():
                path = os.path.join(logs, key)
                with open(path + ".out", "w") as o, \
                        open(path + ".err", "w") as e:
                    procs[key] = subprocess.Popen(
                        [sys.executable, "-c", _dryrun_code(
                            arch, shape, multi_pod, smoke, *overrides)],
                        stdout=o, stderr=e, env=env)
            for key, proc in procs.items():
                rc = proc.wait(timeout=max(1.0, 900 - (time.perf_counter()
                                                       - t0)))
                path = os.path.join(logs, key)
                lines = [ln for ln in open(path + ".out").read().splitlines()
                         if ln.startswith("DRYRUN ")]
                if rc != 0 or not lines:
                    fail(f"dry-run cell {key}: exit {rc}: "
                         f"{open(path + '.err').read().strip()[-2000:]}")
                out[key] = json.loads(lines[-1][len("DRYRUN "):])
                out[key]["subprocess_s"] = time.perf_counter() - t0
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    return out


def scaleout_phase(seed: int, workdir: str, train: dict, served: dict,
                   device: str = "cuda", smoke: bool = False) -> dict:
    """Phase 13, after phase 12 and in its work directory: (a) a process
    group of one rank (NCCL on the card, over a ``FileStore`` in the work
    directory) and ``make_host_mesh()``; (b) two train steps of Qwen3-0.6B
    at phase 12's settings, the state placed by ``param_specs`` in ``fsdp``
    mode and the error-feedback compressor as ``compress_grads``, against
    the same steps on plain tensors, whose hook also checks
    ``compressed_psum`` over the group, and that hook's time; (c) phase
    12's newest checkpoint restored onto the mesh's placements, leaf for
    leaf equal to the plain restore; (d) ``pipeline_forward`` with one
    stage against the sequential loop; (e) the roofline of phase 12's train step and the serving phase's
    Llama-3-8B decode step beside their measured times; (f) the dry run's
    cells, each in a subprocess (``dryrun_cells``)."""
    import gc
    import torch
    import torch.distributed as dist
    from repro_torch.configs.registry import get_config
    from repro_torch.core.checkpoint import CheckpointManager
    from repro_torch.core.tree import leaves
    from repro_torch.distributed import sharding
    from repro_torch.distributed.pipeline import pipeline_forward
    from repro_torch.launch.dryrun import REPLICABLE
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import launcher_opt, make_batch_fn
    from repro_torch.roofline.op_cost import op_cost
    from repro_torch.training.step import (abstract_train_state,
                                           make_train_step)
    res = {}
    t_phase = time.perf_counter()
    # (a) the process group and the host mesh
    if device == "cuda":
        torch.cuda.set_device(0)
    backend = "nccl" if device == "cuda" else "gloo"
    store = dist.FileStore(os.path.join(workdir, "pg-store"), 1)
    dist.init_process_group(backend, store=store, rank=0, world_size=1)
    try:
        mesh = make_host_mesh(device=device)
        if tuple(mesh.shape) != (1, 1) or \
                mesh.mesh_dim_names != ("data", "model"):
            fail(f"host mesh {tuple(mesh.shape)} {mesh.mesh_dim_names}, not "
                 f"(1, 1) ('data', 'model')")
        group = mesh.get_group("data")
        res["process_group"] = dict(backend=dist.get_backend(),
                                    world_size=dist.get_world_size(),
                                    mesh=list(mesh.shape),
                                    axes=list(mesh.mesh_dim_names))

        # (b) sharded, compressed steps against plain ones
        cfg = get_config("qwen3-0.6b", smoke=smoke)
        B, S = (2, 64) if smoke else (8, 2048)
        opt = launcher_opt(1e-3, 8)
        data = make_batch_fn(cfg, B, S, device)
        reset_launches()
        _reset_peak(device)
        hook_ms = []
        t0 = time.perf_counter()
        s_losses, s_params = _scaleout_steps(cfg, opt, seed, data, mesh,
                                             group, device, True, None)
        sharded_s = time.perf_counter() - t0
        _free(device)
        t0 = time.perf_counter()
        p_losses, p_params = _scaleout_steps(cfg, opt, seed, data, mesh,
                                             group, device, False, hook_ms)
        plain_s = time.perf_counter() - t0
        launches = read_launches()
        if any(launches.values()):
            fail(f"the scale-out path launched kernels: {launches}")
        bit_equal, worst, worst_leaf = True, 0.0, None
        if sorted(s_params) != sorted(p_params):
            fail("sharded and plain states have different leaves")
        for path, w in p_params.items():
            g = s_params[path]
            d = float((g.double() - w.double()).abs().max())
            bit_equal &= bool(torch.equal(g, w))
            if d > worst:
                worst, worst_leaf = d, path
        tol = _leaves_close("sharded train step", s_params, p_params, 2e-4)
        for a, b in zip(s_losses, p_losses):
            if abs(a - b) > 2e-4 * abs(b) + 2e-4:
                fail(f"sharded losses {s_losses}, plain {p_losses}")
        n = sum(t.numel() for t in p_params.values())
        hook_bound_ms = 16 * n / HBM_BYTES_PER_S * 1e3
        res["sharded_step"] = dict(
            arch=cfg.name, batch=B, seq=S, steps=SCALEOUT_STEPS,
            mode="fsdp", sharded_losses=s_losses, plain_losses=p_losses,
            losses_equal=s_losses == p_losses, leaves_bit_equal=bit_equal,
            max_leaf_abs_diff=worst, max_diff_leaf=worst_leaf,
            err_over_allowance=tol, sharded_s=sharded_s, plain_s=plain_s,
            peak_bytes=_peak_bytes(device), launches=launches,
            hook_ms=hook_ms, hook_clock="device" if device == "cuda"
            else "host", hook_bound_ms=hook_bound_ms,
            hook_bound_bytes=16 * n)
        del s_params, p_params
        _free(device)

        # (c) the newest checkpoint restored onto the mesh's placements
        ckpt = CheckpointManager(os.path.join(workdir, "ckpt"),
                                 device=device)
        try:
            params_abs, opt_abs = abstract_train_state(cfg, opt)
            like = {"params": params_abs, "opt": opt_abs}
            pspec = sharding.param_specs(params_abs, mesh)
            shardings = sharding.named(
                {"params": pspec, "opt": sharding.opt_specs(opt_abs, pspec)},
                mesh)
            t0 = time.perf_counter()
            plain, step = ckpt.restore(like)
            plain_hashes = _leaf_hashes(plain)
            del plain
            _free(device)
            t1 = time.perf_counter()
            placed, step2 = ckpt.restore(like, shardings=shardings)
            kinds = {type(t).__name__ for t in leaves(placed)}
            placed_hashes = _leaf_hashes(_flat_state(placed))
            restore_s = time.perf_counter() - t1
            del placed
            _free(device)
        finally:
            ckpt.close()
        if step is None or step != step2:
            fail(f"restored steps {step} and {step2}")
        if kinds != {"DTensor"}:
            fail(f"restored leaves with shardings are {kinds}")
        if placed_hashes != plain_hashes:
            bad = [p for p in plain_hashes
                   if placed_hashes.get(p) != plain_hashes[p]]
            fail(f"leaves restored onto placements differ: {bad[:8]}")
        res["restore"] = dict(step=step, leaves=len(plain_hashes),
                              plain_s=t1 - t0, placed_s=restore_s)

        # (d) the pipeline with one stage against the sequential loop
        L, PB, D = 8, 8, 1024
        g = torch.Generator(device=device).manual_seed(seed)
        pp = {"w": torch.randn(L, D, D, generator=g, device=device) * D**-.5,
              "b": torch.randn(L, D, generator=g, device=device) * 0.1}
        x = torch.randn(PB, D, generator=g, device=device)
        layer_fn = lambda p, h: torch.tanh(h @ p["w"] + p["b"])
        want = x
        for i in range(L):
            want = layer_fn({"w": pp["w"][i], "b": pp["b"][i]}, want)
        got = pipeline_forward(layer_fn, pp, x, mesh=mesh,
                               stage_axis="model", n_microbatches=4)
        perr = _close(got, want, 1e-5)
        res["pipeline"] = dict(layers=L, batch=PB, width=D, microbatches=4,
                               stages=1, max_abs_err=perr)
    finally:
        dist.destroy_process_group()

    # (e) the roofline of the measured steps
    tcfg = get_config("qwen3-0.6b", smoke=smoke)
    tb, ts = (2, 64) if smoke else (8, 2048)
    topt = launcher_opt(1e-3, 8)
    t0 = time.perf_counter()
    tp, to = abstract_train_state(tcfg, topt)
    tokens = torch.empty((tb, ts), dtype=torch.int32, device="meta")
    tcost = op_cost(make_train_step(tcfg, topt), tp, to,
                    {"tokens": tokens, "labels": tokens})
    lcfg, lcost, lplain = _llama_decode_cost(
        8, 2048, served["kv_reads"] / served["decode_steps"])
    res["op_cost_s"] = time.perf_counter() - t0
    res["roofline"] = [
        _roofline_line(f"train {tb}x{ts}", tcfg, tcost, tb * ts, "train",
                       train["ms_per_step"], train["peak_bytes"]),
        _roofline_line("decode 8 slots x 2048", lcfg, lcost, 8, "decode",
                       served["decode_ms_per_step"], served.get(
                           "peak_bytes", 0))]
    # op_cost of the plain step (D's whole-arena gathers, each weight
    # counted twice): not the program that was timed; printed beside it.
    res["roofline"][1]["plain_d"] = dict(
        flops=lplain.flops, bytes=lplain.bytes,
        bound_ms=max(lplain.flops / BF16_OPS_PER_S,
                     lplain.bytes / HBM_BYTES_PER_S) * 1e3)

    # (f) the dry-run cells: qwen3-0.6b x train_4k on the fake 256-rank
    # group, mamba2-1.3b's SMOKE train cell on a fake (2, 2) mesh (its
    # cumsum's backward flips), mamba2-1.3b x train_4k on 16 x 16, and
    # both train_4k cells on 2 x 16 x 16 (the batch split over pod and
    # data, the head views: ROADMAP C.12); the serving cells; the MoE
    # train cells (C.16, C.17, C.19)
    cells = dryrun_cells({
        "dryrun_cell": ("qwen3-0.6b", "train_4k", False, False),
        "dryrun_mamba2_smoke": ("mamba2-1.3b", "train", False, True),
        "dryrun_mamba2": ("mamba2-1.3b", "train_4k", False, False),
        "dryrun_mamba2_multi": ("mamba2-1.3b", "train_4k", True, False),
        "dryrun_qwen3_multi": ("qwen3-0.6b", "train_4k", True, False),
        "dryrun_qwen2_moe": ("qwen2-moe-a2.7b", "train_4k", False, False),
        "dryrun_deepseek_2l": ("deepseek-v3-671b", "train_4k", False, False,
                               {"n_layers": 2}),
        "dryrun_deepseek_multi": ("deepseek-v3-671b", "train_4k", True,
                                  False),
        "dryrun_qwen2_vl_2l": ("qwen2-vl-72b", "train_4k", False, False,
                               {"n_layers": 2}),
        **{key: (arch, shape, multi, False)
           for key, (arch, shape, multi, _) in REF_DRYRUN_SERVING.items()}})
    for key, cell in cells.items():
        if cell.get("status") != "ok":
            fail(f"dry-run cell {key}: {cell.get('status')}")
        if not set(cell["replicated_calls"]) <= REPLICABLE:
            fail(f"dry-run cell {key} ran ops replicated outside the named "
                 f"ones: {cell['replicated_calls']}")
        if set(cell["replicated_calls"]) != set(cell["replicated_bytes"]):
            fail(f"dry-run cell {key}: a replicated op without its bytes")
        res[key] = {k: cell[k] for k in (
            "arch", "shape", "mesh", "status", "cost_s", "trace_s", "memory",
            "replicated_calls", "replicated_bytes", "roofline",
            "subprocess_s", "view_rule_registered") + (
                ("flip_rule_registered",)
                if "flip_rule_registered" in cell else ())}
    # The head views of the production cell shard on every torch (ROADMAP
    # C.12), and its peak stays near the JAX package's for the same cell.
    cell = res["dryrun_cell"]
    views = {k: v for k, v in cell["replicated_calls"].items()
             if k in ("view", "_unsafe_view")}
    if views:
        fail(f"dry-run cell: views run replicated {views}")
    peak = cell["memory"]["footprint_bytes"]
    cell["peak_over_reference"] = peak / REF_DRYRUN_PEAK
    cell["collectives_over_reference"] = \
        cell["roofline"]["collective_bytes"] / REF_DRYRUN_COLLECTIVES
    if peak > 1.5 * REF_DRYRUN_PEAK:
        fail(f"dry-run cell: peak {peak} B a device, over 1.5x the "
             f"reference's {REF_DRYRUN_PEAK}")
    # The two-pod train cells against the reference's on the same mesh.
    for key in ("dryrun_qwen3_multi", "dryrun_mamba2_multi"):
        cell = res[key]
        ref_peak, ref_coll = REF_DRYRUN_MULTI[cell["arch"]]
        peak = cell["memory"]["footprint_bytes"]
        cell["peak_over_reference"] = peak / ref_peak
        cell["collectives_over_reference"] = \
            cell["roofline"]["collective_bytes"] / ref_coll
        bound = MULTI_PEAK_BOUND[cell["arch"]]
        if peak > bound * ref_peak:
            fail(f"dry-run cell {key}: peak {peak} B a device, over "
                 f"{bound}x the reference's {ref_peak}")
    # The serving cells: the prefill's cache placed on the mesh, the
    # decode's arena read where it lies.
    for key, (_, _, _, (ref_peak, ref_coll)) in REF_DRYRUN_SERVING.items():
        rf, mem = res[key]["roofline"], res[key]["memory"]
        res[key]["peak_over_reference"] = mem["footprint_bytes"] / ref_peak
        res[key]["collectives_over_reference"] = \
            rf["collective_bytes"] / ref_coll
        res[key]["reference_terms_over_reference"] = \
            mem["peak_reference_terms"] / ref_peak
        if key in SERVING_BOUND:
            metric, bound = SERVING_BOUND[key]
            got = mem[metric] if metric in mem else rf[metric]
            if got > bound:
                fail(f"dry-run cell {key}: {metric} {got} B, over {bound}")
        if key in SERVING_PEAK_BOUND and mem["peak_reference_terms"] > \
                SERVING_PEAK_BOUND[key] * ref_peak:
            fail(f"dry-run cell {key}: peak on the reference's terms "
                 f"{mem['peak_reference_terms']} B, over "
                 f"{SERVING_PEAK_BOUND[key]}x the reference's {ref_peak}")
        ran = set(SERVING_NOT_REPLICATED.get(key, ())) & set(
            res[key]["replicated_calls"])
        if ran:
            fail(f"dry-run cell {key}: ran {sorted(ran)} replicated")
    # Two train cells on the reference's terms (ROADMAP C.16, C.17).
    cell = res["dryrun_qwen2_moe"]
    peak = cell["memory"]["peak_reference_terms"]
    cell["peak_over_reference"] = peak / REF_DRYRUN_QWEN2_MOE
    if peak > QWEN2_MOE_BOUND * REF_DRYRUN_QWEN2_MOE:
        fail(f"dry-run cell dryrun_qwen2_moe: peak on the reference's terms "
             f"{peak} B, over {QWEN2_MOE_BOUND}x the reference's "
             f"{REF_DRYRUN_QWEN2_MOE}")
    cell = res["dryrun_deepseek_2l"]
    peak = cell["memory"]["peak_reference_terms"]
    whole = [h for h in cell["memory"]["peak_holders"]
             if tuple(h[1][-3:]) == DEEPSEEK_WE_DOWN]
    cell["peak_over_reference"] = peak / REF_DRYRUN_DEEPSEEK_2L
    if whole or peak > DEEPSEEK_2L_BOUND * REF_DRYRUN_DEEPSEEK_2L:
        fail(f"dry-run cell dryrun_deepseek_2l: peak on the reference's "
             f"terms {peak} B (bound {DEEPSEEK_2L_BOUND}x the reference's "
             f"{REF_DRYRUN_DEEPSEEK_2L}), we_down whole at "
             f"it: {whole}")
    # DeepSeek's experts run on each device's groups and experts, their
    # gradients scattered over the data axes a layer at a time (C.19).
    for key in ("dryrun_deepseek_2l", "dryrun_deepseek_multi"):
        views = {k: v for k, v in res[key]["replicated_calls"].items()
                 if k in ("view", "_unsafe_view")}
        if views:
            fail(f"dry-run cell {key}: views run replicated {views}")
    mem = res["dryrun_deepseek_multi"]["memory"]
    whole = [h for h in mem["peak_holders"]
             if tuple(h[1]) in DEEPSEEK_EXPERT_STACKS and h[0] != "new_empty"]
    if whole or mem["footprint_bytes"] > DEEPSEEK_MULTI_FOOTPRINT:
        fail(f"dry-run cell dryrun_deepseek_multi: footprint "
             f"{mem['footprint_bytes']} B (bound {DEEPSEEK_MULTI_FOOTPRINT}),"
             f" expert gradients whole at its peak: {whole}")
    whole = [h for h in res["dryrun_qwen2_vl_2l"]["memory"]["peak_holders"]
             if tuple(h[1]) in QWEN2_VL_MLP and h[2] == "float32"]
    if whole:
        fail(f"dry-run cell dryrun_qwen2_vl_2l: MLP gradients whole at its "
             f"peak: {whole}")
    # The new train state comes out of the update placed as its specs, as
    # the reference's out_shardings pin it: the dry run moved no leaf of it
    # after the step, and the footprint holds the old state and the new
    # (ROADMAP C.20).
    for key in STATE_PLACED_CELLS:
        mem = res[key]["memory"]
        if mem["outputs_placed"] or mem["footprint_bytes"] < \
                mem["argument_bytes"] + mem["donated_bytes"]:
            fail(f"dry-run cell {key}: new state placed by DTensor's rules "
                 f"{mem['outputs_placed']}, footprint "
                 f"{mem['footprint_bytes']} B under the old and new state's "
                 f"{mem['argument_bytes'] + mem['donated_bytes']}")
    res["phase_s"] = time.perf_counter() - t_phase
    gc.collect()
    return res


# -------------------------------------------------------------- main path

def make_keys(n: int, tag: bytes) -> list[bytes]:
    return [hashlib.sha256(tag + i.to_bytes(8, "little")).digest()
            for i in range(n)]


def main_path(n_keys: int, seed: int, workdir: str,
              device: str = "cuda") -> dict:
    import torch
    from repro_torch.core.tidestore import DbConfig, KeyspaceConfig, TideDB
    rep = 1024 // 32                   # value = key x 32: 1 KiB, checkable
    tag = b"tidehunter-smoke-%d:" % seed
    keys = make_keys(n_keys, tag)
    absent = make_keys(EXISTS_KEYS // 2, tag + b"absent")
    rng = np.random.default_rng(seed)
    cfg = DbConfig(keyspaces=[KeyspaceConfig("kv", n_cells=256)],
                   device=device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    res = {"keys": n_keys, "value_bytes": 32 * rep}

    reset_launches()
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
    res["launches"] = read_launches()
    res.update(
        put_s=t1 - t0, put_ops_s=n_keys / (t1 - t0),
        flush_close_s=t2 - t1, reopen_s=t3 - t2,
        exists_s=t4 - t3, exists_ops_s=len(probe) / (t4 - t3),
        get_s=t6 - t5, get_ops_s=GET_KEYS / (t6 - t5),
        value_wal_bytes=db.value_wal.tail,
        kernel_lookups=db.stats()["batched_kernel_lookups"])
    if device == "cuda":
        res["profile"] = profile_reads(db, probe, gkeys)
    # The sweep's gets reach its largest size (phase 3's gkeys are 8192).
    sweep_gets = [keys[i] for i in rng.choice(
        n_keys, min(n_keys, SWEEP_SIZES[-1]), replace=False)]
    res["routing"] = routing_sweep(db, present, absent, sweep_gets, device)
    db.close()
    return res


def _stats_ms(samples) -> dict:
    """Median and interquartile range of a route's samples (seconds), in
    ms, with the samples."""
    a = np.asarray(samples) * 1e3
    q1, med, q3 = np.percentile(a, [25, 50, 75])
    return {"median_ms": float(med), "iqr_ms": float(q3 - q1),
            "n": len(a), "samples_ms": [round(float(x), 4) for x in a]}


def _kernel_wins(host: dict, kernel: dict) -> bool:
    """The kernel route's median below the host route's by more than both
    routes' interquartile ranges."""
    return host["median_ms"] - kernel["median_ms"] > max(host["iqr_ms"],
                                                          kernel["iqr_ms"])


def _alternate(routes: dict, n: int) -> dict:
    """``n`` host-clock samples of each callable in ``routes``, the order
    reversed every other round → seconds by route."""
    names, out = list(routes), {name: [] for name in routes}
    for i in range(n):
        for name in names if i % 2 == 0 else names[::-1]:
            t0 = time.perf_counter()
            routes[name]()
            out[name].append(time.perf_counter() - t0)
    return out


def routing_sweep(db, present, absent, gkeys, device: str) -> dict:
    """Phase 3's routing sweep over the warm reopened store (ROADMAP A.4).
    For each batch size of ``SWEEP_SIZES`` it captures what the engine
    routes: the lookup's inputs from ``multi_get``, and the fused Bloom
    probe's from ``multi_exists`` (half the keys absent; the parsed index
    blobs dropped first, as a memoized cell skips the probe), each call
    taken at the host route with the value cache cleared.  It then runs
    both routes on those inputs, ``SWEEP_SAMPLES`` times each in
    alternating order (host clock; the kernel route includes its copies
    and its wait), and fails if they answer differently.  The kernel route
    wins from the smallest size at which it wins (``_kernel_wins``) and at
    every larger size, in the unit the engine routes by: queries a touched
    cell for the Bloom probe (``bloom.kernel_min_batch``), disk-resolved
    queries for the lookup (``large_table.kernel_min_queries``)."""
    from repro_torch.core.tidestore import ReadOptions, bloom, large_table
    from repro_torch.kernels.bloom_check.ops import probe_cells_batch
    from repro_torch.kernels.optimistic_lookup.ops import \
        lookup_indices_batch
    host_opts = ReadOptions(use_kernel=False, fill_cache=False)
    window = db.cfg.keyspaces[0].window_entries

    def capture(module, name, call):
        seen, real = [], getattr(module, name)

        def record(*args):
            seen.append(args)
            return real(*args)
        setattr(module, name, record)
        try:
            call()
        finally:
            setattr(module, name, real)
        return seen

    def bloom_routes(calls):
        host = lambda: [bloom._probe_host(*a) for a in calls]
        kern = lambda: [probe_cells_batch(*a[:5], k=a[5], device=device)
                        for a in calls]
        if not all(np.array_equal(h, k) for h, k in zip(host(), kern())):
            fail("the Bloom probe's routes answer differently")
        return {"host": host, "kernel": kern}

    def lookup_routes(calls):
        host = lambda: [large_table._lookup_host(*a) for a in calls]
        kern = lambda: [lookup_indices_batch(*a, window=window,
                                             device=device) for a in calls]
        for (q32, u32), (hi, hf), (ki, kf) in zip(calls, host(), kern()):
            last = len(u32) - 1
            if not np.array_equal(hf, kf) or not np.array_equal(
                    u32[np.minimum(hi, last)][hf],
                    u32[np.minimum(ki.astype(np.int64), last)][kf]):
                fail("the lookup's routes answer differently")
        return {"host": host, "kernel": kern}

    out = {"sizes": SWEEP_SIZES, "samples": SWEEP_SAMPLES,
           "bloom": {}, "lookup": {}}
    for b in SWEEP_SIZES:
        keys = present[:b // 2] + absent[:b - b // 2]
        db.cache.clear()
        lookups = capture(large_table, "_lookup_host", lambda: db.multi_get(
            gkeys[:b], keyspace="kv", opts=host_opts))
        # A cell whose parsed index blob is memoized skips the Bloom probe.
        db.cache.clear()
        db.table.blob_cache.clear()
        probes = capture(bloom, "_probe_host", lambda: db.multi_exists(
            keys, keyspace="kv", opts=host_opts))
        for what, calls in (("bloom", probes), ("lookup", lookups)):
            routed = sum(len(a[0]) for a in calls)
            if not routed:           # no call reached the routing choice
                continue
            row = {"calls": len(calls), "queries": routed}
            if what == "bloom":
                row["cells"] = sum(len(np.unique(a[2])) for a in calls)
                row["per_cell"] = routed / row["cells"]
            t = _alternate((bloom_routes if what == "bloom"
                            else lookup_routes)(calls), SWEEP_SAMPLES)
            out[what][b] = {**row, "host": _stats_ms(t["host"]),
                            "kernel": _stats_ms(t["kernel"])}
    for what, unit in (("bloom", "per_cell"), ("lookup", "queries")):
        at = None
        for b in reversed(sorted(out[what])):
            row = out[what][b]
            if not _kernel_wins(row["host"], row["kernel"]):
                break
            at = row[unit]
        # In the unit the engine routes by: queries a touched cell for the
        # Bloom probe, disk-resolved queries a batch for the lookup.
        out[f"{what}_kernel_wins_from"] = at
    return out


def _dispatches() -> dict:
    """The ops' dispatch counts, which count on either device."""
    from repro_torch.kernels.bloom_check import ops as bops
    from repro_torch.kernels.optimistic_lookup import ops as lops
    return {"bloom_check_ragged": bops.ragged_dispatch_count,
            "optimistic_lookup_resolve": lops.lookup_dispatch_count}


def _mixed_stream(rng, keys, absent, n: int) -> list[tuple]:
    """``n`` seeded requests: 50% get, 25% exists (half on absent keys),
    20% put that overwrites with a new 1 KiB value, 5% delete."""
    kinds = rng.choice(4, n, p=[0.50, 0.25, 0.20, 0.05])
    pick = rng.integers(0, len(keys), n)
    miss = rng.integers(0, len(absent), n)
    out_of_set = rng.random(n) < 0.5
    ops = []
    for i in range(n):
        key = keys[pick[i]]
        if kinds[i] == 0:
            ops.append(("get", key))
        elif kinds[i] == 1:
            ops.append(("exists", absent[miss[i]] if out_of_set[i] else key))
        elif kinds[i] == 2:
            ops.append(("put", key, (key[:28] + i.to_bytes(4, "little"))
                        * 32))
        else:
            ops.append(("delete", key))
    return ops


def sharded_phase(n_keys: int, seed: int, workdir: str,
                  device: str = "cuda") -> dict:
    """Phase 8: ``KvBatchServer`` over ``ShardedTideDB(n_shards=4,
    replication=2)``, every answer checked against what was written.

    Bulk load through the server, a seeded mixed stream in waves of the
    server's batch (each answer against a dict run in submission order:
    scalar semantics), flush and close, then the batched reads twice, each
    after a fresh reopen (cells UNLOADED, nothing memoized or cached): at
    the default route and with ``ReadOptions(use_kernel=True)``.  Then a
    flipped value byte in a key's primary copy: the server's get fails over
    to the replica, and ``repair()`` restores the copy."""
    import torch
    from repro_torch.core.tidestore import (DbConfig, KeyspaceConfig,
                                            ReadOptions, ShardedTideDB,
                                            read_repair_table)
    from repro_torch.core.tidestore.bloom import kernel_min_batch
    from repro_torch.core.tidestore.large_table import kernel_min_queries
    from repro_torch.core.tidestore.wal import HEADER_SIZE, _ENTRY_HDR
    from repro_torch.serving.kv_server import KvBatchServer
    rep = 1024 // 32                   # value = key x 32: 1 KiB, checkable
    tag = b"tidehunter-sharded-%d:" % seed
    keys = make_keys(n_keys, tag)
    absent = make_keys(EXISTS_KEYS // 2, tag + b"absent")
    rng = np.random.default_rng(seed)
    cfg = DbConfig(keyspaces=[KeyspaceConfig("kv", n_cells=256)],
                   device=device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    def open_store():
        return ShardedTideDB(workdir, cfg, n_shards=N_SHARDS,
                             replication=REPLICATION)

    res = {"keys": n_keys, "value_bytes": 32 * rep, "shards": N_SHARDS,
           "replication": REPLICATION, "max_batch": SERVER_BATCH}
    reset_launches()
    sdb = open_store()
    srv = KvBatchServer(sdb, max_batch=SERVER_BATCH)
    t0 = time.perf_counter()
    for i in range(0, n_keys, SERVER_BATCH):
        reqs = [srv.submit_put(k, k * rep, keyspace="kv")
                for k in keys[i:i + SERVER_BATCH]]
        while srv.step():
            pass
        if any(r.error is not None or not r.done for r in reqs):
            fail("a bulk-load put through the server failed")
    res["server_put_s"] = time.perf_counter() - t0
    res["server_put_ops_s"] = n_keys / res["server_put_s"]

    state = {k: k * rep for k in keys}            # the scalar oracle
    stream = _mixed_stream(rng, keys, absent, MIXED_REQUESTS)
    submit = {"get": srv.submit_get, "exists": srv.submit_exists,
              "delete": srv.submit_delete}
    sojourn, wrong = [], 0
    t0 = time.perf_counter()
    for i in range(0, len(stream), SERVER_BATCH):
        wave = stream[i:i + SERVER_BATCH]
        reqs = [srv.submit_put(op[1], op[2], keyspace="kv")
                if op[0] == "put" else submit[op[0]](op[1], keyspace="kv")
                for op in wave]
        while srv.step():
            pass
        for op, r in zip(wave, reqs):
            if op[0] == "put":
                state[op[1]] = op[2]
            elif op[0] == "delete":
                state[op[1]] = None
            else:
                want = state.get(op[1])
                want = want is not None if op[0] == "exists" else want
                wrong += r.error is not None or r.result() != want
            sojourn.append(r.t_done - r.t_submit)
    res["mixed_s"] = time.perf_counter() - t0
    if wrong:
        fail(f"{wrong} mixed-stream answers differ from scalar execution")
    res.update(
        mixed_requests=len(stream),
        mixed_ops_s=len(stream) / res["mixed_s"],
        sojourn_p50_ms=1e3 * float(np.percentile(sojourn, 50)),
        sojourn_p99_ms=1e3 * float(np.percentile(sojourn, 99)),
        server=srv.stats())
    t0 = time.perf_counter()
    sdb.flush()
    sdb.close()
    res["flush_close_s"] = time.perf_counter() - t0

    live = [k for k in keys if state[k] is not None]
    # Each shard's share of the reads reaches the lookup's threshold on this
    # device (by an eighth), so that C launches on every shard at
    # use_kernel=True; on the CPU, 2048 a shard.  The keys are
    # drawn shard by shard (``shard_of`` is the key's crc32, no state),
    # then shuffled.
    lookup_min, bloom_min = kernel_min_queries(device), kernel_min_batch(
        device)
    per_shard = max(GET_KEYS // N_SHARDS, lookup_min + lookup_min // 8)
    by_shard = collections.defaultdict(list)
    for k in live:
        by_shard[sdb.shard_of(k)].append(k)

    def draw(n):
        out = [by_shard[s][i] for s in sorted(by_shard)
               for i in rng.choice(len(by_shard[s]), n, replace=False)]
        return [out[i] for i in rng.permutation(len(out))]

    present = draw(max(EXISTS_KEYS // 2 // N_SHARDS, per_shard))
    gkeys = draw(per_shard)
    absent_probe = make_keys(len(present), tag + b"absent")
    probe = present + absent_probe
    want_exists = [True] * len(present) + [False] * len(absent_probe)
    want_get = [state[k] for k in gkeys]
    res.update(gets=len(gkeys), probes=len(probe), reads_per_shard=per_shard)
    # Each route twice, in the order default, kernel, kernel, default, each
    # run after its own reopen (cells UNLOADED, nothing memoized).
    runs = {"default": [], "use_kernel": []}
    sdb = None
    for route in ("default", "use_kernel", "use_kernel", "default"):
        opts = ReadOptions(use_kernel=True) if route == "use_kernel" else None
        if sdb is not None:
            sdb.close()
        sdb = open_store()
        calls = {}
        for name, call, n, want in (
                ("multi_exists", lambda: sdb.multi_exists(
                    probe, keyspace="kv", opts=opts), len(probe),
                 want_exists),
                ("multi_get", lambda: sdb.multi_get(
                    gkeys, keyspace="kv", opts=opts), len(gkeys), want_get)):
            launched, before = read_launches(), _dispatches()
            t0 = time.perf_counter()
            got = call()
            sync()
            dt = time.perf_counter() - t0
            if got != want:
                fail(f"sharded {name} ({route}) differs from what was "
                     f"written")
            calls[name] = {
                "s": dt, "ops_s": n / dt,
                "launches": {k: v - launched[k] for k, v in
                             read_launches().items() if v - launched[k]},
                "dispatches": {k: v - before[k]
                               for k, v in _dispatches().items()}}
        runs[route].append(calls)
    cells = sdb.shards[0].cfg.keyspaces[0].n_cells

    def shards_over(keys_, least):
        """Shards whose share of ``keys_`` reaches ``least``."""
        per = collections.Counter(sdb.shard_of(k) for k in keys_)
        return sum(n >= least for n in per.values())

    # With use_kernel=True, on each shard: B once where its batch averages
    # the Bloom probe's threshold a cell (a shard's blob memo holds few of
    # its cells' parsed blobs at this size, so most cells probe, the gets'
    # too), and C once where its disk-resolved queries reach the lookup's
    # threshold (its present keys; the Bloom's few false positives add to
    # them).  The default route launches neither.
    kernel_calls = {name: {k: v for k, v in calls.items() if v} for name,
                    calls in (("multi_exists", {
                        "bloom_check_ragged": shards_over(
                            probe, bloom_min * cells),
                        "optimistic_lookup_resolve": shards_over(
                            present, lookup_min)}),
                        ("multi_get", {
                            "bloom_check_ragged": shards_over(
                                gkeys, bloom_min * cells),
                            "optimistic_lookup_resolve": shards_over(
                                gkeys, lookup_min)}))}
    want = {"default": {"multi_exists": {}, "multi_get": {}},
            "use_kernel": kernel_calls}
    if device == "cuda" and any(
            kernel_calls[n].get("optimistic_lookup_resolve") != N_SHARDS
            for n in kernel_calls):
        fail(f"the sharded reads do not reach the lookup's threshold on "
             f"every shard: {kernel_calls}")
    for route, calls_list in runs.items():
        for calls in calls_list:
            for name, c in calls.items():
                counted = {k: v for k, v in c["dispatches"].items() if v}
                if counted != want[route][name]:
                    fail(f"sharded {name} ({route}) dispatched {counted}, "
                         f"not {want[route][name]}")
                if device == "cuda" and c["launches"] != want[route][name]:
                    fail(f"sharded {name} ({route}) launched "
                         f"{c['launches']}, not {want[route][name]}")
    res["routes"] = {route: {name: {
        "ops_s": [c[name]["ops_s"] for c in calls_list],
        "s": [c[name]["s"] for c in calls_list],
        "launches": calls_list[0][name]["launches"]}
        for name in ("multi_exists", "multi_get")}
        for route, calls_list in runs.items()}

    # The multi-shard default route (ROADMAP A.4): both routes named
    # explicitly, alternated ROUTE_PAIRS times on the warm store, each call
    # after the value caches are dropped; every answer checked.
    def timed_call(name, kernel):
        opts = ReadOptions(use_kernel=kernel)
        keys_, want_ = ((probe, want_exists) if name == "multi_exists"
                        else (gkeys, want_get))
        sdb.clear_caches()
        t0 = time.perf_counter()
        got = getattr(sdb, name)(keys_, keyspace="kv", opts=opts)
        sync()
        dt = time.perf_counter() - t0
        if got != want_:
            fail(f"sharded {name} (use_kernel={kernel}) differs from what "
                 f"was written")
        return dt

    alt = {}
    for name in ("multi_exists", "multi_get"):
        t = {"host": [], "kernel": []}
        for i in range(ROUTE_PAIRS):
            for route in ("host", "kernel")[::1 if i % 2 == 0 else -1]:
                t[route].append(timed_call(name, route == "kernel"))
        alt[name] = {route: _stats_ms(v) for route, v in t.items()}
        alt[name]["kernel_wins"] = _kernel_wins(alt[name]["host"],
                                                alt[name]["kernel"])
        alt[name]["host_wins"] = _kernel_wins(alt[name]["kernel"],
                                              alt[name]["host"])
    res["route_alternation"] = alt

    # Failover and repair: one flipped value byte in a key's primary copy.
    key = gkeys[0]
    prim = sdb.shards[sdb.shard_of(key)]
    pos = prim.table.get_position(prim._ks_id("kv"), key)
    wal = prim.value_wal
    off = (pos % wal.cfg.segment_size + HEADER_SIZE + _ENTRY_HDR.size
           + len(key) + 1)
    fd = wal._fd(pos // wal.cfg.segment_size)
    os.pwrite(fd, bytes([os.pread(fd, 1, off)[0] ^ 0x5A]), off)
    sdb.clear_caches()
    srv = KvBatchServer(sdb, max_batch=SERVER_BATCH)
    r = srv.submit_get(key, keyspace="kv")
    srv.step()
    failovers = prim.metrics.read_failovers
    if r.result() != state[key] or failovers < 1:
        fail(f"a corrupt primary copy did not fail over (value ok: "
             f"{r.result() == state[key]}, read_failovers {failovers})")
    if pos not in wal.quarantined():
        fail("the corrupt primary copy was not quarantined")
    repaired = sdb.repair()
    strict = ReadOptions(strict_errors=True, fill_cache=False)
    sdb.clear_caches()
    table = read_repair_table(sdb)
    if (repaired["repaired"] != 1 or any(sh.value_wal.quarantined()
                                         for sh in sdb.shards)
            or prim.get(key, keyspace="kv", opts=strict) != state[key]
            or table["summary"]["repair_appends"] < 1):
        fail(f"repair did not restore the primary copy: {repaired}, "
             f"{table['summary']}")
    res.update(read_failovers=failovers, repair=repaired,
               repair_table=table["summary"],
               value_wal_bytes=sum(sh.value_wal.tail for sh in sdb.shards))
    res["launches"] = read_launches()
    # Phase 3's routing sweep on shard 0's store (64 cells, each as full as
    # phase 3's 256), over keys it holds: after the launches are read, as
    # its kernel calls compare routes.
    held = [k for k in live if 0 in sdb.replicas_of(sdb.shard_of(k))]
    pick = rng.choice(len(held), min(len(held), EXISTS_KEYS // 2
                                     + SWEEP_SIZES[-1]), replace=False)
    res["routing_shard0"] = routing_sweep(
        sdb.shards[0], [held[i] for i in pick[:EXISTS_KEYS // 2]],
        absent_probe, [held[i] for i in pick[EXISTS_KEYS // 2:]], device)
    sdb.close()
    return res


def engines_phase(n_keys: int, seed: int, workdir: str,
                  device: str = "cuda") -> dict:
    """Phase 14: the paper's engine comparison.  The port's ``TideDB``
    (phase 3's config, ``multi_get`` and ``multi_exists`` launching C and
    B on the card) and the LSM baseline as ``rocksdb(sim)`` and
    ``blobdb(sim)`` (memtables of 512 entries, leveled and key-value
    separated), each in a fresh directory, take the same ``n_keys``
    uniform 32-byte keys with 1 KiB values: ``put_many`` in batches of
    4096 for ``TideDB`` and scalar ``put`` for the baselines, then
    ``flush``.  The fill rate counts the puts and the flush together, as
    the reference's ``Bench.fill`` (``benchmarks/engines.py``) does; the
    put rate leaves the flush out, which for ``TideDB`` is most of its
    fill (its index tables and Bloom filters are written there), while
    the baselines flush their memtables and compact inside ``put``.  The
    reference fills every engine with scalar ``put``: ``TideDB``'s
    batched ``put_many`` here differs from it.  The value caches are
    dropped; then 8192 gets of present keys and 32768 existence checks,
    half of them absent (``multi_get`` / ``multi_exists`` for ``TideDB``,
    scalar calls for the baselines).  Every answer is checked; write
    amplification is the engine's ``bytes_written_disk /
    bytes_written_app``."""
    import torch
    from repro_torch.core.lsm_baseline import LsmBaseline, LsmConfig
    from repro_torch.core.tidestore import DbConfig, KeyspaceConfig, TideDB
    rep = 1024 // 32                   # value = key x 32: 1 KiB, checkable
    tag = b"tidehunter-engines-%d:" % seed
    keys = make_keys(n_keys, tag)
    absent = make_keys(EXISTS_KEYS // 2, tag + b"absent")
    rng = np.random.default_rng(seed)
    gkeys = [keys[i] for i in rng.choice(n_keys, GET_KEYS, replace=False)]
    present = [keys[i] for i in rng.choice(n_keys, EXISTS_KEYS // 2,
                                           replace=False)]
    probe = present + absent
    want_exists = [True] * len(present) + [False] * len(absent)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    engines = {
        "tidehunter": lambda d: TideDB(d, DbConfig(
            keyspaces=[KeyspaceConfig("kv", n_cells=256)], device=device)),
        "rocksdb(sim)": lambda d: LsmBaseline(
            d, LsmConfig(memtable_entries=512)),
        "blobdb(sim)": lambda d: LsmBaseline(
            d, LsmConfig(memtable_entries=512, blob_mode=True))}
    res = {"keys": n_keys, "value_bytes": 32 * rep, "gets": len(gkeys),
           "exists": len(probe),
           "reduced": f"keys {n_keys} (phase 3: 2^20)"}
    reset_launches()
    for name, make in engines.items():
        d = os.path.join(workdir, re.sub(r"\W", "", name))
        db = make(d)
        tide = isinstance(db, TideDB)
        t0 = time.perf_counter()
        if tide:
            for i in range(0, n_keys, BATCH):
                db.put_many([(k, k * rep) for k in keys[i:i + BATCH]],
                            keyspace="kv")
        else:
            for k in keys:
                db.put(k, k * rep)
        t1 = time.perf_counter()
        db.flush()
        t2 = time.perf_counter()
        st = db.stats()
        if tide:
            db.cache.clear()
        t3 = time.perf_counter()
        vals = (db.multi_get(gkeys, keyspace="kv") if tide
                else [db.get(k) for k in gkeys])
        sync()
        t4 = time.perf_counter()
        got = (db.multi_exists(probe, keyspace="kv") if tide
               else [db.exists(k) for k in probe])
        sync()
        t5 = time.perf_counter()
        wrong_get = sum(v != k * rep for v, k in zip(vals, gkeys))
        wrong_exists = sum(g != w for g, w in zip(got, want_exists))
        if wrong_get or wrong_exists:
            fail(f"{name}: {wrong_get} gets and {wrong_exists} existence "
                 f"checks differ from what was written")
        res[name] = {
            "put_s": t1 - t0, "put_ops_s": n_keys / (t1 - t0),
            "flush_s": t2 - t1, "fill_ops_s": n_keys / (t2 - t0),
            "write_amp": st["bytes_written_disk"] / st["bytes_written_app"],
            "bytes_written_app": st["bytes_written_app"],
            "bytes_written_disk": st["bytes_written_disk"],
            "get_s": t4 - t3, "get_ops_s": len(gkeys) / (t4 - t3),
            "exists_s": t5 - t4, "exists_ops_s": len(probe) / (t5 - t4)}
        if not tide:
            res[name]["levels"] = [sum(r.count for r in lv)
                                   for lv in db.levels]
        db.close()
        shutil.rmtree(d, ignore_errors=True)
    res["launches"] = read_launches()
    tide = res["tidehunter"]
    for name in ("rocksdb(sim)", "blobdb(sim)"):
        res[f"tidehunter_over_{name}"] = {
            m: tide[m] / res[name][m]
            for m in ("fill_ops_s", "put_ops_s", "get_ops_s",
                      "exists_ops_s")}
    return res


SCRUB_KEYS = 1 << 14            # phase 15: 16 MiB of 1 KiB values
SCRUB_PASSES = 5
CHURN_KEYS = 64                 # rewritten each churn round, as in the test
# A pause between churn rounds: at 1 KiB values an unpaced churn outgrows
# relocation, and each pass walks a longer WAL (2^16 keys in 4 MiB
# segments: 17 segments at the first pass, 126 at the fifth, 213 s racing
# on the H100's host).
CHURN_PAUSE_S = 0.002
SCRUB_SEGMENT = 1 << 20         # 1 MiB WAL segments: ~1000 records each,
                                # so relocation drops one every ~16 rounds


def scrub_race_phase(n_keys: int, seed: int, workdir: str,
                     device: str = "cuda") -> dict:
    """Phase 15: the scrubber racing writes and pruning (ROADMAP C.14) on
    phase 3's layout (``TideDB(device)``, 256 cells, 32-byte keys, 1 KiB
    values) in WAL segments of ``SCRUB_SEGMENT`` (phase 3: 4 MiB).  ``n_keys`` are put, flushed and the
    store reopened (cells unloaded).  A thread then rewrites the first
    ``CHURN_KEYS`` keys and runs ``prune_step(PruneOptions(
    batch_records=64))`` in a loop (``tests/test_torch_faults.py``'s race,
    paced by ``CHURN_PAUSE_S``),
    whose relocation passes move the watermark and drop whole segments,
    while this thread runs ``SCRUB_PASSES`` ``scrub()`` passes.  After
    each pass every key the churn does not touch is read back with
    ``multi_get`` and ``multi_exists`` (with as many absent keys) through
    ``use_kernel=True``, the index flushed and the value and parsed-index
    caches dropped first, so that B and C launch; after the churn stops,
    the churned keys too.
    It fails unless every pass reports no corruption, the quarantine stays
    empty, no CRC failure is counted and every answer is what was last
    written."""
    import threading

    import torch
    from repro_torch.core.tidestore import (DbConfig, KeyspaceConfig,
                                            PruneOptions, ReadOptions,
                                            TideDB)
    from repro_torch.core.tidestore.wal import WalConfig
    rep = 1024 // 32
    tag = b"tidehunter-scrub-%d:" % seed
    keys = make_keys(n_keys, tag)
    absent = make_keys(n_keys - CHURN_KEYS, tag + b"absent")
    churned, still = keys[:CHURN_KEYS], keys[CHURN_KEYS:]
    cfg = DbConfig(keyspaces=[KeyspaceConfig("kv", n_cells=256)],
                   wal=WalConfig(segment_size=SCRUB_SEGMENT), device=device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    opts = ReadOptions(use_kernel=True)
    t_start = time.perf_counter()
    db = TideDB(workdir, cfg)
    for i in range(0, n_keys, BATCH):
        db.put_many([(k, k * rep) for k in keys[i:i + BATCH]], keyspace="kv")
    db.flush()
    db.close()
    db = TideDB(workdir, cfg)
    last = {k: k * rep for k in churned}
    stop, errs, rounds = threading.Event(), [], [0]

    def churn():
        try:
            while not stop.is_set():
                i = rounds[0]
                batch = [(k, (k[:28] + i.to_bytes(4, "little")) * rep)
                         for k in churned]
                db.put_many(batch, keyspace="kv")
                last.update(batch)
                db.prune_step(PruneOptions(batch_records=64))
                rounds[0] += 1
                stop.wait(CHURN_PAUSE_S)
        except Exception as e:      # reported below, and the phase fails
            errs.append(e)

    def read_back(ks, want_vals):
        # Relocation's index updates sit in the cells' dirty buffers, which
        # answer without the kernels: flush them to the on-disk index.
        db.flush()
        db.cache.clear()
        db.table.blob_cache.clear()
        got = db.multi_get(ks, keyspace="kv", opts=opts)
        sync()
        if got != want_vals:
            bad = sum(g != w for g, w in zip(got, want_vals))
            fail(f"scrub race: multi_get returned {bad} wrong values")
        db.cache.clear()               # multi_get filled it
        db.table.blob_cache.clear()
        probe = ks + absent[:len(ks)]
        got = db.multi_exists(probe, keyspace="kv", opts=opts)
        sync()
        if got != [True] * len(ks) + [False] * (len(probe) - len(ks)):
            fail("scrub race: multi_exists answers differ from what was "
                 "written")
        return len(ks) + len(probe)

    res = {"keys": n_keys, "churn_keys": CHURN_KEYS, "passes": [],
           "read_backs": 0}
    wal = db.value_wal
    reset_launches()
    before = _dispatches()
    t0 = time.perf_counter()
    worker = threading.Thread(target=churn, name="scrub-race-churn")
    worker.start()
    try:
        for _ in range(SCRUB_PASSES):
            segs = db.scrubber._sealed_segments()
            t_pass = time.perf_counter()
            report = db.scrub()
            gone = sum(wal.segment_missing(s) for s in segs)
            res["passes"].append({
                "segments": len(segs), "dropped_mid_pass": gone,
                "records_checked": report["records_checked"],
                "corruptions": report["corruptions"],
                "findings": len(report["findings"]),
                "quarantined": len(wal.quarantined()),
                "s": time.perf_counter() - t_pass})
            if report["corruptions"] or report["findings"] or \
                    wal.quarantined():
                fail(f"scrub race: pass {len(res['passes'])} reported "
                     f"{report['findings'][:4]} and quarantined "
                     f"{sorted(wal.quarantined())[:4]}")
            res["read_backs"] += read_back(still, [k * rep for k in still])
    finally:
        stop.set()
        worker.join(timeout=60)
    if errs:
        fail(f"scrub race: the churn thread raised {errs[0]!r}")
    res["read_backs"] += read_back(churned, [last[k] for k in churned])
    res["launches"] = read_launches()
    res["dispatches"] = {k: v - before[k] for k, v in _dispatches().items()}
    res["race_s"] = time.perf_counter() - t0
    res["churn_rounds"] = rounds[0]
    res["segments_dropped_mid_pass"] = sum(
        p["dropped_mid_pass"] for p in res["passes"])
    m = db.metrics
    res.update(crc_failures=m.crc_failures, segments_deleted=
               m.segments_deleted, scrub_passes=m.scrub_passes)
    if m.crc_failures or wal.quarantined():
        fail(f"scrub race: {m.crc_failures} CRC failures counted")
    db.close()
    res["phase_s"] = time.perf_counter() - t_start
    return res


def profile_reads(db, probe, gkeys) -> dict:
    """Warm read passes: one under torch.profiler (wall time, the device
    time of every kernel and copy, their sum, and the kernels launched, by
    the wrappers' counts), one under cProfile (the host functions that take
    the most time of their own).  Fails if ``multi_exists`` launched a cub
    select or reduce kernel: the lookup resolves on the card in one launch.
    """
    out = {}
    for name, call in (("multi_exists", lambda: db.multi_exists(
            probe, keyspace="kv")),
            ("multi_get", lambda: db.multi_get(gkeys, keyspace="kv"))):
        db.cache = type(db.cache)(db.cfg.cache_bytes)     # no value hits
        reset_launches()
        prof = device_profile(call, "lookup", top=None)
        prof["launches"] = {k: v for k, v in read_launches().items() if v}
        db.cache = type(db.cache)(db.cfg.cache_bytes)
        prof["host_own_ms_by_function"] = host_profile(call)
        out[name] = prof
    cub = [k for k in out["multi_exists"]["device_ms_by_op"]
           if "DeviceSelect" in k or "DeviceReduce" in k]
    if cub:
        fail(f"multi_exists launched cub select or reduce kernels: {cub}")
    return out


# ------------------------------------------------------------------- main

def _kernel_name(mangled: str) -> str:
    """The kernel's name and raw template arguments in a mangled symbol,
    e.g. ``tide_split_kernel<13__nv_bfloat16Li64ELi128E>``."""
    for m in re.finditer(r"(\d+)(?=[A-Za-z_])", mangled):
        end = m.end() + int(m.group(1))
        if mangled[m.end():end].endswith("kernel"):
            args = mangled[end:].split("Ev")[0]
            return mangled[m.end():end] + (f"<{args[1:]}>" if
                                           args.startswith("I") else "")
    return mangled


def say_sweep(rt: dict, head: str) -> None:
    """A routing sweep's lines: each route's median (IQR) by batch size,
    and the size from which the kernel route wins."""
    for what, unit in (("bloom", "queries a touched cell"),
                       ("lookup", "disk-resolved queries")):
        say(f"{head}: {what}, median (IQR) ms host / kernel by batch size "
            f"(queries routed): " + ", ".join(
                f"{b} ({r['queries']}): {r['host']['median_ms']:.4f} "
                f"({r['host']['iqr_ms']:.4f}) / "
                f"{r['kernel']['median_ms']:.4f} "
                f"({r['kernel']['iqr_ms']:.4f})"
                for b, r in sorted(rt[what].items())) +
            f"; kernel wins from {rt[f'{what}_kernel_wins_from']} {unit}")


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
                    help="keys written on the storage paths (default 2^20)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA card: torch.cuda.is_available() is False")
    # fp32 comparisons must not drop to TF32 in their matrix products.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
            if "Function properties for" in line:
                say(f"  {name}: {_kernel_name(line.split()[-1])}")
            elif "registers" in line or "spill" in line:
                say(f"  {name}:   {line.strip()}")

    # The launch floor: a launched kernel that does no work, timed as every
    # kernel is.
    floor_ms = time_ms(lambda: torch.cuda._sleep(0))
    say(f"launch floor [{card}]: {floor_ms} ms")
    kernels = kernel_phase(args.seed)
    kernels["tide_attention"] = tide_phase(args.seed)
    kernels["ssd_scan"] = ssd_phase(args.seed)
    say(f"kernel phase: {json.dumps(kernels)}")

    if args.keys < 1 << 20:
        say(f"storage paths cut to {args.keys} keys (from 2^20)")
    (ROOT / "build").mkdir(exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="tidedb-smoke-", dir=ROOT / "build")
    try:
        t_phase = time.perf_counter()
        path = main_path(args.keys, args.seed, workdir)
        path["phase_s"] = time.perf_counter() - t_phase
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    say(f"main path [{card}]: {json.dumps(path)}")
    say(f"main path [{card}]: put {path['put_ops_s']:.0f} ops/s, "
        f"multi_exists {path['exists_ops_s']:.0f} ops/s, "
        f"multi_get {path['get_ops_s']:.0f} ops/s")
    for name in ("bloom_check_ragged", "optimistic_lookup_resolve"):
        if path["launches"][name] < 1:
            fail(f"the main path never launched {name}")
    say_sweep(path["routing"], f"routing sweep [{card}]")

    workdir = tempfile.mkdtemp(prefix="tidedb-sharded-", dir=ROOT / "build")
    try:
        # Half phase 3's keys: 2 replicas over 4 shards of 64 cells then
        # fill each cell as full as phase 3's 256.
        t_phase = time.perf_counter()
        sharded = sharded_phase(args.keys // 2, args.seed, workdir)
        sharded["phase_s"] = time.perf_counter() - t_phase
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    say(f"sharded server [{card}]: {json.dumps(sharded)}")
    r = sharded["routes"]

    def both(name):
        return " / ".join(
            "[" + ", ".join(f"{x:.0f}" for x in r[route][name]["ops_s"]) + "]"
            for route in ("default", "use_kernel"))

    say(f"sharded server [{card}]: {N_SHARDS} shards x{REPLICATION}, "
        f"server put {sharded['server_put_ops_s']:.0f} ops/s, mixed "
        f"{sharded['mixed_ops_s']:.0f} ops/s (sojourn p50 "
        f"{sharded['sojourn_p50_ms']:.1f} ms, p99 "
        f"{sharded['sojourn_p99_ms']:.1f} ms), flush and close "
        f"{sharded['flush_close_s']:.1f} s; {sharded['gets']} gets and "
        f"{sharded['probes']} probes, {sharded['reads_per_shard']} a "
        f"shard; ops/s default / use_kernel: "
        f"multi_exists {both('multi_exists')}, multi_get "
        f"{both('multi_get')}")

    al = sharded["route_alternation"]
    say(f"sharded server [{card}]: routes alternated {ROUTE_PAIRS} times "
        f"on the warm store, median (IQR) ms host / kernel: " + "; ".join(
            f"{n} {al[n]['host']['median_ms']:.2f} "
            f"({al[n]['host']['iqr_ms']:.2f}) / "
            f"{al[n]['kernel']['median_ms']:.2f} "
            f"({al[n]['kernel']['iqr_ms']:.2f})"
            for n in ("multi_exists", "multi_get")) + "; kernel wins: " +
        ", ".join(f"{n} {al[n]['kernel_wins']}, host wins: {n} "
                  f"{al[n]['host_wins']}" for n in ("multi_exists",
                                                    "multi_get")))
    say_sweep(sharded["routing_shard0"], f"routing sweep, shard 0 [{card}]")

    workdir = tempfile.mkdtemp(prefix="engines-", dir=ROOT / "build")
    try:
        t_phase = time.perf_counter()
        engines = engines_phase(min(args.keys, ENGINE_KEYS), args.seed,
                                workdir)
        engines["phase_s"] = time.perf_counter() - t_phase
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    say(f"engine comparison [{card}]: {json.dumps(engines)}")
    say(f"engine comparison [{card}]: {engines['keys']} keys x 1 KiB; " +
        "; ".join(f"{n} fill (puts and flush) "
                  f"{engines[n]['fill_ops_s']:.0f} ops/s, put "
                  f"{engines[n]['put_ops_s']:.0f} ops/s, write amp "
                  f"{engines[n]['write_amp']:.3f}, get "
                  f"{engines[n]['get_ops_s']:.0f} ops/s, exists "
                  f"{engines[n]['exists_ops_s']:.0f} ops/s"
                  for n in ("tidehunter", "rocksdb(sim)", "blobdb(sim)")))
    for name in ("bloom_check_ragged", "optimistic_lookup_resolve"):
        if engines["launches"][name] < 1:
            fail(f"the engine comparison's TideDB never launched {name}")

    workdir = tempfile.mkdtemp(prefix="scrub-race-", dir=ROOT / "build")
    try:
        race = scrub_race_phase(min(args.keys, SCRUB_KEYS), args.seed,
                                workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    say(f"scrub race [{card}]: {json.dumps(race)}")
    say(f"scrub race [{card}]: {len(race['passes'])} scrub passes over "
        f"{race['keys']} keys x 1 KiB racing {race['churn_rounds']} rounds "
        f"of put_many({race['churn_keys']}) + prune_step: corruptions "
        f"{[p['corruptions'] for p in race['passes']]}, quarantined "
        f"{[p['quarantined'] for p in race['passes']]}, segments dropped "
        f"mid-pass {[p['dropped_mid_pass'] for p in race['passes']]}, "
        f"{race['read_backs']} read-backs equal, B "
        f"{race['launches']['bloom_check_ragged']} and C "
        f"{race['launches']['optimistic_lookup_resolve']} launches, "
        f"{race['race_s']:.1f} s racing, {race['phase_s']:.1f} s in all")
    for name in ("bloom_check_ragged", "optimistic_lookup_resolve"):
        if race["launches"][name] < 1:
            fail(f"the scrub race's read-backs never launched {name}")

    served = serve_phase(args.seed)
    say(f"serving path [{card}]: {json.dumps(served)}")
    say(f"serving path [{card}]: {served['arch']}, {served['requests']} "
        f"requests, prefill {served['prefill_ms_per_request']:.1f} ms a "
        f"request, decode {served['decode_ms_per_step']:.2f} ms a step, "
        f"{served['tokens_per_s']:.1f} tokens/s")
    mamba = mamba_phase(args.seed)
    say(f"mamba2 path [{card}]: {json.dumps(mamba)}")
    say(f"mamba2 path [{card}]: prefill {mamba['batch']} x "
        f"{mamba['prompt_tokens']} tokens {mamba['prefill_ms']:.1f} ms, "
        f"decode {mamba['decode_ms_per_step']:.2f} ms a step, "
        f"{mamba['tokens_per_s']:.1f} tokens/s, one "
        f"{mamba['long_prompt']['tokens']}-token prefill "
        f"{mamba['long_prompt']['prefill_ms']:.1f} ms, peak "
        f"{mamba['peak_bytes']} B")
    griffin = griffin_phase(args.seed)
    say(f"griffin path [{card}]: {json.dumps(griffin)}")
    # The SMOKE config's KV blocks of 8 positions: D's tiles span blocks.
    griffin_smoke = griffin_phase(args.seed, smoke=True)
    say(f"griffin SMOKE path [{card}]: {json.dumps(griffin_smoke)}")
    say(f"griffin path [{card}]: prefill {griffin['batch']} x "
        f"{griffin['prompt_tokens']} tokens {griffin['prefill_ms']:.1f} ms, "
        f"decode {griffin['decode_ms_per_step']:.2f} ms a step, "
        f"{griffin['tokens_per_s']:.1f} tokens/s, first_live "
        f"{griffin['first_live']}, peak {griffin['peak_bytes']} B")
    moe = serve_phase(args.seed, arch="qwen2-moe-a2.7b")
    moe["smoke_on_card"] = smoke_on_card("qwen2-moe-a2.7b", args.seed)
    say(f"qwen2-moe path [{card}]: {json.dumps(moe)}")
    say(f"qwen2-moe path [{card}]: {moe['requests']} requests, prefill "
        f"{moe['prefill_ms_per_request']:.1f} ms a request, decode "
        f"{moe['decode_ms_per_step']:.2f} ms a step, "
        f"{moe['tokens_per_s']:.1f} tokens/s, tide_attention "
        f"{moe['launches']['tide_attention'] // moe['decode_steps']} "
        f"launches a step, peak {moe['peak_bytes']} B")
    if moe["peak_bytes"] >= 80e9:
        fail(f"qwen2-moe peaked at {moe['peak_bytes']} B, not below 80 GB")
    deepseek = deepseek_phase(args.seed)
    say(f"deepseek path [{card}]: {json.dumps(deepseek)}")
    say(f"deepseek path [{card}]: {deepseek['reduced']}, "
        f"{deepseek['params']} parameters, prefill {deepseek['batch']} x "
        f"{deepseek['prompt_tokens']} tokens "
        f"{deepseek['prefill_ms']:.1f} ms, "
        f"decode {deepseek['decode_ms_per_step']:.2f} ms a step (median), "
        f"peak {deepseek['init_peak_bytes']} B at init, "
        f"{deepseek['peak_bytes']} B serving")
    whisper = whisper_phase(args.seed)
    say(f"whisper path [{card}]: {json.dumps(whisper)}")
    say(f"whisper path [{card}]: encoder and prefill {whisper['batch']} x "
        f"{whisper['encoder_frames']} frames "
        f"{whisper['encoder_and_prefill_ms']:.1f} ms, decode "
        f"{whisper['decode_ms_per_step']:.2f} ms a step, tide_attention "
        f"{whisper['launches']['tide_attention'] // whisper['decode_steps']}"
        f" launches a step, peak {whisper['peak_bytes']} B")
    workdir = tempfile.mkdtemp(prefix="train-smoke-", dir=ROOT / "build")
    try:
        train = train_phase(args.seed, workdir)
        # Phase 13 restores the checkpoints phase 12 left in workdir.
        scaleout = scaleout_phase(args.seed, workdir, train, served)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    say(f"training path [{card}]: {json.dumps(train)}")
    saves = ", ".join(f"step {r['step']} {r['s']:.2f} s "
                      f"({r['GB_s']:.2f} GB/s; writes {r['write_s']:.2f} s)"
                      for r in train["saves"])
    prof = train["profile"]
    say(f"training path [{card}]: {train['arch']} {train['batch']} x "
        f"{train['seq']} tokens, {train['ms_per_step']:.1f} ms a step, "
        f"{train['tokens_per_s']:.0f} tokens/s, peak "
        f"{train['peak_bytes']} B, idle {prof['idle_share']:.3f} of the "
        f"profiled step; saves {saves}; restore {train['restore']['s']:.2f} "
        f"s ({train['restore']['GB_s']:.2f} GB/s); WAL "
        f"{train['wal_bytes_written']} B written, "
        f"{train['segments_pruned']} segments "
        f"({train['bytes_pruned']} B) pruned; losses "
        f"{', '.join(f'{x:.4f}' for x in train['losses'])}")
    say(f"scale-out path [{card}]: {json.dumps(scaleout)}")
    sh = scaleout["sharded_step"]
    say(f"scale-out path [{card}]: {scaleout['process_group']['backend']} "
        f"world {scaleout['process_group']['world_size']}, mesh "
        f"{scaleout['process_group']['mesh']}; {sh['arch']} {sh['batch']} x "
        f"{sh['seq']} {sh['mode']}: losses sharded "
        f"{sh['sharded_losses']}, plain {sh['plain_losses']}, leaves "
        f"{'bit-equal' if sh['leaves_bit_equal'] else 'not bit-equal'} "
        f"(max |diff| {sh['max_leaf_abs_diff']} at {sh['max_diff_leaf']}); "
        f"compression hook {sh['hook_ms']} ms ({sh['hook_clock']}), bound "
        f"{sh['hook_bound_ms']:.3f} ms; restore onto placements step "
        f"{scaleout['restore']['step']}, {scaleout['restore']['leaves']} "
        f"leaves equal; pipeline max |err| "
        f"{scaleout['pipeline']['max_abs_err']}; phase "
        f"{scaleout['phase_s']:.1f} s")
    for r in scaleout["roofline"]:
        say(f"roofline [{card}]: {r['step']}: {r['flops']:.4e} FLOP, "
            f"{r['bytes']:.4e} B, t_compute {r['t_compute_ms']:.3f} ms, "
            f"t_memory {r['t_memory_ms']:.3f} ms, bound {r['bound_ms']:.3f} "
            f"ms ({r['bound_by']}), measured {r['measured_ms']:.2f} ms, MFU "
            f"{r['mfu']:.4f}, {r['over_bound']:.2f}x the bound" + (
                f"; op_cost of the plain step (whole-arena gathers) "
                f"{r['plain_d']['bytes']:.4e} B, bound "
                f"{r['plain_d']['bound_ms']:.3f} ms" if "plain_d" in r
                else ""))
    rf = scaleout["dryrun_cell"]["roofline"]
    say(f"dry-run cell: {rf['arch']} x {rf['shape']} x {rf['mesh']} "
        f"({rf['chips']} fake ranks): t_compute {rf['t_compute']:.4f} s, "
        f"t_memory {rf['t_memory']:.4f} s, t_collective "
        f"{rf['t_collective']:.4f} s, bottleneck {rf['bottleneck']}, "
        f"peak on the reference's terms {rf['peak_memory_per_device']:.4e}"
        f" B a device, footprint "
        f"{scaleout['dryrun_cell']['memory']['footprint_bytes']:.4e} B, "
        f"collectives {rf['collective_bytes']:.4e} B, calls run "
        f"replicated {scaleout['dryrun_cell']['replicated_calls']} "
        f"gathering {scaleout['dryrun_cell']['replicated_bytes']} B; "
        f"footprint {scaleout['dryrun_cell']['peak_over_reference']:.4f}x and "
        f"collectives "
        f"{scaleout['dryrun_cell']['collectives_over_reference']:.4f}x the "
        f"reference's ({REF_DRYRUN_PEAK} B, {REF_DRYRUN_COLLECTIVES} B); "
        f"view rule registered by the dry run "
        f"{scaleout['dryrun_cell']['view_rule_registered']}")
    for key in ("dryrun_cell", "dryrun_mamba2", "dryrun_mamba2_multi",
                "dryrun_qwen3_multi", "dryrun_qwen2_moe",
                "dryrun_deepseek_2l", "dryrun_deepseek_multi",
                "dryrun_qwen2_vl_2l", *REF_DRYRUN_SERVING):
        c = scaleout[key]
        ref = REF_DRYRUN_SERVING[key][3] if key in REF_DRYRUN_SERVING \
            else (REF_DRYRUN_PEAK, REF_DRYRUN_COLLECTIVES) \
            if key == "dryrun_cell" else REF_DRYRUN_MULTI.get(c["arch"])
        over = ""
        on_terms = {"dryrun_qwen2_moe": REF_DRYRUN_QWEN2_MOE,
                    "dryrun_deepseek_2l": REF_DRYRUN_DEEPSEEK_2L}
        if key in on_terms:
            over = (f" (on the reference's terms "
                    f"{c['peak_over_reference']:.4f}x the reference's "
                    f"{on_terms[key]} B)")
        elif "peak_over_reference" in c:
            over = (f" (footprint {c['peak_over_reference']:.4f}x and "
                    f"collectives {c['collectives_over_reference']:.4f}x the "
                    f"reference's {ref[0]} B and {ref[1]} B"
                    + (f"; on the reference's terms "
                       f"{c['reference_terms_over_reference']:.4f}x"
                       if "reference_terms_over_reference" in c else "")
                    + ")")
        mem = c["memory"]
        cache = mem.get("cache_bytes")
        say(f"dry-run cell: {c['arch']} x {c['shape']} x {c['mesh']}"
            + (" (2 layers)" if key.endswith("_2l") else "") +
            f": peak on the reference's terms "
            f"{mem['peak_reference_terms']:.10e} B a device, footprint "
            f"{mem['footprint_bytes']:.10e} B"
            + (f" (the cache's shards {cache} B)" if cache else "")
            + (f" (the old and new state {mem['argument_bytes']} + "
               f"{mem['donated_bytes']} B, leaves placed after the step "
               f"{mem['outputs_placed']})" if key in STATE_PLACED_CELLS
               else "")
            + f", collectives {c['roofline']['collective_bytes']:.10e} "
            f"B{over}, calls run replicated {c['replicated_calls']} "
            f"gathering {c['replicated_bytes']} B, view rule registered "
            f"{c['view_rule_registered']}, trace {c['trace_s']} s, "
            f"{c['subprocess_s']:.1f} s; largest at the peak "
            f"{mem['peak_holders'][:3]}")
    m2 = scaleout["dryrun_mamba2_smoke"]
    say(f"dry-run cell: {m2['arch']} SMOKE x {m2['shape']} x {m2['mesh']}: "
        f"{m2['status']}, flip rule registered by the dry run "
        f"{m2['flip_rule_registered']}, calls run replicated "
        f"{m2['replicated_calls']}")
    if any(m.split(".")[0] in ("jax", "repro") for m in sys.modules):
        fail("the port pulled in jax or the JAX package")

    by_path = {"storage": path["launches"],
               "sharded-server": sharded["launches"],
               "engine-comparison": engines["launches"],
               "scrub-race": race["launches"],
               "llama3-8b": served["launches"],
               "mamba2-1.3b": mamba["launches"],
               "recurrentgemma-9b": griffin["launches"],
               "recurrentgemma-9b-smoke": griffin_smoke["launches"],
               "qwen2-moe-a2.7b": moe["launches"],
               "deepseek-v3-671b-1-layer": deepseek["launches"],
               "whisper-large-v3": whisper["launches"],
               "qwen3-0.6b-train": train["launches"],
               "qwen3-0.6b-scaleout": scaleout["sharded_step"]["launches"]}
    # These decode paths split every row (S = 4, 33, 2 and 2 on 132 SMs), so
    # each call of D runs its combine pass too.
    for p in ("llama3-8b", "recurrentgemma-9b", "qwen2-moe-a2.7b",
              "whisper-large-v3"):
        c = by_path[p]
        if c["tide_attention_combine"] != c["tide_attention"]:
            fail(f"{p}: {c['tide_attention']} calls of tide_attention ran "
                 f"{c['tide_attention_combine']} combine passes")
    rows = []
    for name, src in (("bloom_check_ragged", "bloom_check.cu"),
                      ("bloom_check", "bloom_check.cu"),
                      ("optimistic_lookup", "optimistic_lookup.cu"),
                      ("optimistic_lookup_resolve", "optimistic_lookup.cu"),
                      ("tide_attention", "tide_attention.cu"),
                      ("ssd_scan", "ssd_scan.cu")):
        k = kernels[name]
        per_path = {p: c[name] for p, c in by_path.items()
                    if c.get(name) or p in ("qwen3-0.6b-train",
                                            "qwen3-0.6b-scaleout")}
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": k["replaces"],
            "on_main_path": any(per_path.values()),
            "launches": sum(per_path.values()),
            "launches_by_path": per_path,
            "mismatches": k.get("mismatches"),
            "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"], "floor_ms": floor_ms,
            "shape": k["shape"], "card": card})
        if "cold_ms" in k:
            rows[-1]["cold_ms"] = k["cold_ms"]
        if name == "tide_attention":
            rows[-1]["combine_launches"] = sum(
                c["tide_attention_combine"] for c in by_path.values())
            rows[-1]["splits"] = k["splits"]
            for other in ("recurrentgemma", "qwen2_moe", "whisper"):
                rows[-1][other] = {
                    key: k[other][key] for key in (
                        "shape", "splits", "max_abs_err", "ms", "plain_ms",
                        "bound_ms", "bound_by", "library_ms")}
                rows[-1][other]["floor_ms"] = floor_ms
            rows[-1]["any_block"] = k["any_block"]
        if name == "ssd_scan":
            rows[-1]["pass_launches"] = {
                n: sum(c[n] for c in by_path.values()) for n in _SSD_PASSES}
            rows[-1]["warm_ms"] = k["warm_ms"]
            rows[-1]["fp32_bound_ms"] = k["fp32_bound_ms"]
            rows[-1]["long_prompt"] = {
                key: k["timing"]["b=1 l=16384"][key] for key in (
                    "ms", "warm_ms", "plain_ms", "bound_ms",
                    "fp32_bound_ms")}
            rows[-1]["mamba2_long_prefill_ms"] = \
                mamba["long_prompt"]["prefill_ms"]
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
