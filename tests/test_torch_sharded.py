"""Sharded, replicated parity: the port's ShardedTideDB against the JAX
package's.

Seeded traces drive both engines, each in its own directory, under the
deterministic explorer configuration, at (shards, replication) = (3, 1),
(4, 2) and (3, 3).  Every get, exists, multi_get and multi_exists answer
must be equal, with the kernels off and on (Pallas interpret mode in the
reference, the plain PyTorch versions in the port, which runs on the CPU
here); every shard's value-WAL and index-WAL segments byte-identical (the
control region holds a wall-clock stamp and is left out); and each engine
must reopen the other's sharded directory and give the same answers.  The
replicated repair trace (a planted value corruption, scrub, repair, a
degraded shard and its resync) must leave equal ``TAG_REPAIR`` tables that
either engine reads from the other's directory.
"""
import dataclasses
import os
import sys
import threading

import numpy as np
import pytest

import repro.core.tidestore as ref
import repro.core.tidestore.simulate as ref_sim
import repro_torch.core.tidestore as port
import repro_torch.core.tidestore.simulate as port_sim
from repro.core.tidestore.simulate import KEYSPACES, key_of
from repro.kernels.bloom_check import ops as ref_bloom_ops
from repro_torch.kernels import build
from repro_torch.kernels.bloom_check import ops as port_bloom_ops
from repro_torch.kernels.optimistic_lookup import ops as port_lookup_ops
from test_torch_tidestore import port_apply, port_config, segments

LAYOUTS = [(3, 1), (4, 2), (3, 3)]
N_KEYS = 12


def answers(db, mod, keyspaces, keys, use_kernel):
    """Every read the engine offers, for every key, on one route."""
    opts = mod.ReadOptions(use_kernel=use_kernel)
    return {ks: ([db.get(k, keyspace=ks, opts=opts) for k in keys],
                 [db.exists(k, keyspace=ks, opts=opts) for k in keys],
                 db.multi_get(keys, keyspace=ks, opts=opts),
                 db.multi_exists(keys, keyspace=ks, opts=opts))
            for ks in keyspaces}


def shard_segments(path, n_shards):
    """{shard directory: its segment files}, every shard present."""
    names = sorted(n for n in os.listdir(path) if n.startswith("shard-"))
    assert names == [f"shard-{i:02d}" for i in range(n_shards)]
    return {n: segments(os.path.join(path, n)) for n in names}


def assert_same_segments(ref_dir, port_dir, n_shards):
    want = shard_segments(ref_dir, n_shards)
    got = shard_segments(port_dir, n_shards)
    for name, segs in want.items():
        assert any(s.startswith("value-") for s in segs), name
        assert any(s.startswith("index-") for s in segs), name
        assert got[name].keys() == segs.keys(), name
        for seg in segs:
            assert got[name][seg] == segs[seg], (name, seg)


def engines(tmp_path, ref_cfg, n_shards, replication):
    """(package, open(path)) for the reference and the port, and their
    directories."""
    def opener(mod, cfg):
        return lambda path: mod.ShardedTideDB(
            path, cfg, n_shards=n_shards, replication=replication)
    return ([(ref, opener(ref, ref_cfg)),
             (port, opener(port, port_config(ref_cfg)))],
            [str(tmp_path / "ref"), str(tmp_path / "port")])


@pytest.mark.parametrize("n_shards,replication", LAYOUTS)
@pytest.mark.parametrize("seed", range(2))
def test_sharded_trace_parity(tmp_path, n_shards, replication, seed):
    trace = ref.generate_trace(seed, n_ops=40, n_keys=N_KEYS)
    pairs, (ref_dir, port_dir) = engines(
        tmp_path, ref.explorer_config(), n_shards, replication)
    (rmod, ropen), (pmod, popen) = pairs
    rdb, pdb = ropen(ref_dir), popen(port_dir)
    for op in trace:
        ref.apply_op(rdb, None, op)
        port_apply(pdb, op)
    keys = [key_of(i) for i in range(N_KEYS + 3)]     # the last 3 never exist
    live = {}
    for use_kernel in (False, True):
        live[use_kernel] = answers(rdb, rmod, KEYSPACES, keys, use_kernel)
        assert answers(pdb, pmod, KEYSPACES, keys, use_kernel) == \
            live[use_kernel]
    assert live[False] == live[True]
    rdb.close()
    pdb.close()
    assert_same_segments(ref_dir, port_dir, n_shards)

    # Reopen each directory with its own engine, then with the other one.
    for path in (ref_dir, port_dir):
        for mod, open_ in pairs:
            with open_(path) as db:
                assert answers(db, mod, KEYSPACES, keys, False) == live[False]


@pytest.mark.parametrize("n_shards,replication", LAYOUTS)
def test_sharded_kernel_route_parity(tmp_path, n_shards, replication):
    """Batches large enough that each touched shard takes both kernel
    branches under ``use_kernel=True``: the fused Bloom probe (≥ 64 queries
    per touched cell) and the blob lookup (≥ 128 queries), on a uniform
    keyspace read after reopen.  Each route starts from a fresh reopen,
    with its cells UNLOADED and nothing memoized or cached."""
    rng = np.random.default_rng(100 * n_shards + replication)
    keys = [bytes(k) for k in rng.integers(0, 256, (6144, 32), dtype=np.uint8)]
    present, absent = keys[:4096], keys[4096:]
    items = [(k, b"v%d:" % i + k[:int(rng.integers(0, 32))])
             for i, k in enumerate(present)]
    ref_cfg = dataclasses.replace(
        ref.explorer_config(), keyspaces=[ref.KeyspaceConfig("u", n_cells=32)])
    pairs, dirs = engines(tmp_path, ref_cfg, n_shards, replication)
    for (_, open_), path in zip(pairs, dirs):
        with open_(path) as db:
            for i in range(0, len(items), 512):
                db.put_many(items[i:i + 512], keyspace="u")
            db.flush()
    assert_same_segments(*dirs, n_shards)

    probe = present[::2] + absent                  # 2048 + 2048 keys
    gets = present[1::4] + absent[:256]
    want_exists = [True] * 2048 + [False] * 2048
    want_get = [v for _, v in items[1::4]] + [None] * 256
    sample = probe[::16]
    results = {}
    for (mod, open_), path in zip(pairs, dirs):
        is_port = mod is port
        bloom_ops = port_bloom_ops if is_port else ref_bloom_ops
        for use_kernel in (False, True):
            opts = mod.ReadOptions(use_kernel=use_kernel)
            with open_(path) as db:
                touched = len({db.shard_of(k) for k in probe})
                bloom0 = bloom_ops.ragged_dispatch_count
                lookup0 = port_lookup_ops.lookup_dispatch_count
                got_exists = db.multi_exists(probe, keyspace="u", opts=opts)
                launched = (bloom_ops.ragged_dispatch_count - bloom0,
                            port_lookup_ops.lookup_dispatch_count - lookup0)
                got_get = db.multi_get(gets, keyspace="u", opts=opts)
                scalar = ([db.get(k, keyspace="u", opts=opts) for k in sample],
                          [db.exists(k, keyspace="u", opts=opts)
                           for k in sample])
            assert got_exists == want_exists
            assert got_get == want_get
            assert scalar == ([dict(items).get(k) for k in sample],
                              want_exists[::16])
            # One fused probe per touched shard, and in the port one lookup
            # dispatch per touched shard, on the kernel route only.
            assert launched[0] == (touched if use_kernel else 0)
            if is_port:
                assert launched[1] == (touched if use_kernel else 0)
            results[is_port, use_kernel] = (got_exists, got_get, scalar)
    assert len(set(map(repr, results.values()))) == 1


def _without_clock(table):
    """A repair table without ``last_repair_at``, the wall clock of the
    engine's own repair pass (and its sum in the rollup)."""
    def strip(row):
        return None if row is None else {
            k: v for k, v in row.items() if k != "last_repair_at"}
    return {"summary": strip(table["summary"]),
            "shards": [strip(r) for r in table["shards"]]}


@pytest.mark.parametrize("n_shards,replication",
                         [(ref_sim.REPAIR_TRACE_SHARDS, 2), (4, 2), (3, 3)])
def test_repair_trace_parity(tmp_path, n_shards, replication):
    """Each package's own repair-trace runner on its own engine (a planted
    value corruption on shard 0, scrub, repair, a forced outage and its
    resync), with ``__system`` on so repairs publish: the same oracle
    report, equal answers, equal repair tables, and each engine reads the
    other's table (the ``TAG_REPAIR`` rows are one wire format).

    The script is written for its own layout of 2 shards, where it must
    report nothing.  At the other layouts its check that shard 0 serves
    every planted key by itself flags one key in both engines alike: a key
    that shard 0 does not hold, or a replica copy that no read and no scrub
    of a sealed segment reached, so nothing quarantined it."""
    trace = ref.generate_repair_trace(3)
    ref_cfg = dataclasses.replace(ref.explorer_config(), system_stats=True)
    pairs, dirs = engines(tmp_path, ref_cfg, n_shards, replication)
    keys = sorted({k for op in trace for _, k in
                   (op.items if op.kind == "reads" else ())})
    reports, tables, live = [], [], []
    for (mod, open_), path, sim in zip(pairs, dirs, (ref_sim, port_sim)):
        with open_(path) as db:
            reports.append(sim._run_repair_trace(db, trace, sim.ShadowModel(),
                                                 None))
            tables.append(mod.read_repair_table(db))
            live.append(answers(db, mod, KEYSPACES, keys, False))
    assert reports[0] == reports[1]
    assert reports[0]["lost_reads"] == 0
    if n_shards == ref_sim.REPAIR_TRACE_SHARDS:
        assert reports[0]["violations"] == []
    assert tables[0]["summary"]["repaired_positions"] >= 1
    assert tables[0]["shards"][0]["quarantined"] == 0
    assert _without_clock(tables[0]) == _without_clock(tables[1])
    assert live[0] == live[1]
    for path, table in zip(dirs, tables):
        for mod, open_ in pairs:
            with open_(path) as db:
                assert mod.read_repair_table(db) == table
                assert answers(db, mod, KEYSPACES, keys, False) == live[0]


def test_default_device_needs_a_card(tmp_path, monkeypatch):
    """Without a card, a sharded store that names no device refuses before
    it creates its directory, as ``TideDB`` does."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.ShardedTideDB(str(tmp_path / "db"), port.DbConfig(), n_shards=2)
    assert not (tmp_path / "db").exists()
    with port.ShardedTideDB(str(tmp_path / "cpu"),
                            port.DbConfig(device="cpu"), n_shards=2,
                            replication=2) as sdb:
        sdb.put(b"k" * 32, b"v")
        assert sdb.get(b"k" * 32) == b"v"


def test_launch_counts_are_exact_across_threads():
    """Shard threads count launches at once: eight threads through the
    wrappers' helper, with the interpreter switching threads as often as it
    can, lose no count."""
    counts = {"a": 0, "b": 0}
    n, per = 8, 20_000
    barrier = threading.Barrier(n)

    def work():
        barrier.wait(timeout=30)
        for _ in range(per):
            build.count_launch(counts, "a", "b")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert counts == {"a": n * per, "b": n * per}
