"""Whole-slice parity: the port's TideDB against the JAX package's.

The same seeded op traces drive both engines, each in its own directory,
under the deterministic explorer configuration.  After close and reopen
every point and batched answer must be equal, the value-WAL and index-WAL
segment files byte-identical (the control region holds a wall-clock stamp
and is left out), and each engine must reopen the other's directory and
give the same answers.  A second case routes batched reads through the
kernels in both engines (Pallas interpret mode in the reference, the plain
PyTorch versions in the port, which runs on the CPU here).
"""
import dataclasses
import os

import numpy as np
import pytest

import repro.core.tidestore as ref
import repro_torch.core.tidestore as port
from repro.core.tidestore.simulate import KEYSPACES, key_of
from repro.kernels.bloom_check import ops as ref_bloom_ops
from repro_torch.kernels.bloom_check import ops as port_bloom_ops
from repro_torch.kernels.optimistic_lookup import ops as port_lookup_ops

N_KEYS = 12


def _to_port(value):
    """The port's instance of a reference config dataclass, field by field."""
    if isinstance(value, list):
        return [_to_port(v) for v in value]
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        cls = getattr(port, type(value).__name__)
        return cls(**{f.name: _to_port(getattr(value, f.name))
                      for f in dataclasses.fields(value)})
    return value


def port_config(ref_cfg):
    cfg = _to_port(ref_cfg)
    cfg.device = "cpu"
    return cfg


def port_apply(db, op):
    """``simulate.apply_op`` for the port: the same calls with the port's own
    option and batch classes."""
    if op.kind == "put":
        key, value = op.items[0]
        db.put(key, value, keyspace=op.ks, opts=port.WriteOptions(
            epoch=op.epoch, durability="sync" if op.sync else "async"))
    elif op.kind == "delete":
        db.delete(op.items[0], keyspace=op.ks, epoch=op.epoch)
    elif op.kind == "put_many":
        db.put_many(list(op.items), keyspace=op.ks, epoch=op.epoch)
    elif op.kind == "write_batch":
        wb = port.WriteBatch()
        for o in op.batch:
            if o[0] == "put":
                wb.put(o[2], o[3], keyspace=o[1])
            else:
                wb.delete(o[2], keyspace=o[1])
        db.write_batch(wb, epoch=op.epoch)
    elif op.kind == "flush":
        db.flush()
    elif op.kind == "prune_step":
        db.prune_step()
    elif op.kind == "scrub_step":
        db.scrub_step()
    else:
        raise ValueError(op.kind)


def answers(db, keyspaces, keys):
    """Every read the engine offers, for every key, present or absent."""
    out = {}
    for ks in keyspaces:
        out[ks] = (
            [db.get(k, keyspace=ks) for k in keys],
            [db.exists(k, keyspace=ks) for k in keys],
            db.multi_get(keys, keyspace=ks),
            db.multi_exists(keys, keyspace=ks),
        )
    return out


def segments(path):
    return {name: open(os.path.join(path, name), "rb").read()
            for name in sorted(os.listdir(path)) if name.endswith(".seg")}


@pytest.mark.parametrize("seed", range(8))
def test_trace_parity(tmp_path, seed):
    trace = ref.generate_trace(seed, n_ops=40, n_keys=N_KEYS)
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_cfg = ref.explorer_config()
    rdb = ref.TideDB(ref_dir, ref_cfg)
    pdb = port.TideDB(port_dir, port_config(ref_cfg))
    for op in trace:
        ref.apply_op(rdb, None, op)
        port_apply(pdb, op)
    keys = [key_of(i) for i in range(N_KEYS + 3)]     # the last 3 never exist
    live = answers(rdb, KEYSPACES, keys)
    assert answers(pdb, KEYSPACES, keys) == live
    rdb.close()
    pdb.close()

    ref_segs, port_segs = segments(ref_dir), segments(port_dir)
    assert any(n.startswith("value-") for n in ref_segs)
    assert any(n.startswith("index-") for n in ref_segs)
    assert port_segs.keys() == ref_segs.keys()
    for name in ref_segs:
        assert port_segs[name] == ref_segs[name], name

    # Reopen each directory with its own engine, then with the other one.
    for path in (ref_dir, port_dir):
        with ref.TideDB(path, ref.explorer_config()) as db:
            assert answers(db, KEYSPACES, keys) == live
        with port.TideDB(path, port_config(ref.explorer_config())) as db:
            assert answers(db, KEYSPACES, keys) == live


def test_batched_kernel_path_parity(tmp_path):
    """Batches large enough that both engines take the kernel branch: the
    fused Bloom probe (≥ 64 queries per touched cell) and the blob lookup
    (≥ 128 queries), on a uniform 8-cell keyspace read after reopen."""
    rng = np.random.default_rng(42)
    keys = [bytes(k) for k in rng.integers(0, 256, (2560, 32), dtype=np.uint8)]
    present, absent = keys[:2048], keys[2048:]
    items = [(k, b"v%d:" % i + k[:int(rng.integers(0, 32))])
             for i, k in enumerate(present)]
    ref_cfg = dataclasses.replace(
        ref.explorer_config(), batched_kernels=True,
        keyspaces=[ref.KeyspaceConfig("u", n_cells=8)])
    engines = [(ref.TideDB, ref_cfg, str(tmp_path / "ref")),
               (port.TideDB, port_config(ref_cfg), str(tmp_path / "port"))]
    for cls, cfg, path in engines:
        with cls(path, cfg) as db:
            for i in range(0, len(items), 512):
                db.put_many(items[i:i + 512], keyspace="u")
            db.flush()

    probe = present[::4] + absent                  # 512 + 512 keys
    want_exists = [True] * 512 + [False] * 512
    want_get = [v for _, v in items[::4]] + [None] * 512
    results = []
    for cls, cfg, path in engines:
        bloom0 = (ref_bloom_ops.ragged_dispatch_count,
                  port_bloom_ops.ragged_dispatch_count)
        lookup0 = port_lookup_ops.lookup_dispatch_count
        with cls(path, cfg) as db:                 # cells UNLOADED
            got_exists = db.multi_exists(probe, keyspace="u")
            bloom1 = (ref_bloom_ops.ragged_dispatch_count,
                      port_bloom_ops.ragged_dispatch_count)
            got_get = db.multi_get(probe, keyspace="u")
            kernel_lookups = db.stats()["batched_kernel_lookups"]
        is_port = cls is port.TideDB
        assert bloom1[is_port] == bloom0[is_port] + 1   # one for the batch
        assert bloom1[not is_port] == bloom0[not is_port]
        assert kernel_lookups >= 128
        if is_port:
            assert port_lookup_ops.lookup_dispatch_count > lookup0
        assert got_exists == want_exists
        assert got_get == want_get
        results.append((got_exists, got_get))
    assert results[0] == results[1]


@pytest.mark.parametrize("use_kernel", [False, True])
def test_bloom_filters_and_fused_probe_parity(use_kernel):
    """The port's filters are the reference's bit for bit (so the T_FILTER
    wire form is the same), and the fused probe gives the same answers
    under both routings — the kernel branch engages for the 400-key cell."""
    from repro.core.tidestore import bloom as ref_bloom
    from repro_torch.core.tidestore import bloom as port_bloom
    rng = np.random.default_rng(7)
    spec = [(1, 0), (6, 6), (500, 400), (64, 64), (100, 90)]
    ref_cells, port_cells, queries, groups = [], [], [], []
    for expected, n_add in spec:
        added = [bytes(k) for k in rng.integers(0, 256, (n_add, 32),
                                                dtype=np.uint8)]
        rf = ref_bloom.BloomFilter(expected)
        pf = port_bloom.BloomFilter(expected)
        rf.add_many(added)
        pf.add_many(added)
        assert pf.to_bytes() == rf.to_bytes()
        assert port_bloom.BloomFilter.from_bytes(rf.to_bytes()).to_bytes() \
            == rf.to_bytes()
        ref_cells.append(rf)
        port_cells.append(pf)
        miss = [bytes(k) for k in rng.integers(0, 256, (70, 32),
                                               dtype=np.uint8)]
        groups.append(np.arange(len(queries), len(queries) + n_add + 70))
        queries += added + miss
    h1, h2 = port_bloom.key_hashes_many(queries)
    before = port_bloom_ops.ragged_dispatch_count
    got = port_bloom.probe_cells(port_cells, h1, h2, groups,
                                 use_kernel=use_kernel, device="cpu")
    assert port_bloom_ops.ragged_dispatch_count == before + int(use_kernel)
    want = ref_bloom.probe_cells(ref_cells, h1, h2, groups,
                                 use_kernel=use_kernel)
    np.testing.assert_array_equal(got, want)
    for cell, g in zip(port_cells, groups):
        np.testing.assert_array_equal(
            got[g], [cell.might_contain(queries[i]) for i in g])


def test_multi_exists_is_one_launch_per_store(tmp_path):
    """However many cells a batch touches, the port's multi_exists makes one
    fused probe dispatch; with the kernels off it makes none and agrees."""
    cfg = port_config(dataclasses.replace(
        ref.explorer_config(), batched_kernels=True, blob_cache_bytes=0,
        keyspaces=[ref.KeyspaceConfig("u", n_cells=8)]))
    rng = np.random.default_rng(3)
    keys = [bytes(k) for k in rng.integers(0, 256, (1024, 32), dtype=np.uint8)]
    with port.TideDB(str(tmp_path / "db"), cfg) as db:
        db.put_many([(k, b"v" * 32) for k in keys[:512]], keyspace="u")
        db.snapshot_now(flush_threshold=1)            # cells → UNLOADED
        before = port_bloom_ops.ragged_dispatch_count
        got = db.multi_exists(keys, keyspace="u")
        assert port_bloom_ops.ragged_dispatch_count == before + 1
        assert got == [True] * 512 + [False] * 512
        off = port.ReadOptions(use_kernel=False)
        before = port_bloom_ops.ragged_dispatch_count
        assert db.multi_exists(keys, keyspace="u", opts=off) == got
        assert port_bloom_ops.ragged_dispatch_count == before
