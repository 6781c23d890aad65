"""The storage kernels' routing by device: on the CPU the thresholds are the
JAX package's, so that the mirrors' counters equal the reference's; on the
card they are the values measured there (``chip_smoke.py`` phases 3 and
8).  Each is read from the engine's device, and routing never changes an
answer: at batch sizes just below and just above each threshold, both
routes answer as scalar reads do.  A multi-shard read that names no route
takes the host route on every device, as in the JAX package."""
import hashlib

import pytest

from repro.core.tidestore import bloom as ref_bloom
from repro.core.tidestore import large_table as ref_large_table
from repro_torch.core.tidestore import (DbConfig, KeyspaceConfig,
                                        ReadOptions, ShardedTideDB, TideDB,
                                        bloom, large_table)
from repro_torch.kernels.bloom_check import ops as bloom_ops

N_KEYS = max(large_table._KERNEL_MIN_QUERIES.values()) + 256


def test_cpu_routing_is_the_references():
    assert large_table.kernel_min_queries("cpu") == \
        ref_large_table._KERNEL_MIN_QUERIES
    assert bloom.kernel_min_batch("cpu") == ref_bloom._KERNEL_MIN_BATCH


def test_cuda_routing_is_read_from_the_device_type():
    for dev in ("cuda", "cuda:0", "cuda:3"):
        assert large_table.kernel_min_queries(dev) == \
            large_table._KERNEL_MIN_QUERIES["cuda"]
        assert bloom.kernel_min_batch(dev) == bloom._KERNEL_MIN_BATCH["cuda"]
    for table in (large_table._KERNEL_MIN_QUERIES, bloom._KERNEL_MIN_BATCH):
        assert set(table) == {"cpu", "cuda"}


def _keys(n, tag):
    return [hashlib.sha256(tag + i.to_bytes(4, "little")).digest()
            for i in range(n)]


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """One cell of ``N_KEYS`` keys on the CPU, flushed and reopened: every
    batched read of it routes its whole batch (one Bloom probe of one cell,
    one whole-blob lookup)."""
    path = str(tmp_path_factory.mktemp("routing"))
    cfg = DbConfig(keyspaces=[KeyspaceConfig("kv", n_cells=1)],
                   device="cpu")
    db = TideDB(path, cfg)
    keys = _keys(N_KEYS, b"routing:")
    db.put_many([(k, k * 4) for k in keys], keyspace="kv")
    db.flush()
    db.close()
    db = TideDB(path, cfg)
    yield db, keys
    db.close()


def _sizes(table):
    return sorted({t + d for t in table.values() for d in (-1, 0, 1)})


@pytest.mark.parametrize("size", _sizes(bloom._KERNEL_MIN_BATCH))
def test_exists_routes_agree_around_the_bloom_threshold(store, size):
    db, keys = store
    batch = keys[:size // 2] + _keys(size - size // 2, b"absent:")
    want = [db.exists(k, keyspace="kv") for k in batch]
    assert want == [True] * (size // 2) + [False] * (size - size // 2)
    got = {}
    for kernel in (False, True):
        db.cache.clear()
        db.table.blob_cache.clear()          # a memoized cell skips Bloom
        before = bloom_ops.ragged_dispatch_count
        got[kernel] = db.multi_exists(batch, keyspace="kv",
                                      opts=ReadOptions(use_kernel=kernel))
        launched = bloom_ops.ragged_dispatch_count - before
        assert launched == int(kernel and size >=
                               bloom.kernel_min_batch("cpu"))
    assert got[False] == got[True] == want


@pytest.mark.parametrize("size", _sizes(large_table._KERNEL_MIN_QUERIES))
def test_get_routes_agree_around_the_lookup_threshold(store, size):
    db, keys = store
    batch = keys[-size:]
    got = {}
    for kernel in (False, True):
        db.cache.clear()
        before = db.stats()["batched_kernel_lookups"]
        got[kernel] = db.multi_get(batch, keyspace="kv",
                                   opts=ReadOptions(use_kernel=kernel))
        routed = db.stats()["batched_kernel_lookups"] - before
        assert routed == (size if kernel and size >=
                          large_table.kernel_min_queries("cpu") else 0)
    assert got[False] == got[True] == [k * 4 for k in batch]


def test_multi_shard_default_route_is_the_host(tmp_path):
    """A multi-shard read that names no route takes the host route: no
    lookup reaches the kernel wrapper, while ``use_kernel=True`` does; the
    answers are equal."""
    cfg = DbConfig(keyspaces=[KeyspaceConfig("kv", n_cells=4)],
                   device="cpu")
    sdb = ShardedTideDB(str(tmp_path), cfg, n_shards=2, replication=2)
    keys = _keys(1024, b"sharded:")
    sdb.put_many([(k, k) for k in keys], keyspace="kv")
    sdb.flush()
    got = {}
    for opts in (None, ReadOptions(use_kernel=True)):
        sdb.clear_caches()
        before = sdb.stats()["batched_kernel_lookups"]
        got[opts is None] = sdb.multi_get(keys, keyspace="kv", opts=opts)
        routed = sdb.stats()["batched_kernel_lookups"] - before
        assert (routed > 0) == (opts is not None)
    assert got[True] == got[False] == keys
    sdb.close()
