"""The port's sharded, replicated store and its KV server on a card.

Every test here is marked ``cuda`` and skips without an NVIDIA card.  The
file imports neither JAX nor the JAX package, so it runs on the machine
with the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_sharded_cuda.py

A store of 4 shards with 2 replicas of each key (2^16 keys) serves batched
reads on both routes: the default, which a multi-shard store takes on the
host, and ``use_kernel=True``, where the shard threads launch the Bloom
probe (B) and the lookup's resolve entry (C) at once.  Both routes must
give what was written, and B and C must each launch once a touched shard.
The engine's reads end in a device-to-host copy of the answers, a sync by
design, so ``torch.cuda.set_sync_debug_mode`` cannot wrap them; the lookup
entry alone runs under it in ``test_torch_kernels_cuda.py``.
"""
import hashlib

import numpy as np
import pytest
import torch

from repro_torch.core.tidestore import (DbConfig, KeyspaceConfig,
                                        ReadOptions, ShardedTideDB)
from repro_torch.kernels.bloom_check import kernel as bloom_kernel
from repro_torch.kernels.optimistic_lookup import kernel as lookup_kernel
from repro_torch.serving.kv_server import KvBatchServer

N_KEYS = 1 << 16
PROBES = 32768                 # 8192 a shard over its 64 cells: B engages


def _keys(n, tag):
    return [hashlib.sha256(tag + i.to_bytes(8, "little")).digest()
            for i in range(n)]


def _launches():
    return (bloom_kernel.launches["bloom_check_ragged"],
            lookup_kernel.launches["optimistic_lookup_resolve"])


@pytest.fixture
def store(tmp_path):
    """(open(), written {key: value}, absent keys): a flushed store of
    N_KEYS keys with 64-byte values, closed, so every open starts with its
    cells UNLOADED."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    path = str(tmp_path / "sharded")
    cfg = DbConfig(keyspaces=[KeyspaceConfig("kv", n_cells=256)],
                   device="cuda")

    def open_():
        return ShardedTideDB(path, cfg, n_shards=4, replication=2)

    keys = _keys(N_KEYS, b"present")
    written = {k: k * 2 for k in keys}
    with open_() as sdb:
        for i in range(0, N_KEYS, 4096):
            sdb.put_many([(k, written[k]) for k in keys[i:i + 4096]],
                         keyspace="kv")
        sdb.flush()
    return open_, written, _keys(PROBES // 2, b"absent")


@pytest.mark.cuda
def test_kernel_route_equals_default_and_written(store):
    open_, written, absent = store
    rng = np.random.default_rng(0)
    keys = list(written)
    present = [keys[i] for i in rng.choice(N_KEYS, PROBES // 2,
                                           replace=False)]
    probe = present + absent
    gets = [keys[i] for i in rng.choice(N_KEYS, 8192, replace=False)]
    want_exists = [True] * len(present) + [False] * len(absent)
    want_get = [written[k] for k in gets]
    for opts in (None, ReadOptions(use_kernel=True)):
        with open_() as sdb:           # cells UNLOADED, nothing memoized
            touched = len({sdb.shard_of(k) for k in probe})
            b0, c0 = _launches()
            assert sdb.multi_exists(probe, keyspace="kv",
                                    opts=opts) == want_exists
            b1, c1 = _launches()
            assert sdb.multi_get(gets, keyspace="kv", opts=opts) == want_get
            b2, c2 = _launches()
        kernel = opts is not None
        assert touched == 4
        assert (b1 - b0, c1 - c0) == ((touched, touched) if kernel
                                      else (0, 0))
        # 2048 gets a shard over 64 cells is 32 a cell: under the Bloom
        # probe's 64, so multi_get launches the lookup alone.
        assert (b2 - b1, c2 - c1) == ((0, touched) if kernel else (0, 0))


@pytest.mark.cuda
def test_server_mixed_stream_equals_scalar_execution(store):
    """A seeded mixed stream through ``KvBatchServer`` (get, exists on
    present and absent keys, overwriting put, delete, in waves of the
    server's batch) answers as the same requests run one at a time would,
    and the store ends in the state they leave."""
    open_, written, absent = store
    rng = np.random.default_rng(1)
    keys = list(written)
    state = dict(written)
    with open_() as sdb:
        srv = KvBatchServer(sdb, max_batch=1024)
        for wave in range(8):
            reqs, wants = [], []
            for i in range(1024):
                kind = rng.choice(4, p=[0.5, 0.25, 0.2, 0.05])
                key = keys[int(rng.integers(N_KEYS))]
                if kind == 0:
                    reqs.append(srv.submit_get(key, keyspace="kv"))
                    wants.append(state[key])
                elif kind == 1:
                    if rng.random() < 0.5:
                        key = absent[int(rng.integers(len(absent)))]
                    reqs.append(srv.submit_exists(key, keyspace="kv"))
                    wants.append(state.get(key) is not None)
                elif kind == 2:
                    value = b"w%d:%d:" % (wave, i) + key
                    reqs.append(srv.submit_put(key, value, keyspace="kv"))
                    state[key] = value
                    wants.append(None)
                else:
                    reqs.append(srv.submit_delete(key, keyspace="kv"))
                    state[key] = None
                    wants.append(None)
            assert srv.run_until_drained() == len(reqs)
            for r, want in zip(reqs, wants):
                assert r.done and r.error is None
                if r.op in ("get", "exists"):
                    assert r.result() == want
        sample = keys[::64]
        assert sdb.multi_get(sample, keyspace="kv") == \
            [state[k] for k in sample]
        assert [sdb.get(k, keyspace="kv") for k in sample] == \
            [state[k] for k in sample]
