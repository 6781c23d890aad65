"""The self-observing store: the reserved ``__system`` keyspace, its
stats tables (oracle parity, crash-reopen survival, sharded merge), the
persisted-Bloom fast path (bit-identical to the lazy rebuild), and the
adaptive copier pool (CopyPool.resize + CopierGovernor control law).

The port's mirror of ``tests/test_system_keyspace.py``: ``repro`` → ``repro_torch``,
``device="cpu"`` at each config; no case left out.
"""
import hashlib
import shutil
import tempfile

import numpy as np
import pytest

from repro_torch.core.tidestore import (CopyPool, DbConfig, KeyspaceConfig,
                                  SYSTEM_KEYSPACE, ShardedTideDB, TideDB,
                                  WriteBatch)
from repro_torch.core.tidestore.bloom import BloomFilter
from repro_torch.core.tidestore.system import (SYSTEM_KS_ID, TAG_LARGE_VALUES,
                                         CopierGovernor, decode_row_key,
                                         row_key, scan_rows)
from repro_torch.core.tidestore.wal import WalConfig


def small_cfg(**kw):
    defaults = dict(
        keyspaces=[KeyspaceConfig("default", n_cells=8,
                                  dirty_flush_threshold=64)],
        wal=WalConfig(segment_size=64 * 1024, background=False),
        index_wal=WalConfig(segment_size=1 * 1024 * 1024, background=False),
        background_snapshots=False,
        cache_bytes=0,
    )
    defaults.update(kw)
    return DbConfig(device="cpu", **defaults)


def keys_n(n, tag=""):
    return [hashlib.sha256(f"{tag}{i}".encode()).digest() for i in range(n)]


def sizes_n(n):
    """Deterministic, distinct value sizes (distinct → unique top-N)."""
    return [64 + ((i * 7919) % 4096) for i in range(n)]


@pytest.fixture()
def tmpdir():
    d = tempfile.mkdtemp(prefix="tide-system-")
    yield d
    shutil.rmtree(d, ignore_errors=True)


# ----------------------------------------------------------- reserved name
class TestReservedKeyspace:
    def test_user_keyspace_named_system_rejected(self, tmpdir):
        cfg = small_cfg(keyspaces=[KeyspaceConfig(SYSTEM_KEYSPACE)])
        with pytest.raises(ValueError, match="reserved"):
            TideDB(tmpdir, cfg)

    def test_sharded_rejects_reserved_name_too(self, tmpdir):
        cfg = small_cfg(keyspaces=[KeyspaceConfig("ok"),
                                   KeyspaceConfig(SYSTEM_KEYSPACE)])
        with pytest.raises(ValueError, match="reserved"):
            ShardedTideDB(tmpdir, cfg, n_shards=2)

    def test_system_keyspace_is_read_only_to_users(self, tmpdir):
        with TideDB(tmpdir, small_cfg()) as db:
            k = row_key(TAG_LARGE_VALUES, 0, 0)
            with pytest.raises(ValueError, match="read-only"):
                db.put(k, b"v", keyspace=SYSTEM_KEYSPACE)
            with pytest.raises(ValueError, match="read-only"):
                db.delete(k, keyspace=SYSTEM_KEYSPACE)
            with pytest.raises(ValueError, match="read-only"):
                db.put_many([(k, b"v")], keyspace=SYSTEM_KEYSPACE)
            with pytest.raises(ValueError, match="read-only"):
                db.delete_many([k], keyspace=SYSTEM_KEYSPACE)
            with pytest.raises(ValueError, match="read-only"):
                db.write_batch(
                    WriteBatch().put(k, b"v", keyspace=SYSTEM_KEYSPACE))
            # reads are fine (that's the point of the keyspace)
            db.keyspace(SYSTEM_KEYSPACE).multi_get([k])

    def test_user_keyspace_ids_are_stable(self, tmpdir):
        """__system lives at the FIXED sentinel id: user ks_ids keep their
        positional meaning, and system_stats=False still reserves it."""
        cfg = small_cfg(keyspaces=[KeyspaceConfig("a", n_cells=8),
                                   KeyspaceConfig("b", n_cells=8)],
                        system_stats=False)
        with TideDB(tmpdir, cfg) as db:
            assert db._ks_id("a") == 0
            assert db._ks_id("b") == 1
            assert db._ks_id(SYSTEM_KEYSPACE) == SYSTEM_KS_ID
            assert db.system is None           # observer gated off
            # ... but the keyspace still exists for replay compatibility
            assert db.keyspace(SYSTEM_KEYSPACE) is not None

    def test_system_rows_survive_keyspace_addition(self, tmpdir):
        """The review scenario the sentinel id exists for: persist system
        rows, then reopen with an EXTRA user keyspace.  Under a positional
        id the new keyspace would inherit __system's WAL entries and cell
        pointers; with the sentinel, __system keeps its history and the new
        keyspace starts empty."""
        ks = keys_n(60)
        sizes = sizes_n(60)
        cfg1 = small_cfg(keyspaces=[KeyspaceConfig("a", n_cells=8,
                                                   dirty_flush_threshold=64)])
        with TideDB(tmpdir, cfg1) as db:
            db.put_many([(k, b"x" * s) for k, s in zip(ks, sizes)],
                        keyspace="a")
            db.snapshot_now()                 # fold + flush + control region
        cfg2 = small_cfg(keyspaces=[KeyspaceConfig("a", n_cells=8,
                                                   dirty_flush_threshold=64),
                                    KeyspaceConfig("b", n_cells=8,
                                                   dirty_flush_threshold=64)])
        with TideDB(tmpdir, cfg2) as db2:
            # __system kept its history across the config change
            t = db2.system_tables()
            assert t["keyspace_stats"]["a"]["puts"] == 60
            got = [(r["key"], r["size"]) for r in t["large_values"]["a"]]
            want = sorted(zip(ks, sizes), key=lambda kv: (-kv[1], kv[0]))[:8]
            assert got == want
            # ... and the new keyspace did NOT inherit the system rows
            sys_rows = db2.keyspace(SYSTEM_KEYSPACE).scan_prefix(b"")
            assert sys_rows, "system rows still readable"
            for key, _ in sys_rows:
                assert db2.get(key, keyspace="b") is None
            assert db2.prev(b"\xff" * 16, keyspace="b") is None
            # user data in "a" is untouched
            assert db2.multi_get(ks, keyspace="a") == \
                [b"x" * s for s in sizes]


# ---------------------------------------------------------------- tables
class TestSystemTables:
    def test_large_values_match_independent_oracle(self, tmpdir):
        cfg = small_cfg(system_top_n=8)
        ks = keys_n(300)
        sizes = sizes_n(300)
        with TideDB(tmpdir, cfg) as db:
            db.put_many([(k, b"x" * s) for k, s in zip(ks, sizes)])
            t = db.system_tables()
            got = [(r["key"], r["size"]) for r in t["large_values"]["default"]]
            # independent oracle: top-8 by (size desc, key asc)
            want = sorted(zip(ks, sizes), key=lambda kv: (-kv[1], kv[0]))[:8]
            assert got == want
            # the rows read back through the NORMAL engine API too
            h = db.keyspace(SYSTEM_KEYSPACE)
            rows = h.scan_prefix(bytes([TAG_LARGE_VALUES]))
            assert len(rows) == 8
            assert [decode_row_key(k)[2] for k, _ in rows] == list(range(8))

    def test_keyspace_stats_counts(self, tmpdir):
        ks = keys_n(50)
        with TideDB(tmpdir, small_cfg()) as db:
            db.put_many([(k, b"v" * 32) for k in ks])
            db.delete_many(ks[:10])
            db.multi_get(ks[10:30])
            db.multi_exists(ks)
            db.get(ks[40])
            db.exists(ks[41])
            row = db.system_tables()["keyspace_stats"]["default"]
            assert row["puts"] == 50
            assert row["deletes"] == 10
            assert row["reads"] == 21
            assert row["exists"] == 51
            assert row["app_bytes"] == 50 * (32 + 32)

    def test_deleted_whale_leaves_large_values(self, tmpdir):
        ks = keys_n(20)
        with TideDB(tmpdir, small_cfg(system_top_n=4)) as db:
            db.put_many([(k, b"x" * (100 + i)) for i, k in enumerate(ks)])
            whale = ks[19]                    # largest value
            t = db.system_tables()
            assert t["large_values"]["default"][0]["key"] == whale
            db.delete(whale)
            t = db.system_tables()
            assert all(r["key"] != whale
                       for r in t["large_values"]["default"])

    def test_hot_cells_attribute_write_traffic(self, tmpdir):
        ks = keys_n(256)
        with TideDB(tmpdir, small_cfg(system_sample=1)) as db:
            db.put_many([(k, b"v") for k in ks])
            rows = db.system_tables()["hot_cells"]["default"]
            assert rows, "hot cells observed"
            total = sum(r["writes"] for r in rows)
            assert total > 0
            assert all(r["reads"] == 0 for r in rows)

    def test_stats_survive_crash_reopen(self, tmpdir):
        cfg = small_cfg()
        ks = keys_n(120)
        sizes = sizes_n(120)
        db = TideDB(tmpdir, cfg)
        db.put_many([(k, b"x" * s) for k, s in zip(ks, sizes)])
        db.snapshot_now()                     # fold + flush + control region
        db.close(flush=False)                 # crash: no final flush
        db2 = TideDB(tmpdir, cfg)
        t = db2.system_tables()
        assert t["keyspace_stats"]["default"]["puts"] == 120
        got = [(r["key"], r["size"]) for r in t["large_values"]["default"]]
        want = sorted(zip(ks, sizes), key=lambda kv: (-kv[1], kv[0]))[:8]
        assert got == want
        # ... and keeps ACCUMULATING on top of the reloaded rollup
        db2.put(ks[0], b"fresh")
        assert db2.system_tables()["keyspace_stats"]["default"]["puts"] == 121
        db2.close()

    def test_folded_rows_replay_from_wal_without_snapshot(self, tmpdir):
        """A fold whose rows never flushed still survives: they are plain
        WAL entries, so replay restores them like any user write."""
        cfg = small_cfg()
        db = TideDB(tmpdir, cfg)
        db.put_many([(k, b"v") for k in keys_n(30)])
        assert db.system.fold() > 0           # rows in WAL + Large Table mem
        db.close(flush=False)                 # crash before any snapshot
        db2 = TideDB(tmpdir, cfg)
        assert db2.system_tables()["keyspace_stats"]["default"]["puts"] == 30
        db2.close()

    def test_stale_ranks_deleted_when_table_shrinks(self, tmpdir):
        with TideDB(tmpdir, small_cfg(system_top_n=4)) as db:
            ks = keys_n(10)
            db.put_many([(k, b"x" * (50 + i)) for i, k in enumerate(ks)])
            db.system.fold()
            assert len(scan_rows(db, TAG_LARGE_VALUES)) == 4
            db.delete_many(ks[6:])            # top values vanish
            db.system.fold()
            rows = scan_rows(db, TAG_LARGE_VALUES)
            # ranks re-packed from 0, no stale higher-rank leftovers
            assert [decode_row_key(k)[2] for k, _ in rows] == \
                list(range(len(rows)))
            assert len(rows) <= 4


# ---------------------------------------------------------------- sharded
class TestShardedSystemTables:
    def test_merge_parity_vs_per_shard_oracle(self, tmpdir):
        cfg = small_cfg(keyspaces=[KeyspaceConfig("default", n_cells=32,
                                                  dirty_flush_threshold=64)])
        ks = keys_n(400)
        sizes = sizes_n(400)
        with ShardedTideDB(tmpdir, cfg, n_shards=4) as sdb:
            sdb.put_many([(k, b"x" * s) for k, s in zip(ks, sizes)])
            sdb.multi_get(ks[:100])
            merged = sdb.system_tables()
            # oracle 1: summed counters equal per-shard sums
            per_shard = [sh.system_tables() for sh in sdb.shards]
            assert merged["keyspace_stats"]["default"]["puts"] == sum(
                t["keyspace_stats"]["default"]["puts"] for t in per_shard
                if "default" in t["keyspace_stats"]) == 400
            assert merged["keyspace_stats"]["default"]["reads"] == 100
            # oracle 2: global top-8 by size across all 400 writes
            got = [(r["key"], r["size"])
                   for r in merged["large_values"]["default"]]
            want = sorted(zip(ks, sizes),
                          key=lambda kv: (-kv[1], kv[0]))[:8]
            assert got == want
            # hot cells carry their shard id (cell ids are per-shard)
            for r in merged["hot_cells"].get("default", []):
                assert 0 <= r["shard"] < 4


# ------------------------------------------------------- persisted filters
class TestPersistedBloomFilters:
    def test_wire_roundtrip(self):
        bf = BloomFilter(500, 10)
        for k in keys_n(200, "wire"):
            bf.add(k)
        back = BloomFilter.from_bytes(bf.to_bytes())
        assert back.nbits == bf.nbits and back.k == bf.k
        assert (back.bits == bf.bits).all()
        with pytest.raises(ValueError):
            BloomFilter.from_bytes(bf.to_bytes()[:-1])
        with pytest.raises(ValueError):
            BloomFilter.from_bytes(b"\x00" * 4)

    def test_persisted_filter_loads_on_reopen(self, tmpdir):
        cfg = small_cfg(blob_cache_bytes=0)
        ks = keys_n(100)
        with TideDB(tmpdir, cfg) as db:
            db.put_many([(k, b"v") for k in ks])
            db.snapshot_now(flush_threshold=1)
            assert db.metrics.bloom_filters_persisted > 0
        db2 = TideDB(tmpdir, cfg)
        miss = keys_n(30, "nope")
        assert db2.multi_exists(miss) == [False] * 30
        assert db2.metrics.bloom_filters_loaded > 0
        assert db2.metrics.bloom_lazy_rebuilds == 0   # fast path, no rebuild
        assert db2.multi_exists(ks) == [True] * len(ks)
        db2.close()

    def test_persisted_filter_bit_identical_to_rebuilt(self, tmpdir):
        """Loading the T_FILTER blob must give exactly the bits a lazy
        rebuild over the same index blob would: same key set, same sizing —
        so the two code paths can never answer differently."""
        ks = keys_n(150)
        cfg_p = small_cfg(blob_cache_bytes=0)
        cfg_r = small_cfg(blob_cache_bytes=0, persist_filters=False)

        def seed(d, cfg):
            with TideDB(d, cfg) as db:
                db.put_many([(k, b"v-" + k[:3]) for k in ks])
                db.delete(ks[0])
                db.snapshot_now(flush_threshold=1)

        seed(tmpdir + "-p", cfg_p)
        seed(tmpdir + "-r", cfg_r)
        dbp = TideDB(tmpdir + "-p", cfg_p)
        dbr = TideDB(tmpdir + "-r", cfg_r)
        probe = keys_n(40, "touch")
        dbp.multi_exists(probe)               # loads persisted filters
        dbr.multi_exists(probe)               # rebuilds from the blob
        assert dbp.metrics.bloom_filters_loaded > 0
        assert dbr.metrics.bloom_lazy_rebuilds > 0
        loaded = {c.cell_id: c.bloom for ks_id, c in dbp.table.all_cells()
                  if ks_id == 0 and c.bloom is not None}
        rebuilt = {c.cell_id: c.bloom for ks_id, c in dbr.table.all_cells()
                   if ks_id == 0 and c.bloom is not None}
        assert loaded and set(loaded) == set(rebuilt)
        for cid, bf in loaded.items():
            assert bf.nbits == rebuilt[cid].nbits
            assert bf.k == rebuilt[cid].k
            assert (np.asarray(bf.bits) == np.asarray(rebuilt[cid].bits)).all()
        dbp.close()
        dbr.close()

    def test_corrupt_persisted_filter_falls_back_to_rebuild(self, tmpdir):
        cfg = small_cfg(blob_cache_bytes=0)
        with TideDB(tmpdir, cfg) as db:
            db.put_many([(k, b"v") for k in keys_n(80)])
            db.snapshot_now(flush_threshold=1)
        db2 = TideDB(tmpdir, cfg)
        # poison every filter pointer: the pread returns index bytes that
        # fail from_bytes validation, so the rebuild fallback must fire
        for ks_id, c in db2.table.all_cells():
            if c.filter_pos is not None:
                c.filter_len = 7              # truncated blob
        assert db2.multi_exists(keys_n(20, "zz")) == [False] * 20
        assert db2.metrics.bloom_lazy_rebuilds > 0
        assert db2.multi_exists(keys_n(80)) == [True] * 80
        db2.close()


# ------------------------------------------------------------ copier pool
class TestAdaptiveCopyPool:
    def test_resize_clamps_to_capacity(self):
        pool = CopyPool(2, capacity=4)
        assert pool.threads == 2 and pool.capacity == 4
        assert pool.resize(8) == 4            # capped at capacity
        assert pool.resize(0) == 1            # floored at 1
        pool.close()

    def test_adaptive_pool_sizes_to_cores(self):
        import os
        pool = CopyPool(None)
        assert pool.threads == min(os.cpu_count() or 1, pool.capacity)
        assert pool.capacity == (os.cpu_count() or 1)
        pool.close()

    def test_governor_control_law(self):
        pool = CopyPool(4, capacity=4)
        load = [0.0]
        gov = CopierGovernor(pool, cores=4, load_fn=lambda: load[0],
                             interval_s=0.0)
        # idle host: full core budget
        assert gov.maybe_adjust() is None and pool.threads == 4
        # external load of ~2 cores (beyond the pool's own threads)
        load[0] = pool.threads + 2.0
        assert gov.maybe_adjust() == 2 and pool.threads == 2
        # fully oversubscribed host: never below 1
        load[0] = pool.threads + 100.0
        assert gov.maybe_adjust() == 1 and pool.threads == 1
        # load drains: grows back, capped at cores/capacity
        load[0] = 0.0
        assert gov.maybe_adjust() == 4 and pool.threads == 4
        pool.close()

    def test_governor_rate_limit(self):
        pool = CopyPool(2, capacity=2)
        calls = [0]

        def load_fn():
            calls[0] += 1
            return 0.0

        gov = CopierGovernor(pool, cores=2, load_fn=load_fn, interval_s=3600)
        gov.maybe_adjust()
        gov.maybe_adjust()
        gov.maybe_adjust()
        assert calls[0] == 1                  # one sample per interval
        pool.close()

    def test_db_defaults_to_adaptive_pool_with_governor(self, tmpdir):
        import os
        with TideDB(tmpdir, small_cfg()) as db:
            assert db.cfg.copy_threads is None
            assert db._copy_pool.governor is not None
            assert db._copy_pool.threads <= (os.cpu_count() or 1)
            assert db.stats()["copy_pool_threads"] == db._copy_pool.threads

    def test_snapshot_tick_drives_governor(self, tmpdir):
        db = TideDB(tmpdir, small_cfg())
        pool = db._copy_pool
        samples = [0]

        def load_fn():
            samples[0] += 1
            return 0.0

        pool.governor = CopierGovernor(pool, db.metrics, cores=pool.capacity,
                                       load_fn=load_fn, interval_s=0.0)
        db.put(b"k" * 32, b"v")
        db.snapshot_now()
        assert samples[0] >= 1                # the tick sampled the load
        db.close()

    def test_explicit_copy_threads_still_pins(self, tmpdir):
        cfg = small_cfg(copy_threads=1)
        with TideDB(tmpdir, cfg) as db:
            assert db._copy_pool.governor is None
            assert db._copy_pool.threads == 1
