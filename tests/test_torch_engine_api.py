"""Engine-protocol surface: handles, WriteBatch, options, ShardedTideDB,
and the mixed read/write serve path.

Covers the api_redesign acceptance matrix: handle/WriteBatch round-trips,
cross-keyspace atomic batches surviving close()+reopen recovery, sharded
multi_get parity vs a single-shard oracle (deterministic + hypothesis),
mixed read/write KvBatchServer.step ordering, the legacy-signature
deprecation shims, and the parsed-blob memo cache invalidation.

The port's mirror of ``tests/test_engine_api.py``: the same cases and
assertions over the port's engines and ``KvBatchServer``, every store on
``device="cpu"``, where the batched reads take the kernels' plain versions.
"""
import hashlib
import shutil
import tempfile
import threading

import pytest

from repro_torch.core.tidestore import (
    DbConfig, Engine, KeyspaceConfig, KeyspaceHandle, ReadOptions,
    ShardedTideDB, TideDB, WriteBatch, WriteOptions)
from repro_torch.core.tidestore.wal import WalConfig
from tests.hypothesis_compat import (HAVE_HYPOTHESIS, HealthCheck, given,
                                     settings, st)


def small_cfg(**kw):
    defaults = dict(
        device="cpu",
        keyspaces=[KeyspaceConfig("default", n_cells=16,
                                  dirty_flush_threshold=64)],
        wal=WalConfig(segment_size=16 * 1024, background=False),
        index_wal=WalConfig(segment_size=1 * 1024 * 1024, background=False),
        background_snapshots=False,
        cache_bytes=kw.pop("cache_bytes", 1 * 1024 * 1024),
    )
    defaults.update(kw)
    return DbConfig(**defaults)


def two_ks_cfg(**kw):
    return small_cfg(keyspaces=[
        KeyspaceConfig("objects", n_cells=16, dirty_flush_threshold=64),
        KeyspaceConfig("meta", n_cells=4, dirty_flush_threshold=64),
    ], **kw)


def keys_n(n, tag=""):
    return [hashlib.sha256(f"{tag}{i}".encode()).digest() for i in range(n)]


@pytest.fixture()
def tmpdir():
    d = tempfile.mkdtemp(prefix="tide-api-test-")
    yield d
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture()
def tmpdir2():
    d = tempfile.mkdtemp(prefix="tide-api-test2-")
    yield d
    shutil.rmtree(d, ignore_errors=True)


# ------------------------------------------------------------------ handles
class TestKeyspaceHandle:
    def test_handle_round_trip(self, tmpdir):
        with TideDB(tmpdir, two_ks_cfg()) as db:
            h = db.keyspace("objects")
            assert isinstance(h, KeyspaceHandle)
            ks = keys_n(50)
            for i, k in enumerate(ks):
                h.put(k, b"v%d" % i)
            assert h.get(ks[7]) == b"v7"
            assert h.exists(ks[7]) and not h.exists(keys_n(1, "no")[0])
            assert h.multi_get(ks) == [b"v%d" % i for i in range(50)]
            assert h.multi_exists(ks[:5]) == [True] * 5
            h.delete(ks[0])
            assert h.get(ks[0]) is None
            srt = sorted(ks[1:])
            assert h.prev(srt[3]) == (srt[2], h.get(srt[2]))

    def test_handles_are_isolated_per_keyspace(self, tmpdir):
        with TideDB(tmpdir, two_ks_cfg()) as db:
            obj, meta = db.keyspace("objects"), db.keyspace("meta")
            k = keys_n(1)[0]
            obj.put(k, b"obj")
            meta.put(k, b"meta")
            assert obj.get(k) == b"obj" and meta.get(k) == b"meta"

    def test_unknown_keyspace_rejected_eagerly(self, tmpdir):
        with TideDB(tmpdir, two_ks_cfg()) as db:
            with pytest.raises(KeyError):
                db.keyspace("nope")

    def test_scan_prefix_covers_wide_keys_with_ff_suffix(self, tmpdir):
        """The probe pads out to the keyspace's key width: with a fixed
        64-byte pad, a 96-byte key whose suffix starts with 0xff bytes
        compares ABOVE the probe and the walk silently misses it."""
        cfg = small_cfg(keyspaces=[KeyspaceConfig(
            "wide", key_len=96, n_cells=4, dirty_flush_threshold=64)])
        with TideDB(tmpdir, cfg) as db:
            assert db.key_len("wide") == 96
            h = db.keyspace("wide")
            worst = b"pp" + b"\xff" * 94      # all-0xff suffix, full width
            low = b"pp" + b"\x00" * 94
            mid = b"pp" + b"\xff" * 40 + b"\x00" * 54
            other = b"qq" + b"\x7f" * 94
            for k in (worst, low, mid, other):
                h.put(k, b"v:" + k[:4])
            got = h.scan_prefix(b"pp")
            assert [k for k, _ in got] == [low, mid, worst]
        shutil.rmtree(tmpdir)
        with ShardedTideDB(tmpdir, cfg, n_shards=2) as sdb:
            assert sdb.key_len("wide") == 96
            h = sdb.keyspace("wide")
            for k in (worst, low, mid, other):
                h.put(k, b"v:" + k[:4])
            assert [k for k, _ in h.scan_prefix(b"pp")] == [low, mid, worst]

    def test_engines_satisfy_protocol(self, tmpdir, tmpdir2):
        with TideDB(tmpdir, small_cfg()) as db:
            assert isinstance(db, Engine)
        with ShardedTideDB(tmpdir2, small_cfg(), n_shards=2) as sdb:
            assert isinstance(sdb, Engine)


# ------------------------------------------------------------------ batches
class TestWriteBatch:
    def test_write_batch_chains_and_defaults(self):
        wb = WriteBatch(default_keyspace="meta")
        wb.put(b"a" * 32, b"1").delete(b"b" * 32).put(b"c" * 32, b"2",
                                                      keyspace="objects")
        assert len(wb) == 3
        assert wb.ops[0] == ("put", "meta", b"a" * 32, b"1")
        assert wb.ops[1] == ("del", "meta", b"b" * 32)
        assert wb.ops[2][1] == "objects"
        wb.clear()
        assert not wb

    def test_per_handle_batch(self, tmpdir):
        with TideDB(tmpdir, two_ks_cfg()) as db:
            h = db.keyspace("meta")
            ks = keys_n(10)
            wb = h.batch()
            for i, k in enumerate(ks):
                wb.put(k, b"m%d" % i)
            positions = h.write_batch(wb)
            assert len(positions) == 10 and all(isinstance(p, int)
                                                for p in positions)
            assert h.multi_get(ks) == [b"m%d" % i for i in range(10)]
            # the other keyspace saw nothing
            assert db.keyspace("objects").multi_exists(ks) == [False] * 10

    def test_cross_keyspace_batch_survives_reopen(self, tmpdir):
        cfg = two_ks_cfg()
        ks = keys_n(6)
        with TideDB(tmpdir, cfg) as db:
            wb = WriteBatch()
            for i, k in enumerate(ks):
                wb.put(k, b"o%d" % i, keyspace="objects")
                wb.put(k, b"m%d" % i, keyspace="meta")
            wb.delete(ks[0], keyspace="objects")
            db.write_batch(wb)
        # close() + reopen: recovery replays the one atomic batch record
        with TideDB(tmpdir, cfg) as db:
            obj, meta = db.keyspace("objects"), db.keyspace("meta")
            assert obj.get(ks[0]) is None          # delete ordered after put
            assert [obj.get(k) for k in ks[1:]] == \
                [b"o%d" % i for i in range(1, 6)]
            assert [meta.get(k) for k in ks] == [b"m%d" % i for i in range(6)]

    def test_crashed_batch_all_or_nothing(self, tmpdir):
        """Abandon the db without close: the batch is one WAL record, so
        recovery admits all of it (page cache) — never a prefix."""
        cfg = two_ks_cfg()
        ks = keys_n(8)
        db = TideDB(tmpdir, cfg)
        wb = WriteBatch(default_keyspace="objects")
        for i, k in enumerate(ks):
            wb.put(k, b"x%d" % i)
        db.write_batch(wb)
        db2 = TideDB(tmpdir, cfg)               # no close() on db
        vis = [db2.get(k, keyspace="objects") for k in ks]
        assert vis == [b"x%d" % i for i in range(8)] or \
            all(v is None for v in vis)
        db2.close()
        db.close(flush=False)

    def test_legacy_tuple_ops_shim(self, tmpdir):
        with TideDB(tmpdir, small_cfg()) as db:
            ks = keys_n(4)
            with pytest.deprecated_call():
                db.write_batch([("put", 0, ks[0], b"t0"),
                                ("put", 0, ks[1], b"t1"),
                                ("del", 0, ks[2])])
            assert db.get(ks[0]) == b"t0" and db.get(ks[1]) == b"t1"
            with pytest.raises(ValueError):
                with pytest.deprecated_call():
                    db.write_batch([("frob", 0, ks[0])])


# ------------------------------------------------------------------ options
class TestOptions:
    def test_fill_cache_off(self, tmpdir):
        with TideDB(tmpdir, small_cfg()) as db:
            ks = keys_n(50)
            for i, k in enumerate(ks):
                db.put(k, b"v%d" % i)
            db.snapshot_now(flush_threshold=1)
            db.cache.clear()
            no_fill = ReadOptions(fill_cache=False)
            assert db.get(ks[0], opts=no_fill) == b"v0"
            assert db.multi_get(ks, opts=no_fill) == \
                [b"v%d" % i for i in range(50)]
            assert len(db.cache) == 0
            db.multi_get(ks[:5])
            assert len(db.cache) == 5

    def test_use_kernel_override(self, tmpdir):
        with TideDB(tmpdir, small_cfg(cache_bytes=0)) as db:
            ks = keys_n(300)
            for i, k in enumerate(ks):
                db.put(k, b"k%d" % i)
            db.snapshot_now(flush_threshold=1)
            want = [b"k%d" % i for i in range(300)]
            assert db.multi_get(ks, opts=ReadOptions(use_kernel=False)) == want
            assert db.metrics.batched_kernel_lookups == 0
            assert db.multi_get(ks, opts=ReadOptions(use_kernel=True)) == want
            assert db.metrics.batched_kernel_lookups > 0

    def test_min_live_pin_floor(self, tmpdir):
        with TideDB(tmpdir, small_cfg()) as db:
            ks = keys_n(10)
            for k in ks[:5]:
                db.put(k, b"old")
            pin = db.value_wal.tail          # everything so far below pin
            for k in ks[5:]:
                db.put(k, b"new")
            db.multi_get(ks)                 # values now sit in the cache
            pinned = ReadOptions(min_live_pin=pin, fill_cache=False)
            # pinned reads bypass the cache: cached pre-pin values stay out
            assert db.multi_get(ks, opts=pinned) == [None] * 5 + [b"new"] * 5
            assert db.multi_exists(ks, opts=pinned) == [False] * 5 + [True] * 5
            assert db.get(ks[0], opts=pinned) is None
            assert not db.exists(ks[0], opts=pinned)
            assert db.min_live() <= pin
            # unpinned reads still see everything
            assert db.multi_get(ks) == [b"old"] * 5 + [b"new"] * 5

    def test_write_options_epoch_and_sync(self, tmpdir):
        with TideDB(tmpdir, small_cfg()) as db:
            k = keys_n(1)[0]
            db.put(k, b"e7", opts=WriteOptions(epoch=7, durability="sync"))
            with db.value_wal._dirty_lock:
                assert not db.value_wal._dirty_segments   # fsynced already
            epochs = db.value_wal.segment_epochs()
            assert any(rng[1] >= 7 for rng in epochs.values())
        with pytest.raises(ValueError):
            WriteOptions(durability="eventually")

    def test_legacy_epoch_kwarg_still_works(self, tmpdir):
        with TideDB(tmpdir, small_cfg()) as db:
            k = keys_n(1)[0]
            db.put(k, b"v", epoch=3)
            epochs = db.value_wal.segment_epochs()
            assert any(rng[1] >= 3 for rng in epochs.values())
            # kwarg folds into explicit opts whose epoch is defaulted...
            db.put(k, b"v2", epoch=5, opts=WriteOptions(durability="sync"))
            epochs = db.value_wal.segment_epochs()
            assert any(rng[1] >= 5 for rng in epochs.values())
            # ...but two conflicting spellings must not silently pick one
            with pytest.raises(ValueError):
                db.put(k, b"v3", epoch=5, opts=WriteOptions(epoch=6))


# ------------------------------------------------------------------ sharded
class TestShardedTideDB:
    def test_parity_with_single_shard_oracle(self, tmpdir, tmpdir2):
        """Deterministic oracle check over a mixed workload."""
        with TideDB(tmpdir, small_cfg()) as oracle, \
                ShardedTideDB(tmpdir2, small_cfg(), n_shards=3) as sdb:
            present, missing = keys_n(200, "p"), keys_n(50, "m")
            for i, k in enumerate(present):
                oracle.put(k, b"v%06d" % i)
                sdb.put(k, b"v%06d" % i)
            for k in present[10:20]:
                oracle.delete(k)
                sdb.delete(k)
            oracle.snapshot_now(flush_threshold=1)
            sdb.snapshot_now(flush_threshold=1)
            probes = present + missing + present[:30]    # dups included
            assert sdb.multi_get(probes) == oracle.multi_get(probes)
            assert sdb.multi_exists(probes) == oracle.multi_exists(probes)
            for k in probes[:20]:
                assert sdb.get(k) == oracle.get(k)
            srt = sorted(set(present) - set(present[10:20]))
            assert sdb.prev(srt[17]) == oracle.prev(srt[17])
            assert sdb.prev(srt[0]) is None and oracle.prev(srt[0]) is None

    @pytest.mark.skipif(not HAVE_HYPOTHESIS, reason="hypothesis not installed")
    @settings(max_examples=15, deadline=None,
              suppress_health_check=[HealthCheck.too_slow])
    @given(st.lists(st.tuples(st.sampled_from(["put", "del"]),
                              st.integers(0, 39), st.binary(max_size=8)),
                    max_size=60),
           st.lists(st.integers(0, 39), max_size=30))
    def test_parity_under_hypothesis(self, ops, probe_ids):
        universe = keys_n(40, "h")
        d1 = tempfile.mkdtemp(prefix="tide-hyp1-")
        d2 = tempfile.mkdtemp(prefix="tide-hyp2-")
        try:
            with TideDB(d1, small_cfg()) as oracle, \
                    ShardedTideDB(d2, small_cfg(), n_shards=3) as sdb:
                for op, ki, val in ops:
                    if op == "put":
                        oracle.put(universe[ki], val)
                        sdb.put(universe[ki], val)
                    else:
                        oracle.delete(universe[ki])
                        sdb.delete(universe[ki])
                probes = [universe[i] for i in probe_ids] + universe[:5]
                assert sdb.multi_get(probes) == oracle.multi_get(probes)
                assert sdb.multi_exists(probes) == oracle.multi_exists(probes)
        finally:
            shutil.rmtree(d1, ignore_errors=True)
            shutil.rmtree(d2, ignore_errors=True)

    def test_multi_exists_parity_mixed_put_delete_stream(self, tmpdir,
                                                         tmpdir2):
        """Sharded existence answers equal the single-store oracle's under
        an interleaved batched put/delete stream — before and after flush,
        with dups and never-written keys in the probe, on both kernel
        routings (the fused probe coalesces per shard either way)."""
        universe = keys_n(240, "mx")
        with TideDB(tmpdir, small_cfg()) as oracle, \
                ShardedTideDB(tmpdir2, small_cfg(), n_shards=3) as sdb:
            for db in (oracle, sdb):
                db.put_many([(k, b"a%d" % i)
                             for i, k in enumerate(universe[:180])])
                db.delete_many(universe[60:120])
                db.put_many([(k, b"b") for k in universe[90:100]])
                db.delete_many(universe[:10])
            probes = universe + universe[50:130]          # dups included
            for opts in (None, ReadOptions(use_kernel=True),
                         ReadOptions(use_kernel=False)):
                assert sdb.multi_exists(probes, opts=opts) == \
                    oracle.multi_exists(probes, opts=opts)
            oracle.snapshot_now(flush_threshold=1)
            sdb.snapshot_now(flush_threshold=1)
            want = oracle.multi_exists(probes)
            assert sdb.multi_exists(probes) == want
            assert [sdb.exists(k) for k in probes] == want
            assert sdb.stats()["fused_bloom_probes"] > 0

    def test_cross_shard_write_batch_and_reopen(self, tmpdir):
        cfg = small_cfg()
        ks = keys_n(40, "wb")
        with ShardedTideDB(tmpdir, cfg, n_shards=4) as sdb:
            wb = WriteBatch()
            for i, k in enumerate(ks):
                wb.put(k, b"b%d" % i)
            positions = sdb.write_batch(wb)
            assert len(positions) == 40
            assert {sdb.shard_of(k) for k in ks} == set(range(4))
        with ShardedTideDB(tmpdir, cfg, n_shards=4) as sdb:
            assert sdb.multi_get(ks) == [b"b%d" % i for i in range(40)]

    def test_stats_merge_and_handles(self, tmpdir):
        with ShardedTideDB(tmpdir, small_cfg(), n_shards=2) as sdb:
            h = sdb.keyspace("default")
            ks = keys_n(30, "s")
            for i, k in enumerate(ks):
                h.put(k, b"x%d" % i)
            assert h.multi_get(ks) == [b"x%d" % i for i in range(30)]
            st_ = sdb.stats()
            assert st_["n_shards"] == 2
            assert st_["wal_appends"] >= 30


# --------------------------------------------------------------- serve path
class TestKvBatchServerMixed:
    def test_step_orders_reads_around_writes(self, tmpdir):
        """Within one drained batch, a read observes exactly the writes
        submitted before it — identical to scalar execution."""
        from repro_torch.serving.engine import KvBatchServer
        with TideDB(tmpdir, small_cfg()) as db:
            k = keys_n(1, "ord")[0]
            db.put(k, b"v0")
            srv = KvBatchServer(db, max_batch=64)
            r0 = srv.submit_get(k)
            w1 = srv.submit_put(k, b"v1")
            r1 = srv.submit_get(k)
            w2 = srv.submit_delete(k)
            r2 = srv.submit_get(k)
            e2 = srv.submit_exists(k)
            w3 = srv.submit_put(k, b"v3")
            r3 = srv.submit_get(k)
            assert srv.step() == 8              # one step drains everything
            assert (r0.value, r1.value, r2.value, r3.value) == \
                (b"v0", b"v1", None, b"v3")
            assert e2.found is False
            assert all(w.done and w.pos is not None for w in (w1, w2, w3))
            assert db.get(k) == b"v3"

    def test_exists_stage_matches_scalar_execution(self, tmpdir):
        """Exists stages served through the fused multi_exists path return
        exactly what scalar program-order execution would: checks around
        same-key puts/deletes in one drained batch observe every earlier
        write and no later one."""
        from repro_torch.serving.engine import KvBatchServer
        with TideDB(tmpdir, small_cfg()) as db:
            ks = keys_n(120, "ex")
            db.put_many([(k, b"seed") for k in ks[:60]])
            db.snapshot_now(flush_threshold=1)   # blooms live for the stage
            srv = KvBatchServer(db, max_batch=512)
            model: dict = {k: True for k in ks[:60]}
            checks = []
            for i, k in enumerate(ks):
                if i % 3 == 0:
                    srv.submit_put(k, b"w%d" % i)
                    model[k] = True
                elif i % 3 == 1 and i % 2 == 1:
                    srv.submit_delete(k)
                    model[k] = False
                checks.append((srv.submit_exists(k), model.get(k, False)))
                if i % 4 == 2:       # re-check after more traffic lands
                    srv.submit_put(ks[(i * 7) % 120], b"later")
                    model[ks[(i * 7) % 120]] = True
            srv.run_until_drained()
            for req, want in checks:
                assert req.done and req.found == want
            assert srv.stats()["exists_served"] == len(checks)

    def test_keyspace_spelling_does_not_break_ordering(self, tmpdir):
        """A write addressed by keyspace *name* still orders against a
        read addressed by keyspace *id* (the scheduler normalizes both)."""
        from repro_torch.serving.engine import KvBatchServer
        with TideDB(tmpdir, small_cfg()) as db:
            k = keys_n(1, "norm")[0]
            db.put(k, b"old")
            srv = KvBatchServer(db, max_batch=16)
            srv.submit_get(keys_n(1, "other")[0], keyspace=0)
            srv.submit_put(k, b"new", keyspace="default")
            r = srv.submit_get(k, keyspace=0)
            srv.step()
            assert r.value == b"new"

    def test_mixed_stream_matches_scalar_execution(self, tmpdir, tmpdir2):
        """A shuffled get/put/delete/exists stream through the server ==
        the same stream executed scalarly, on a sharded engine."""
        import random
        from repro_torch.serving.engine import KvBatchServer, KvWrite
        rng = random.Random(11)
        universe = keys_n(60, "mix")
        stream = []
        for i in range(500):
            op = rng.choice(["get", "exists", "put", "put", "delete"])
            k = rng.choice(universe)
            stream.append((op, k, b"val%d" % i))
        with TideDB(tmpdir, small_cfg()) as oracle, \
                ShardedTideDB(tmpdir2, small_cfg(), n_shards=2) as sdb:
            want = []
            for op, k, v in stream:
                if op == "get":
                    want.append(oracle.get(k))
                elif op == "exists":
                    want.append(oracle.exists(k))
                elif op == "put":
                    want.append(oracle.put(k, v) is not None)
                else:
                    want.append(oracle.delete(k) is not None)
            srv = KvBatchServer(sdb, max_batch=96)
            reqs = []
            for op, k, v in stream:
                if op == "get":
                    reqs.append(srv.submit_get(k))
                elif op == "exists":
                    reqs.append(srv.submit_exists(k))
                elif op == "put":
                    reqs.append(srv.submit_put(k, v))
                else:
                    reqs.append(srv.submit_delete(k))
            served = srv.run_until_drained()
            assert served == len(stream)
            for r, w, (op, k, v) in zip(reqs, want, stream):
                assert r.done
                if op == "get":
                    assert r.value == w, (op, k)
                elif op == "exists":
                    assert r.found == w
                else:
                    assert isinstance(r, KvWrite) and r.pos is not None
            st_ = srv.stats()
            assert st_["queued"] == 0
            assert st_["writes_served"] == sum(
                1 for op, _, _ in stream if op in ("put", "delete"))
            # final state parity
            assert sdb.multi_get(universe) == oracle.multi_get(universe)

    def test_stats_safe_under_concurrent_submitters(self, tmpdir):
        from repro_torch.serving.engine import KvBatchServer
        with TideDB(tmpdir, small_cfg()) as db:
            srv = KvBatchServer(db, max_batch=32)
            ks = keys_n(64, "c")
            stop = threading.Event()
            errors = []

            def submitter():
                try:
                    i = 0
                    while not stop.is_set():
                        srv.submit_put(ks[i % 64], b"x")
                        i += 1
                except Exception as e:  # pragma: no cover
                    errors.append(e)

            ts = [threading.Thread(target=submitter) for _ in range(3)]
            for t in ts:
                t.start()
            for _ in range(200):
                srv.stats()
                srv.step()
            stop.set()
            for t in ts:
                t.join()
            srv.run_until_drained()
            assert not errors
            assert srv.stats()["queued"] == 0


# ------------------------------------------------------------ blob memo LRU
class TestBlobArrayCache:
    def test_flush_invalidates_old_blob(self, tmpdir):
        with TideDB(tmpdir, small_cfg(cache_bytes=0)) as db:
            ks = keys_n(300, "bc")
            for i, k in enumerate(ks):
                db.put(k, b"a%d" % i)
            db.snapshot_now(flush_threshold=1)
            db.multi_get(ks)                       # populate the memo
            populated = len(db.table.blob_cache)
            assert populated > 0
            db.multi_get(ks)
            assert db.metrics.blob_cache_hits > 0
            old_pos = {c.disk_pos for _, c in db.table.all_cells()
                       if c.has_disk()}
            for i, k in enumerate(ks):             # dirty + reflush all cells
                db.put(k, b"b%d" % i)
            db.snapshot_now(flush_threshold=1)
            # every replaced blob's memo entry was invalidated
            assert all(db.table.blob_cache.get(p) is None for p in old_pos)
            assert db.multi_get(ks) == [b"b%d" % i for i in range(300)]

    def test_byte_budget_evicts(self):
        from repro_torch.core.tidestore.cache import BlobArrayCache
        c = BlobArrayCache(100)
        c.put(1, ("a",), 60)
        c.put(2, ("b",), 60)                       # evicts 1
        assert c.get(1) is None and c.get(2) == ("b",)
        c.put(3, ("c",), 1000)                     # over budget: not cached
        assert c.get(3) is None
        c.invalidate(2)
        assert len(c) == 0
