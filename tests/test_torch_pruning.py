"""Concurrent epoch pruning & relocation on the reserve→copy→commit protocol.

Covers the batched relocation path (one ``append_many`` + one batched CAS
per harvest batch), the PruneController trigger policy, mid-log segment
drops, control-region durability (torn/truncated ``control.bin`` falls back
to the rotated previous snapshot), crash-during-relocation recovery, the
serving loop's prune scheduling, sharded pruning, and the copy-thread clamp.

The port's mirror of ``tests/test_pruning.py``: the same cases and
assertions over the port's ``TideDB``, ``ShardedTideDB`` and
``KvBatchServer``, every store on ``device="cpu"``.  The port's checkpoint
retention (``core/checkpoint.py``) rests on these epoch drops.
"""
import hashlib
import os
import shutil
import tempfile
import threading

import pytest

from hypothesis_compat import HealthCheck, given, settings, st

from repro_torch.core.tidestore import (DbConfig, KeyspaceConfig,
                                        PruneController, PruneOptions,
                                        ShardedTideDB, TideDB)
from repro_torch.core.tidestore.db import clamp_copy_threads
from repro_torch.core.tidestore.snapshot import (CONTROL_FALLBACK,
                                                 CONTROL_FILE,
                                                 read_control_region)
from repro_torch.core.tidestore.util import Metrics
from repro_torch.core.tidestore.wal import WalConfig


def small_cfg(**kw):
    defaults = dict(
        keyspaces=[KeyspaceConfig("default", n_cells=16,
                                  dirty_flush_threshold=64)],
        wal=WalConfig(segment_size=16 * 1024, background=False),
        index_wal=WalConfig(segment_size=1 * 1024 * 1024, background=False),
        background_snapshots=False,
        cache_bytes=kw.pop("cache_bytes", 1 * 1024 * 1024),
        device="cpu",
    )
    defaults.update(kw)
    return DbConfig(**defaults)


def keys_n(n, tag=""):
    return [hashlib.sha256(f"{tag}{i}".encode()).digest() for i in range(n)]


@pytest.fixture()
def tmpdir():
    d = tempfile.mkdtemp(prefix="tide-prune-")
    yield d
    shutil.rmtree(d, ignore_errors=True)


# -------------------------------------------------------- batched dispatch
class TestBatchedDispatch:
    def _spy(self, wal):
        calls = {"append": 0, "append_many": 0}
        orig_a, orig_m = wal.append, wal.append_many

        def spy_a(*a, **kw):
            calls["append"] += 1
            return orig_a(*a, **kw)

        def spy_m(*a, **kw):
            calls["append_many"] += 1
            return orig_m(*a, **kw)

        wal.append, wal.append_many = spy_a, spy_m
        return calls

    def test_wal_relocation_dispatches_append_many_only(self, tmpdir):
        """The tentpole invariant: survivors re-append through the batched
        reserve→copy→commit protocol — zero per-record scalar appends."""
        with TideDB(tmpdir, small_cfg()) as db:
            ks = keys_n(400)
            for k in ks:
                db.put(k, bytes(100))
            for k in ks[:300]:
                db.delete(k)
            calls = self._spy(db.value_wal)
            moved = db.relocator.relocate_wal_based()
            assert moved >= 100
            assert calls["append"] == 0
            assert calls["append_many"] >= 1
            assert db.metrics.relocation_batches >= 1
            assert db.metrics.relocated_entries >= 100

    def test_index_relocation_dispatches_append_many_only(self, tmpdir):
        with TideDB(tmpdir, small_cfg()) as db:
            ks = keys_n(300)
            for i, k in enumerate(ks):
                db.put(k, b"i%06d" % i)
            db.snapshot_now(flush_threshold=1)
            for k in ks[:200]:
                db.delete(k)
            calls = self._spy(db.value_wal)
            db.relocator.relocate_index_based(
                db.value_wal.tracker.last_processed)
            assert calls["append"] == 0
            assert calls["append_many"] >= 1
            for i, k in enumerate(ks[200:], start=200):
                assert db.get(k) == b"i%06d" % i

    def test_relocation_batch_bounds_respected(self, tmpdir):
        """batch_records bounds each append_many; a pass over N survivors
        issues ceil(N / batch_records) batches, not one giant one."""
        cfg = small_cfg(prune=PruneOptions(batch_records=32))
        with TideDB(tmpdir, cfg) as db:
            ks = keys_n(200)
            for k in ks:
                db.put(k, bytes(64))
            moved = db.relocator.relocate_wal_based()
            assert moved == 200
            assert db.metrics.relocation_batches >= 200 // 32


# ------------------------------------------------------- trigger policy
class TestPruneController:
    def test_uncalibrated_triggers_above_min_bytes(self, tmpdir):
        opts = PruneOptions(min_reclaim_bytes=1024)
        with TideDB(tmpdir, small_cfg(prune=opts)) as db:
            pc = db.prune_controller
            assert not pc.should_relocate()          # empty store
            for k in keys_n(50):
                db.put(k, bytes(100))
            assert pc.should_relocate()              # uncalibrated: span >= min
            out = db.prune()
            assert out["triggered"] and out["space_amp"] < float("inf")

    def test_space_amp_trigger_after_calibration(self, tmpdir):
        opts = PruneOptions(min_reclaim_bytes=1024, space_amp_trigger=2.0,
                            reclaim_fraction=1.0)
        with TideDB(tmpdir, small_cfg(prune=opts)) as db:
            ks = keys_n(100)
            for k in ks:
                db.put(k, bytes(100))
            db.prune()                               # calibration pass
            pc = db.prune_controller
            assert not pc.should_relocate()          # all-live: amp ~= 1
            # churn: overwrite everything twice -> span ~3x live
            for _ in range(2):
                for k in ks:
                    db.put(k, bytes(100))
            assert pc.space_amp() > 2.0
            out = pc.maybe_prune()
            assert out["triggered"]
            db.value_wal._mapper_once()
            live = db.value_wal.tail - db.value_wal.first_live_pos
            for k in ks:
                assert db.get(k) == bytes(100)
            assert pc.space_amp() < 2.5
            assert live < 3 * 100 * (100 + 64)       # churn actually reclaimed

    def test_retain_epochs_drops_expired_segments(self, tmpdir):
        opts = PruneOptions(retain_epochs=2, min_reclaim_bytes=1 << 40)
        with TideDB(tmpdir, small_cfg(prune=opts)) as db:
            for ep in range(1, 5):
                for i in range(80):
                    db.put(hashlib.sha256(f"{ep}/{i}".encode()).digest(),
                           bytes(150), epoch=ep)
            assert db.prune_controller.epoch_floor() == 3
            out = db.prune()
            assert out["segments_pruned"] > 0
            assert db.metrics.segments_pruned > 0
            db.value_wal._mapper_once()
            assert db.get(hashlib.sha256(b"1/5").digest()) is None
            assert db.get(hashlib.sha256(b"4/5").digest()) == bytes(150)

    def test_relocation_retires_expired_epochs_instead_of_copying(
            self, tmpdir):
        """When segment epoch ranges straddle the floor, whole-segment
        expiry can't fire — the relocation pass must retire aged records
        via its filter rather than copy them to the tail (where they would
        poison the landing segment's epoch range forever)."""
        opts = PruneOptions(retain_epochs=1, min_reclaim_bytes=1,
                            reclaim_fraction=1.0)
        with TideDB(tmpdir, small_cfg(prune=opts)) as db:
            old = [hashlib.sha256(b"old%d" % i).digest() for i in range(60)]
            new = [hashlib.sha256(b"new%d" % i).digest() for i in range(60)]
            for ko, kn in zip(old, new):     # interleave: ranges span [1, 4]
                db.put(ko, bytes(150), epoch=1)
                db.put(kn, bytes(150), epoch=4)
            assert db.prune_controller.epoch_floor() == 4
            out = db.prune()
            assert out["triggered"]
            assert out["segments_pruned"] == 0   # nothing wholly expired
            assert db.metrics.relocated_entries <= 61   # survivors only
            db.value_wal._mapper_once()
            for ko in old:
                assert db.get(ko) is None        # retired, never copied
            for kn in new:
                assert db.get(kn) == bytes(150)

    def test_step_is_bounded_and_completes_pass(self, tmpdir):
        opts = PruneOptions(min_reclaim_bytes=1024, batch_records=64)
        with TideDB(tmpdir, small_cfg(prune=opts)) as db:
            ks = keys_n(400)
            for k in ks:
                db.put(k, bytes(100))
            for k in ks[:300]:
                db.delete(k)
            first_live0 = db.value_wal.first_live_pos
            total, steps = 0, 0
            while steps < 1000:
                n = db.prune_step()
                steps += 1
                if n == 0 and not db.relocator.scanning:
                    break
                assert n <= 64                       # bounded slice
                total += n
            assert total > 0
            assert db.value_wal.first_live_pos > first_live0
            for k in ks[300:]:
                assert db.get(k) == bytes(100)

    def test_step_skips_when_lock_busy(self, tmpdir):
        with TideDB(tmpdir, small_cfg()) as db:
            for k in keys_n(50):
                db.put(k, bytes(100))
            pc = db.prune_controller
            pc._lock.acquire()
            try:
                assert pc.step(PruneOptions(min_reclaim_bytes=1)) == 0
            finally:
                pc._lock.release()


# ------------------------------------------------------- mid-log drops
class TestMidLogDrops:
    def _fill_epochs(self, db, per_epoch=80, epochs=(1, 2, 3, 4)):
        """Returns {epoch: [(key, wal_pos), ...]}.  Epochs are written in
        order, so low epochs fill the oldest segments; boundary segments
        straddle two epochs and must survive a drop of the older one."""
        keys = {}
        for ep in epochs:
            ks = keys_n(per_epoch, tag=f"ep{ep}-")
            keys[ep] = [(k, db.put(k, bytes(200), epoch=ep)) for k in ks]
        return keys

    def test_mid_log_drop_hides_only_dropped_epochs(self, tmpdir):
        with TideDB(tmpdir, small_cfg()) as db:
            keys = self._fill_epochs(db)
            seg_size = db.cfg.wal.segment_size
            # drop epochs 1-2: mid-log holes; epoch 3-4 segments stay put
            # (boundary segments straddling epoch 2/3 survive too)
            n = db.prune_epochs_below(3)
            assert n > 0
            gone = present = 0
            for k, pos in keys[1] + keys[2]:
                if db.value_wal.segment_missing(pos // seg_size):
                    assert db.get(k) is None and not db.exists(k)
                    gone += 1
                else:
                    assert db.get(k) == bytes(200)   # straddle segment kept
                    present += 1
            assert gone > 0                          # the drop was real
            for ep in (3, 4):
                for k, _ in keys[ep]:
                    assert db.get(k) == bytes(200)
            dropped_keys = [k for k, pos in keys[1]
                            if db.value_wal.segment_missing(pos // seg_size)]
            live_keys = [k for k, _ in keys[4]]
            assert db.multi_get(dropped_keys[:5] + live_keys[:5]) == \
                [None] * 5 + [bytes(200)] * 5
            assert db.multi_exists(dropped_keys[:5] + live_keys[:5]) == \
                [False] * 5 + [True] * 5

    def test_reopen_with_gaps(self, tmpdir):
        cfg = small_cfg()
        seg_size = cfg.wal.segment_size
        db = TideDB(tmpdir, cfg)
        keys = self._fill_epochs(db)
        db.snapshot_now()
        db.prune_epochs_below(3)
        expect = {k: (None if db.value_wal.segment_missing(pos // seg_size)
                      else bytes(200))
                  for k, pos in keys[1] + keys[2]}
        # crash: no snapshot after the drop — the control region still
        # references the deleted segments; replay must skip the holes
        db.close(flush=False)
        db2 = TideDB(tmpdir, cfg)
        for k, want in expect.items():
            assert db2.get(k) == want
        for ep in (3, 4):
            for k, _ in keys[ep]:
                assert db2.get(k) == bytes(200)
        # the resurrected epoch map must not re-offer dropped segments
        for seg in db2.value_wal.segment_epochs():
            assert not db2.value_wal.segment_missing(seg)
        db2.close()

    def test_snapshot_after_drop_roundtrips(self, tmpdir):
        cfg = small_cfg()
        db = TideDB(tmpdir, cfg)
        keys = self._fill_epochs(db)
        db.prune_epochs_below(3)
        db.snapshot_now()
        state = read_control_region(tmpdir)
        for seg in state["segment_epochs"]:
            assert not db.value_wal.segment_missing(int(seg))
        db.close(flush=False)
        db2 = TideDB(tmpdir, cfg)
        for ep in (3, 4):
            for k, _ in keys[ep]:
                assert db2.get(k) == bytes(200)
        db2.close()


# --------------------------------------------- control-region durability
def _populated(path, n=200):
    cfg = small_cfg()
    ks = keys_n(n)
    db = TideDB(path, cfg)
    for i, k in enumerate(ks[:n // 2]):
        db.put(k, b"a%06d" % i)
    db.snapshot_now()                    # snapshot #1 -> control.bin
    for i, k in enumerate(ks[n // 2:], start=n // 2):
        db.put(k, b"a%06d" % i)
    db.snapshot_now()                    # snapshot #2 -> rotates #1 to .1
    db.close(flush=False)
    return cfg, ks


class TestControlRegionDurability:
    @given(mode=st.sampled_from(["truncate", "flip", "empty", "garbage"]),
           frac=st.floats(0.0, 1.0))
    @settings(max_examples=12, deadline=None,
              suppress_health_check=[HealthCheck.too_slow])
    def test_torn_control_falls_back_to_previous(self, mode, frac):
        """Fuzz torn/truncated control.bin: recovery must fall back to the
        rotated previous snapshot — an older snapshot only lengthens
        replay, it never loses acknowledged data."""
        d = tempfile.mkdtemp(prefix="tide-ctl-")
        try:
            cfg, ks = _populated(d)
            fn = os.path.join(d, CONTROL_FILE)
            blob = open(fn, "rb").read()
            off = min(int(frac * len(blob)), len(blob) - 1)
            if mode == "truncate":
                open(fn, "wb").write(blob[:off])
            elif mode == "flip":
                mutated = bytearray(blob)
                mutated[off] ^= 0xFF
                open(fn, "wb").write(bytes(mutated))
            elif mode == "empty":
                open(fn, "wb").close()
            else:
                open(fn, "wb").write(b"\x00garbage\x00" * 4)
            state = read_control_region(d)
            assert state is not None                 # .1 fallback kicked in
            db = TideDB(d, cfg)
            for i, k in enumerate(ks):
                assert db.get(k) == b"a%06d" % i
            db.close()
        finally:
            shutil.rmtree(d, ignore_errors=True)

    def test_both_controls_corrupt_full_replay(self, tmpdir):
        cfg, ks = _populated(tmpdir)
        for fn in (CONTROL_FILE, CONTROL_FALLBACK):
            open(os.path.join(tmpdir, fn), "wb").write(b"torn")
        assert read_control_region(tmpdir) is None
        db = TideDB(tmpdir, cfg)                     # full WAL replay
        for i, k in enumerate(ks):
            assert db.get(k) == b"a%06d" % i
        db.close()

    def test_rotation_keeps_previous_snapshot(self, tmpdir):
        _populated(tmpdir)
        assert os.path.exists(os.path.join(tmpdir, CONTROL_FILE))
        assert os.path.exists(os.path.join(tmpdir, CONTROL_FALLBACK))


# --------------------------------------------- crash during relocation
class TestCrashDuringRelocation:
    def test_killed_relocation_batch_never_loses_data(self, tmpdir):
        """A relocation batch whose copier dies mid-flight raises; every
        live key stays readable — at its old position (CAS never ran) or
        its new one (batch fully committed) — before AND after reopen."""
        cfg = small_cfg()
        db = TideDB(tmpdir, cfg)
        ks = keys_n(300, tag="cr")
        # ~160B records: the relocation batch spans several 16K segments,
        # so append_many splits it into multiple copy sub-runs and the
        # fault below reliably kills one mid-batch
        val = lambda i: (b"c%06d" % i) + bytes(120)
        for i, k in enumerate(ks):
            db.put(k, val(i))
        db.snapshot_now()
        for k in ks[:200]:
            db.delete(k)
        calls = {"n": 0}

        def fault(idx):
            calls["n"] += 1
            if calls["n"] > 1:
                raise RuntimeError("copier killed mid-relocation")

        db.value_wal.copy_fault = fault
        with pytest.raises(RuntimeError):
            db.relocator.relocate_wal_based()
        db.value_wal.copy_fault = None
        assert not db.relocator.scanning             # lock released, no pass
        for i, k in enumerate(ks[200:], start=200):
            assert db.get(k) == val(i)               # old or new pos, never lost
        db.close(flush=False)

        db2 = TideDB(tmpdir, cfg)
        for i, k in enumerate(ks[200:], start=200):
            assert db2.get(k) == val(i)
        for k in ks[:200]:
            assert db2.get(k) is None
        # the store still relocates fine after the crash
        db2.relocator.relocate_wal_based()
        for i, k in enumerate(ks[200:], start=200):
            assert db2.get(k) == val(i)
        db2.close()


# ------------------------------------------- relocation vs live writes
class TestInterleavedOracle:
    @given(
        ops=st.lists(
            st.tuples(
                st.sampled_from(["put_many", "delete_many", "reloc_step",
                                 "reloc_full", "check", "flush"]),
                st.integers(0, 50),          # key-id base
                st.integers(1, 12),          # batch width
                st.integers(0, 7),           # value version
            ),
            min_size=1, max_size=60,
        )
    )
    @settings(max_examples=20, deadline=None,
              suppress_health_check=[HealthCheck.too_slow])
    def test_batched_ops_interleaved_with_relocation(self, ops):
        """Hypothesis: put_many/delete_many interleaved with relocation
        slices and full passes match a scalar dict oracle, including after
        crash-recovery."""
        d = tempfile.mkdtemp(prefix="tide-ilv-")
        cfg = DbConfig(
            keyspaces=[KeyspaceConfig("default", n_cells=4,
                                      dirty_flush_threshold=8)],
            wal=WalConfig(segment_size=8 * 1024, background=False),
            index_wal=WalConfig(segment_size=256 * 1024, background=False),
            background_snapshots=False,
            cache_bytes=0,
            prune=PruneOptions(min_reclaim_bytes=1024, batch_records=16),
            device="cpu",
        )
        oracle = {}
        key_of = lambda kid: hashlib.sha256(f"k{kid}".encode()).digest()
        try:
            with TideDB(d, cfg) as db:
                for op, base, width, ver in ops:
                    kids = [(base + j) % 64 for j in range(width)]
                    if op == "put_many":
                        items = [(key_of(kid), b"v%d-%d" % (kid, ver))
                                 for kid in kids]
                        db.put_many(items)
                        oracle.update(items)
                    elif op == "delete_many":
                        db.delete_many([key_of(kid) for kid in kids])
                        for kid in kids:
                            oracle.pop(key_of(kid), None)
                    elif op == "reloc_step":
                        db.prune_step()
                    elif op == "reloc_full":
                        db.relocator.relocate_wal_based()
                    elif op == "flush":
                        db.snapshot_now(flush_threshold=1)
                    else:
                        for kid in kids:
                            assert db.get(key_of(kid)) == \
                                oracle.get(key_of(kid))
                for key, val in oracle.items():
                    assert db.get(key) == val
            with TideDB(d, cfg) as db2:
                for key, val in oracle.items():
                    assert db2.get(key) == val
        finally:
            shutil.rmtree(d, ignore_errors=True)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_interleaved_deterministic_fuzz(self, tmpdir, seed):
        """Seeded-random twin of the hypothesis test above: runs even on
        images without hypothesis installed."""
        import random
        rng = random.Random(seed)
        cfg = DbConfig(
            keyspaces=[KeyspaceConfig("default", n_cells=4,
                                      dirty_flush_threshold=8)],
            wal=WalConfig(segment_size=8 * 1024, background=False),
            index_wal=WalConfig(segment_size=256 * 1024, background=False),
            background_snapshots=False,
            cache_bytes=0,
            prune=PruneOptions(min_reclaim_bytes=1024, batch_records=16),
            device="cpu",
        )
        oracle = {}
        key_of = lambda kid: hashlib.sha256(f"k{kid}".encode()).digest()
        with TideDB(tmpdir, cfg) as db:
            for _ in range(150):
                op = rng.choice(["put_many", "put_many", "delete_many",
                                 "reloc_step", "reloc_full", "check",
                                 "flush"])
                kids = [rng.randrange(64) for _ in range(rng.randint(1, 12))]
                if op == "put_many":
                    items = [(key_of(kid),
                              b"v%d-%d" % (kid, rng.randrange(8)))
                             for kid in kids]
                    db.put_many(items)
                    oracle.update(items)
                elif op == "delete_many":
                    db.delete_many([key_of(kid) for kid in kids])
                    for kid in kids:
                        oracle.pop(key_of(kid), None)
                elif op == "reloc_step":
                    db.prune_step()
                elif op == "reloc_full":
                    db.relocator.relocate_wal_based()
                elif op == "flush":
                    db.snapshot_now(flush_threshold=1)
                else:
                    for kid in kids:
                        assert db.get(key_of(kid)) == oracle.get(key_of(kid))
            for key, val in oracle.items():
                assert db.get(key) == val
        with TideDB(tmpdir, cfg) as db2:
            for key, val in oracle.items():
                assert db2.get(key) == val

    def test_relocation_concurrent_with_foreground_put_many(self, tmpdir):
        """Live put_many traffic flows while a relocation pass runs; the
        CAS always yields to the newer write."""
        with TideDB(tmpdir, small_cfg()) as db:
            ks = keys_n(400, tag="fg")
            db.put_many([(k, b"gen0-%03d" % i) for i, k in enumerate(ks)])
            stop = threading.Event()
            errors = []

            def updater():
                g = 1
                try:
                    while not stop.is_set():
                        db.put_many([(k, b"gen%d-%03d" % (g, i))
                                     for i, k in enumerate(ks[:80])])
                        g += 1
                except Exception as e:  # pragma: no cover
                    errors.append(e)

            t = threading.Thread(target=updater)
            t.start()
            try:
                for _ in range(3):
                    db.relocator.relocate_wal_based()
            finally:
                stop.set()
                t.join()
            assert not errors
            for i, k in enumerate(ks[80:], start=80):
                assert db.get(k) == b"gen0-%03d" % i
            for i, k in enumerate(ks[:80]):
                v = db.get(k)
                assert v is not None and v.endswith(b"-%03d" % i)


# ------------------------------------------------------ serving loop
class TestServerPruning:
    def test_server_interleaves_prune_steps(self, tmpdir):
        from repro_torch.serving.engine import KvBatchServer
        opts = PruneOptions(min_reclaim_bytes=1024, batch_records=64,
                            space_amp_trigger=1.0, reclaim_fraction=1.0)
        with TideDB(tmpdir, small_cfg(prune=opts)) as db:
            srv = KvBatchServer(db, max_batch=64, prune_opts=opts)
            ks = keys_n(200, tag="srv")
            for gen in (b"old", b"new"):             # churn: 50% dead bytes
                reqs = [srv.submit_put(k, gen + b"-%06d" % i)
                        for i, k in enumerate(ks)]
                srv.run_until_drained()
                assert all(r.done for r in reqs)
            first_live0 = db.value_wal.first_live_pos
            for _ in range(200):                     # idle steps still prune
                srv.step()
                if (not db.relocator.scanning
                        and db.value_wal.first_live_pos > first_live0):
                    break
            s = srv.stats()
            assert s["prune_steps"] > 0
            assert s["prune_scanned"] > 0
            assert db.value_wal.first_live_pos > first_live0
            for i, k in enumerate(ks):
                assert db.get(k) == b"new-%06d" % i

    def test_server_prune_disabled_by_default(self, tmpdir):
        from repro_torch.serving.engine import KvBatchServer
        with TideDB(tmpdir, small_cfg()) as db:
            srv = KvBatchServer(db, max_batch=16)
            for i, k in enumerate(keys_n(30)):
                srv.submit_put(k, b"p%d" % i)
            srv.run_until_drained()
            srv.step()
            assert srv.stats()["prune_steps"] == 0
            assert srv._prune_step is None

    def test_server_tolerates_engine_without_prune_step(self, tmpdir):
        from repro_torch.serving.engine import KvBatchServer

        class Bare:
            def put_many(self, items, keyspace=0, opts=None):
                return list(range(len(items)))
            def delete_many(self, keys, keyspace=0, opts=None):
                return list(range(len(keys)))
            def multi_get(self, keys, keyspace=0):
                return [None] * len(keys)
            def multi_exists(self, keys, keyspace=0):
                return [False] * len(keys)

        srv = KvBatchServer(Bare(), prune_opts=PruneOptions())
        srv.submit_put(b"k", b"v")
        assert srv.run_until_drained() == 1          # no AttributeError
        assert srv.stats()["prune_steps"] == 0


# ---------------------------------------------------------- sharded
class TestShardedPrune:
    def _cfg(self):
        return small_cfg(
            keyspaces=[KeyspaceConfig("default", n_cells=8,
                                      dirty_flush_threshold=64)])

    def test_sharded_prune_merges_shard_summaries(self, tmpdir):
        with ShardedTideDB(tmpdir, self._cfg(), n_shards=2) as sdb:
            ks = keys_n(300, tag="sh")
            sdb.put_many([(k, bytes(100)) for k in ks])
            sdb.delete_many(ks[:200])
            out = sdb.prune(PruneOptions(min_reclaim_bytes=1024,
                                         reclaim_fraction=1.0))
            assert out["triggered"]
            assert out["relocated"] > 0
            assert out["space_amp"] >= 1.0
            for k in ks[200:]:
                assert sdb.get(k) == bytes(100)
            for k in ks[:200]:
                assert sdb.get(k) is None

    def test_sharded_prune_step_round_robins(self, tmpdir):
        with ShardedTideDB(tmpdir, self._cfg(), n_shards=2) as sdb:
            sdb.put_many([(k, bytes(100)) for k in keys_n(200, tag="rr")])
            opts = PruneOptions(min_reclaim_bytes=1024, batch_records=32)
            rr0 = sdb._prune_rr
            for _ in range(4):
                sdb.prune_step(opts)
            assert sdb._prune_rr == rr0 + 4          # cycled both shards twice

    def test_sharded_epoch_prune_sums(self, tmpdir):
        with ShardedTideDB(tmpdir, self._cfg(), n_shards=2) as sdb:
            for ep in (1, 2, 3):
                sdb.put_many([(k, bytes(150))
                              for k in keys_n(120, tag=f"e{ep}-")],
                             epoch=ep)
            n = sdb.prune_epochs_below(3)
            assert n >= 2                            # at least one per shard
            for k in keys_n(120, tag="e1-"):
                assert sdb.get(k) is None
            for k in keys_n(120, tag="e3-"):
                assert sdb.get(k) == bytes(150)


# ------------------------------------------------------- clamp metric
class TestCopyThreadClamp:
    def test_clamp_records_metric(self, tmpdir):
        cores = os.cpu_count() or 1
        cfg = small_cfg(copy_threads=cores + 4)
        with TideDB(tmpdir, cfg) as db:
            assert db._copy_pool.threads == cores
            assert db.metrics.copy_threads_clamped == 4

    def test_clamp_opt_out(self, tmpdir):
        cores = os.cpu_count() or 1
        cfg = small_cfg(copy_threads=cores + 2, clamp_copy_threads=False)
        with TideDB(tmpdir, cfg) as db:
            assert db._copy_pool.threads == cores + 2
            assert db.metrics.copy_threads_clamped == 0

    def test_within_budget_not_clamped(self):
        m = Metrics()
        assert clamp_copy_threads(1, m) == 1
        assert m.copy_threads_clamped == 0

    def test_sharded_clamp_records_metric(self, tmpdir):
        cores = os.cpu_count() or 1
        cfg = small_cfg(copy_threads=cores + 3)
        with ShardedTideDB(tmpdir, cfg, n_shards=2) as sdb:
            assert sdb._copy_pool.threads == cores
            assert sdb.stats()["copy_threads_clamped"] >= 3
