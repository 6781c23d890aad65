"""Deterministic crash-schedule explorer + the try_recover escape hatch.

Four layers:

1. Explorer: every injectable fault point a seeded trace reaches gets one
   fork that crashes there (meta-checked: the fork's ``crashed_at`` equals
   its scheduled point), reopens, and must satisfy the model-based
   durability oracle — acked-sync writes survive, unacked writes are
   all-or-nothing, nothing is ever torn or interleaved.
2. Oracle negative controls: the ``ShadowModel`` actually flags a lost
   acked write and a torn atomic batch (an oracle that can't fail proves
   nothing).
3. ``try_recover``: the operator path out of degraded mode without a
   reopen — succeeds once the device heals, refuses while it's still
   failing, rate-limits repeat probes, and is reachable through
   ``KvBatchServer``.
4. A hypothesis ``RuleBasedStateMachine`` over the Engine API with the
   shadow model as invariant (skips without hypothesis; a deterministic
   fallback drives the same machine by hand so the bare image still
   exercises it).

The port's mirror of ``tests/test_crash_explorer.py``: the same cases and
assertions over the port's explorer (``simulate.py``) over its engines,
every store on ``device="cpu"``, where the batched reads take the kernels'
plain versions.
"""
import os
import random
import shutil
import tempfile

import pytest

from repro_torch.core.tidestore import (DbConfig, FaultRule, FaultyIo,
                                        KeyspaceConfig, ShardedTideDB, TideDB,
                                        WriteOptions)
from repro_torch.core.tidestore.simulate import (
    KEYSPACES, ShadowModel, explore_sharded_trace, explore_trace,
    explorer_config, generate_trace, key_of)
from repro_torch.core.tidestore.wal import WalConfig

from tests.hypothesis_compat import (HAVE_STATEFUL, RuleBasedStateMachine,
                                     invariant, rule,
                                     run_state_machine_as_test, settings, st)


@pytest.fixture()
def tmpdir():
    d = tempfile.mkdtemp(prefix="tide-explorer-")
    yield d
    shutil.rmtree(d, ignore_errors=True)


def small_cfg(**kw):
    defaults = dict(
        device="cpu",
        keyspaces=[KeyspaceConfig("default", n_cells=16,
                                  dirty_flush_threshold=64)],
        wal=WalConfig(segment_size=16 * 1024, background=False),
        index_wal=WalConfig(segment_size=1 * 1024 * 1024, background=False),
        background_snapshots=False,
        system_stats=False,
    )
    defaults.update(kw)
    return DbConfig(**defaults)


def _full_disk_rules():
    """A persistently full device: every mutating op fails with ENOSPC."""
    return [FaultRule(op=op, kind="enospc", after=0, count=None)
            for op in ("pwrite", "pwritev", "fsync", "ftruncate")]


K32 = [bytes([i]) * 32 for i in range(16)]      # default 32-byte keyspace


# ------------------------------------------------------------- the explorer
class TestCrashExplorer:
    def test_trace_is_deterministic(self):
        assert generate_trace(5) == generate_trace(5)
        assert generate_trace(5) != generate_trace(6)
        assert generate_trace(5, n_ops=9) != generate_trace(5)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_every_fault_point_crashes_and_recovers(self, seed, tmpdir):
        rep = explore_trace(seed, n_ops=10, n_keys=8, base_dir=tmpdir,
                            device="cpu")
        assert rep["fault_points"] > 0
        assert rep["forks"] == rep["fault_points"]
        assert rep["violations"] == []
        assert rep["unreached_points"] == []
        # Meta-check: fork k crashed at exactly fault point k — the
        # schedule FIRED everywhere, it didn't silently under-explore.
        assert rep["fork_points"] == list(range(rep["fault_points"]))
        # Both crash styles ran.
        assert rep["style_counts"]["clean"] > 0
        assert rep["style_counts"]["torn"] > 0

    def test_sharded_explorer_per_shard_schedules(self, tmpdir):
        rep = explore_sharded_trace(2, n_ops=10, n_keys=10, base_dir=tmpdir,
                                    device="cpu")
        assert rep["fault_points"] > 0
        assert rep["forks"] == rep["fault_points"]
        assert rep["violations"] == []
        assert rep["fork_points"] == list(range(rep["fault_points"]))
        # The device fault actually degraded the shard in most forks, and
        # every degraded fork exited degraded mode via try_recover once
        # the device healed; still-failing probes refused to clear.
        assert rep["degraded_forks"] > 0
        assert rep["recovered"] == rep["degraded_forks"]
        if rep["degraded_forks"] >= 2:
            assert rep["stayed_degraded"] > 0

    def test_repair_trace_is_deterministic(self):
        from repro_torch.core.tidestore.simulate import generate_repair_trace
        assert generate_repair_trace(5) == generate_repair_trace(5)
        assert generate_repair_trace(5) != generate_repair_trace(6)

    def test_repair_trace_covers_repair_and_resync(self, tmpdir):
        """Crash-at-fault-point over the replicated repair trace: the
        trace must actually reach injectable I/O *inside* the repair pass
        and *inside* the post-recover resync (meta-checked via
        ``phase_spans``), every sampled fork must satisfy the durability
        oracle after reopen + scrub + repair, and the surviving replica
        must keep every mid-trace read legal (zero reads lost)."""
        from repro_torch.core.tidestore.simulate import explore_repair_trace
        rep = explore_repair_trace(0, base_dir=tmpdir, max_points=12,
                                   device="cpu")
        assert rep["fault_points"] > 0
        assert rep["forks"] > 0
        assert rep["violations"] == []
        assert rep["lost_reads"] == 0
        assert rep["style_counts"]["clean"] > 0
        assert rep["style_counts"]["torn"] > 0
        # Meta-check: both self-healing phases performed injectable I/O,
        # so some fork crashed a repair/resync mid-flight (the explorer
        # samples the full point range, which covers both spans).
        for phase in ("repair", "recover"):
            lo, hi = rep["phase_spans"][phase]
            assert hi > lo, f"{phase} phase performed no injectable I/O"
        spans = sorted(rep["phase_spans"].values())
        assert spans[1][0] >= spans[0][1]        # phases don't overlap
        assert any(lo <= p < hi for p in rep["fork_points"]
                   for lo, hi in rep["phase_spans"].values())


# ------------------------------------------------- oracle negative controls
class TestOracleDetectsViolations:
    def test_flags_lost_acked_write(self, tmpdir):
        with TideDB(tmpdir, explorer_config(None, device="cpu")) as db:
            model = ShadowModel()
            model.apply_put("alpha", key_of(1), b"acked-value")
            model.ack()
            # The store never saw the write: the acked value is missing.
            violations = model.check(db)
        assert violations and "illegal state" in violations[0]

    def test_flags_torn_atomic_batch(self, tmpdir):
        with TideDB(tmpdir, explorer_config(None, device="cpu")) as db:
            model = ShadowModel()
            model.apply_batch((("put", "alpha", key_of(1), b"b1"),
                               ("put", "alpha", key_of(2), b"b2")))
            db.put(key_of(1), b"b1", keyspace="alpha")   # half the batch
            violations = model.check(db)
        assert any("torn atomic batch" in v for v in violations)

    def test_accepts_legal_partial_states(self, tmpdir):
        with TideDB(tmpdir, explorer_config(None, device="cpu")) as db:
            model = ShadowModel()
            model.apply_put("alpha", key_of(1), b"v1")
            model.ack()
            model.apply_put("alpha", key_of(1), b"v2")   # unacked
            db.put(key_of(1), b"v1", keyspace="alpha")   # crash ate v2
            assert model.check(db) == []
            db.put(key_of(1), b"v2", keyspace="alpha")   # ...or it landed
            assert model.check(db) == []


# ------------------------------------------- torn-header phantom regression
class TestTornHeaderPhantom:
    """Found by the explorer (seed 23, fault point 27, torn style): a write
    torn inside the 9-byte record header over a preallocated zero-filled
    segment leaves ``type=T_ENTRY, length=0, crc=0`` — and since
    ``crc32(b"") == 0`` the empty phantom record passed CRC validation and
    crashed ``decode_entry`` (struct.error) during reopen replay."""

    def test_header_torn_phantom_is_skipped_on_reopen(self, tmpdir):
        from repro_torch.core.tidestore.wal import T_ENTRY
        db = TideDB(tmpdir, small_cfg())
        db.put(K32[0], b"keep")
        db.flush()
        wal = db.value_wal
        seg_size = wal.cfg.segment_size
        fd = wal._fd(wal.tail // seg_size)
        # One byte of a record header lands, the rest stays zeros.
        os.pwrite(fd, bytes([T_ENTRY]), wal.tail % seg_size)
        db.crash()

        db2 = TideDB(tmpdir, small_cfg())       # must not raise
        try:
            assert db2.get(K32[0]) == b"keep"
            assert db2.metrics.replay_torn_records >= 1
            # The store stays writable past the skipped phantom.
            db2.put(K32[1], b"after")
            db2.flush()
            assert db2.get(K32[1]) == b"after"
        finally:
            db2.close()

    def test_entry_framed_rejects_short_payloads(self):
        from repro_torch.core.tidestore.wal import (
            T_ENTRY, T_INDEX, T_TOMBSTONE, encode_entry, encode_tombstone,
            entry_framed)
        assert not entry_framed(T_ENTRY, b"")
        assert not entry_framed(T_TOMBSTONE, b"\x00" * 11)
        # Header claims an 8-byte key but the payload stops short of it.
        assert not entry_framed(T_ENTRY, encode_entry(1, b"k" * 8, b"")[:14])
        assert entry_framed(T_ENTRY, encode_entry(1, b"k" * 8, b""))
        assert entry_framed(T_ENTRY, encode_entry(1, b"k" * 8, b"v"))
        assert entry_framed(T_TOMBSTONE, encode_tombstone(1, b"k" * 8))
        # Tombstones carry no value: trailing bytes mean a torn record.
        assert not entry_framed(T_TOMBSTONE, encode_tombstone(1, b"k") + b"x")
        assert entry_framed(T_INDEX, b"")       # non-entry types: no claim


# --------------------------------------------- FaultyIo fork-reset semantics
class TestFaultyIoReset:
    def test_reset_rearms_schedules_between_forks(self, tmpdir):
        io = FaultyIo([FaultRule(op="pwrite", kind="eio", after=1, count=1)])
        fd = os.open(os.path.join(tmpdir, "f"),
                     os.O_RDWR | os.O_CREAT, 0o644)
        try:
            io.pwrite(fd, b"aa", 0)                     # nth=0: clean
            with pytest.raises(OSError):
                io.pwrite(fd, b"bb", 2)                 # nth=1: fires
            snap = io.reset()
            assert snap["calls"]["pwrite"] == 2
            assert snap["injected"] == [("pwrite", 1, "eio")]
            # Counters zeroed: without reset, the one-shot rule would
            # never fire again and fork 2's coverage accounting would
            # read fork 1's counts.
            assert io.injected_counts() == {}
            assert io.snapshot()["calls"]["pwrite"] == 0
            io.pwrite(fd, b"aa", 0)
            with pytest.raises(OSError):
                io.pwrite(fd, b"bb", 2)                 # fires again
            assert io.injected_counts() == {"eio": 1}
            # snapshot() is non-destructive.
            s = io.snapshot()
            assert io.snapshot() == s
        finally:
            os.close(fd)

    def test_reset_seed_reproduces_torn_prefixes(self, tmpdir):
        io = FaultyIo([FaultRule(op="pwrite", kind="torn", count=1)], seed=11)
        sizes = []
        for fork in range(2):
            path = os.path.join(tmpdir, f"t{fork}")
            fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
            try:
                with pytest.raises(OSError):
                    io.pwrite(fd, b"x" * 1000, 0)
            finally:
                os.close(fd)
            sizes.append(os.path.getsize(path))
            io.reset(seed=11)                           # re-arm rng + rules
        assert sizes[0] == sizes[1] < 1000              # strict prefix


# ----------------------------------------------------------- try_recover
class TestTryRecover:
    def test_healthy_store_is_a_noop(self, tmpdir):
        with TideDB(tmpdir, small_cfg()) as db:
            assert db.try_recover() is True
            assert db.metrics.recover_probes == 0       # no disk probe

    def test_recovers_after_disk_freed(self, tmpdir):
        io = FaultyIo([])
        db = TideDB(tmpdir, small_cfg(io=io))
        try:
            db.put(K32[0], b"pre")
            db.flush()
            io.rules = _full_disk_rules()
            with pytest.raises(OSError):
                for k in K32[1:8]:
                    db.put(k, b"x" * 200)
            assert db.degraded
            # Device still full: the re-probe must refuse.
            assert db.try_recover(min_retry_interval_s=0.0) is False
            assert db.degraded
            io.rules = []                               # operator freed space
            assert db.try_recover(min_retry_interval_s=0.0) is True
            assert db.health == "ok"
            assert db.metrics.degraded_recoveries == 1
            # The write surface is open again without a reopen, and the
            # pre-outage data is intact.
            db.put(K32[9], b"post-recover")
            assert db.get(K32[9]) == b"post-recover"
            assert db.get(K32[0]) == b"pre"
        finally:
            db.close(flush=not db.degraded)

    def test_failed_probes_are_rate_limited(self, tmpdir):
        io = FaultyIo([])
        db = TideDB(tmpdir, small_cfg(io=io))
        try:
            io.rules = _full_disk_rules()
            with pytest.raises(OSError):
                db.put(K32[0], b"x" * 200)
            assert db.degraded
            assert db.try_recover() is False            # probe hits the disk
            assert db.metrics.recover_probes == 1
            # An immediate retry (an operator loop, a serving tier retrying
            # every shed write) must NOT touch the device again.
            assert db.try_recover() is False
            assert db.metrics.recover_probes == 1
            assert db.metrics.recover_probes_skipped == 1
            io.rules = []
            # Still inside the retry window: refused without probing —
            # no flapping — but an explicit zero-interval probe recovers.
            assert db.try_recover() is False
            assert db.metrics.recover_probes == 1
            assert db.try_recover(min_retry_interval_s=0.0) is True
            assert db.health == "ok"
        finally:
            db.close(flush=not db.degraded)

    def test_try_recover_via_server(self, tmpdir):
        from repro_torch.serving.admission import Overloaded
        from repro_torch.serving.engine import KvBatchServer
        io = FaultyIo([])
        db = TideDB(tmpdir, small_cfg(io=io))
        try:
            srv = KvBatchServer(db)
            srv.submit_put(K32[0], b"pre")
            while srv.step():
                pass
            io.rules = _full_disk_rules()
            with pytest.raises(OSError):
                db.put(K32[1], b"x" * 200)
            assert db.degraded
            with pytest.raises(Overloaded):
                srv.submit_put(K32[2], b"shed")
            # Device still failing: the server-side probe refuses too.
            assert srv.try_recover() is False
            io.rules = []
            db._last_recover_attempt = None             # skip the window
            assert srv.try_recover() is True
            st_ = srv.stats()
            assert st_["recover_attempts"] == 2
            assert st_["recoveries"] == 1
            assert st_["health"] == "ok"
            # Writes stop being shed immediately.
            r = srv.submit_put(K32[3], b"post")
            while srv.step():
                pass
            r.result()                                  # raises if shed
            assert db.get(K32[3]) == b"post"
        finally:
            db.close(flush=not db.degraded)

    def test_sharded_try_recover_spans_shards(self, tmpdir):
        io0 = FaultyIo([])
        sdb = ShardedTideDB(tmpdir, small_cfg(), n_shards=2,
                            shard_ios=[io0, None])
        try:
            io0.rules = _full_disk_rules()
            with pytest.raises(OSError):
                for k in K32:
                    sdb.shards[0].put(k, b"x" * 200)
            assert sdb.shards[0].degraded
            assert sdb.stats()["degraded_shards"] == 1
            assert sdb.try_recover(min_retry_interval_s=0.0) is False
            io0.rules = []
            assert sdb.try_recover(min_retry_interval_s=0.0) is True
            assert sdb.health == "ok"
            assert sdb.stats()["degraded_shards"] == 0
        finally:
            sdb.close(flush=False)


# ------------------------------------------------- hypothesis state machine
class EngineMachine(RuleBasedStateMachine):
    """Random Engine-API schedules (put/delete/flush/prune/crash/reopen)
    with the shadow model as the standing invariant.  Without fault
    injection a ``crash()`` loses nothing that reached the OS page cache,
    so every observation must sit inside the model's legal set."""

    def __init__(self):
        super().__init__()
        self.dir = tempfile.mkdtemp(prefix="tide-machine-")
        self.db = TideDB(self.dir, explorer_config(None, device="cpu"))
        self.model = ShadowModel()
        self._version = 0

    def _fresh(self, key: bytes) -> bytes:
        self._version += 1
        return b"m:%s:%d" % (key, self._version)

    @rule(i=st.integers(min_value=0, max_value=7),
          ks=st.sampled_from(KEYSPACES),
          sync=st.booleans())
    def put(self, i, ks, sync):
        key, value = key_of(i), self._fresh(key_of(i))
        self.model.apply_put(ks, key, value)
        self.db.put(key, value, keyspace=ks,
                    opts=WriteOptions(durability="sync" if sync else "async"))
        if sync:
            self.model.ack()

    @rule(i=st.integers(min_value=0, max_value=7),
          ks=st.sampled_from(KEYSPACES))
    def delete(self, i, ks):
        self.model.apply_delete(ks, key_of(i))
        self.db.delete(key_of(i), keyspace=ks)

    @rule()
    def flush(self):
        self.db.flush()
        self.model.ack()

    @rule()
    def prune_step(self):
        self.db.prune_step()

    @rule()
    def crash_and_reopen(self):
        self.db.crash()
        self.db = TideDB(self.dir, explorer_config(None, device="cpu"))

    @invariant()
    def observations_are_legal(self):
        assert self.model.check(self.db) == []

    def teardown(self):
        self.db.crash()
        shutil.rmtree(self.dir, ignore_errors=True)


class TestEngineStateMachine:
    def test_hypothesis_stateful(self):
        run_state_machine_as_test(
            EngineMachine,
            settings=settings(max_examples=10, stateful_step_count=12,
                              deadline=None))

    def test_deterministic_fallback_drive(self):
        """Runs the same machine by hand on a seeded schedule, so the bare
        image (no hypothesis) still exercises every rule + the invariant."""
        m = EngineMachine()
        rng = random.Random(7)
        try:
            for _ in range(40):
                action = rng.choice(("put", "put", "put", "delete", "flush",
                                     "prune_step", "crash_and_reopen"))
                if action == "put":
                    m.put(rng.randrange(8), rng.choice(KEYSPACES),
                          rng.random() < 0.3)
                elif action == "delete":
                    m.delete(rng.randrange(8), rng.choice(KEYSPACES))
                else:
                    getattr(m, action)()
                m.observations_are_legal()
        finally:
            m.teardown()

    @pytest.mark.skipif(not HAVE_STATEFUL,
                        reason="hypothesis.stateful not installed")
    def test_stateful_import_is_real(self):
        from hypothesis.stateful import RuleBasedStateMachine as Real
        assert issubclass(EngineMachine, Real)
