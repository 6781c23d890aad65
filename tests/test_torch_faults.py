"""Fault injection, corruption scrubbing, and degraded-mode serving.

Three layers of coverage over the robustness work:

1. Unit: ``FaultyIo`` semantics (determinism, rule windows, short/torn
   prefixes) and the typed error taxonomy.
2. Integrity: CRC corruption is detected and quarantined (never served),
   the scrubber finds planted corruption (including while racing
   foreground writes/relocation), recovery survives corrupted control
   regions plus a torn WAL tail.
3. Fuzz: seeded random fault schedules drive the full write path; after a
   simulated crash (``db.crash()``) and clean reopen, every
   sync-acknowledged write must read back as an acknowledged-or-later
   version, and no reader may ever observe a torn value.

Runs without hypothesis: schedules come from ``random_schedule(seed)``
via pytest parametrization, so the fuzz tier is deterministic per seed.

The port's mirror of ``tests/test_faults.py``: ``repro`` → ``repro_torch``,
``device="cpu"`` at each config; no case left out.
"""
import errno
import hashlib
import os
import shutil
import tempfile
import threading

import pytest

from repro_torch.core.tidestore import (CorruptionError, DbConfig, DegradedError,
                                  FaultRule, FaultyIo, KeyspaceConfig,
                                  KeyWidthError, PruneOptions, TideDB,
                                  TornRecordError, WalHoleError, WalReadError,
                                  WriteBatch, WriteOptions, random_schedule)
from repro_torch.core.tidestore.scrub import read_scrub_table
from repro_torch.core.tidestore.shard import ShardedTideDB
from repro_torch.core.tidestore.snapshot import CONTROL_FALLBACK, CONTROL_FILE
from repro_torch.core.tidestore.wal import HEADER_SIZE, WalConfig


def small_cfg(**kw):
    defaults = dict(
        keyspaces=[KeyspaceConfig("default", n_cells=16,
                                  dirty_flush_threshold=64)],
        wal=WalConfig(segment_size=16 * 1024, background=False),
        index_wal=WalConfig(segment_size=1 * 1024 * 1024, background=False),
        background_snapshots=False,
    )
    defaults.update(kw)
    return DbConfig(device="cpu", **defaults)


def keys_n(n, tag=""):
    return [hashlib.sha256(f"{tag}{i}".encode()).digest() for i in range(n)]


@pytest.fixture()
def tmpdir():
    d = tempfile.mkdtemp(prefix="tide-fault-")
    yield d
    shutil.rmtree(d, ignore_errors=True)


# ------------------------------------------------------------------ FaultyIo
class TestFaultyIo:
    def test_rule_window_and_counters(self, tmpdir):
        io = FaultyIo([FaultRule(op="pwrite", kind="eio", after=2, count=2)])
        fd = os.open(os.path.join(tmpdir, "f"), os.O_RDWR | os.O_CREAT, 0o644)
        try:
            assert io.pwrite(fd, b"aa", 0) == 2          # nth=0: clean
            assert io.pwrite(fd, b"bb", 2) == 2          # nth=1: clean
            for _ in range(2):                           # nth=2,3: window
                with pytest.raises(OSError) as ei:
                    io.pwrite(fd, b"cc", 4)
                assert ei.value.errno == errno.EIO
            assert io.pwrite(fd, b"dd", 4) == 2          # nth=4: exhausted
            assert io.calls["pwrite"] == 5
            assert io.injected_counts() == {"eio": 2}
        finally:
            os.close(fd)

    def test_torn_write_lands_prefix_then_raises(self, tmpdir):
        io = FaultyIo([FaultRule(op="pwrite", kind="torn")], seed=3)
        fd = os.open(os.path.join(tmpdir, "f"), os.O_RDWR | os.O_CREAT, 0o644)
        try:
            with pytest.raises(OSError) as ei:
                io.pwrite(fd, b"x" * 64, 0)
            assert ei.value.errno == errno.EIO
            n = os.pread(fd, 128, 0)
            assert 0 <= len(n) < 64                      # strict prefix
            assert n == b"x" * len(n)
        finally:
            os.close(fd)

    def test_enospc_moves_no_bytes(self, tmpdir):
        io = FaultyIo([FaultRule(op="pwrite", kind="enospc")])
        fd = os.open(os.path.join(tmpdir, "f"), os.O_RDWR | os.O_CREAT, 0o644)
        try:
            with pytest.raises(OSError) as ei:
                io.pwrite(fd, b"x" * 64, 0)
            assert ei.value.errno == errno.ENOSPC
            assert os.pread(fd, 128, 0) == b""
        finally:
            os.close(fd)

    def test_star_op_matches_everything(self, tmpdir):
        io = FaultyIo([FaultRule(op="*", kind="eio", count=None)])
        with pytest.raises(OSError):
            io.open(os.path.join(tmpdir, "f"), os.O_RDWR | os.O_CREAT)

    def test_rule_validation(self):
        with pytest.raises(ValueError):
            FaultRule(op="pwritev2", kind="eio")
        with pytest.raises(ValueError):
            FaultRule(op="pwrite", kind="bitrot")

    def test_random_schedule_deterministic(self):
        assert random_schedule(17) == random_schedule(17)
        assert random_schedule(17) != random_schedule(18)
        for rule in random_schedule(99):
            assert rule.op in ("pwrite", "pwritev", "fsync")

    def test_taxonomy_shapes(self):
        # Read errors subclass KeyError so existing relocation-race retry
        # loops keep treating them as "position went away".
        for cls in (CorruptionError, TornRecordError, WalHoleError):
            e = cls("boom at 42", 42)
            assert isinstance(e, WalReadError)
            assert isinstance(e, KeyError)
            assert e.pos == 42
            assert str(e) == "boom at 42"                # no KeyError quoting
        d = DegradedError("disk full")
        assert d.reason == "disk full"
        assert isinstance(KeyWidthError("w"), ValueError)


# ------------------------------------------------------------ read integrity
def _flip_payload_byte(db, pos, delta=5):
    """Corrupt one payload byte of the record at ``pos`` on disk (segments
    are one file each; in-file offsets are segment-relative)."""
    wal = db.value_wal
    fd = wal._fd(pos // wal.cfg.segment_size)
    off = pos % wal.cfg.segment_size + HEADER_SIZE + delta
    old = os.pread(fd, 1, off)
    os.pwrite(fd, bytes([old[0] ^ 0xFF]), off)


class TestReadIntegrity:
    def test_corrupt_record_never_served_and_quarantined(self, tmpdir):
        with TideDB(tmpdir, small_cfg(cache_bytes=0)) as db:
            ks = keys_n(50)
            pos = [db.put(k, b"v%06d" % i) for i, k in enumerate(ks)]
            db.flush()
            _flip_payload_byte(db, pos[7])
            assert db.get(ks[7]) is None                 # fail-safe, not torn
            assert db.metrics.crc_failures >= 1
            assert db.metrics.quarantined_positions == 1
            q = db.value_wal.quarantined()
            assert pos[7] in q
            db.get(ks[7])                                # counted again...
            assert db.value_wal.quarantined()[pos[7]] >= 2
            assert db.metrics.quarantined_positions == 1  # ...quarantined once
            assert db.get(ks[8]) == b"v%06d" % 8         # neighbours fine

    def test_typed_errors_from_read_record(self, tmpdir):
        with TideDB(tmpdir, small_cfg(cache_bytes=0)) as db:
            pos = db.put(keys_n(1)[0], b"value")
            db.flush()
            _flip_payload_byte(db, pos)
            with pytest.raises(CorruptionError):
                db.value_wal.read_record(pos)
            # A position past every written byte is a hole, not corruption.
            with pytest.raises(WalHoleError):
                db.value_wal.read_record(db.value_wal.tail + 1 << 20)


# ------------------------------------------------------------------ scrubber
class TestScrubber:
    def test_finds_all_planted_corruptions(self, tmpdir):
        with TideDB(tmpdir, small_cfg(cache_bytes=0)) as db:
            ks = keys_n(500)
            pos = [db.put(k, b"p" * 150) for k in ks]
            db.flush()
            seg_size = db.value_wal.cfg.segment_size
            tail_seg = db.value_wal.tail // seg_size
            planted = [p for p in (pos[3], pos[90], pos[200])
                       if p // seg_size < tail_seg]      # sealed only
            assert len(planted) >= 2
            for p in planted:
                _flip_payload_byte(db, p)
            rep = db.scrub()
            found = {f["pos"] for f in rep["findings"] if f["kind"] == "crc"}
            assert found == set(planted)                 # 100% detection
            assert rep["corruptions"] == len(planted)
            assert db.metrics.scrub_passes == 1
            assert db.metrics.scrub_corruptions_found == len(planted)
            table = read_scrub_table(db)
            assert table["summary"]["corruptions_found"] == len(planted)
            assert len(table["findings"]) == len(planted)

    def test_step_resumes_and_completes_a_pass(self, tmpdir):
        with TideDB(tmpdir, small_cfg(cache_bytes=0)) as db:
            for k in keys_n(500):
                db.put(k, b"s" * 150)
            db.flush()
            sealed = len(db.scrubber._sealed_segments())
            assert sealed >= 3
            total = 0
            for _ in range(sealed):
                total += db.scrub_step(1)
            assert db.metrics.scrub_passes == 1
            assert total == db.metrics.scrub_records_checked

    def test_scrub_races_foreground_traffic(self, tmpdir):
        """A full scrub pass racing put_many + prune slices must finish
        with zero false positives: segments relocated or dropped under the
        cursor are skipped, never misread."""
        with TideDB(tmpdir, small_cfg(cache_bytes=0)) as db:
            ks = keys_n(300)
            db.put_many([(k, b"w" * 120) for k in ks])
            db.flush()
            stop = threading.Event()
            errs = []

            def churn():
                try:
                    i = 0
                    while not stop.is_set():
                        db.put_many([(k, b"w%04d" % i) for k in ks[:64]])
                        db.prune_step(PruneOptions(batch_records=64))
                        i += 1
                except Exception as e:   # pragma: no cover - failure detail
                    errs.append(e)

            t = threading.Thread(target=churn)
            t.start()
            try:
                reports = [db.scrub() for _ in range(5)]
            finally:
                stop.set()
                t.join(timeout=30)
            assert not errs
            for rep in reports:
                assert rep["corruptions"] == 0
                assert not [f for f in rep["findings"] if f["kind"] == "crc"]


# --------------------------------------------------------------- degradation
class TestDegradedMode:
    def test_enospc_transitions_to_read_only(self, tmpdir):
        # The disk "fills up" after a dozen payload copies; every later
        # write (including poison-repair pwrites) keeps failing.
        io = FaultyIo([FaultRule(op="pwritev", kind="enospc", after=12,
                                 count=None),
                       FaultRule(op="pwrite", kind="enospc", after=12,
                                 count=None)])
        db = TideDB(tmpdir, small_cfg(io=io))
        try:
            ks = keys_n(50)
            written = []
            with pytest.raises(OSError):
                for k in ks:
                    db.put(k, b"v" * 100)
                    written.append(k)
            assert written                               # progress, then full
            assert db.health == "degraded"
            assert "enospc" in db.degraded_reason
            assert db.stats()["health"] == "degraded"
            assert db.metrics.degraded_transitions == 1
            with pytest.raises(DegradedError):
                db.put(ks[0], b"rejected")
            with pytest.raises(DegradedError):
                db.write_batch(WriteBatch().put(ks[0], b"rejected"))
            # Reads keep serving everything that made it to disk.
            for k in written:
                assert db.get(k) == b"v" * 100
            assert db.exists(written[0])
        finally:
            db.crash()

    def test_unrepairable_poison_backlog_degrades(self, tmpdir):
        # Torn copy, then every repair pwrite fails too: flush cannot
        # acknowledge durability -> degraded.
        io = FaultyIo([FaultRule(op="pwritev", kind="torn", after=0, count=1),
                       FaultRule(op="pwrite", kind="eio", count=None)])
        db = TideDB(tmpdir, small_cfg(io=io))
        sync = WriteOptions(durability="sync")
        try:
            with pytest.raises(OSError):                 # the torn copy
                for k in keys_n(20):
                    db.put(k, b"v" * 100)
            # The failed record's header could not be rewritten as a torn
            # marker either: the next sync point refuses to acknowledge
            # durability and the store degrades.
            with pytest.raises(OSError):
                db.put(keys_n(1, "sync")[0], b"v", opts=sync)
            assert db.health == "degraded"
            assert "unrepaired WAL hole" in db.degraded_reason
        finally:
            db.crash()

    def test_degraded_is_not_persistent(self, tmpdir):
        """Degraded mode is a runtime verdict about THIS process's I/O; a
        reopen (new fds, maybe space freed) starts healthy."""
        io = FaultyIo([FaultRule(op="pwritev", kind="enospc", count=None)])
        db = TideDB(tmpdir, small_cfg(io=io))
        with pytest.raises(OSError):
            for k in keys_n(50):
                db.put(k, b"v" * 100)
        assert db.degraded
        db.crash()
        with TideDB(tmpdir, small_cfg()) as db2:
            assert db2.health == "ok"
            db2.put(keys_n(1, "post")[0], b"recovered")

    def test_sharded_health_aggregates(self, tmpdir):
        sdb = ShardedTideDB(tmpdir, small_cfg(), n_shards=2)
        try:
            sdb.put_many([(k, b"v" * 64) for k in keys_n(64)])
            assert sdb.health == "ok"
            sdb.shards[1]._enter_degraded("shard fault")
            assert sdb.health == "degraded"
            assert sdb.degraded_reason.startswith("shard 1:")
            st = sdb.stats()
            assert st["degraded_shards"] == 1
            assert st["health"] == "degraded"
            rep = sdb.scrub()
            assert rep["corruptions"] == 0
            sdb.scrub_step()                             # round-robin slice
        finally:
            sdb.close(flush=False)


# ---------------------------------------------------------- degraded serving
class TestDegradedServing:
    def test_server_sheds_writes_serves_reads(self, tmpdir):
        from repro_torch.serving.admission import Overloaded
        from repro_torch.serving.engine import KvBatchServer
        db = TideDB(tmpdir, small_cfg())
        try:
            srv = KvBatchServer(db)
            ks = keys_n(8)
            for k in ks:
                srv.submit_put(k, b"pre-" + k[:4])
            while srv.step():
                pass
            db._enter_degraded("test: disk full")
            with pytest.raises(Overloaded) as ei:
                srv.submit_put(ks[0], b"rejected")
            assert "degraded" in str(ei.value)
            with pytest.raises(Overloaded):
                srv.submit_delete(ks[0])
            # Reads and exists keep serving through the same loop.
            gets = [srv.submit_get(k) for k in ks]
            ex = srv.submit_exists(ks[0])
            while srv.step():
                pass
            for k, r in zip(ks, gets):
                assert r.result() == b"pre-" + k[:4]
            assert ex.result() is True
            st = srv.stats()
            assert st["health"] == "degraded"
            assert st["writes_shed_degraded"] == 2
        finally:
            db.crash()

    def test_idle_steps_scrub(self, tmpdir):
        from repro_torch.serving.engine import KvBatchServer
        with TideDB(tmpdir, small_cfg(cache_bytes=0)) as db:
            srv = KvBatchServer(db, scrub=True)
            items = [(k, b"i" * 150) for k in keys_n(500)]
            for k, v in items:
                srv.submit_put(k, v)
            while srv.step():
                pass
            db.flush()
            sealed = len(db.scrubber._sealed_segments())
            assert sealed >= 3
            for _ in range(sealed + 2):                  # idle ticks
                srv.step()
            st = srv.stats()
            assert st["scrub_steps"] >= sealed
            assert st["scrub_checked"] == db.metrics.scrub_records_checked
            assert db.metrics.scrub_passes >= 1


# ------------------------------------------------------- key-width satellite
class TestKeyWidth:
    def test_write_entrypoints_reject_wrong_width(self, tmpdir):
        with TideDB(tmpdir, small_cfg()) as db:
            good = keys_n(3)
            for bad in (b"short", good[0] + b"x"):
                with pytest.raises(KeyWidthError):
                    db.put(bad, b"v")
                with pytest.raises(KeyWidthError):
                    db.delete(bad)
                with pytest.raises(KeyWidthError):
                    db.put_many([(good[0], b"v"), (bad, b"v")])
                with pytest.raises(KeyWidthError):
                    db.delete_many([bad])
                with pytest.raises(KeyWidthError):
                    db.write_batch(WriteBatch().put(bad, b"v"))
            # Nothing from the rejected batch landed.
            assert db.get(good[0]) is None

    def test_reads_stay_width_tolerant(self, tmpdir):
        # scan_prefix-style probes use sub-width keys on the read path.
        with TideDB(tmpdir, small_cfg()) as db:
            k = keys_n(1)[0]
            db.put(k, b"v")
            assert db.get(b"short") is None
            assert not db.exists(b"short")
            assert db.prev(k[:4]) is None or True        # must not raise


# ----------------------------------------------- control + torn-tail recovery
class TestRecoveryWithCorruptControl:
    def test_both_controls_corrupt_plus_torn_tail(self, tmpdir):
        cfg = small_cfg()
        ks = keys_n(200)
        db = TideDB(tmpdir, cfg)
        for i, k in enumerate(ks[:100]):
            db.put(k, b"a%06d" % i)
        db.snapshot_now()
        for i, k in enumerate(ks[100:], start=100):
            db.put(k, b"a%06d" % i)
        db.snapshot_now()
        tail_seg_path = db.value_wal._segment_path(
            db.value_wal.tail // db.value_wal.cfg.segment_size)
        db.close(flush=False)
        # Corrupt BOTH control copies AND smear garbage past the WAL tail:
        # recovery must fall all the way back to a zero-state replay and
        # stop cleanly at the garbage header.
        for fn in (CONTROL_FILE, CONTROL_FALLBACK):
            with open(os.path.join(tmpdir, fn), "wb") as f:
                f.write(b"\xff" * 16)
        with open(tail_seg_path, "ab") as f:
            f.write(b"\xff" * (HEADER_SIZE + 11))
        db2 = TideDB(tmpdir, cfg)
        for i, k in enumerate(ks):
            assert db2.get(k) == b"a%06d" % i
        db2.close()


# ------------------------------------------------------------------ fuzz tier
FUZZ_SEEDS = list(range(25))


def run_fault_schedule(seed: int, d: str, n_ops: int = 120,
                       n_keys: int = 40) -> dict:
    """Drive one seeded fault schedule through the write path, crash, and
    verify the durability invariant on a clean reopen.

    Invariant: for every key, the post-crash value is one of the versions
    written at-or-after the last sync-acknowledged version (the ack is
    durable; a later non-acked write may legally have landed in full), and
    is NEVER a value outside the written set (no torn reads).  Returns
    counters for the benchmark harness.
    """
    rules = random_schedule(seed)
    io = FaultyIo(rules, seed=seed)
    cfg = small_cfg(io=io, copy_threads=0)   # in-line copies: deterministic
    ks = keys_n(n_keys, f"fz{seed}")
    db = TideDB(d, cfg)
    history = {k: [] for k in ks}            # key -> [(op_idx, value)]
    last_ack = {}                            # key -> op_idx of last acked put
    acked_vals = {}
    write_errors = 0
    degraded = False
    for i in range(n_ops):
        k = ks[i % n_keys]
        v = b"s%d-op%d" % (seed, i)
        try:
            db.put(k, v)
            history[k].append((i, v))
            db.flush()
            last_ack[k], acked_vals[k] = i, v
        except DegradedError:
            degraded = True
            break
        except OSError:
            write_errors += 1
            history[k].append((i, v))        # may or may not be durable
            continue
    degraded = degraded or db.degraded
    db.crash()

    db2 = TideDB(d, small_cfg())             # clean I/O for verification
    try:
        for k in ks:
            got = db2.get(k)
            valid = {v for idx, v in history[k]
                     if k not in last_ack or idx >= last_ack[k]}
            if k in acked_vals:
                assert got is not None, \
                    f"seed {seed}: acked write lost for {k.hex()[:8]}"
                assert got in valid, \
                    f"seed {seed}: read {got!r} older than ack/torn"
            elif got is not None:
                assert got in valid, f"seed {seed}: torn value {got!r}"
    finally:
        db2.close()
    return {"seed": seed, "acked": len(acked_vals),
            "write_errors": write_errors, "degraded": degraded,
            "injected": io.injected_counts()}


class TestFaultFuzz:
    @pytest.mark.parametrize("seed", FUZZ_SEEDS)
    def test_acked_writes_survive_crash(self, seed, tmpdir):
        report = run_fault_schedule(seed, tmpdir)
        # Most schedules are survivable by construction; every one must
        # have made SOME durable progress before any terminal fault.
        assert report["acked"] > 0

    def test_fuzz_actually_injects(self, tmpdir):
        """Meta-check: across the seed set the schedules exercised every
        fault kind at least once (guards against a silent no-op seam)."""
        kinds = set()
        for seed in FUZZ_SEEDS[:12]:
            d = os.path.join(tmpdir, str(seed))
            os.makedirs(d)
            kinds.update(run_fault_schedule(seed, d)["injected"])
        assert {"eio", "enospc"} & kinds or {"torn", "short"} & kinds
