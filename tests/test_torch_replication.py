"""Self-healing replication: replicated writes, failover, repair, resync.

Coverage map (replication + scrub-triggered repair):

1. Placement: crc32 ring (primary + R−1 successors), constructor bounds,
   replication=1 passthrough.
2. Replicated writes: every write path (put / put_many / write_batch)
   lands a copy on every ring shard.
3. Read failover: CRC corruption, quarantine, and degraded shards on the
   primary are transparent to ``get``/``multi_get``/``exists`` — the
   replica answers, ``read_failovers`` counts, and results stay
   byte-identical to a healthy store (zero reads lost).
4. Repair: ``RepairController`` restores a healthy copy onto the damaged
   shard (verified by a direct strict read with failover disabled),
   clears the quarantine, loses to concurrent foreground writes, refuses
   to bury records no peer can supply, and publishes TAG_REPAIR rows.
5. Resync: writes shed by a degraded replica are recorded as debt and
   replayed from peers after ``try_recover`` — the rejoin half of the
   degraded-shard lifecycle.
6. Satellites: ``ScrubConfig.max_findings``, repaired findings aging out
   of ``__system``, crc_failures not double-counting re-detections, and
   the serving loop's operator-less ``auto_recover`` probe.
7. Property: a replicated store with one faulty replica stays
   byte-identical to a plain dict oracle (runs only when hypothesis is
   installed; collects as a skip otherwise).

The port's mirror of ``tests/test_replication.py``: the same cases and
assertions over the port's ``ShardedTideDB``, ``RepairController`` and
``KvBatchServer``, every store on ``device="cpu"``, where the batched reads
take the kernels' plain versions. One case differs by design (ROADMAP C.9):
``test_probe_is_rate_limited_and_opt_in`` pins the first auto-recover probe
to fire whatever the machine's uptime.
"""
import hashlib
import os
import shutil
import tempfile
import time
import types

import pytest

from repro_torch.core.tidestore import (DbConfig, DegradedError, FaultRule,
                                        FaultyIo, KeyspaceConfig, ReadOptions,
                                        ScrubConfig, ShardedTideDB, TideDB,
                                        WriteBatch, read_repair_table)
from repro_torch.core.tidestore.scrub import read_scrub_table
from repro_torch.core.tidestore.system import TAG_REPAIR
from repro_torch.core.tidestore.wal import HEADER_SIZE, WalConfig, _ENTRY_HDR
from repro_torch.serving.admission import Overloaded
from repro_torch.serving import kv_server
from repro_torch.serving.engine import KvBatchServer
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
    )
    defaults.update(kw)
    return DbConfig(**defaults)


def keys_n(n, tag=""):
    return [hashlib.sha256(f"{tag}{i}".encode()).digest() for i in range(n)]


def primary_keys(sdb, sid, n, tag=""):
    """First ``n`` generated keys whose crc32 primary is ``sid``."""
    out, i = [], 0
    while len(out) < n:
        k = hashlib.sha256(f"{tag}{i}".encode()).digest()
        if sdb.shard_of(k) == sid:
            out.append(k)
        i += 1
    return out


def flip_value_byte(sh, pos, klen):
    """Corrupt one byte in the VALUE region of the record at ``pos`` —
    entry header and key bytes stay intact, so replay and repair
    identification still see the true key."""
    wal = sh.value_wal
    fd = wal._fd(pos // wal.cfg.segment_size)
    off = (pos % wal.cfg.segment_size + HEADER_SIZE
           + _ENTRY_HDR.size + klen + 1)
    old = os.pread(fd, 1, off)
    os.pwrite(fd, bytes([old[0] ^ 0x5A]), off)


NO_FAILOVER = ReadOptions(strict_errors=True, fill_cache=False)


@pytest.fixture()
def tmpdir():
    d = tempfile.mkdtemp(prefix="tide-repl-")
    yield d
    shutil.rmtree(d, ignore_errors=True)


# ----------------------------------------------------------------- placement
class TestPlacement:
    def test_ring_is_primary_plus_successors(self, tmpdir):
        with ShardedTideDB(tmpdir, small_cfg(), n_shards=4,
                           replication=3) as sdb:
            assert sdb.replicas_of(0) == (0, 1, 2)
            assert sdb.replicas_of(3) == (3, 0, 1)
            assert sdb.stats()["replication"] == 3

    def test_replication_bounds(self, tmpdir):
        with pytest.raises(ValueError):
            ShardedTideDB(tmpdir, small_cfg(), n_shards=2, replication=0)
        with pytest.raises(ValueError):
            ShardedTideDB(tmpdir, small_cfg(), n_shards=2, replication=3)

    def test_replication_1_passthrough(self, tmpdir):
        with ShardedTideDB(tmpdir, small_cfg(), n_shards=2) as sdb:
            assert sdb.repairer is None
            rep = sdb.repair()
            assert rep == {"examined": 0, "repaired": 0, "cas_lost": 0,
                           "unrepaired": 0, "skipped": 0}
            k = keys_n(1)[0]
            sdb.put(k, b"v")
            # Exactly one shard holds the key.
            holders = [sid for sid, sh in enumerate(sdb.shards)
                       if sh.table.get_position(0, k) is not None]
            assert holders == [sdb.shard_of(k)]


# ---------------------------------------------------------- replicated writes
class TestReplicatedWrites:
    def _holders(self, sdb, key):
        return sorted(sid for sid, sh in enumerate(sdb.shards)
                      if sh.table.get_position(0, key) is not None)

    def test_every_write_path_lands_on_the_ring(self, tmpdir):
        with ShardedTideDB(tmpdir, small_cfg(), n_shards=3,
                           replication=2) as sdb:
            ks = keys_n(9, "w")
            sdb.put(ks[0], b"scalar")
            sdb.put_many([(k, b"pm-%d" % i)
                          for i, k in enumerate(ks[1:5])])
            wb = WriteBatch()
            for i, k in enumerate(ks[5:]):
                wb.put(k, b"wb-%d" % i)
            sdb.write_batch(wb)
            for k in ks:
                ring = sorted(sdb.replicas_of(sdb.shard_of(k)))
                assert self._holders(sdb, k) == ring
            # Replica copies serve the same bytes as the primary.
            for k in ks:
                vals = {sdb.shards[s].get(k, opts=NO_FAILOVER)
                        for s in sdb.replicas_of(sdb.shard_of(k))}
                assert len(vals) == 1

    def test_delete_replicates(self, tmpdir):
        with ShardedTideDB(tmpdir, small_cfg(), n_shards=2,
                           replication=2) as sdb:
            k = keys_n(1, "d")[0]
            sdb.put(k, b"v")
            sdb.delete(k)
            assert sdb.get(k) is None
            for sh in sdb.shards:
                assert sh.table.get_position(0, k) is None


# ------------------------------------------------------------- read failover
class TestReadFailover:
    def test_get_fails_over_on_corruption(self, tmpdir):
        with ShardedTideDB(tmpdir, small_cfg(cache_bytes=0), n_shards=2,
                           replication=2) as sdb:
            ks = primary_keys(sdb, 0, 6, "fo")
            for i, k in enumerate(ks):
                sdb.put(k, b"val-%04d" % i)
            sdb.flush()
            prim = sdb.shards[0]
            pos = prim.table.get_position(0, ks[2])
            flip_value_byte(prim, pos, len(ks[2]))
            sdb.clear_caches()
            # Transparent: the replica answers; the primary quarantines.
            assert sdb.get(ks[2]) == b"val-0002"
            assert prim.metrics.read_failovers >= 1
            assert pos in prim.value_wal.quarantined()
            # The damaged copy really is unreadable without failover.
            with pytest.raises(KeyError):
                prim.get(ks[2], opts=NO_FAILOVER)

    def test_multi_get_parity_with_mixed_corruption(self, tmpdir):
        with ShardedTideDB(tmpdir, small_cfg(cache_bytes=0), n_shards=2,
                           replication=2) as sdb:
            ks = keys_n(24, "mg")
            expect = [b"mg-%04d" % i for i in range(len(ks))]
            sdb.put_many(list(zip(ks, expect)))
            sdb.flush()
            for k in ks[::5]:                    # corrupt every 5th primary
                sh = sdb.shards[sdb.shard_of(k)]
                flip_value_byte(sh, sh.table.get_position(0, k), len(k))
            sdb.clear_caches()
            assert sdb.multi_get(ks) == expect              # zero reads lost
            assert [sdb.get(k) for k in ks] == expect       # scalar parity
            absent = keys_n(3, "nope")
            assert sdb.multi_get(absent) == [None] * 3

    def test_degraded_primary_routes_around(self, tmpdir):
        with ShardedTideDB(tmpdir, small_cfg(), n_shards=2,
                           replication=2) as sdb:
            ks = primary_keys(sdb, 0, 4, "deg")
            for i, k in enumerate(ks):
                sdb.put(k, b"d%d" % i)
            sdb.shards[0]._enter_degraded("test: forced outage")
            assert sdb._read_order(0) == [1, 0]     # stale demoted, not dropped
            for i, k in enumerate(ks):
                assert sdb.get(k) == b"d%d" % i
                assert sdb.exists(k)
            assert sdb.multi_get(ks) == [b"d%d" % i for i in range(4)]
            assert sdb.shards[0].metrics.read_failovers >= 1


# --------------------------------------------------------------------- repair
class TestRepair:
    def test_repair_restores_copy_and_clears_quarantine(self, tmpdir):
        with ShardedTideDB(tmpdir, small_cfg(cache_bytes=0), n_shards=2,
                           replication=2) as sdb:
            ks = primary_keys(sdb, 0, 8, "rep")
            for i, k in enumerate(ks):
                sdb.put(k, b"healthy-%04d" % i)
            sdb.flush()
            prim = sdb.shards[0]
            pos = prim.table.get_position(0, ks[3])
            flip_value_byte(prim, pos, len(ks[3]))
            sdb.clear_caches()
            assert sdb.get(ks[3]) == b"healthy-0003"   # quarantines + fails over
            assert pos in prim.value_wal.quarantined()

            rep = sdb.repair()
            assert rep["examined"] == 1 and rep["repaired"] == 1
            assert rep["unrepaired"] == 0 and rep["cas_lost"] == 0
            # Quarantine cleared on every shard...
            for sh in sdb.shards:
                assert sh.value_wal.quarantined() == {}
            # ...and the damaged shard serves the key WITHOUT failover.
            sdb.clear_caches()
            assert prim.get(ks[3], opts=NO_FAILOVER) == b"healthy-0003"
            assert prim.metrics.repaired_positions == 1
            assert prim.metrics.repair_appends == 1
            # Outcome published into __system under TAG_REPAIR.
            table = read_repair_table(sdb)
            assert table["summary"]["repair_appends"] == 1
            assert table["summary"]["quarantined"] == 0
            assert table["shards"][0]["repair_appends"] == 1

    def test_repair_loses_to_foreground_write(self, tmpdir):
        """A foreground overwrite between detection and repair must win:
        the index already points past the carcass, so repair only clears
        the quarantine (no append, no index touch)."""
        with ShardedTideDB(tmpdir, small_cfg(cache_bytes=0), n_shards=2,
                           replication=2) as sdb:
            k = primary_keys(sdb, 0, 1, "cas")[0]
            sdb.put(k, b"old-value")
            sdb.flush()
            prim = sdb.shards[0]
            pos = prim.table.get_position(0, k)
            flip_value_byte(prim, pos, len(k))
            sdb.clear_caches()
            assert sdb.get(k) == b"old-value"          # quarantined on primary
            sdb.put(k, b"new-value")                   # foreground moves the key
            appends_before = prim.metrics.repair_appends
            rep = sdb.repair()
            assert rep["repaired"] == 1                # carcass proven superseded
            assert prim.metrics.repair_appends == appends_before
            assert prim.value_wal.quarantined() == {}
            sdb.clear_caches()
            assert prim.get(k, opts=NO_FAILOVER) == b"new-value"

    def test_cas_insert_only_if_absent(self, tmpdir):
        with ShardedTideDB(tmpdir, small_cfg(), n_shards=2,
                           replication=2) as sdb:
            k1, k2 = keys_n(2, "ioa")
            sdb.put(k1, b"v1")
            sh = sdb.shards[sdb.shard_of(k1)]
            pos = sh.table.get_position(0, k1)
            # Present key: insert-CAS must lose.
            assert not sh.table.compare_and_set(0, k1, None, pos)
            # Absent key: insert-CAS lands, and a second one loses.
            assert sh.table.compare_and_set(0, k2, None, pos)
            assert sh.table.get_position(0, k2) == pos
            assert not sh.table.compare_and_set(0, k2, None, pos)

    def test_no_peer_copy_stays_quarantined(self, tmpdir):
        """Corruption on EVERY replica is genuine loss — repair must keep
        it visible (fail-safe None reads), never bury it."""
        with ShardedTideDB(tmpdir, small_cfg(cache_bytes=0), n_shards=2,
                           replication=2) as sdb:
            k = primary_keys(sdb, 0, 1, "loss")[0]
            sdb.put(k, b"doomed")
            sdb.flush()
            positions = {}
            for sid in sdb.replicas_of(0):
                sh = sdb.shards[sid]
                p = sh.table.get_position(0, k)
                flip_value_byte(sh, p, len(k))
                positions[sid] = p
            sdb.clear_caches()
            assert sdb.get(k) is None                  # fail-safe, both bad
            rep = sdb.repair()
            assert rep["unrepaired"] >= 1 and rep["repaired"] == 0
            assert positions[0] in sdb.shards[0].value_wal.quarantined()

    def test_repair_zero_reads_lost_during_window(self, tmpdir):
        """Every user read between corruption and repaired state returns
        the correct value — the acceptance criterion for the repair gate."""
        with ShardedTideDB(tmpdir, small_cfg(cache_bytes=0), n_shards=2,
                           replication=2) as sdb:
            ks = keys_n(30, "win")
            expect = [b"w%06d" % i for i in range(len(ks))]
            sdb.put_many(list(zip(ks, expect)))
            sdb.flush()
            for k in ks[::4]:
                sh = sdb.shards[sdb.shard_of(k)]
                flip_value_byte(sh, sh.table.get_position(0, k), len(k))
            sdb.clear_caches()
            assert sdb.multi_get(ks) == expect         # during the window
            while sdb.repair_step(max_repairs=2)["examined"]:
                assert sdb.multi_get(ks) == expect     # between repair slices
            for sh in sdb.shards:
                assert sh.value_wal.quarantined() == {}
            sdb.clear_caches()
            for k, v in zip(ks, expect):               # failover now unneeded
                for sid in sdb.replicas_of(sdb.shard_of(k)):
                    assert sdb.shards[sid].get(k, opts=NO_FAILOVER) == v


# --------------------------------------------------------------------- resync
class TestResync:
    def test_shed_writes_resync_after_recover(self, tmpdir):
        with ShardedTideDB(tmpdir, small_cfg(), n_shards=2,
                           replication=2) as sdb:
            ks = primary_keys(sdb, 0, 3, "rs")
            sdb.put(ks[0], b"before")
            sdb.shards[0]._enter_degraded("test: forced outage")
            sdb.put(ks[1], b"missed-put")       # lands on replica only
            sdb.delete(ks[0])                   # ... so does the delete
            st_ = sdb.stats()
            assert st_["resync_backlog"] == 2
            assert st_["replica_write_misses"] >= 2
            assert sdb.get(ks[1]) == b"missed-put"       # served via replica
            assert sdb.get(ks[0]) is None

            assert sdb.try_recover(min_retry_interval_s=0.0)
            assert sdb.stats()["resync_backlog"] == 0
            # The rejoined shard now holds what it missed.
            assert sdb.shards[0].get(ks[1], opts=NO_FAILOVER) == b"missed-put"
            assert sdb.shards[0].table.get_position(0, ks[0]) is None
            assert sdb.shards[0].metrics.resync_records >= 2
            assert sdb.shards[0].metrics.resync_runs >= 1
            assert sdb._read_order(0) == [0, 1]          # fresh again

    def test_write_landing_nowhere_raises_without_debt(self, tmpdir):
        with ShardedTideDB(tmpdir, small_cfg(), n_shards=2,
                           replication=2) as sdb:
            for sh in sdb.shards:
                sh._enter_degraded("test: total outage")
            with pytest.raises(DegradedError):
                sdb.put(keys_n(1, "nw")[0], b"v")
            assert sdb.stats()["resync_backlog"] == 0    # nothing to replay


# ------------------------------------------- scrub satellites (cap, counters)
class TestScrubSatellites:
    def _seeded(self, tmpdir, **cfg_kw):
        db = TideDB(tmpdir, small_cfg(cache_bytes=0, **cfg_kw))
        ks = keys_n(400, "sc")
        pos = [db.put(k, b"p" * 150) for k in ks]
        db.flush()
        seg = db.value_wal.cfg.segment_size
        tail_seg = db.value_wal.tail // seg
        sealed = [p for p in pos if p // seg < tail_seg]
        assert len(sealed) >= 8
        return db, ks, sealed

    def test_max_findings_caps_published_rows(self, tmpdir):
        db, _, sealed = self._seeded(
            tmpdir, scrub_cfg=ScrubConfig(max_findings=2))
        try:
            planted = sealed[:5]
            for p in planted:
                flip_value_byte(db, p, 32)
            rep = db.scrub()
            assert rep["corruptions"] == len(planted)    # detection uncapped
            table = read_scrub_table(db)
            assert len(table["findings"]) == 2           # persistence capped
        finally:
            db.close()

    def test_repaired_findings_age_out(self, tmpdir):
        db, _, sealed = self._seeded(tmpdir)
        try:
            planted = sealed[:3]
            for p in planted:
                flip_value_byte(db, p, 32)
            rep = db.scrub()
            assert rep["corruptions"] == 3
            assert len(read_scrub_table(db)["findings"]) == 3
            for p in planted:
                db.value_wal.mark_repaired(p)
            rep2 = db.scrub()                            # skips repaired bytes
            assert rep2["corruptions"] == 0
            assert read_scrub_table(db)["findings"] == []
            assert db.value_wal.quarantined() == {}
        finally:
            db.close()

    def test_crc_failures_count_once_across_passes(self, tmpdir):
        db, ks, sealed = self._seeded(tmpdir)
        try:
            p = sealed[0]
            flip_value_byte(db, p, 32)
            db.scrub()
            db.scrub()                                   # re-detects same pos
            corrupt_key = next(k for k in ks
                               if db.table.get_position(0, k) == p)
            db.get(corrupt_key)                          # and so does a read
            assert db.value_wal.quarantined()[p] >= 3    # observations pile up
            assert db.metrics.crc_failures == 1          # distinct positions
            assert db.metrics.quarantined_positions == 1
        finally:
            db.close()


# ------------------------------------------------- serving: auto-recovery
class TestServingAutoRecover:
    def test_idle_step_probes_and_recovers(self, tmpdir):
        with TideDB(tmpdir, small_cfg()) as db:
            srv = KvBatchServer(db, auto_recover=True, recover_interval_s=0.0)
            db._enter_degraded("test: transient outage")
            assert db.health == "degraded"
            assert srv.step() == 0                       # idle tick
            assert db.health == "ok"                     # disk is fine: healed
            s = srv.stats()
            assert s["auto_recover_probes"] == 1
            assert s["auto_recoveries"] == 1

    def test_probe_is_rate_limited_and_opt_in(self, tmpdir, monkeypatch):
        # ROADMAP C.9: the server's clock reads 5 s after boot, inside the
        # interval; the rate limit starts at "never probed", so the first
        # probe still fires and only the second is refused.
        monkeypatch.setattr(kv_server, "time", types.SimpleNamespace(
            monotonic=lambda: 5.0, time=time.time))
        with TideDB(tmpdir, small_cfg()) as db:
            calls = []
            db.try_recover = lambda **kw: (calls.append(1), False)[1]
            srv = KvBatchServer(db, auto_recover=True,
                                recover_interval_s=1000.0)
            db._enter_degraded("test: persistent outage")
            srv.step()
            srv.step()                                   # within the interval
            assert len(calls) == 1
            assert srv.stats()["auto_recover_probes"] == 1
            assert srv.stats()["auto_recoveries"] == 0

            off = KvBatchServer(db)                      # default: no probing
            off.step()
            assert off.stats()["auto_recover_probes"] == 0
            assert len(calls) == 1

    def test_server_keeps_accepting_writes_with_one_replica_down(
            self, tmpdir):
        # A replicated store with one degraded shard is still writable
        # (the engine sheds the copy to ring peers), so the serving tier
        # must NOT turn the outage into client-visible Overloaded errors.
        with ShardedTideDB(tmpdir, small_cfg(), n_shards=2,
                           replication=2) as sdb:
            srv = KvBatchServer(sdb, max_batch=8)
            sdb.shards[0]._enter_degraded("test: replica outage")
            assert sdb.health == "degraded"
            assert sdb.writable                 # every ring has a peer up
            k = keys_n(1, "sw")[0]
            w = srv.submit_put(k, b"through-the-outage")
            while srv.step():
                pass
            assert w.error is None
            r = srv.submit_get(k)
            while srv.step():
                pass
            assert r.value == b"through-the-outage"
            assert sdb.stats()["resync_backlog"] >= 1    # debt recorded

    def test_server_sheds_writes_when_a_ring_is_fully_down(self, tmpdir):
        # replication=1: a degraded shard owns keys no peer can absorb,
        # so the whole write surface sheds (pre-replication behavior).
        d1 = os.path.join(tmpdir, "r1")
        with ShardedTideDB(d1, small_cfg(), n_shards=2) as sdb:
            srv = KvBatchServer(sdb)
            sdb.shards[0]._enter_degraded("test: outage")
            assert not sdb.writable
            with pytest.raises(Overloaded):
                srv.submit_put(keys_n(1, "s1")[0], b"x")
        # replication=2 with BOTH ring members down: nothing can land.
        d2 = os.path.join(tmpdir, "r2")
        with ShardedTideDB(d2, small_cfg(), n_shards=2,
                           replication=2) as sdb:
            srv = KvBatchServer(sdb)
            for sh in sdb.shards:
                sh._enter_degraded("test: total outage")
            assert not sdb.writable
            with pytest.raises(Overloaded):
                srv.submit_put(keys_n(1, "s2")[0], b"x")


# ------------------------------------------------------------------- property
class TestReplicatedParity:
    """One replica misbehaves (torn writes, EIO, ENOSPC windows); the
    replicated store must stay byte-identical to a dict oracle — every
    write either lands replicated or sheds to the healthy peer, every
    read fails over."""

    @settings(max_examples=12, deadline=None,
              suppress_health_check=[HealthCheck.too_slow])
    @given(st.data())
    def test_one_faulty_replica_is_invisible(self, data):
        pool = keys_n(10, "par")
        n_ops = data.draw(st.integers(min_value=5, max_value=40))
        ops = [
            (data.draw(st.sampled_from(["put", "put", "put", "delete",
                                        "get", "multi_get"])),
             data.draw(st.integers(min_value=0, max_value=len(pool) - 1)),
             data.draw(st.binary(min_size=1, max_size=48)))
            for _ in range(n_ops)
        ]
        rules = [
            FaultRule(op="pwritev", kind=data.draw(
                st.sampled_from(["torn", "eio", "enospc"])),
                after=data.draw(st.integers(min_value=2, max_value=12)),
                count=data.draw(st.integers(min_value=1, max_value=4))),
            FaultRule(op="pwrite", kind="eio",
                      after=data.draw(st.integers(min_value=2, max_value=12)),
                      count=2),
        ]
        d = tempfile.mkdtemp(prefix="tide-parity-")
        sdb = ShardedTideDB(
            d, small_cfg(cache_bytes=0), n_shards=2, replication=2,
            shard_ios=[FaultyIo(rules, seed=data.draw(
                st.integers(min_value=0, max_value=999))), None])
        oracle: dict = {}
        try:
            for kind, ki, val in ops:
                k = pool[ki]
                if kind == "put":
                    sdb.put(k, val)
                    oracle[k] = val
                elif kind == "delete":
                    sdb.delete(k)
                    oracle.pop(k, None)
                elif kind == "get":
                    assert sdb.get(k) == oracle.get(k)
                else:
                    assert sdb.multi_get(pool) == \
                        [oracle.get(x) for x in pool]
            # Final sweep: scalar and batched reads both match the oracle.
            assert sdb.multi_get(pool) == [oracle.get(x) for x in pool]
            for k in pool:
                assert sdb.get(k) == oracle.get(k)
            # If the faulty replica degraded and its fault windows have
            # drained, rejoin must not change a single answer.
            if sdb.health == "degraded":
                sdb.try_recover(min_retry_interval_s=0.0)
            assert sdb.multi_get(pool) == [oracle.get(x) for x in pool]
        finally:
            sdb.crash()
            shutil.rmtree(d, ignore_errors=True)
