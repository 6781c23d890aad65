"""Vectorized write pipeline tests: ``append_many`` position/replay parity
with the scalar path, the reserve → parallel copy → commit protocol
(copies outside the allocation lock, the flush completion latch, killed
copies on crash), crash-consistency fuzz (segment-straddling batches,
torn-tail truncation mid-run, unwritten sub-run holes),
``put_many``/``delete_many`` end-to-end recovery parity (including
per-tombstone epochs), and the batched serving write stages.

The port's mirror of ``tests/test_write_batching.py``: ``repro`` → ``repro_torch``,
``device="cpu"`` at each config; no case left out.
"""
import hashlib
import os
import shutil
import tempfile
import threading

import pytest

from repro_torch.core.tidestore import (DbConfig, KeyspaceConfig, ShardedTideDB,
                                  TideDB, WriteOptions)
from repro_torch.core.tidestore import wal as wal_mod
from repro_torch.core.tidestore.wal import (HEADER_SIZE, T_ENTRY, T_TOMBSTONE, Wal,
                                      WalConfig, write_parts)

from tests.hypothesis_compat import HealthCheck, given, settings, st

SEG = 256  # tiny segments so batches straddle boundaries constantly


def small_cfg(**kw):
    defaults = dict(
        keyspaces=[KeyspaceConfig("default", n_cells=16,
                                  dirty_flush_threshold=64)],
        wal=WalConfig(segment_size=16 * 1024, background=False),
        index_wal=WalConfig(segment_size=1 * 1024 * 1024, background=False),
        background_snapshots=False,
        cache_bytes=kw.pop("cache_bytes", 1 * 1024 * 1024),
    )
    defaults.update(kw)
    return DbConfig(device="cpu", **defaults)


def keys_n(n, tag=""):
    return [hashlib.sha256(f"{tag}{i}".encode()).digest() for i in range(n)]


@pytest.fixture()
def tmpdir():
    d = tempfile.mkdtemp(prefix="tide-wbatch-")
    yield d
    shutil.rmtree(d, ignore_errors=True)


def _wal(d, seg=SEG):
    return Wal(d, "v", WalConfig(segment_size=seg, background=False))


def _pwal(d, seg=SEG, threads=3, split=32):
    """A WAL with a real copier pool and a tiny split threshold, so even
    tiny test batches fan out across multiple sub-runs."""
    return Wal(d, "v", WalConfig(segment_size=seg, background=False,
                                 copy_threads=threads,
                                 copy_split_bytes=split))


def _records(sizes):
    return [(T_ENTRY if i % 7 else T_TOMBSTONE, bytes([i % 251]) * s)
            for i, s in enumerate(sizes)]


# ------------------------------------------------------------- append_many
class TestAppendMany:
    def test_positions_identical_to_scalar(self, tmpdir):
        """Batched reservation must be byte-identical to N scalar appends,
        including zero-padding at every segment roll."""
        recs = _records([0, 1, 100, 247, 30, 247, 5, 60, 200, 17] * 5)
        w1 = _wal(os.path.join(tmpdir, "a"))
        w2 = _wal(os.path.join(tmpdir, "b"))
        batched = w1.append_many(recs)
        scalar = [w2.append(t, p) for t, p in recs]
        assert batched == scalar
        assert w1.tail == w2.tail
        assert list(w1.iter_records()) == list(w2.iter_records())
        w1.close()
        w2.close()

    def test_empty_and_oversize(self, tmpdir):
        w = _wal(tmpdir)
        assert w.append_many([]) == []
        with pytest.raises(ValueError):
            w.append_many([(T_ENTRY, bytes(SEG))])
        w.close()

    def test_single_pwrite_per_contiguous_run(self, tmpdir):
        w = _wal(tmpdir, seg=1 << 20)
        w.append_many([(T_ENTRY, b"x" * 64)] * 50)
        assert w.metrics.batched_append_runs == 1
        assert w.metrics.batched_write_records == 50
        w.close()

    def test_replay_parity_across_reopen(self, tmpdir):
        recs = _records([60, 247, 0, 13, 200, 88, 247, 1] * 8)
        w = _wal(tmpdir)
        w.append_many(recs)
        before = list(w.iter_records())
        w.close()
        w = _wal(tmpdir)
        assert list(w.iter_records()) == before
        assert [(t, p) for _, t, p in before] == recs
        w.close()

    @settings(max_examples=25, deadline=None,
              suppress_health_check=[HealthCheck.too_slow])
    @given(sizes=st.lists(st.integers(min_value=0, max_value=SEG - HEADER_SIZE),
                          min_size=1, max_size=60),
           chunk=st.integers(min_value=1, max_value=17))
    def test_fuzz_parity_with_scalar(self, sizes, chunk):
        """Hypothesis: any batch split, any record sizes (straddling segment
        boundaries), positions + replay identical to the scalar path."""
        d = tempfile.mkdtemp(prefix="tide-fuzz-")
        try:
            recs = _records(sizes)
            w1 = _wal(os.path.join(d, "a"))
            w2 = _wal(os.path.join(d, "b"))
            batched = []
            for off in range(0, len(recs), chunk):
                batched.extend(w1.append_many(recs[off:off + chunk]))
            scalar = [w2.append(t, p) for t, p in recs]
            assert batched == scalar
            assert list(w1.iter_records()) == list(w2.iter_records())
            w1.close()
            w2.close()
            w1 = _wal(os.path.join(d, "a"))  # recovery replays the same
            assert [(t, p) for _, t, p in w1.iter_records()] == recs
            w1.close()
        finally:
            shutil.rmtree(d, ignore_errors=True)

    def test_torn_tail_header_drops_suffix_only(self, tmpdir):
        """Zeroing a record's header mid-run (torn pwrite at crash) reads as
        padding: replay keeps every record before it, drops the suffix of
        that segment, and the recovered tail lands at the torn record."""
        recs = [(T_ENTRY, bytes([i]) * 40) for i in range(40)]
        w = _wal(tmpdir)
        positions = w.append_many(recs)
        w.close()

        torn = positions[-3]
        seg = torn // SEG
        path = os.path.join(tmpdir, f"v-{seg:010d}.seg")
        with open(path, "r+b") as f:
            f.seek(torn % SEG)
            f.write(b"\x00" * (SEG - torn % SEG))

        w = _wal(tmpdir)
        survived = [pos for pos, _, _ in w.iter_records()]
        assert survived == [p for p in positions if p < torn]
        # The recovered tail never lands inside surviving data (it may sit
        # past the torn record when a pre-resolved/preallocated empty next
        # segment exists — same as the mapper's behaviour), and appends
        # after recovery replay alongside the survivors.
        assert w.tail >= torn
        new_pos = w.append(T_ENTRY, b"after-recovery")
        replayed = list(w.iter_records())
        assert [pos for pos, _, _ in replayed] == survived + [new_pos]
        w.close()

    def test_torn_payload_mid_run_is_skipped(self, tmpdir):
        """A CRC-failing payload with an intact header is skipped by length;
        records after it in the same run still replay."""
        recs = [(T_ENTRY, bytes([i]) * 40) for i in range(40)]
        w = _wal(tmpdir)
        positions = w.append_many(recs)
        w.close()

        victim = positions[10]
        seg = victim // SEG
        path = os.path.join(tmpdir, f"v-{seg:010d}.seg")
        with open(path, "r+b") as f:
            f.seek(victim % SEG + HEADER_SIZE)
            f.write(b"\xff" * 8)          # corrupt payload, keep header

        w = _wal(tmpdir)
        survived = [pos for pos, _, _ in w.iter_records()]
        assert survived == [p for p in positions if p != victim]
        w.close()


# ----------------------------------------- reserve → parallel copy → commit
class TestReserveCopyCommit:
    def test_parallel_copy_parity_with_scalar(self, tmpdir):
        """Pool-fanned sub-run copies must reproduce the scalar byte
        stream exactly: positions, replay, and reopen all identical."""
        recs = _records([0, 1, 100, 247, 30, 247, 5, 60, 200, 17] * 5)
        w1 = _pwal(os.path.join(tmpdir, "a"))
        w2 = _wal(os.path.join(tmpdir, "b"))
        batched = w1.append_many(recs)
        scalar = [w2.append(t, p) for t, p in recs]
        assert batched == scalar
        # the tiny split threshold must actually have split the runs
        assert w1.metrics.parallel_copy_subruns > w1.metrics.batched_append_runs
        assert list(w1.iter_records()) == list(w2.iter_records())
        w1.close()
        w2.close()
        w1 = _wal(os.path.join(tmpdir, "a"))
        assert [(t, p) for _, t, p in w1.iter_records()] == recs
        w1.close()

    def test_copies_run_outside_alloc_lock(self, tmpdir):
        """The whole point of reserve-then-copy: during every payload copy
        (batched sub-runs AND the scalar path) the allocation lock is
        free, so concurrent writers can reserve while we copy."""
        w = _pwal(tmpdir)
        lock_free = []

        def fault(idx):
            ok = w._alloc_lock.acquire(timeout=5)
            if ok:
                w._alloc_lock.release()
            lock_free.append(ok)

        w.copy_fault = fault
        w.append_many([(T_ENTRY, bytes(40))] * 20)
        w.append(T_ENTRY, b"scalar-too")
        assert lock_free and all(lock_free)
        w.close()

    def test_parallel_false_copies_inline(self, tmpdir):
        """WriteOptions(parallel_copy=False) plumbing: the copies stay on
        the calling thread (still outside the lock)."""
        w = _pwal(tmpdir)
        tids = set()
        w.copy_fault = lambda idx: tids.add(threading.get_ident())
        w.append_many([(T_ENTRY, bytes(40))] * 20, parallel=False)
        assert tids == {threading.get_ident()}
        w.copy_fault = None
        w.close()

    @pytest.mark.parametrize("kill", ["first", "middle", "last"])
    def test_killed_subrun_drops_only_its_segment_suffix(self, tmpdir, kill):
        """Crash-consistency for the parallel-copy path: kill one sub-run
        mid-batch (fault-injection on the copier), reopen, and check only
        fully-copied records are visible — the unwritten hole reads as
        padding and drops exactly its segment's suffix, nothing else."""
        recs = [(T_ENTRY, bytes([i]) * 40) for i in range(40)]
        # Twin WAL: reservation is deterministic, so the twin's positions
        # are the oracle for what the killed batch reserved.
        twin = _pwal(os.path.join(tmpdir, "twin"))
        positions = twin.append_many(recs)
        twin.close()
        target = {"first": positions[0],
                  "middle": positions[len(recs) // 2],
                  "last": positions[-1]}[kill]

        w = _pwal(os.path.join(tmpdir, "w"))
        holes = []
        orig = w._copy_subrun

        def spy(job):
            idx, fd, off, nbytes = job[:4]
            with w._fd_lock:
                seg = next(s for s, f in w._fds.items() if f == fd)
            lo = seg * SEG + off
            hi = lo + nbytes
            if lo <= target < hi:
                holes.append((lo, hi))
                # non-OSError: a killed process writes nothing — the
                # poison-header repair must NOT fire for crash simulation
                raise RuntimeError("copier killed mid-batch")
            orig(job)

        w._copy_subrun = spy
        with pytest.raises(RuntimeError):
            w.append_many(recs)
        assert holes, "the targeted sub-run never ran"
        del w._copy_subrun
        w.close()

        w = _wal(os.path.join(tmpdir, "w"))
        survived = list(w.iter_records())
        # Replay oracle: a record is visible iff no unwritten hole starts
        # at or before it within its own segment (the zero header reads as
        # padding and the rest of that segment is dropped).
        expected = [p for p in positions if not any(
            lo // SEG == p // SEG and lo <= p for lo, _ in holes)]
        assert [pos for pos, _, _ in survived] == expected
        by_pos = dict(zip(positions, recs))
        for pos, rtype, payload in survived:     # survivors are byte-exact
            assert (rtype, payload) == by_pos[pos]
        w.close()

    def test_io_error_poisons_headers_instead_of_hole(self, tmpdir):
        """An OSError mid-copy (ENOSPC/EIO — process alive, unlike a
        crash) must not leave a segment-truncating zero hole: the failed
        sub-run's record headers are re-written best-effort, so its
        records replay as torn payloads (skipped individually) and every
        OTHER record — including same-segment records *after* the failure
        — survives."""
        recs = [(T_ENTRY, bytes([i]) * 40) for i in range(40)]
        twin = _pwal(os.path.join(tmpdir, "twin"))
        positions = twin.append_many(recs)
        twin.close()
        target = positions[len(recs) // 2]

        w = _pwal(os.path.join(tmpdir, "w"))
        failed, kill = [], set()
        orig = w._copy_subrun

        def spy(job):
            idx, fd, off, nbytes = job[:4]
            with w._fd_lock:
                seg = next(s for s, f in w._fds.items() if f == fd)
            lo = seg * SEG + off
            if lo <= target < lo + nbytes:
                failed.append((lo, lo + nbytes))
                kill.add(idx)
            orig(job)          # the real method: its repair path must run

        def fault(idx):
            if idx in kill:
                raise OSError("disk full mid-copy")

        w._copy_subrun = spy
        w.copy_fault = fault
        with pytest.raises(OSError):
            w.append_many(recs)
        assert failed
        del w._copy_subrun
        w.copy_fault = None
        w.close()

        w = _wal(os.path.join(tmpdir, "w"))
        survived = [pos for pos, _, _ in w.iter_records()]
        lo, hi = failed[0]
        assert survived == [p for p in positions if not lo <= p < hi]
        w.close()

    def test_unrepairable_hole_blocks_flush_until_repaired(self, tmpdir,
                                                           monkeypatch):
        """If even the poison-header writes fail, the hole goes onto a
        repair backlog and flush() must refuse to acknowledge durability
        until it drains — then the failed records replay as torn payloads
        and the WAL stays usable."""
        w = _pwal(tmpdir)
        real_pwrite = os.pwrite
        dead = {"on": False}

        def fake_pwrite(fd, data, offset):
            if dead["on"]:
                raise OSError("dead disk")
            return real_pwrite(fd, data, offset)

        def fault(idx):
            raise OSError("io error mid-copy")

        w.copy_fault = fault
        monkeypatch.setattr("repro.core.tidestore.wal.os.pwrite", fake_pwrite)
        dead["on"] = True
        with pytest.raises(OSError):
            # non-zero payloads: a zero payload would be byte-identical to
            # the preallocated hole and legitimately replay as written
            w.append_many([(T_ENTRY, bytes([i + 1]) * 40) for i in range(5)])
        w.copy_fault = None
        with pytest.raises(OSError):
            w.flush()                   # hole unrepaired: refuse durability
        dead["on"] = False
        w.flush()                       # backlog drains: headers poisoned
        assert list(w.iter_records()) == []   # torn payloads, skipped
        pos = w.append(T_ENTRY, b"alive-after-repair")
        assert [p for p, _, _ in w.iter_records()] == [pos]
        w.close()

    def test_flush_waits_for_inflight_copies(self, tmpdir):
        """The durability gate: a sync flush issued while an earlier
        batch's copies are still in flight must not return (and so must
        not acknowledge durability for any later record) until those
        copies complete — otherwise a crash could replay the earlier hole
        as padding and drop the acknowledged record."""
        w = _pwal(tmpdir, seg=16 * 1024, threads=2, split=64)
        gate, entered = threading.Event(), threading.Event()
        state = {"armed": True}

        def fault(idx):
            if idx == 0 and state["armed"]:
                state["armed"] = False
                entered.set()
                assert gate.wait(timeout=10)

        w.copy_fault = fault
        appender = threading.Thread(
            target=lambda: w.append_many([(T_ENTRY, bytes(100))] * 8))
        appender.start()
        assert entered.wait(timeout=10)      # batch reserved, copy stalled
        pos = w.append(T_ENTRY, b"sync-me")  # later writer, higher position
        done = threading.Event()
        flusher = threading.Thread(target=lambda: (w.flush(), done.set()))
        flusher.start()
        assert not done.wait(timeout=0.3)    # latch holds the fsync back
        gate.set()
        assert done.wait(timeout=10)
        appender.join(timeout=10)
        flusher.join(timeout=10)
        replayed = list(w.iter_records())
        assert len(replayed) == 9            # batch of 8 + the scalar record
        assert pos in [p for p, _, _ in replayed]
        w.copy_fault = None
        w.close()


class TestPwritevFallback:
    def test_fallback_path_parity(self, tmpdir, monkeypatch):
        """Platforms without ``os.pwritev`` take the staged single-pwrite
        shim; bytes must be identical, and a WAL written by one branch
        must reopen cleanly under the other."""
        monkeypatch.setattr(wal_mod, "HAVE_PWRITEV", False)
        recs = _records([60, 247, 0, 13, 200, 88, 247, 1] * 4)
        w1 = _pwal(os.path.join(tmpdir, "a"))
        w2 = _wal(os.path.join(tmpdir, "b"))
        assert w1.append_many(recs) == [w2.append(t, p) for t, p in recs]
        assert list(w1.iter_records()) == list(w2.iter_records())
        w1.close()
        w2.close()
        monkeypatch.undo()                   # reopen under the real branch
        w1 = _wal(os.path.join(tmpdir, "a"))
        assert [(t, p) for _, t, p in w1.iter_records()] == recs
        w1.close()

    @pytest.mark.parametrize("have_pwritev", [True, False])
    def test_write_parts_both_branches(self, tmpdir, monkeypatch,
                                       have_pwritev):
        monkeypatch.setattr(wal_mod, "HAVE_PWRITEV", have_pwritev)
        parts = [b"ab", b"", bytes(range(256)) * 5, b"z"]
        path = os.path.join(tmpdir, f"wp-{have_pwritev}")
        fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            n = write_parts(fd, parts, 7)
            assert n == sum(len(p) for p in parts)
            assert os.pread(fd, n, 7) == b"".join(parts)
        finally:
            os.close(fd)

    def test_write_parts_iov_max_chunking(self, tmpdir):
        """More buffers than IOV_MAX in one call: the vectored path must
        chunk and resume, producing the same bytes."""
        parts = [bytes([i % 251]) * 3 for i in range(3000)]
        path = os.path.join(tmpdir, "iov")
        fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            n = write_parts(fd, parts, 0)
            assert n == sum(len(p) for p in parts)
            assert os.pread(fd, n, 0) == b"".join(parts)
        finally:
            os.close(fd)


class TestEngineParallelCopy:
    def _cfg(self, **kw):
        # clamp_copy_threads=False: these tests exercise a genuinely
        # multi-threaded copier pool regardless of the host's core count.
        return small_cfg(
            wal=WalConfig(segment_size=16 * 1024, background=False,
                          copy_split_bytes=256),
            copy_threads=3, clamp_copy_threads=False, **kw)

    def test_put_many_parallel_recovers_to_scalar_map(self, tmpdir):
        """End to end through TideDB with a real copier pool: positions
        and the recovered key→position map match the scalar oracle."""
        ks = keys_n(120, tag="pc")
        d1, d2 = os.path.join(tmpdir, "a"), os.path.join(tmpdir, "b")
        db1, db2 = TideDB(d1, self._cfg()), TideDB(d2, small_cfg())
        p1 = db1.put_many([(k, b"v" * 200) for k in ks])
        p2 = [db2.put(k, b"v" * 200) for k in ks]
        assert p1 == p2
        assert db1.metrics.parallel_copy_subruns >= \
            db1.metrics.batched_append_runs
        db1.close(flush=False)
        db2.close(flush=False)
        db1, db2 = TideDB(d1, self._cfg()), TideDB(d2, small_cfg())
        for k in ks:
            assert db1.table.get_position(0, k) == db2.table.get_position(0, k)
            assert db1.get(k) == b"v" * 200
        db1.close()
        db2.close()

    def test_sync_durability_with_pool_flushes_all(self, tmpdir):
        with TideDB(tmpdir, self._cfg()) as db:
            db.put_many([(k, bytes(500)) for k in keys_n(40, tag="sd")],
                        opts=WriteOptions(durability="sync"))
            assert not db.value_wal._dirty_segments

    def test_parallel_copy_opt_out_stays_on_caller(self, tmpdir):
        db = TideDB(tmpdir, self._cfg())
        tids = set()
        db.value_wal.copy_fault = lambda idx: tids.add(threading.get_ident())
        db.put_many([(k, bytes(300)) for k in keys_n(30, tag="po")],
                    opts=WriteOptions(parallel_copy=False))
        assert tids == {threading.get_ident()}
        db.value_wal.copy_fault = None
        db.close()

    def test_killed_copy_admits_only_written_records(self, tmpdir):
        """Engine-level crash fuzz: a put_many whose copier dies mid-batch
        raises, and after reopen exactly the fully-copied records are
        visible — each with its correct value — never a torn one."""
        ks = keys_n(60, tag="kc")
        db = TideDB(os.path.join(tmpdir, "a"), self._cfg())
        calls = {"n": 0}

        def fault(idx):
            calls["n"] += 1
            if calls["n"] > 2:               # let two sub-runs land
                raise RuntimeError("copier killed")

        db.value_wal.copy_fault = fault
        with pytest.raises(RuntimeError):
            db.put_many([(k, b"x" * 300) for k in ks])
        db.value_wal.copy_fault = None
        db.close(flush=False)

        db = TideDB(os.path.join(tmpdir, "a"), self._cfg())
        wrote = {k: db.get(k) for k in ks}
        seen = {v for v in wrote.values() if v is not None}
        assert seen <= {b"x" * 300}          # visible ⇒ fully copied
        assert any(v is None for v in wrote.values())  # the kill dropped some
        db.close()


class TestDeleteManyEpochs:
    def test_matches_scalar_deletes(self, tmpdir):
        """ROADMAP leftover: delete_many takes an aligned epochs= vector;
        tombstone payload epochs and per-segment pruning ranges must be
        identical to N scalar deletes."""
        from repro_torch.core.tidestore.wal import decode_tombstone
        ks = keys_n(40, tag="de")
        eps = [i // 8 + 1 for i in range(len(ks))]
        cfg = small_cfg(wal=WalConfig(segment_size=1024, background=False))
        d1, d2 = os.path.join(tmpdir, "a"), os.path.join(tmpdir, "b")
        db1, db2 = TideDB(d1, cfg), TideDB(d2, cfg)
        assert db1.delete_many(ks, epochs=eps) == \
            [db2.delete(k, epoch=e) for k, e in zip(ks, eps)]
        assert db1.value_wal.segment_epochs() == \
            db2.value_wal.segment_epochs()
        got = {key: epoch
               for _, rtype, payload in db1.value_wal.iter_records()
               if rtype == T_TOMBSTONE
               for _, key, epoch in [decode_tombstone(payload)]}
        assert got == dict(zip(ks, eps))
        db1.close()
        db2.close()

    def test_misaligned_rejected_and_handle_spelling(self, tmpdir):
        with TideDB(tmpdir, small_cfg()) as db:
            with pytest.raises(ValueError):
                db.delete_many(keys_n(3), epochs=[1])
            h = db.keyspace("default")
            h.delete_many(keys_n(5, tag="h"), epochs=[2] * 5)
            assert 2 in {rng[1] for rng in
                         db.value_wal.segment_epochs().values()}

    def test_sharded_epochs_split_aligned_with_keys(self, tmpdir):
        """The epochs vector splits per shard alongside its keys: every
        shard's segment pruning ranges match the scalar oracle's."""
        ks = keys_n(60, tag="sh")
        eps = [(i % 4) + 1 for i in range(len(ks))]
        with ShardedTideDB(os.path.join(tmpdir, "a"), small_cfg(),
                           n_shards=3) as s1, \
                ShardedTideDB(os.path.join(tmpdir, "b"), small_cfg(),
                              n_shards=3) as s2:
            s1.put_many([(k, b"x") for k in ks])
            for k in ks:
                s2.put(k, b"x")
            assert s1.delete_many(ks, epochs=eps) == \
                [s2.delete(k, epoch=e) for k, e in zip(ks, eps)]
            for a, b in zip(s1.shards, s2.shards):
                assert a.value_wal.segment_epochs() == \
                    b.value_wal.segment_epochs()
            assert s1.multi_exists(ks) == [False] * len(ks)


# ----------------------------------------------------- engine-level writes
class TestPutMany:
    def test_recovers_to_scalar_key_position_map(self, tmpdir):
        """Acceptance: a store written via append_many recovers to the same
        key→position map as the same ops applied scalar."""
        ks = keys_n(300)
        d1, d2 = os.path.join(tmpdir, "a"), os.path.join(tmpdir, "b")
        db1, db2 = TideDB(d1, small_cfg()), TideDB(d2, small_cfg())
        p1 = db1.put_many([(k, b"v%03d" % i) for i, k in enumerate(ks)])
        p2 = [db2.put(k, b"v%03d" % i) for i, k in enumerate(ks)]
        assert p1 == p2
        db1.delete_many(ks[:40])
        for k in ks[:40]:
            db2.delete(k)
        db1.close(flush=False)
        db2.close(flush=False)

        db1, db2 = TideDB(d1, small_cfg()), TideDB(d2, small_cfg())
        for k in ks:
            assert db1.table.get_position(0, k) == db2.table.get_position(0, k)
            assert db1.get(k) == db2.get(k)
        db1.close()
        db2.close()

    def test_same_key_repeated_last_wins(self, tmpdir):
        with TideDB(tmpdir, small_cfg()) as db:
            k = keys_n(1)[0]
            db.put_many([(k, b"first"), (k, b"second"), (k, b"third")])
            assert db.get(k) == b"third"

    def test_one_shot_iterables_are_applied(self, tmpdir):
        """Regression: put_many/delete_many read their input twice; a
        generator argument must not leave WAL records unapplied to the
        index (writes silently invisible until crash replay)."""
        with TideDB(tmpdir, small_cfg()) as db:
            ks = keys_n(30, tag="gen")
            db.put_many((k, b"g%d" % i) for i, k in enumerate(ks))
            assert db.multi_get(ks) == [b"g%d" % i for i in range(30)]
            db.delete_many(k for k in ks[:10])
            assert db.multi_exists(ks) == [False] * 10 + [True] * 20

    def test_invalidates_cached_values(self, tmpdir):
        with TideDB(tmpdir, small_cfg()) as db:
            ks = keys_n(20)
            db.put_many([(k, b"old") for k in ks])
            assert all(v == b"old" for v in db.multi_get(ks))  # fills cache
            db.put_many([(k, b"new") for k in ks])
            assert all(db.get(k) == b"new" for k in ks)
            db.delete_many(ks[:5])
            assert all(db.get(k) is None for k in ks[:5])

    def test_sync_durability_flushes(self, tmpdir):
        with TideDB(tmpdir, small_cfg()) as db:
            ks = keys_n(10)
            db.put_many([(k, b"d") for k in ks],
                        opts=WriteOptions(durability="sync"))
            assert not db.value_wal._dirty_segments  # all fsynced

    def test_handle_and_epoch_spellings(self, tmpdir):
        with TideDB(tmpdir, small_cfg()) as db:
            h = db.keyspace("default")
            ks = keys_n(10, tag="h")
            h.put_many([(k, b"hv") for k in ks])
            assert all(h.get(k) == b"hv" for k in ks)
            db.put_many([(k, b"e") for k in ks], epoch=3)
            assert 3 in {rng[1] for rng in
                         db.value_wal.segment_epochs().values()}

    def test_sharded_put_many_parity(self, tmpdir):
        ks = keys_n(200, tag="s")
        with ShardedTideDB(os.path.join(tmpdir, "s"), small_cfg(),
                           n_shards=3) as sdb:
            positions = sdb.put_many([(k, b"sv%03d" % i)
                                      for i, k in enumerate(ks)])
            assert len(positions) == len(ks) and None not in positions
            assert sdb.multi_get(ks) == [b"sv%03d" % i
                                         for i in range(len(ks))]
            sdb.delete_many(ks[::2])
            assert all(sdb.get(k) is None for k in ks[::2])
            assert all(sdb.get(k) is not None for k in ks[1::2])


class TestPerRecordEpochs:
    def test_segment_epochs_match_scalar_appends(self, tmpdir):
        """Regression (ROADMAP write follow-on): one mixed-epoch batch
        spanning segments must tag each segment with ONLY the epochs of the
        records landing in it — previously the whole batch's single epoch
        tagged every touched segment."""
        recs = _records([60, 120, 30, 200, 90, 40, 180, 15] * 4)
        eps = [(i % 5) + 1 for i in range(len(recs))]
        w1 = _wal(os.path.join(tmpdir, "a"))
        w2 = _wal(os.path.join(tmpdir, "b"))
        assert w1.append_many(recs, epochs=eps) == \
            [w2.append(t, p, epoch=e) for (t, p), e in zip(recs, eps)]
        assert w1.segment_epochs() == w2.segment_epochs()
        for probe in (1, 3, 6):
            assert w1.segments_expired_below_epoch(probe) == \
                w2.segments_expired_below_epoch(probe)
        w1.close()
        w2.close()

    def test_uniform_epoch_unchanged_and_misaligned_rejected(self, tmpdir):
        w = _wal(tmpdir)
        recs = _records([50, 50, 50])
        w.append_many(recs, epoch=7)
        assert all(rng == (7, 7) for rng in w.segment_epochs().values())
        with pytest.raises(ValueError):
            w.append_many(recs, epochs=[1, 2])   # must align 1:1
        w.close()

    def test_put_many_triples_tag_per_record(self, tmpdir):
        """(key, value, epoch) triples flow through the whole pipeline:
        payload epochs round-trip via replay and segment ranges match the
        same ops issued scalar."""
        from repro_torch.core.tidestore.wal import decode_entry
        ks = keys_n(40, tag="ep")
        items = [(k, b"v%02d" % i, i // 8 + 1) for i, k in enumerate(ks)]
        d1, d2 = os.path.join(tmpdir, "a"), os.path.join(tmpdir, "b")
        cfg = small_cfg(wal=WalConfig(segment_size=1024, background=False))
        db1, db2 = TideDB(d1, cfg), TideDB(d2, cfg)
        assert db1.put_many(items) == \
            [db2.put(k, v, epoch=e) for k, v, e in items]
        assert db1.value_wal.segment_epochs() == \
            db2.value_wal.segment_epochs()
        got = {key: epoch for _, rtype, payload in db1.value_wal.iter_records()
               if rtype == T_ENTRY
               for _, key, _, epoch in [decode_entry(payload)]}
        assert got == {k: e for k, _, e in items}
        assert db1.multi_get(ks) == db2.multi_get(ks)
        db1.close()
        db2.close()


class TestApplyManyParity:
    def test_conflict_rule_matches_scalar_apply(self, tmpdir):
        d1, d2 = os.path.join(tmpdir, "a"), os.path.join(tmpdir, "b")
        db1, db2 = TideDB(d1, small_cfg()), TideDB(d2, small_cfg())
        k = keys_n(1)[0]
        # Higher WAL position always wins, regardless of apply order.
        items = [(0, k, 500), (0, k, 100), (0, k, 900), (0, k, 200)]
        db1.table.apply_many(items)
        for ks_id, key, marker in items:
            db2.table.apply(ks_id, key, marker)
        assert db1.table.get_position(0, k) == db2.table.get_position(0, k) \
            == 900
        db1.close(flush=False)
        db2.close(flush=False)


class TestServerWriteStages:
    def test_mixed_stream_matches_scalar(self, tmpdir):
        from repro_torch.serving.engine import KvBatchServer
        ks = keys_n(60, tag="srv")
        with TideDB(os.path.join(tmpdir, "a"), small_cfg()) as db, \
                TideDB(os.path.join(tmpdir, "b"), small_cfg()) as oracle:
            srv = KvBatchServer(db, max_batch=64)
            handles = []
            for i, k in enumerate(ks):
                handles.append(srv.submit_put(k, b"x%03d" % i))
                oracle.put(k, b"x%03d" % i)
            # same key put+delete in one stage: order must be preserved
            handles.append(srv.submit_put(ks[0], b"updated"))
            handles.append(srv.submit_delete(ks[1]))
            handles.append(srv.submit_delete(ks[0]))
            oracle.put(ks[0], b"updated")
            oracle.delete(ks[1])
            oracle.delete(ks[0])
            srv.run_until_drained()
            assert all(h.done for h in handles)
            for k in ks:
                assert db.get(k) == oracle.get(k)
            s = srv.stats()
            assert s["write_stages"] >= 1
            assert s["write_bytes"] > 0
            assert s["mean_write_stage_records"] > 1

    def test_aliased_keyspace_spellings_keep_order(self, tmpdir):
        """0 and "default" name the same keyspace: same-key puts under
        both spellings in one stage must land in ONE group, or the later
        group's higher WAL position would invert submission order."""
        from repro_torch.serving.engine import KvBatchServer
        with TideDB(tmpdir, small_cfg()) as db:
            srv = KvBatchServer(db, max_batch=64)
            kx, ky = keys_n(2, tag="alias")
            srv.submit_put(ky, b"other", keyspace=0)
            srv.submit_put(kx, b"second", keyspace="default")
            srv.submit_put(kx, b"last", keyspace=0)
            srv.run_until_drained()
            assert db.get(kx) == b"last"

    def test_pure_put_stage_uses_append_many(self, tmpdir):
        from repro_torch.serving.engine import KvBatchServer
        with TideDB(tmpdir, small_cfg()) as db:
            srv = KvBatchServer(db, max_batch=64)
            for i, k in enumerate(keys_n(50, tag="p")):
                srv.submit_put(k, b"v%03d" % i)
            srv.run_until_drained()
            assert db.metrics.batched_write_records == 50
            assert db.metrics.batched_append_runs >= 1

    def test_write_opts_thread_through_every_stage_kind(self, tmpdir):
        """The server's write_opts reach both retirement paths — the
        put_many/delete_many groups AND the same-key write_batch fallback
        — here observed via sync durability leaving nothing dirty."""
        from repro_torch.serving.engine import KvBatchServer
        with TideDB(tmpdir, small_cfg()) as db:
            srv = KvBatchServer(db, max_batch=64,
                                write_opts=WriteOptions(durability="sync"))
            ks = keys_n(20, tag="wo")
            for i, k in enumerate(ks):
                srv.submit_put(k, b"v%03d" % i)
            # same key under both ops in one stage → write_batch fallback
            srv.submit_put(ks[0], b"again")
            srv.submit_delete(ks[0])
            srv.run_until_drained()
            assert srv.stats()["writes_served"] == len(ks) + 2
            assert not db.value_wal._dirty_segments
            assert db.get(ks[0]) is None
