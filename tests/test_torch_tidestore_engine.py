"""Tidestore engine tests: behaviour, crash recovery, relocation, concurrency.

The port's mirror of ``tests/test_tidestore.py``: ``repro`` → ``repro_torch``,
``device="cpu"`` at each config; no case left out.
"""
import glob
import hashlib
import os
import shutil
import struct
import tempfile
import threading

import pytest

from repro_torch.core.tidestore import (DbConfig, Decision, KeyspaceConfig, TideDB)
from repro_torch.core.tidestore.large_table import CellState
from repro_torch.core.tidestore.wal import T_ENTRY, Wal, WalConfig


def small_cfg(**kw):
    defaults = dict(
        keyspaces=[KeyspaceConfig("default", n_cells=16, dirty_flush_threshold=64)],
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
    d = tempfile.mkdtemp(prefix="tide-test-")
    yield d
    shutil.rmtree(d, ignore_errors=True)


# ------------------------------------------------------------------ basics
class TestBasicOps:
    def test_put_get_delete_exists(self, tmpdir):
        with TideDB(tmpdir, small_cfg()) as db:
            ks = keys_n(300)
            for i, k in enumerate(ks):
                db.put(k, b"v%06d" % i)
            assert db.get(ks[0]) == b"v000000"
            assert db.get(ks[299]) == b"v000299"
            assert db.exists(ks[150])
            assert not db.exists(hashlib.sha256(b"absent").digest())
            db.delete(ks[5])
            assert db.get(ks[5]) is None
            assert not db.exists(ks[5])

    def test_overwrite_latest_wins(self, tmpdir):
        with TideDB(tmpdir, small_cfg()) as db:
            k = keys_n(1)[0]
            for i in range(50):
                db.put(k, b"ver%04d" % i)
            assert db.get(k) == b"ver0049"

    def test_reads_through_disk_index(self, tmpdir):
        with TideDB(tmpdir, small_cfg(cache_bytes=0)) as db:
            ks = keys_n(500)
            for i, k in enumerate(ks):
                db.put(k, b"d%06d" % i)
            db.snapshot_now(flush_threshold=1)
            # user keyspace only: most reserved __system cells stay EMPTY
            states = {c.state for ks_id, c in db.table.all_cells()
                      if ks_id == 0}
            assert states == {CellState.UNLOADED}
            for i, k in enumerate(ks):
                assert db.get(k) == b"d%06d" % i
            # negative lookups resolve via bloom without index I/O
            before = db.metrics.index_lookups
            for k in keys_n(100, tag="miss-"):
                assert not db.exists(k)
            assert db.metrics.bloom_negative >= 95  # a few FPs allowed

    def test_header_index_format(self, tmpdir):
        cfg = small_cfg(keyspaces=[KeyspaceConfig(
            "default", n_cells=8, index_format="header", dirty_flush_threshold=64)])
        with TideDB(tmpdir, cfg) as db:
            ks = keys_n(400)
            for i, k in enumerate(ks):
                db.put(k, b"h%06d" % i)
            db.snapshot_now(flush_threshold=1)
            for i, k in enumerate(ks):
                assert db.get(k) == b"h%06d" % i
            assert not db.exists(hashlib.sha256(b"no").digest())

    def test_dirty_unloaded_buffers_without_load(self, tmpdir):
        with TideDB(tmpdir, small_cfg()) as db:
            ks = keys_n(300)
            for i, k in enumerate(ks):
                db.put(k, b"x%06d" % i)
            db.snapshot_now(flush_threshold=1)
            # a write to a cold cell must not load the disk index
            newk = keys_n(1, tag="new-")[0]
            db.put(newk, b"fresh")
            cell = db.table.ks(0).cell_for_key(newk)
            assert cell.state == CellState.DIRTY_UNLOADED
            assert len(cell.mem) == 1           # only the new entry buffered
            assert db.get(newk) == b"fresh"
            # old entries in the same cell still readable via point lookup
            for k in ks:
                if db.table.ks(0).cell_id_for_key(k) == cell.cell_id:
                    assert db.get(k) is not None

    def test_batch_atomicity_and_positions(self, tmpdir):
        with TideDB(tmpdir, small_cfg()) as db:
            ks = keys_n(10)
            db.write_batch([("put", 0, k, b"b%d" % i) for i, k in enumerate(ks)])
            for i, k in enumerate(ks):
                assert db.get(k) == b"b%d" % i
            db.write_batch([("del", 0, ks[0]), ("put", 0, ks[1], b"upd")])
            assert db.get(ks[0]) is None
            assert db.get(ks[1]) == b"upd"

    def test_reverse_iterator(self, tmpdir):
        with TideDB(tmpdir, small_cfg()) as db:
            ks = sorted(keys_n(200))
            for i, k in enumerate(ks):
                db.put(k, b"r%06d" % i)
            db.delete(ks[100])
            got = db.prev(ks[101])
            assert got is not None and got[0] == ks[99]  # skips tombstone
            assert db.prev(ks[0]) is None
            got = db.prev(b"\xff" * 32)
            assert got[0] == ks[199]
            # across flush
            db.snapshot_now(flush_threshold=1)
            got = db.prev(ks[101])
            assert got[0] == ks[99]

    def test_multiple_keyspaces(self, tmpdir):
        cfg = small_cfg(keyspaces=[
            KeyspaceConfig("objects", n_cells=8),
            KeyspaceConfig("meta", n_cells=4, key_len=16),
        ])
        with TideDB(tmpdir, cfg) as db:
            k = keys_n(1)[0]
            db.put(k, b"obj", keyspace="objects")
            db.put(k[:16], b"meta", keyspace="meta")
            assert db.get(k, keyspace="objects") == b"obj"
            assert db.get(k[:16], keyspace="meta") == b"meta"
            assert db.get(k[:16], keyspace="objects") is None

    def test_prefix_keyspace(self, tmpdir):
        cfg = small_cfg(keyspaces=[KeyspaceConfig(
            "composite", distribution="prefix", prefix_len=4, key_len=32)])
        with TideDB(tmpdir, cfg) as db:
            for tenant in range(5):
                for rec in range(50):
                    key = struct.pack(">I", tenant) + hashlib.sha256(
                        str(rec).encode()).digest()[:28]
                    db.put(key, b"t%dr%d" % (tenant, rec))
            key = struct.pack(">I", 3) + hashlib.sha256(b"7").digest()[:28]
            assert db.get(key) == b"t3r7"
            assert len(db.table.ks(0).cells) == 5   # one cell per prefix


# ---------------------------------------------------------------- recovery
class TestRecovery:
    def test_clean_restart(self, tmpdir):
        cfg = small_cfg()
        ks = keys_n(300)
        with TideDB(tmpdir, cfg) as db:
            for i, k in enumerate(ks):
                db.put(k, b"c%06d" % i)
            db.delete(ks[10])
        with TideDB(tmpdir, cfg) as db:
            assert db.get(ks[0]) == b"c000000"
            assert db.get(ks[299]) == b"c000299"
            assert db.get(ks[10]) is None

    def test_crash_without_close(self, tmpdir):
        cfg = small_cfg()
        ks = keys_n(300)
        db = TideDB(tmpdir, cfg)
        for i, k in enumerate(ks[:200]):
            db.put(k, b"s%06d" % i)
        db.snapshot_now()
        for i, k in enumerate(ks[200:], start=200):
            db.put(k, b"s%06d" % i)
        # abandon db without close: state = page cache only
        db2 = TideDB(tmpdir, cfg)
        for i, k in enumerate(ks):
            assert db2.get(k) == b"s%06d" % i
        db2.close()

    def test_torn_tail_write(self, tmpdir):
        cfg = small_cfg()
        ks = keys_n(300)
        db = TideDB(tmpdir, cfg)
        for i, k in enumerate(ks):
            db.put(k, b"t%06d" % i)
        tail = db.value_wal.tail
        seg = (tail - 5) // cfg.wal.segment_size
        with open(os.path.join(tmpdir, f"value-{seg:010d}.seg"), "r+b") as f:
            f.seek((tail - 5) % cfg.wal.segment_size)
            f.write(b"\xde\xad\xbe\xef")
        db2 = TideDB(tmpdir, cfg)
        ok = sum(db2.get(k) == b"t%06d" % i for i, k in enumerate(ks[:299]))
        assert ok == 299
        assert db2.get(ks[299]) is None      # torn record dropped, not garbage
        db2.close()

    def test_torn_batch_dropped_wholesale(self, tmpdir):
        cfg = small_cfg()
        db = TideDB(tmpdir, cfg)
        ks = keys_n(20)
        for k in ks[:10]:
            db.put(k, b"pre")
        db.write_batch([("put", 0, k, b"batch") for k in ks[10:]])
        tail = db.value_wal.tail
        # corrupt the middle of the batch body
        pos = tail - 40
        seg = pos // cfg.wal.segment_size
        with open(os.path.join(tmpdir, f"value-{seg:010d}.seg"), "r+b") as f:
            f.seek(pos % cfg.wal.segment_size)
            f.write(b"\x00" * 8)
        db2 = TideDB(tmpdir, cfg)
        for k in ks[:10]:
            assert db2.get(k) == b"pre"
        # atomicity: the whole batch is gone, not a prefix of it
        batch_vis = [db2.get(k) for k in ks[10:]]
        assert all(v is None for v in batch_vis)
        db2.close()

    def test_recovery_is_lazy(self, tmpdir):
        """After restart cells stay UNLOADED; reads use optimistic lookups."""
        cfg = small_cfg(cache_bytes=0)
        ks = keys_n(500)
        with TideDB(tmpdir, cfg) as db:
            for i, k in enumerate(ks):
                db.put(k, b"z%06d" % i)
        db2 = TideDB(tmpdir, cfg)
        assert all(c.state in (CellState.UNLOADED, CellState.EMPTY)
                   for _, c in db2.table.all_cells())
        assert db2.get(ks[123]) == b"z%06d" % 123
        assert db2.metrics.index_lookups >= 1
        db2.close()


# -------------------------------------------------------------- relocation
class TestRelocation:
    def test_wal_relocation_reclaims(self, tmpdir):
        with TideDB(tmpdir, small_cfg()) as db:
            ks = keys_n(400)
            for i, k in enumerate(ks):
                db.put(k, bytes(100))
            for k in ks[:320]:
                db.delete(k)
            before = db.value_wal.tail - db.value_wal.first_live_pos
            moved = db.relocator.relocate_wal_based()
            db.value_wal._mapper_once()
            after = db.value_wal.tail - db.value_wal.first_live_pos
            assert moved > 0 and after < before * 0.5
            for k in ks[320:]:
                assert db.get(k) == bytes(100)
            for k in ks[:320]:
                assert db.get(k) is None

    def test_index_relocation(self, tmpdir):
        with TideDB(tmpdir, small_cfg()) as db:
            ks = keys_n(300)
            for i, k in enumerate(ks):
                db.put(k, b"i%06d" % i)
            db.snapshot_now(flush_threshold=1)
            for k in ks[:200]:
                db.delete(k)
            cutoff = db.value_wal.tracker.last_processed
            db.relocator.relocate_index_based(cutoff)
            db.value_wal._mapper_once()
            for i, k in enumerate(ks[200:], start=200):
                assert db.get(k) == b"i%06d" % i

    def test_relocation_filter_remove(self, tmpdir):
        with TideDB(tmpdir, small_cfg()) as db:
            ks = keys_n(100)
            for i, k in enumerate(ks):
                db.put(k, b"odd" if i % 2 else b"even")
            filt = lambda key, value, epoch: (
                Decision.REMOVE if value == b"odd" else Decision.KEEP)
            db.relocator.relocate_wal_based(filt=filt)
            for i, k in enumerate(ks):
                assert db.get(k) == (None if i % 2 else b"even")

    def test_relocation_concurrent_write_wins(self, tmpdir):
        """CAS semantics: a write racing relocation must not be clobbered."""
        with TideDB(tmpdir, small_cfg()) as db:
            ks = keys_n(50)
            for k in ks:
                db.put(k, b"old")
            orig = db.relocator._maybe_relocate

            def racing(ks_id, key, value, epoch, pos, tomb, filt):
                # concurrent client updates the key mid-relocation
                if not tomb and value == b"old":
                    db.put(key, b"newer")
                return orig(ks_id, key, value, epoch, pos, tomb, filt)

            db.relocator._maybe_relocate = racing
            db.relocator.relocate_wal_based()
            for k in ks:
                assert db.get(k) == b"newer"

    def test_epoch_pruning(self, tmpdir):
        with TideDB(tmpdir, small_cfg()) as db:
            for ep in range(4):
                for i in range(100):
                    db.put(hashlib.sha256(f"{ep}/{i}".encode()).digest(),
                           bytes(150), epoch=ep)
            n = db.prune_epochs_below(2)
            db.value_wal._mapper_once()
            assert n > 0
            assert db.get(hashlib.sha256(b"0/5").digest()) is None
            assert not db.exists(hashlib.sha256(b"1/5").digest())
            assert db.get(hashlib.sha256(b"3/5").digest()) == bytes(150)

    def test_write_amp_near_one_without_relocation(self, tmpdir):
        """C1: without relocation the engine writes each value ~once."""
        with TideDB(tmpdir, small_cfg()) as db:
            for i, k in enumerate(keys_n(2000)):
                db.put(k, bytes(512))
            db.snapshot_now(flush_threshold=1)
            wa = db.metrics.write_amplification
            assert wa < 1.5, wa   # value bytes 1×; small index flush overhead


# -------------------------------------------------------------- concurrency
class TestConcurrency:
    def test_parallel_writers_readers(self, tmpdir):
        cfg = small_cfg(
            wal=WalConfig(segment_size=64 * 1024, background=True),
            index_wal=WalConfig(segment_size=1024 * 1024, background=True),
            background_snapshots=True,
        )
        with TideDB(tmpdir, cfg) as db:
            errors = []
            n_per = 300

            def writer(tid):
                try:
                    for i in range(n_per):
                        k = hashlib.sha256(f"w{tid}-{i}".encode()).digest()
                        db.put(k, b"t%02d-%06d" % (tid, i))
                except Exception as e:  # pragma: no cover
                    errors.append(e)

            def reader(tid):
                try:
                    for i in range(n_per):
                        k = hashlib.sha256(f"w{tid}-{i}".encode()).digest()
                        v = db.get(k)
                        assert v in (None, b"t%02d-%06d" % (tid, i))
                except Exception as e:  # pragma: no cover
                    errors.append(e)

            ws = [threading.Thread(target=writer, args=(t,)) for t in range(4)]
            rs = [threading.Thread(target=reader, args=(t,)) for t in range(4)]
            for t in ws + rs:
                t.start()
            for t in ws + rs:
                t.join()
            assert not errors
            for tid in range(4):
                for i in range(n_per):
                    k = hashlib.sha256(f"w{tid}-{i}".encode()).digest()
                    assert db.get(k) == b"t%02d-%06d" % (tid, i)

    def test_relocation_concurrent_with_writes(self, tmpdir):
        with TideDB(tmpdir, small_cfg()) as db:
            ks = keys_n(500)
            for i, k in enumerate(ks):
                db.put(k, b"gen0-%05d" % i)
            stop = threading.Event()
            errors = []

            def updater():
                g = 1
                try:
                    while not stop.is_set():
                        for i, k in enumerate(ks[:100]):
                            db.put(k, b"gen%d-%05d" % (g, i))
                        g += 1
                except Exception as e:  # pragma: no cover
                    errors.append(e)

            t = threading.Thread(target=updater)
            t.start()
            for _ in range(3):
                db.relocator.relocate_wal_based()
            stop.set()
            t.join()
            assert not errors
            for i, k in enumerate(ks[100:], start=100):
                assert db.get(k) == b"gen0-%05d" % i
            for i, k in enumerate(ks[:100]):
                v = db.get(k)
                assert v is not None and v.endswith(b"-%05d" % i)
