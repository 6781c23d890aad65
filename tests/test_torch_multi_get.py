"""Batched read pipeline: multi_get / multi_exists vs the scalar path.

Covers the batched-read acceptance matrix: present keys,
missing keys, tombstones, empty values, duplicates, keys spanning multiple
keyspaces/cells, kernel-on vs kernel-off, both index formats, prefix
keyspaces (per-key fallback), close/reopen recovery, the coalesced WAL
batch read, the vectorized Bloom pass, and the KvBatchServer serve path.

The port's mirror of ``tests/test_multi_get.py``: the same cases and
assertions over the port's ``TideDB``, every store on ``device="cpu"``,
where the batched reads take the kernels' plain versions.
"""
import hashlib
import shutil
import struct
import tempfile
import threading

import numpy as np
import pytest

from repro_torch.core.tidestore import DbConfig, KeyspaceConfig, TideDB
from repro_torch.core.tidestore.bloom import BloomFilter, key_hashes_many
from repro_torch.core.tidestore.wal import T_ENTRY, Wal, WalConfig


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


def keys_n(n, tag=""):
    return [hashlib.sha256(f"{tag}{i}".encode()).digest() for i in range(n)]


@pytest.fixture()
def tmpdir():
    d = tempfile.mkdtemp(prefix="tide-batch-test-")
    yield d
    shutil.rmtree(d, ignore_errors=True)


def mixed_workload(db):
    """Insert a mixed workload; returns the probe list covering every case."""
    present = keys_n(300, "p")
    missing = keys_n(100, "m")
    for i, k in enumerate(present):
        db.put(k, b"val%06d" % i)
    db.put(present[3], b"")                    # empty value
    for k in present[10:20]:
        db.delete(k)                           # tombstones
    probes = present + missing + present[:50]  # duplicates in one batch
    return probes


def assert_agrees(db, probes):
    got = db.multi_get(probes)
    want = [db.get(k) for k in probes]
    assert got == want
    gote = db.multi_exists(probes)
    wante = [db.exists(k) for k in probes]
    assert gote == wante


class TestMultiGetAgreement:
    def test_in_memory(self, tmpdir):
        with TideDB(tmpdir, small_cfg()) as db:
            probes = mixed_workload(db)
            assert_agrees(db, probes)

    def test_after_flush_unloaded_cells(self, tmpdir):
        """Post-flush, cells are UNLOADED: the blob + kernel path serves."""
        with TideDB(tmpdir, small_cfg(cache_bytes=0)) as db:
            probes = mixed_workload(db)
            db.snapshot_now(flush_threshold=1)
            before = db.metrics.snapshot()
            assert_agrees(db, probes)
            after = db.metrics.snapshot()
            assert after["batched_blob_reads"] > before["batched_blob_reads"]
            assert after["batched_kernel_lookups"] > \
                before["batched_kernel_lookups"]
            assert after["bloom_negative"] > before["bloom_negative"]
            # A repeat batch serves from the parsed-blob memo cache —
            # no new blob reads, and memoized cells skip the Bloom pass.
            assert_agrees(db, probes)
            final = db.metrics.snapshot()
            assert final["blob_cache_hits"] > 0
            assert final["batched_blob_reads"] == after["batched_blob_reads"]

    def test_kernel_off_agrees(self, tmpdir):
        with TideDB(tmpdir, small_cfg(batched_kernels=False,
                                      cache_bytes=0)) as db:
            probes = mixed_workload(db)
            db.snapshot_now(flush_threshold=1)
            assert_agrees(db, probes)
            assert db.metrics.batched_kernel_lookups == 0

    def test_header_index_format(self, tmpdir):
        cfg = small_cfg(keyspaces=[KeyspaceConfig(
            "default", n_cells=8, index_format="header",
            dirty_flush_threshold=64)], cache_bytes=0)
        with TideDB(tmpdir, cfg) as db:
            probes = mixed_workload(db)
            db.snapshot_now(flush_threshold=1)
            assert_agrees(db, probes)

    def test_across_close_reopen(self, tmpdir):
        cfg = small_cfg()
        with TideDB(tmpdir, cfg) as db:
            probes = mixed_workload(db)
            db.snapshot_now(flush_threshold=1)
            want = [db.get(k) for k in probes]
        with TideDB(tmpdir, cfg) as db2:
            assert db2.multi_get(probes) == want
            assert db2.multi_exists(probes) == [v is not None for v in want]

    def test_multiple_keyspaces(self, tmpdir):
        cfg = small_cfg(keyspaces=[
            KeyspaceConfig("objects", n_cells=8),
            KeyspaceConfig("meta", n_cells=4, key_len=16),
        ])
        with TideDB(tmpdir, cfg) as db:
            ks = keys_n(60)
            for i, k in enumerate(ks):
                db.put(k, b"obj%d" % i, keyspace="objects")
                db.put(k[:16], b"meta%d" % i, keyspace="meta")
            db.snapshot_now(flush_threshold=1)
            assert db.multi_get(ks, keyspace="objects") == \
                [db.get(k, keyspace="objects") for k in ks]
            m16 = [k[:16] for k in ks]
            assert db.multi_get(m16, keyspace="meta") == \
                [db.get(k, keyspace="meta") for k in m16]
            # objects-keyspace probes with meta keys: all absent
            assert db.multi_exists(m16, keyspace="objects") == [False] * 60

    def test_prefix_keyspace_perkey_fallback(self, tmpdir):
        cfg = small_cfg(keyspaces=[KeyspaceConfig(
            "composite", distribution="prefix", prefix_len=4, key_len=32)])
        with TideDB(tmpdir, cfg) as db:
            probes = []
            for tenant in range(4):
                for rec in range(30):
                    key = struct.pack(">I", tenant) + hashlib.sha256(
                        str(rec).encode()).digest()[:28]
                    db.put(key, b"t%dr%d" % (tenant, rec))
                    probes.append(key)
            probes += [struct.pack(">I", 9) + bytes(28)]   # absent tenant
            db.snapshot_now(flush_threshold=1)
            assert_agrees(db, probes)

    def test_empty_batch_and_cache_fill(self, tmpdir):
        with TideDB(tmpdir, small_cfg()) as db:
            assert db.multi_get([]) == []
            assert db.multi_exists([]) == []
            ks = keys_n(100)
            for i, k in enumerate(ks):
                db.put(k, b"c%d" % i)
            db.snapshot_now(flush_threshold=1)
            db.cache.clear()
            db.multi_get(ks)                     # fills the cache once
            h0 = db.metrics.cache_hits
            assert db.multi_get(ks) == [b"c%d" % i for i in range(100)]
            assert db.metrics.cache_hits - h0 == 100

    def test_concurrent_writers(self, tmpdir):
        cfg = small_cfg(
            wal=WalConfig(segment_size=64 * 1024, background=True),
            index_wal=WalConfig(segment_size=1024 * 1024, background=True),
            background_snapshots=True)
        with TideDB(tmpdir, cfg) as db:
            errors = []
            n_per = 200

            def writer(tid):
                try:
                    for i in range(n_per):
                        k = hashlib.sha256(f"w{tid}-{i}".encode()).digest()
                        db.put(k, b"t%02d-%06d" % (tid, i))
                except Exception as e:  # pragma: no cover
                    errors.append(e)

            def batch_reader(tid):
                try:
                    ks = [hashlib.sha256(f"w{tid}-{i}".encode()).digest()
                          for i in range(n_per)]
                    for _ in range(5):
                        for v, i in zip(db.multi_get(ks), range(n_per)):
                            assert v in (None, b"t%02d-%06d" % (tid, i))
                except Exception as e:  # pragma: no cover
                    errors.append(e)

            ts = [threading.Thread(target=writer, args=(t,)) for t in range(3)]
            rs = [threading.Thread(target=batch_reader, args=(t,))
                  for t in range(3)]
            for t in ts + rs:
                t.start()
            for t in ts + rs:
                t.join()
            assert not errors
            for tid in range(3):
                ks = [hashlib.sha256(f"w{tid}-{i}".encode()).digest()
                      for i in range(n_per)]
                assert db.multi_get(ks) == \
                    [b"t%02d-%06d" % (tid, i) for i in range(n_per)]


class TestWalBatchRead:
    def test_coalesced_runs_match_read_record(self, tmpdir):
        wal = Wal(tmpdir, "value", WalConfig(segment_size=16 * 1024,
                                             background=False))
        positions = []
        for i in range(200):
            payload = b"p%04d" % i * (1 + i % 7)
            pos = wal.append(T_ENTRY, payload)
            wal.mark_processed(pos, len(payload))
            positions.append(pos)
        got = wal.read_records_batch(positions)
        assert set(got) == set(positions)
        for p in positions:
            assert got[p] == wal.read_record(p)
        assert wal.metrics.batched_read_runs < len(positions) / 4
        # sparse subset still correct (forces gap splitting)
        sparse = positions[::17]
        got = wal.read_records_batch(sparse, max_gap=64)
        for p in sparse:
            assert got[p] == wal.read_record(p)
        # bogus positions are absent, not wrong
        assert wal.read_records_batch([positions[-1] + 3]) == {}
        wal.close()

    def test_long_run_on_missing_segment_is_empty(self, tmpdir):
        """A >=32-position run whose segment vanished (GC race) must come
        back empty, not crash the vectorized header parse."""
        wal = Wal(tmpdir, "value", WalConfig(segment_size=16 * 1024,
                                             background=False,
                                             preallocate=False))
        ghosts = list(range(0, 40 * 20, 20))     # one coalesced run of 40
        assert wal.read_records_batch(ghosts) == {}
        wal.close()


class TestBloomBatch:
    def test_no_false_negatives_and_scalar_agreement(self):
        bf = BloomFilter(500, bits_per_key=10)
        added = keys_n(400, "a")
        probes = keys_n(300, "q")
        bf.add_many(added)
        # batch answers == scalar answers on both paths
        for use_kernel in (False, True):
            got = bf.might_contain_many(added + probes, use_kernel=use_kernel,
                                        device="cpu")
            want = np.array([bf.might_contain(k) for k in added + probes])
            np.testing.assert_array_equal(got, want)
            assert got[:400].all()               # no false negatives
        assert float(np.mean(got[400:])) < 0.2   # bounded false positives

    def test_precomputed_hashes(self):
        bf = BloomFilter(64)
        ks = keys_n(50, "h")
        bf.add_many(ks)
        h1, h2 = key_hashes_many(ks)
        np.testing.assert_array_equal(
            bf.might_contain_many(ks, h1=h1, h2=h2),
            np.ones(50, dtype=bool))


class TestKvBatchServer:
    def test_serves_batches_matching_scalar(self, tmpdir):
        from repro_torch.serving.engine import KvBatchServer
        with TideDB(tmpdir, small_cfg()) as db:
            ks = keys_n(150, "s")
            for i, k in enumerate(ks):
                db.put(k, b"srv%05d" % i)
            db.delete(ks[5])
            db.snapshot_now(flush_threshold=1)
            srv = KvBatchServer(db, max_batch=64)
            gets = [srv.submit_get(k) for k in ks]
            exs = [srv.submit_exists(k) for k in ks + keys_n(20, "nope")]
            served = srv.run_until_drained()
            assert served == len(gets) + len(exs)
            for i, r in enumerate(gets):
                assert r.done and r.value == db.get(ks[i])
            for r, k in zip(exs, ks + keys_n(20, "nope")):
                assert r.done and r.found == db.exists(k)
            st = srv.stats()
            assert st["queued"] == 0
            assert st["batches_served"] >= (len(gets) + len(exs)) // 64
            assert st["mean_batch"] > 1
