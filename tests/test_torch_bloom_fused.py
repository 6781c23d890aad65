"""Fused ragged Bloom-probe tier: ``probe_cells`` parity with scalar
``might_contain`` (hypothesis fuzz over ragged group shapes, empty cells,
pow2 padding boundaries), the one-dispatch-per-store invariant on
``multi_exists``, and tombstone visibility through the fused path across a
crash/reopen (incl. ``min_live_pin`` snapshot reads).

The port's mirror of ``tests/test_bloom_fused.py``: ``repro`` → ``repro_torch``,
``device="cpu"`` at each config and probe; no case left out.
"""
import hashlib
import shutil
import tempfile

import numpy as np
import pytest

from repro_torch.core.tidestore import (DbConfig, KeyspaceConfig, ReadOptions,
                                  TideDB)
from repro_torch.core.tidestore.bloom import (BloomFilter, key_hashes,
                                        key_hashes_many, probe_cells)
from repro_torch.core.tidestore.wal import WalConfig

from tests.hypothesis_compat import HealthCheck, given, settings, st

SETTINGS = settings(max_examples=20, deadline=None,
                    suppress_health_check=[HealthCheck.too_slow])


def keys_n(n, tag=""):
    return [hashlib.sha256(f"{tag}{i}".encode()).digest() for i in range(n)]


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


@pytest.fixture()
def tmpdir():
    d = tempfile.mkdtemp(prefix="tide-fused-")
    yield d
    shutil.rmtree(d, ignore_errors=True)


def oracle_contains(bf: BloomFilter, key: bytes) -> bool:
    """Independent oracle: the documented probe arithmetic in pure python
    ints — shares no code with probe_cells or the kernel."""
    h1, h2 = key_hashes(key)
    for i in range(bf.k):
        idx = ((h1 + i * h2) & 0xFFFFFFFF) % bf.nbits
        if not (int(bf.bits[idx >> 5]) >> (idx & 31)) & 1:
            return False
    return True


def build_cells(spec, tag="c"):
    """spec: list of (expected_entries, n_added) → (cells, added_keys)."""
    cells, added = [], []
    for ci, (expected, n_add) in enumerate(spec):
        bf = BloomFilter(expected, bits_per_key=10)
        ks = keys_n(n_add, f"{tag}{ci}-")
        bf.add_many(ks)
        cells.append(bf)
        added.append(ks)
    return cells, added


def ragged_queries(added, n_miss_per_cell, tag="m"):
    """Round-robin present+absent queries per cell → (queries, groups)."""
    queries, groups = [], []
    for ci, ks in enumerate(added):
        g = []
        for k in ks:
            g.append(len(queries))
            queries.append(k)
        for k in keys_n(n_miss_per_cell, f"{tag}{ci}-"):
            g.append(len(queries))
            queries.append(k)
        groups.append(np.asarray(g, dtype=np.int64))
    return queries, groups


class TestProbeCellsParity:
    @pytest.mark.parametrize("use_kernel", [False, True])
    def test_ragged_matches_oracle(self, use_kernel):
        """Ragged shapes, an empty cell, pow2-boundary filter sizes — the
        fused answer equals the independent per-key oracle, under both
        routings (the kernel threshold scales per cell, so the big config
        actually dispatches)."""
        spec = [(1, 0), (6, 6), (7, 7), (500, 400), (64, 64), (100, 90)]
        cells, added = build_cells(spec)
        queries, groups = ragged_queries(added, 70)
        h1, h2 = key_hashes_many(queries)
        got = probe_cells(cells, h1, h2, groups, use_kernel=use_kernel,
                           device="cpu")
        want = np.zeros(len(queries), dtype=bool)
        for ci, g in enumerate(groups):
            for qi in g:
                want[qi] = oracle_contains(cells[ci], queries[qi])
        np.testing.assert_array_equal(got, want)
        # provably no false negatives introduced by fusion
        for ci, g in enumerate(groups):
            assert got[g[:len(added[ci])]].all()

    def test_unassigned_queries_come_back_false(self):
        cells, added = build_cells([(50, 30)])
        queries = added[0] + keys_n(10, "u")
        h1, h2 = key_hashes_many(queries)
        got = probe_cells(cells, h1, h2, [np.arange(len(added[0]))],
                          device="cpu")
        assert got[:30].all() and not got[30:].any()

    def test_empty_inputs(self):
        cells, _ = build_cells([(10, 5)])
        assert probe_cells(cells, np.zeros(0, np.uint32),
                           np.zeros(0, np.uint32), [[]],
                           device="cpu").shape == (0,)
        assert not probe_cells([], np.uint32([1]), np.uint32([1]), [],
                               device="cpu").any()
        assert not probe_cells([None], np.uint32([1]), np.uint32([1]),
                               [[0]], device="cpu").any()

    @pytest.mark.parametrize("q", [63, 64, 65, 127, 128, 129])
    def test_pow2_padding_boundaries(self, q):
        """Query counts straddling the pad buckets (and the single-cell
        kernel threshold at 64) agree with scalar answers bit for bit."""
        bf = BloomFilter(200, bits_per_key=10)
        present = keys_n(100, "p")
        bf.add_many(present)
        probes = (present + keys_n(100, "n"))[:q]
        for use_kernel in (False, True):
            got = bf.might_contain_many(probes, use_kernel=use_kernel,
                           device="cpu")
            want = np.array([oracle_contains(bf, k) for k in probes])
            np.testing.assert_array_equal(got, want)

    @given(seed=st.integers(0, 2**31 - 1),
           spec=st.lists(st.tuples(st.sampled_from([1, 3, 6, 7, 13, 51]),
                                   st.integers(0, 40)),
                         min_size=1, max_size=5),
           n_miss=st.integers(0, 30),
           use_kernel=st.booleans())
    @SETTINGS
    def test_property_fused_equals_scalar(self, seed, spec, n_miss,
                                          use_kernel):
        """Hypothesis: for any ragged mix of cell sizes (incl. empty cells
        and pow2-boundary expected_entries), fused probe_cells is
        bit-for-bit equal to N scalar might_contain calls."""
        cells, added = build_cells(spec, tag=f"s{seed}-")
        queries, groups = ragged_queries(added, n_miss, tag=f"q{seed}-")
        if not queries:
            return
        h1, h2 = key_hashes_many(queries)
        got = probe_cells(cells, h1, h2, groups, use_kernel=use_kernel,
                           device="cpu")
        for ci, g in enumerate(groups):
            for qi in g:
                assert got[qi] == cells[ci].might_contain(queries[qi])


class TestDispatchBudget:
    def test_multi_exists_is_one_dispatch_per_store(self, tmpdir):
        """However many cells the batch touches: ONE fused kernel dispatch
        (blob memo disabled so the Bloom gate stays live; 8 cells × 1024
        queries crosses the per-cell-scaled kernel threshold)."""
        from repro_torch.kernels.bloom_check import ops as bloom_ops
        cfg = small_cfg(blob_cache_bytes=0)
        with TideDB(tmpdir, cfg) as db:
            present = keys_n(512, "p")
            db.put_many([(k, b"v" * 32) for k in present])
            db.snapshot_now(flush_threshold=1)     # cells → UNLOADED
            batch = present + keys_n(512, "miss")
            db.multi_exists(batch)                 # warm the jit shapes
            before_k = bloom_ops.ragged_dispatch_count
            before_p = db.metrics.fused_bloom_probes
            got = db.multi_exists(batch)
            assert bloom_ops.ragged_dispatch_count - before_k == 1
            assert db.metrics.fused_bloom_probes - before_p == 1
            assert got == [db.exists(k) for k in batch]
            # below the scaled threshold: still one fused probe, but the
            # identical numpy pass — zero kernel dispatches
            before_k = bloom_ops.ragged_dispatch_count
            before_p = db.metrics.fused_bloom_probes
            small = db.multi_exists(batch[:96])
            assert bloom_ops.ragged_dispatch_count == before_k
            assert db.metrics.fused_bloom_probes - before_p == 1
            assert small == got[:96]

    def test_kernel_off_routes_numpy_and_agrees(self, tmpdir):
        from repro_torch.kernels.bloom_check import ops as bloom_ops
        cfg = small_cfg(blob_cache_bytes=0, batched_kernels=False)
        with TideDB(tmpdir, cfg) as db:
            present = keys_n(512, "p")
            db.put_many([(k, b"v" * 32) for k in present])
            db.snapshot_now(flush_threshold=1)
            before = bloom_ops.ragged_dispatch_count
            got = db.multi_exists(present + keys_n(512, "miss"))
            assert bloom_ops.ragged_dispatch_count == before
            assert got == [True] * 512 + [False] * 512


class TestCrashConsistency:
    def test_exists_false_after_delete_many_and_reopen(self, tmpdir):
        """Tombstones written by delete_many stay visible to the fused
        existence path across a crash (close without flush → WAL replay),
        including under a min_live_pin snapshot read."""
        cfg = small_cfg(blob_cache_bytes=0)
        present = keys_n(300, "p")
        with TideDB(tmpdir, cfg) as db:
            positions = db.put_many([(k, b"v%d" % i)
                                     for i, k in enumerate(present)])
            db.snapshot_now(flush_threshold=1)     # index + blooms on disk
            db.delete_many(present[:100])
            # crash: no flush, control region still pre-delete
            db.close(flush=False)
        with TideDB(tmpdir, cfg) as db2:
            batch = present + keys_n(50, "never")
            want = [False] * 100 + [True] * 200 + [False] * 50
            assert db2.multi_exists(batch) == want
            assert [db2.exists(k) for k in batch] == want
            # pinned reads resolve identically (same floor)
            pin = db2.min_live()
            opts = ReadOptions(min_live_pin=pin)
            assert db2.multi_exists(batch, opts=opts) == want
            # a pin above a key's position hides it from the snapshot
            opts_hi = ReadOptions(min_live_pin=positions[150] + 1)
            got = db2.multi_exists(present[148:153], opts=opts_hi)
            assert got[2] is False                 # pruned below the pin
            assert db2.exists(present[150], opts=opts_hi) is False
            assert db2.exists(present[151], opts=opts_hi) is True
            db2.close()

    def test_deleted_keys_stay_gone_after_second_flush_cycle(self, tmpdir):
        """After the tombstones themselves flush, the rebuilt bloom covers
        only the live set, so the fused path answers deleted keys straight
        from the filter — and the answers survive a reopen (where blooms
        start unbuilt and the blob path resolves the same markers)."""
        cfg = small_cfg(blob_cache_bytes=0)
        present = keys_n(200, "p")
        want = [False] * 80 + [True] * 120
        with TideDB(tmpdir, cfg) as db:
            db.put_many([(k, b"x") for k in present])
            db.delete_many(present[:80])
            db.snapshot_now(flush_threshold=1)     # bloom rebuilt, live only
            before = db.metrics.bloom_negative
            assert db.multi_exists(present) == want
            assert db.metrics.bloom_negative > before  # filtered, not read
            db.close()
        with TideDB(tmpdir, cfg) as db2:
            assert db2.multi_exists(present) == want
            db2.close()


class TestLazyBloomRebuild:
    """ROADMAP item: filters are rebuilt only at flush time, so a freshly
    reopened store answered cold ``exists`` through blob reads until the
    first flush.  The first probe of a disk-resident, filterless cell now
    rebuilds its filter lazily, restoring the filter fast-path immediately
    after recovery."""

    def _seed(self, d, n=80):
        # no blob memo: probes must use bloom; no persisted filters: this
        # class exercises the lazy REBUILD fallback (the persisted fast
        # path is covered in test_system_keyspace.py)
        cfg = small_cfg(blob_cache_bytes=0, persist_filters=False)
        db = TideDB(d, cfg)
        ks = keys_n(n, tag="lz")
        for k in ks:
            db.put(k, b"v-" + k[:4])
        db.delete(ks[0])
        db.snapshot_now(flush_threshold=1)    # index + blooms on disk
        db.close()
        return cfg, ks

    def test_scalar_exists_rebuilds_and_short_circuits(self, tmpdir):
        cfg, ks = self._seed(tmpdir)
        db = TideDB(tmpdir, cfg)
        assert all(c.bloom is None for _, c in db.table.all_cells())
        miss = keys_n(1, tag="nope")[0]
        assert db.exists(miss) is False       # first probe: rebuild fires
        assert db.metrics.bloom_lazy_rebuilds >= 1
        assert any(c.bloom is not None for _, c in db.table.all_cells())
        before = db.metrics.index_lookups
        neg_before = db.metrics.bloom_negative
        assert db.exists(miss) is False       # second probe: filter only
        assert db.metrics.index_lookups == before
        assert db.metrics.bloom_negative > neg_before
        # no false negatives: present keys answer True, the deleted one False
        assert all(db.exists(k) for k in ks[1:10])
        assert db.exists(ks[0]) is False
        db.close()

    def test_multi_exists_rebuilds_and_answers_correctly(self, tmpdir):
        cfg, ks = self._seed(tmpdir)
        db = TideDB(tmpdir, cfg)
        miss = keys_n(40, tag="mm")
        got = db.multi_exists(ks + miss)
        assert got == [False] + [True] * (len(ks) - 1) + [False] * len(miss)
        assert db.metrics.bloom_lazy_rebuilds >= 1
        # every touched (user-keyspace) cell is filtered; the reserved
        # __system keyspace's cells were not probed and stay lazy
        assert all(c.bloom is not None
                   for ks_id, c in db.table.all_cells()
                   if c.has_disk() and ks_id == 0)
        # with every touched cell filtered (and no blob memo), a repeat
        # all-miss batch is answered by the filters alone
        blob_before = db.metrics.batched_blob_reads
        neg_before = db.metrics.bloom_negative
        assert db.multi_exists(miss) == [False] * len(miss)
        assert db.metrics.batched_blob_reads == blob_before
        assert db.metrics.bloom_negative >= neg_before + len(miss)
        db.close()

    def test_rebuilt_filter_matches_flush_built_filter(self, tmpdir):
        """The lazily rebuilt filter must be bit-identical to the one the
        flush built (same sizing, same live key set), so switching the
        build site can never change an answer."""
        cfg, ks = self._seed(tmpdir)
        db = TideDB(tmpdir, cfg)
        flush_blooms = {}
        with TideDB(tmpdir + "-twin", cfg) as twin:
            for k in ks:
                twin.put(k, b"v-" + k[:4])
            twin.delete(ks[0])
            twin.snapshot_now(flush_threshold=1)
            # user keyspace only: __system cells share the 0..7 cell-id
            # space and would collide in a cell_id-keyed dict
            for ks_id, cell in twin.table.all_cells():
                if ks_id == 0 and cell.bloom is not None:
                    flush_blooms[cell.cell_id] = cell.bloom.bits.copy()
        db.multi_exists(keys_n(30, tag="touch"))   # trigger lazy rebuilds
        rebuilt = {cell.cell_id: cell.bloom.bits
                   for ks_id, cell in db.table.all_cells()
                   if ks_id == 0 and cell.bloom is not None}
        assert rebuilt                        # something was rebuilt
        for cid, bits in rebuilt.items():
            assert (bits == flush_blooms[cid]).all()
        db.close()

    def test_writes_after_rebuild_reach_the_filter(self, tmpdir):
        """Keys applied after the lazy install go through the normal
        apply→bloom.add path: no false negatives for post-rebuild writes."""
        cfg, ks = self._seed(tmpdir)
        db = TideDB(tmpdir, cfg)
        db.multi_exists(ks)                   # rebuild every touched cell
        fresh = keys_n(30, tag="after")
        db.put_many([(k, b"new") for k in fresh])
        assert db.multi_exists(fresh) == [True] * len(fresh)
        assert all(db.exists(k) for k in fresh)
        db.close()
