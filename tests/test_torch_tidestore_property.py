"""Property-based tests (hypothesis) for tidestore invariants.

The port's mirror of ``tests/test_tidestore_property.py``: ``repro`` → ``repro_torch``,
``device="cpu"`` at each config; no case left out.
"""
import hashlib
import shutil
import tempfile

import numpy as np
import pytest

from hypothesis_compat import HealthCheck, given, settings, st

from repro_torch.core.tidestore import DbConfig, KeyspaceConfig, TideDB
from repro_torch.core.tidestore.index import (HeaderLookup, OptimisticLookup,
                                        serialize_header,
                                        serialize_optimistic)
from repro_torch.core.tidestore.util import PositionTracker
from repro_torch.core.tidestore.wal import WalConfig

SETTINGS = settings(max_examples=40, deadline=None,
                    suppress_health_check=[HealthCheck.too_slow])


def _mk_pread(blob):
    return lambda off, n: blob[off:off + n]


# -------------------------------------------------------------- index props
@given(
    keys=st.sets(st.binary(min_size=32, max_size=32), min_size=0, max_size=400),
    probes=st.lists(st.binary(min_size=32, max_size=32), max_size=30),
    window=st.sampled_from([8, 17, 64, 800]),
)
@SETTINGS
def test_optimistic_index_matches_dict(keys, probes, window):
    entries = {k: i + 1 for i, k in enumerate(sorted(keys))}
    blob, count = serialize_optimistic(entries, 32)
    lk = OptimisticLookup(_mk_pread(blob), count, 32, window_entries=window)
    for k in list(entries) + probes:
        got, iters = lk.lookup(k)
        assert got == entries.get(k), k.hex()
        assert iters <= max(4, int(np.ceil(np.log2(max(count, 2)))) + 6)


@given(
    keys=st.sets(st.binary(min_size=32, max_size=32), min_size=0, max_size=400),
    probes=st.lists(st.binary(min_size=32, max_size=32), max_size=30),
)
@SETTINGS
def test_header_index_matches_dict(keys, probes):
    entries = {k: i + 1 for i, k in enumerate(sorted(keys))}
    blob, count = serialize_header(entries, 32)
    lk = HeaderLookup(_mk_pread(blob), count, 32)
    for k in list(entries) + probes:
        got, _ = lk.lookup(k)
        assert got == entries.get(k)


@given(
    keys=st.sets(st.binary(min_size=32, max_size=32), min_size=1, max_size=300),
    probes=st.lists(st.binary(min_size=32, max_size=32), min_size=1, max_size=20),
    window=st.sampled_from([8, 64, 800]),
)
@SETTINGS
def test_optimistic_predecessor_matches_sorted_list(keys, probes, window):
    entries = {k: i + 1 for i, k in enumerate(sorted(keys))}
    blob, count = serialize_optimistic(entries, 32)
    lk = OptimisticLookup(_mk_pread(blob), count, 32, window_entries=window)
    skeys = sorted(entries)
    for q in probes + skeys:
        want = None
        for k in reversed(skeys):
            if k < q:
                want = k
                break
        gk, gp, _ = lk.predecessor(q)
        assert gk == want
        if want is not None:
            assert gp == entries[want]


@given(st.data())
@SETTINGS
def test_position_tracker_watermark(data):
    """Watermark == longest contiguous prefix of completed ranges."""
    n = data.draw(st.integers(1, 30))
    sizes = [data.draw(st.integers(1, 100)) for _ in range(n)]
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    order = data.draw(st.permutations(range(n)))
    tr = PositionTracker()
    done = set()
    for i in order:
        tr.mark(int(starts[i]), int(starts[i] + sizes[i]))
        done.add(i)
        expect = 0
        for j in range(n):
            if j in done:
                expect = int(starts[j] + sizes[j])
            else:
                break
        assert tr.last_processed == expect


# ---------------------------------------------------------- engine vs shadow
@given(
    ops=st.lists(
        st.tuples(
            st.sampled_from(["put", "del", "get", "exists", "flush", "reloc"]),
            st.integers(0, 60),       # key id
            st.integers(0, 5),        # value version
        ),
        min_size=1, max_size=120,
    )
)
@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
def test_engine_matches_shadow_dict(ops):
    """Stress test with shadow-state verification (paper §5 methodology)."""
    d = tempfile.mkdtemp(prefix="tide-prop-")
    cfg = DbConfig(device="cpu", 
        keyspaces=[KeyspaceConfig("default", n_cells=4, dirty_flush_threshold=8)],
        wal=WalConfig(segment_size=8 * 1024, background=False),
        index_wal=WalConfig(segment_size=256 * 1024, background=False),
        background_snapshots=False,
        cache_bytes=0,
    )
    shadow = {}
    try:
        with TideDB(d, cfg) as db:
            for op, kid, ver in ops:
                key = hashlib.sha256(f"k{kid}".encode()).digest()
                if op == "put":
                    val = b"v%d-%d" % (kid, ver)
                    db.put(key, val)
                    shadow[key] = val
                elif op == "del":
                    db.delete(key)
                    shadow.pop(key, None)
                elif op == "get":
                    assert db.get(key) == shadow.get(key)
                elif op == "exists":
                    assert db.exists(key) == (key in shadow)
                elif op == "flush":
                    db.snapshot_now(flush_threshold=1)
                elif op == "reloc":
                    db.relocator.relocate_wal_based()
            for key, val in shadow.items():
                assert db.get(key) == val
        # recovery preserves the final state
        with TideDB(d, cfg) as db2:
            for key, val in shadow.items():
                assert db2.get(key) == val
    finally:
        shutil.rmtree(d, ignore_errors=True)
