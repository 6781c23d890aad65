"""Batched reads against a relocation that lands under them (ROADMAP C.15).

``multi_get`` and ``multi_exists`` resolve a batch's index positions, then
drop the positions that are no longer live as pruned.  A relocation pass
can move a key and advance the watermark past its old copy in between: the
key is live, at its new position, yet the JAX package's batched reads
answer absent for it.  The port resolves such keys again until none moves.
Each case injects the relocation deterministically, by wrapping the Large
Table's ``get_positions_batch`` so that its first call runs a forced
``prune()`` before it returns its (now stale) positions; no thread races.

Keys that were really pruned (their epoch expired) still read as absent,
as the JAX package reads them.
"""
import hashlib
import shutil
import tempfile

import pytest

from repro.core.tidestore import DbConfig as JaxDbConfig
from repro.core.tidestore import KeyspaceConfig as JaxKeyspaceConfig
from repro.core.tidestore import TideDB as JaxTideDB
from repro.core.tidestore.wal import WalConfig as JaxWalConfig
from repro_torch.core.tidestore import (DbConfig, KeyspaceConfig,
                                        PruneOptions, TideDB)
from repro_torch.core.tidestore.wal import WalConfig


def _cfg_kwargs(ks_cls, wal_cls):
    return dict(
        keyspaces=[ks_cls("default", n_cells=16, dirty_flush_threshold=64)],
        wal=wal_cls(segment_size=16 * 1024, background=False),
        index_wal=wal_cls(segment_size=1024 * 1024, background=False),
        background_snapshots=False, cache_bytes=0)


def small_cfg():
    return DbConfig(device="cpu", **_cfg_kwargs(KeyspaceConfig, WalConfig))


def keys_n(n, tag=""):
    return [hashlib.sha256(f"{tag}{i}".encode()).digest() for i in range(n)]


@pytest.fixture()
def tmpdir():
    d = tempfile.mkdtemp(prefix="tide-read-race-")
    yield d
    shutil.rmtree(d, ignore_errors=True)


def relocate_after_resolution(db):
    """Wrap ``db.table.get_positions_batch``: its first call resolves, then
    a forced relocation pass moves the oldest half of the WAL and drops
    those segments before the positions are returned → the watermark
    before and after the pass."""
    real, seen = db.table.get_positions_batch, []

    def resolve(ks_id, keys, **kw):
        out = real(ks_id, keys, **kw)
        if not seen:
            seen.append(db.value_wal.first_live_pos)
            db.prune(PruneOptions(reclaim_fraction=0.5))
            seen.append(db.value_wal.first_live_pos)
        return out

    db.table.get_positions_batch = resolve
    return seen


def filled(path):
    db = TideDB(path, small_cfg())
    ks = keys_n(300)
    db.put_many([(k, b"v%03d" % i * 40) for i, k in enumerate(ks)])
    db.flush()
    return db, ks


@pytest.mark.parametrize("call", ["multi_get", "multi_exists"])
def test_batched_read_finds_keys_relocated_under_it(tmpdir, call):
    """Every key of the batch is answered as written, though the oldest
    half of them moved, and their old segments went, between the batch's
    index resolution and its liveness check."""
    db, ks = filled(tmpdir)
    with db:
        seen = relocate_after_resolution(db)
        got = getattr(db, call)(ks)
        assert seen[1] > seen[0]                  # the pass dropped segments
        assert db.metrics.relocated_entries > 0
        want = [b"v%03d" % i * 40 for i in range(len(ks))] \
            if call == "multi_get" else [True] * len(ks)
        assert got == want
        assert [db.get(k) for k in ks] == [b"v%03d" % i * 40
                                            for i in range(len(ks))]


def _epoch_store(path, make):
    db = make(path)
    for ep in range(4):
        db.put_many([(k, bytes(150)) for k in keys_n(100, f"{ep}/")],
                    epoch=ep)
    db.flush()
    return db


def test_pruned_keys_read_absent_as_the_reference(tmpdir):
    """Keys whose epoch expired (whole segments dropped, none relocated)
    read as absent in both packages, batched and scalar alike; the rest
    read back."""
    keys = [k for ep in range(4) for k in keys_n(100, f"{ep}/")]
    answers = []
    for name, make in (
            ("jax", lambda p: JaxTideDB(p, JaxDbConfig(**_cfg_kwargs(
                JaxKeyspaceConfig, JaxWalConfig)))),
            ("torch", lambda p: TideDB(p, small_cfg()))):
        with _epoch_store(f"{tmpdir}/{name}", make) as db:
            assert db.prune_epochs_below(2) > 0
            answers.append((db.multi_get(keys), db.multi_exists(keys),
                            [db.get(k) for k in keys]))
    assert answers[0] == answers[1]
    got, exists, scalar = answers[1]
    assert got == scalar
    assert exists == [v is not None for v in got]
    assert got[-100:] == [bytes(150)] * 100
    assert sum(v is None for v in got) >= 100
