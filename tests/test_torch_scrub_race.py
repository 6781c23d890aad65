"""The scrubber against a segment dropped under its cursor (ROADMAP C.14).

A pruning slice can drop a sealed segment between the scrubber's header
read and its payload read of one record.  The payload read then comes back
short (the file is gone) or, through a retired descriptor, holds other
bytes.  The port's scrubber checks ``Wal.segment_missing`` before it
records anything: such a record is no finding, nothing is quarantined, and
the records verified before it still count.  Each case here injects the
drop deterministically, by wrapping the WAL's ``_pread_raw`` so that the
payload read of a chosen record drops its segment first; no thread races.

Damage in a segment that still exists is reported as the JAX package
reports it: the same findings, the same quarantine, on the same stores.
"""
import hashlib
import os
import shutil
import tempfile

import pytest

from repro.core.tidestore import DbConfig as JaxDbConfig
from repro.core.tidestore import KeyspaceConfig as JaxKeyspaceConfig
from repro.core.tidestore import TideDB as JaxTideDB
from repro.core.tidestore.scrub import read_scrub_table as jax_scrub_table
from repro.core.tidestore.wal import WalConfig as JaxWalConfig
from repro_torch.core.tidestore import (CorruptionError, DbConfig,
                                        KeyspaceConfig, TideDB)
from repro_torch.core.tidestore.scrub import read_scrub_table
from repro_torch.core.tidestore.shard import ShardedTideDB
from repro_torch.core.tidestore.wal import _HDR, HEADER_SIZE, T_PAD, WalConfig

SEG = 16 * 1024


def small_cfg(**kw):
    return DbConfig(device="cpu", **_cfg_kwargs(KeyspaceConfig, WalConfig),
                    **kw)


def jax_cfg(**kw):
    return JaxDbConfig(**_cfg_kwargs(JaxKeyspaceConfig, JaxWalConfig), **kw)


def _cfg_kwargs(ks_cls, wal_cls):
    return dict(
        keyspaces=[ks_cls("default", n_cells=16, dirty_flush_threshold=64)],
        wal=wal_cls(segment_size=SEG, background=False),
        index_wal=wal_cls(segment_size=1024 * 1024, background=False),
        background_snapshots=False, cache_bytes=0)


def keys_n(n, tag=""):
    return [hashlib.sha256(f"{tag}{i}".encode()).digest() for i in range(n)]


@pytest.fixture()
def tmpdir():
    d = tempfile.mkdtemp(prefix="tide-scrub-race-")
    yield d
    shutil.rmtree(d, ignore_errors=True)


def fill(db, n=300, tag=""):
    db.put_many([(k, b"w" * 120) for k in keys_n(n, tag)])
    db.flush()


def record_positions(wal, seg):
    """Positions of the records of one sealed segment, by its headers."""
    pos, end, out = seg * SEG, (seg + 1) * SEG, []
    while end - pos >= HEADER_SIZE:
        rtype, length, _ = _HDR.unpack(wal._pread_raw(pos, HEADER_SIZE))
        if rtype == T_PAD or pos + HEADER_SIZE + length > end:
            break
        out.append(pos)
        pos += HEADER_SIZE + length
    return out


def drop_before_payload(wal, target, stale):
    """Wrap ``wal._pread_raw``: the payload read of the record at ``target``
    first drops its segment (as a pruning slice would); with ``stale`` it
    then returns zeros of the full length (a read through a retired
    descriptor), else the real read, which comes back short.  Returns the
    list of segments it dropped."""
    real, dropped = wal._pread_raw, []

    def pread(pos, n):
        if pos == target + HEADER_SIZE and not dropped:
            seg = target // SEG
            assert wal.drop_segments([seg]) == 1
            dropped.append(seg)
            if stale:
                return bytes(n)
        return real(pos, n)

    wal._pread_raw = pread
    return dropped


def middle_target(db):
    """(segment, its record positions, the record to race): the third
    record of the second sealed segment."""
    wal = db.value_wal
    segs = db.scrubber._sealed_segments()
    assert len(segs) >= 3
    seg = segs[1]
    recs = record_positions(wal, seg)
    assert len(recs) >= 4
    return seg, recs, recs[2]


def assert_no_trace_of_it(db):
    assert db.value_wal.quarantined() == {}
    assert db.metrics.crc_failures == 0
    assert db.metrics.scrub_corruptions_found == 0
    table = read_scrub_table(db)
    assert table["findings"] == []
    assert table["summary"]["corruptions_found"] == 0
    assert table["summary"]["quarantined"] == 0


@pytest.mark.parametrize("stale", [False, True], ids=["short", "stale"])
def test_scrub_skips_a_segment_dropped_between_its_reads(tmpdir, stale):
    """``db.scrub()`` whose payload read of one record finds the segment
    dropped: no finding, no quarantine, no CRC failure, no finding row in
    ``__system``; the records before it and every other segment count."""
    with TideDB(tmpdir, small_cfg()) as db:
        fill(db)
        seg, recs, target = middle_target(db)
        others = sum(len(record_positions(db.value_wal, s))
                     for s in db.scrubber._sealed_segments() if s != seg)
        dropped = drop_before_payload(db.value_wal, target, stale)
        rep = db.scrub()
        assert dropped == [seg]
        assert rep["corruptions"] == 0 and rep["findings"] == []
        assert rep["records_checked"] == others + recs.index(target)
        assert_no_trace_of_it(db)


@pytest.mark.parametrize("stale", [False, True], ids=["short", "stale"])
def test_scrub_step_skips_a_segment_dropped_between_its_reads(tmpdir,
                                                              stale):
    """The same through ``scrub_step``, one segment a slice, until the
    pass completes."""
    with TideDB(tmpdir, small_cfg()) as db:
        fill(db)
        seg, _, target = middle_target(db)
        dropped = drop_before_payload(db.value_wal, target, stale)
        for _ in range(64):
            db.scrub_step(1)
            if db.metrics.scrub_passes:
                break
        assert dropped == [seg] and db.metrics.scrub_passes == 1
        assert db.scrubber.findings == []
        assert_no_trace_of_it(db)


def test_no_quarantine_for_a_dropped_segment_on_the_read_path(tmpdir):
    """A CRC mismatch read through ``Wal.read_record`` after its segment
    was dropped still raises, but quarantines nothing; nor does a direct
    ``_quarantine_pos`` of a position in a dropped segment."""
    with TideDB(tmpdir, small_cfg()) as db:
        fill(db)
        wal = db.value_wal
        _, recs, target = middle_target(db)
        drop_before_payload(wal, target, stale=True)
        with pytest.raises(CorruptionError):
            wal.read_record(target)
        wal._quarantine_pos(recs[0])
        assert wal.quarantined() == {}
        assert db.metrics.crc_failures == 0


# ------------------------------------------- damage that is real: reported
def _damage(db, how):
    """Damage the third record of the second sealed segment → its
    position: flip a payload byte, or cut the file in its payload."""
    seg, _, target = middle_target(db)
    path = db.value_wal._segment_path(seg)
    off = target % SEG + HEADER_SIZE + 40
    if how == "flip":
        with open(path, "r+b") as f:
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([b[0] ^ 0x5A]))
    else:
        os.truncate(path, off)
    return target


@pytest.mark.parametrize("how", ["flip", "truncate"])
def test_damage_in_a_live_segment_is_reported_as_the_reference(tmpdir, how):
    """A flipped byte, or a file cut inside a payload, in a segment that
    still exists: ``crc`` and quarantined, as the JAX package reports it
    on the same store (its WAL segments are byte-identical)."""
    reports = []
    for pkg, make, table in (
            ("jax", lambda p: JaxTideDB(p, jax_cfg()), jax_scrub_table),
            ("torch", lambda p: TideDB(p, small_cfg()), read_scrub_table)):
        path = os.path.join(tmpdir, pkg)
        with make(path) as db:
            fill(db)
            pos = _damage(db, how)
            rep = db.scrub()
            reports.append((rep["findings"], rep["corruptions"],
                            rep["records_checked"],
                            db.value_wal.quarantined(),
                            db.metrics.crc_failures,
                            table(db)["findings"]))
    assert reports[0] == reports[1]
    findings, corruptions, _, quarantined, crc_failures, rows = reports[1]
    assert corruptions == 1 and crc_failures == 1
    assert [f["kind"] for f in findings] == ["crc"]
    assert findings[0]["pos"] == pos and quarantined == {pos: 1}
    assert rows == findings


# ------------------------------------------------------------- replicated
def test_replicated_store_has_nothing_to_repair(tmpdir):
    """``ShardedTideDB(3 shards, 2 replicas)`` scrubbed while one record's
    segment drops on every shard: no finding, no quarantine anywhere, and
    ``RepairController`` examines nothing."""
    with ShardedTideDB(tmpdir, small_cfg(), n_shards=3,
                       replication=2) as sdb:
        fill(sdb, 900)
        drops = []
        for sh in sdb.shards:
            seg, _, target = middle_target(sh)
            drops.append((drop_before_payload(sh.value_wal, target, False),
                          seg))
        rep = sdb.scrub()
        assert all(d == [seg] for d, seg in drops)
        assert rep["corruptions"] == 0 and rep["findings"] == []
        for sh in sdb.shards:
            assert sh.value_wal.quarantined() == {}
            assert sh.metrics.crc_failures == 0
        assert sdb.repair() == {"examined": 0, "repaired": 0, "cas_lost": 0,
                                "unrepaired": 0, "skipped": 0}


def test_repair_skips_an_entry_of_a_segment_dropped_after_it(tmpdir):
    """A quarantine entry recorded before its segment was dropped (a WAL
    with background GC prunes it only on the mapper's next cycle) is moot:
    the controller neither fetches nor counts it."""
    with ShardedTideDB(tmpdir, small_cfg(), n_shards=3,
                       replication=2) as sdb:
        fill(sdb, 900)
        wal = sdb.shards[0].value_wal
        seg, _, target = middle_target(sdb.shards[0])
        assert wal.drop_segments([seg]) == 1
        with wal._quarantine_lock:            # as if pruned only later
            wal._quarantine[target] = 1
        assert sdb.repair()["examined"] == 0
        assert sdb.shards[0].metrics.repair_fetch_failures == 0
