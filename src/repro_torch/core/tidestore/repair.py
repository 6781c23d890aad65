"""Scrub-triggered repair: re-replicate quarantined records from a peer.

Because the WAL *is* the permanent store (§3.1), a CRC failure in a
sealed segment is permanent loss for a single store — the scrubber can
only report it.  Under ``ShardedTideDB(replication=R>1)`` a healthy copy
lives on a peer replica, so the loop can close: ``RepairController``
consumes what the scrubber (and foreground reads) quarantined, fetches
the healthy copy off a peer, re-appends it through the damaged shard's
own WAL, and clears the quarantine so findings age out of ``__system``.

The index hand-off reuses the relocation discipline (§4.4): the repaired
copy sits at the WAL tail but carries *old* bytes, so it must lose to any
concurrent foreground write.  Three shapes, one rule:

- **Referenced** (index → corrupt position): strict CAS from the corrupt
  position to the repaired copy.  A foreground write that moved the key
  wins; the carcass is then superseded either way.
- **Divergent** (index → some *other* position): the corrupt record was
  dropped at crash replay (``Wal.iter_records`` CRC-skips), silently
  rewinding the key to an older version — or to nothing.  If the local
  answer already matches the peers, the carcass is just history; if not,
  the peer copy re-appends with a CAS from the current position
  (``expect_pos=None`` = insert-only-if-absent when the key vanished).
- **Unidentifiable / no healthy peer copy**: the position STAYS
  quarantined and keeps re-reporting — invisible data loss is the one
  outcome repair must never manufacture.

Repairs publish into ``__system`` under ``TAG_REPAIR`` (one summary row
per shard, ``read_repair_table`` decodes) so operators see the loop run.
"""
from __future__ import annotations

import struct
import threading
import time
from typing import Optional

import msgpack

from .api import ReadOptions
from .system import TAG_REPAIR, row_key, scan_rows
from .wal import (HEADER_SIZE, T_ENTRY, T_TOMBSTONE, _ENTRY_HDR, _HDR,
                  encode_entry)

# Bound on the index-walk fallback used to identify a corrupt record whose
# own header bytes can't be trusted: predecessor-walk at most this many
# keys per keyspace looking for one that references the position.
_IDENTIFY_WALK_LIMIT = 100_000


class RepairController:
    """Drains quarantined positions on every shard of a replicated store.

    ``run()`` is one full pass; ``step(max_repairs)`` is a bounded slice
    for serving loops.  Both return outcome counts::

        {"examined", "repaired", "cas_lost", "unrepaired", "skipped"}

    ``repaired`` covers positions whose quarantine cleared (healthy copy
    restored, or carcass proven superseded); ``cas_lost`` repairs that
    lost their CAS to a concurrent foreground write (the key is current —
    the quarantine still clears); ``unrepaired`` positions left
    quarantined because no peer holds a healthy copy (or the record can't
    be identified); ``skipped`` per-shard-local ``__system`` rows, which
    no peer replicates.
    """

    def __init__(self, sdb, *, publish: bool = True):
        self.sdb = sdb
        self.publish = publish
        self._lock = threading.Lock()      # one repair slice at a time
        self.last_repair_at: Optional[float] = None

    # ------------------------------------------------------------- driving
    def run(self) -> dict:
        return self._process(None)

    def step(self, max_repairs: int = 8) -> dict:
        return self._process(max_repairs)

    def _process(self, limit: Optional[int]) -> dict:
        totals = {"examined": 0, "repaired": 0, "cas_lost": 0,
                  "unrepaired": 0, "skipped": 0}
        with self._lock:
            for sid, sh in enumerate(self.sdb.shards):
                wal = sh.value_wal
                # An entry of a segment dropped since it was quarantined is
                # moot (no reader reaches it; GC prunes it): nothing to fetch.
                positions = sorted(
                    p for p in wal.quarantined()
                    if not wal.segment_missing(p // wal.cfg.segment_size))
                if limit is not None:
                    positions = positions[:max(0, limit
                                               - totals["examined"])]
                if not positions:
                    continue
                for pos in positions:
                    outcome = self._repair_one(sid, sh, pos)
                    totals[outcome] += 1
                    totals["examined"] += 1
                self.last_repair_at = time.time()
                if self.publish:
                    self._publish(sh)
        return totals

    # -------------------------------------------------------- identification
    def _identify(self, sh, pos: int):
        """Best-effort (ks_id, key, verified) for a quarantined position.

        The payload failed its CRC, so its own bytes are suspect: the
        decode is *verified* only when the index corroborates it (some key
        maps to this position) — corruption in the value region leaves the
        entry header and key intact, which is the common case.  Falls back
        to a bounded reverse index walk; None when nothing identifies the
        record."""
        wal = sh.value_wal
        try:
            hdr = wal._pread_raw(pos, HEADER_SIZE)
        except OSError:
            return None
        if len(hdr) < HEADER_SIZE:
            return None
        rtype, length, _crc = _HDR.unpack(hdr)
        decoded = None
        if (rtype in (T_ENTRY, T_TOMBSTONE)
                and _ENTRY_HDR.size <= length <= wal.cfg.segment_size):
            try:
                payload = wal._pread_raw(pos + HEADER_SIZE, length)
            except OSError:
                payload = b""
            if len(payload) >= _ENTRY_HDR.size:
                try:
                    ks_id, klen, _epoch = _ENTRY_HDR.unpack_from(payload, 0)
                except struct.error:
                    ks_id = klen = None
                if klen is not None:
                    key = bytes(payload[_ENTRY_HDR.size:
                                        _ENTRY_HDR.size + klen])
                    try:
                        plausible = (klen == sh.key_len(ks_id)
                                     and len(key) == klen)
                    except Exception:
                        plausible = False
                    if plausible:
                        decoded = (ks_id, key)
        if decoded is not None:
            ks_id, key = decoded
            try:
                cur = sh.table.get_position(ks_id, key)
            except Exception:
                cur = None
            if cur == pos:
                return ks_id, key, True
        walked = self._identify_by_index(sh, pos)
        if walked is not None:
            return walked
        if decoded is not None:
            return decoded[0], decoded[1], False
        return None

    def _identify_by_index(self, sh, pos: int):
        """Reverse lookup: walk each keyspace's index (predecessor chain)
        for a key that references ``pos``.  Authoritative when it hits —
        the index survives corruption of the record it points at."""
        wal = sh.value_wal
        for name in list(getattr(sh, "_ks_by_name", {})):
            ks_id = sh._ks_id(name)
            if ks_id == sh._system_ks_id:
                continue
            try:
                klen = sh.key_len(ks_id)
                probe = b"\xff" * (klen + 1)
                k, p = sh.table.predecessor(ks_id, probe,
                                            wal.first_live_pos)
                steps = 0
                while k is not None and steps < _IDENTIFY_WALK_LIMIT:
                    if p == pos:
                        return ks_id, bytes(k), True
                    k, p = sh.table.predecessor(ks_id, k,
                                                wal.first_live_pos)
                    steps += 1
            except Exception:
                continue
        return None

    # --------------------------------------------------------------- repair
    def _repair_one(self, sid: int, sh, pos: int) -> str:
        ident = self._identify(sh, pos)
        if ident is None:
            sh.metrics.add(repair_fetch_failures=1)
            return "unrepaired"
        ks_id, key, verified = ident
        if ks_id == sh._system_ks_id:
            # __system rows are per-shard self-observation — no peer holds
            # a copy, and the next stats/scrub fold rewrites the row at the
            # tail anyway.  Clear the quarantine so the carcass stops
            # re-reporting.
            sh.value_wal.mark_repaired(pos)
            return "skipped"
        try:
            cur = sh.table.get_position(ks_id, key)
        except Exception:
            cur = None
        ent = self.sdb._fetch_from_peers(ks_id, key, exclude=sid)

        if cur == pos:
            # Referenced: the index still serves the corrupt bytes.
            if ent is None:
                # No healthy peer copy: genuine loss, keep it visible.
                sh.metrics.add(repair_fetch_failures=1)
                return "unrepaired"
            return self._reappend(sh, ks_id, key, ent, expect=pos,
                                  carcass=pos)

        # Divergent: replay dropped the corrupt record; the index answers
        # from an older version (or not at all).
        local = self._local_value(sh, ks_id, key)
        peer_val = None if ent is None else ent[0]
        if local == peer_val:
            if ent is None and not verified:
                # Unverified decode AND nobody knows the key: clearing the
                # quarantine here could silently bury a record whose key
                # bytes the corruption mangled.  Leave it visible.
                sh.metrics.add(repair_fetch_failures=1)
                return "unrepaired"
            # Carcass of a superseded (or consistently deleted) version.
            sh.value_wal.mark_repaired(pos)
            return "repaired"
        if ent is None:
            # Local has a readable value, peers have none: local is ahead
            # (peer repair/resync is their shard's loop).  The carcass is
            # superseded by the readable local copy.
            sh.value_wal.mark_repaired(pos)
            return "repaired"
        return self._reappend(sh, ks_id, key, ent, expect=cur, carcass=pos)

    def _local_value(self, sh, ks_id: int, key: bytes):
        try:
            return sh.get(key, ks_id, opts=ReadOptions(fill_cache=False))
        except KeyError:
            return None

    def _reappend(self, sh, ks_id: int, key: bytes, ent, *,
                  expect: Optional[int], carcass: int) -> str:
        """Relocation-style hand-off for the healthy peer copy: append to
        the damaged shard's WAL tail (app_bytes=0 — repair I/O is not
        application write volume), then CAS the index from ``expect``.
        Losing the CAS means a concurrent foreground write made the key
        current — repair still succeeded in the sense that matters, so the
        quarantine clears either way."""
        value, epoch = ent
        payload = encode_entry(ks_id, key, value, epoch)
        try:
            [new] = sh.value_wal.append_many([(T_ENTRY, payload)],
                                             app_bytes=0, epochs=[epoch])
        except OSError:
            sh.metrics.add(repair_fetch_failures=1)
            return "unrepaired"
        ok = sh.table.compare_and_set(ks_id, key, expect, new)
        # The carcass is NOT marked processed: its header length can't be
        # trusted (the corruption may have hit it), and a wrong range would
        # poison the reclaim watermark.  Relocation's own scan retires it.
        sh.cache.invalidate(sh._cache_key(ks_id, key))
        sh.value_wal.mark_repaired(carcass)
        sh.metrics.add(repair_appends=1)
        if ok:
            return "repaired"
        sh.metrics.add(repair_cas_fail=1)
        return "cas_lost"

    # -------------------------------------------------------------- publish
    def _publish(self, sh) -> None:
        """Best-effort per-shard summary row under TAG_REPAIR.  Never
        raises — repair on a limping store must not die reporting."""
        if getattr(sh, "system", None) is None:
            return
        m = sh.metrics
        row = msgpack.packb({
            "repaired_positions": m.repaired_positions,
            "repair_appends": m.repair_appends,
            "repair_cas_fail": m.repair_cas_fail,
            "repair_fetch_failures": m.repair_fetch_failures,
            "quarantined": len(sh.value_wal.quarantined()),
            "last_repair_at": self.last_repair_at,
        }, use_bin_type=True)
        try:
            with sh._allow_system_writes():
                sh.put(row_key(TAG_REPAIR, 0, 0), row,
                       keyspace=sh._system_ks_id)
        except Exception:
            pass


def read_repair_table(engine) -> dict:
    """Decode TAG_REPAIR rows: per-shard summaries plus a numeric rollup.
    Accepts a ``ShardedTideDB`` (scans each shard's ``__system`` directly —
    identical row keys collide under the sharded ``prev``) or a single
    ``TideDB``."""
    shards = getattr(engine, "shards", None)
    if shards is None:
        rows = [v for _, v in scan_rows(engine, TAG_REPAIR)]
        return {"summary": rows[0] if rows else None,
                "shards": [rows[0] if rows else None]}
    out: dict = {"summary": None, "shards": []}
    total: dict = {}
    for sh in shards:
        rows = [v for _, v in scan_rows(sh, TAG_REPAIR)]
        summary = rows[0] if rows else None
        out["shards"].append(summary)
        if summary:
            for k, v in summary.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    total[k] = total.get(k, 0) + v
    out["summary"] = total or None
    return out
