"""Background corruption scrubber (integrity half of the robustness work).

Because the WAL *is* the permanent store (§3.1), latent corruption in a
sealed segment is permanent data loss waiting for a read to find it.  The
scrubber walks sealed segments — fully below the open tail segment, not
dropped, at or above the GC watermark — re-verifying every record's CRC,
quarantining bad positions, and publishing findings into the ``__system``
keyspace (tag ``TAG_SCRUB``) so operators see corruption before a reader
trips over it.

Scheduling mirrors pruning: ``db.scrub()`` runs one full pass,
``db.scrub_step()`` verifies a bounded slice (one segment by default) and
is cheap enough for ``KvBatchServer`` idle ticks, and ``ScrubThread`` is
the standalone background loop.  Scrubbing is read-only with respect to
user data; it races safely with foreground writes, flushes, relocation,
and pruning (a segment dropped mid-pass is simply skipped).

The skip is a rule, checked wherever a walk would record a finding: a
pruning slice can drop the segment between the header read and the payload
read of one record, and the payload read then comes back short (the file is
gone) or, through a retired descriptor, holds other bytes.  So before any
finding is recorded the scrubber asks ``Wal.segment_missing``; if the
segment is gone by then, the walk of that segment stops with no finding and
no quarantine, and the records already verified still count.  A short or
mismatched read of a segment that still exists is reported and quarantined
as before.  (The JAX package records such a read as ``"crc"``.)
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional

import msgpack

from .system import TAG_SCRUB, row_key, scan_rows
from .util import crc32
from .wal import HEADER_SIZE, T_FILTER, T_PAD, _HDR

# Default cap on per-pass findings persisted to __system: corruption is
# normally rare; a rotted disk producing thousands of findings should not
# bloat the WAL with its own damage report.  Tunable per store via
# ``ScrubConfig.max_findings`` (``DbConfig.scrub_cfg``).
MAX_PUBLISHED_FINDINGS = 32


@dataclass
class ScrubConfig:
    """Scrubber policy knobs (``DbConfig.scrub_cfg``).

    - ``max_findings``: per-pass cap on finding rows persisted to
      ``__system``.  Findings beyond the cap are still counted and
      quarantined — only their individual rows are elided.
    """

    max_findings: int = MAX_PUBLISHED_FINDINGS


class Scrubber:
    """CRC-verifies sealed WAL segments and records findings.

    Holds a resume cursor so ``scrub_step`` spreads one full pass over many
    idle ticks; a completed pass publishes a summary (and the most recent
    findings) into ``__system`` and bumps ``scrub_passes``.  Findings whose
    position has since been repaired (``Wal.mark_repaired``) age out: the
    next completed pass neither re-reports them nor leaves their stale rows
    in ``__system``.
    """

    def __init__(self, db, *, publish: bool = True,
                 config: Optional[ScrubConfig] = None):
        self.db = db
        self.publish = publish
        self.cfg = config or ScrubConfig()
        self._lock = threading.Lock()      # one scrub slice at a time
        self._cursor: Optional[int] = None  # next segment index to verify
        self._prev_published = 0           # finding rows currently persisted
        self._pass_findings: list[dict] = []
        self.findings: list[dict] = []     # last completed pass
        self.last_pass_at: Optional[float] = None

    # ------------------------------------------------------------- planning
    def _sealed_segments(self) -> list[int]:
        wal = self.db.value_wal
        seg_size = wal.cfg.segment_size
        first = wal.first_live_pos // seg_size
        tail_seg = wal.tail // seg_size
        return [s for s in range(first, tail_seg)
                if not wal.segment_missing(s)]

    # ------------------------------------------------------------- verify
    def _verify_segment(self, seg: int) -> tuple[int, list[dict]]:
        """Walk one sealed segment record by record; returns
        (records_checked, findings).  Torn records in a *sealed* segment
        are poison headers from a failed copy — already acknowledged as
        failed, but reported so operators can see the scar tissue; CRC
        mismatches on full-length payloads are latent corruption.  A
        segment dropped under the walk ends it without a finding."""
        wal = self.db.value_wal
        seg_size = wal.cfg.segment_size
        pos = seg * seg_size
        end = pos + seg_size
        checked = 0
        findings: list[dict] = []
        repaired = wal.repaired()

        def found(kind: str, **extra) -> None:
            """A finding at ``pos``, unless the segment was dropped since
            its bytes were read."""
            if not wal.segment_missing(seg):
                findings.append({"pos": pos, "segment": seg, "kind": kind,
                                 **extra})

        while pos < end:
            if end - pos < HEADER_SIZE:
                break
            try:
                hdr = wal._pread_raw(pos, HEADER_SIZE)
            except OSError as e:
                found("io", detail=str(e))
                break
            if len(hdr) < HEADER_SIZE:
                break                      # segment dropped mid-pass
            rtype, length, crc = _HDR.unpack(hdr)
            if rtype == T_PAD:
                break
            if rtype > T_FILTER:
                # Garbage header: length can't be trusted, stop the walk.
                found("header")
                break
            nxt = pos + HEADER_SIZE + length
            if nxt > end:
                found("torn")
                break
            try:
                payload = wal._pread_raw(pos + HEADER_SIZE, length)
            except OSError as e:
                found("io", detail=str(e))
                break
            if len(payload) < length or crc32(payload) != crc:
                if wal.segment_missing(seg):
                    break                  # dropped between the two reads
                if pos not in repaired:
                    # Repaired carcasses stay corrupt on disk until segment
                    # GC reclaims them; re-reporting (or re-quarantining)
                    # known-dead bytes would keep resolved findings alive
                    # in __system forever.
                    findings.append({"pos": pos, "segment": seg,
                                     "kind": "crc"})
                    wal._quarantine_pos(pos)
            checked += 1
            pos = nxt
        return checked, findings

    def rescan(self) -> None:
        """Restart the sweep from the first sealed segment, discarding any
        partial pass.  ``TideDB.try_recover`` calls this after a successful
        disk re-probe: findings collected through the failing device
        (``kind == "io"``) are artifacts of the outage, so the next pass
        must re-verify every segment with healthy I/O instead of resuming
        mid-sweep and carrying the outage's scar tissue forward."""
        with self._lock:
            self._cursor = None
            self._pass_findings = []

    # ------------------------------------------------------------- driving
    def step(self, max_segments: int = 1) -> int:
        """Verify up to ``max_segments`` sealed segments; returns records
        checked.  Completing the sweep publishes and resets the cursor."""
        with self._lock:
            segs = self._sealed_segments()
            if not segs:
                self._cursor = None
                return 0
            start = self._cursor
            if start is None:
                start = segs[0]
            todo = [s for s in segs if s >= start][:max_segments]
            if not todo:
                # Cursor ran off the end (segments pruned): wrap.
                self._finish_pass()
                return 0
            checked = 0
            for s in todo:
                n, found = self._verify_segment(s)
                checked += n
                self._pass_findings.extend(found)
            self.db.metrics.add(scrub_records_checked=checked)
            last = todo[-1]
            later = [s for s in segs if s > last]
            if later:
                self._cursor = later[0]
            else:
                self._finish_pass()
            return checked

    def run(self) -> dict:
        """One full pass over every sealed segment; returns the report."""
        with self._lock:
            self._cursor = None
            self._pass_findings = []
            checked = 0
            segs = self._sealed_segments()
            for s in segs:
                n, found = self._verify_segment(s)
                checked += n
                self._pass_findings.extend(found)
            self.db.metrics.add(scrub_records_checked=checked)
            report = self._finish_pass()
            report["records_checked"] = checked
            report["segments_checked"] = len(segs)
            return report

    def _finish_pass(self) -> dict:
        """Pass complete (under ``_lock``): roll findings over, count
        corruptions, publish, reset the cursor."""
        self.findings = self._pass_findings
        self._pass_findings = []
        self._cursor = None
        self.last_pass_at = time.time()
        corruptions = sum(1 for f in self.findings if f["kind"] == "crc")
        self.db.metrics.add(scrub_passes=1,
                            scrub_corruptions_found=corruptions)
        report = {"findings": list(self.findings),
                  "corruptions": corruptions}
        if self.publish:
            self._publish(report)
        return report

    def _publish(self, report: dict) -> None:
        """Best-effort persistence into ``__system``: a rank-0 summary row
        plus one row per finding (capped).  Never raises — a degraded or
        failing store must not lose the scrub result that diagnosed it."""
        db = self.db
        if getattr(db, "system", None) is None:
            return
        m = db.metrics
        rows = [(row_key(TAG_SCRUB, 0, 0), msgpack.packb({
            "passes": m.scrub_passes,
            "records_checked": m.scrub_records_checked,
            "corruptions_found": m.scrub_corruptions_found,
            "quarantined": len(db.value_wal.quarantined()),
            "last_pass_at": self.last_pass_at,
        }, use_bin_type=True))]
        ranked = report["findings"][:self.cfg.max_findings]
        for rank, f in enumerate(ranked):
            rows.append((row_key(TAG_SCRUB, 0, rank + 1),
                         msgpack.packb(f, use_bin_type=True)))
        dels = [row_key(TAG_SCRUB, 0, r)
                for r in range(len(ranked) + 1, self._prev_published + 1)]
        try:
            with db._allow_system_writes():
                db.put_many(rows, keyspace=db._system_ks_id)
                if dels:
                    db.delete_many(dels, keyspace=db._system_ks_id)
            self._prev_published = len(ranked)
        except Exception:
            pass


def read_scrub_table(engine) -> dict:
    """Decode the scrubber's ``__system`` rows: ``{"summary": {...} | None,
    "findings": [...]}`` (rank order).  Separate from ``read_tables`` so
    the workload-rollup readers keep their shape."""
    out: dict = {"summary": None, "findings": []}
    rows = scan_rows(engine, TAG_SCRUB)
    for key, value in rows:
        out["findings"].append(value)
    if out["findings"]:
        out["summary"] = out["findings"].pop(0)
    return out


class ScrubThread:
    """Standalone background scrubber: one bounded slice per interval
    (mirrors ``PruneThread``)."""

    def __init__(self, db, interval_s: float = 1.0, max_segments: int = 1):
        self.db = db
        self.interval = interval_s
        self.max_segments = max_segments
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="tide-scrub")

    def start(self) -> None:
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.db.scrub_step(self.max_segments)
            except Exception:  # pragma: no cover - scrub must never crash
                import traceback
                traceback.print_exc()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
