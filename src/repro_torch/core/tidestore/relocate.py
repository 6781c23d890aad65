"""Relocation and epoch pruning (§4.4) on the reserve→copy→commit protocol.

Relocation reclaims Value WAL space by re-appending live entries at the tail
and deleting old segment files.  Correctness under concurrent writes uses
compare-and-set against the captured watermark: an entry read at position P
is re-applied only if the index still points at P; a concurrent write that
moved the key to P'' > L wins and the relocated copy is simply ignored
(it becomes dead bytes reclaimed by the *next* relocation pass).

Since the batched write pipeline landed, survivors no longer trickle out one
scalar append at a time: a pass harvests live entries into batches and
re-appends each batch through ``Wal.append_many`` — ONE allocation-lock
acquisition per batch, payload copies fanned across the shared CopyPool —
then CASes the whole batch against the positions captured at harvest with
``LargeTable.compare_and_set_many`` (one row-lock acquisition per touched
cell).  The CAS always completes before the pass advances the GC watermark,
so a snapshot taken mid-pass can never persist an index that still points
into a segment the pass is about to delete.

Two strategies, as in the paper:
- **WAL-based**: sequential scan of the oldest segments; liveness = "does
  the index still point here".
- **Index-based**: iterate cells, pick entries whose positions fall below
  the cutoff, read just those values (one batched WAL read).

Plus the blockchain-style fast path: **epoch pruning** drops whole segments
whose epoch range has expired without relocating a single byte — including
segments in the *middle* of the live span (``Wal.drop_segments``).

``PruneController`` owns the trigger policy (space-amplification threshold
+ epoch expiry) and exposes three grains: a forced full pass (explicit
``TideDB.prune``), a trigger-respecting pass (the background
``PruneThread``), and a single bounded batch (``step`` — what
``KvBatchServer`` interleaves between serving stages).
"""
from __future__ import annotations

import threading
from enum import Enum
from typing import Callable, Optional

from .api import PruneOptions
from .index import TOMB_FLAG, is_tombstone, real_pos
from .large_table import CellState, LargeTable
from .util import Metrics
from .wal import (HEADER_SIZE, T_ENTRY, T_TOMBSTONE, Wal, decode_entry,
                  decode_tombstone, encode_tombstone, entry_framed)


class Decision(Enum):
    KEEP = 0
    REMOVE = 1
    STOP = 2


# filter(key, value_or_None, epoch) -> Decision
RelocationFilter = Callable[[bytes, Optional[bytes], int], Decision]


class Relocator:
    def __init__(self, table: LargeTable, value_wal: Wal,
                 metrics: Optional[Metrics] = None, *,
                 batch_records: int = 512, batch_bytes: int = 4 * 1024 * 1024):
        self.table = table
        self.wal = value_wal
        self.metrics = metrics or Metrics()
        self.batch_records = batch_records
        self.batch_bytes = batch_bytes
        self._lock = threading.Lock()          # single relocator at a time
        # Incremental scan cursor (relocate_step): None = no pass in flight.
        # Sub-records of a batch tile contiguously, so the cursor may rest
        # mid-batch and the next slice resumes on the following sub-record.
        self._scan_pos: Optional[int] = None
        self._scan_cutoff = 0
        self._scan_stop = 0
        self._pass_stats = {"scanned_records": 0, "scanned_bytes": 0,
                            "live_bytes": 0, "moved": 0}
        # Stats of the most recent *completed* pass; the PruneController's
        # live-bytes estimator reads the live fraction from here.
        self.last_pass: dict = {}

    @property
    def scanning(self) -> bool:
        return self._scan_pos is not None

    # ------------------------------------------------------------ strategies
    def relocate_wal_based(self, cutoff: Optional[int] = None,
                           filt: Optional[RelocationFilter] = None) -> int:
        """Scan the WAL from the oldest live position up to ``cutoff`` and
        re-append live entries in batches.  Returns entries relocated."""
        with self._lock:
            if not self._begin_pass(cutoff):
                return 0
            try:
                moved, _, _ = self._run_scan(filt, max_records=None)
            except BaseException:
                self._scan_pos = None    # abandon the pass: committed batches
                raise                    # are durable, watermark untouched
            return moved

    def relocate_step(self, max_records: Optional[int] = None,
                      cutoff: Optional[int] = None,
                      filt: Optional[RelocationFilter] = None) -> int:
        """One bounded relocation slice: at most ``max_records`` records
        scanned, at most a few ``append_many`` batches issued.  Starts a new
        pass when none is in flight (``cutoff`` applies only then); resumes
        the saved cursor otherwise.  Returns records scanned (0 = idle)."""
        with self._lock:
            if self._scan_pos is None and not self._begin_pass(cutoff):
                return 0
            try:
                _, scanned, _ = self._run_scan(
                    filt, max_records=max_records or self.batch_records)
            except BaseException:
                self._scan_pos = None
                raise
            return scanned

    def relocate_index_based(self, cutoff: Optional[int] = None,
                             filt: Optional[RelocationFilter] = None) -> int:
        """Iterate Large Table cells; relocate entries below the cutoff.
        Values are fetched with one batched WAL read per harvest and
        survivors re-appended through the same batched flush as the
        WAL-based strategy."""
        with self._lock:
            last = self.wal.tracker.last_processed
            cutoff = self._effective_cutoff(cutoff)
            # The watermark must land on a record boundary (a mid-record
            # first_live makes a later WAL scan start inside a record).
            # last_processed is a record end by construction; any other
            # byte cutoff floors to its segment start — file-granular GC
            # frees whole segments only, so this costs nothing.
            seg_size = self.wal.cfg.segment_size
            aligned = (cutoff if cutoff == last
                       else cutoff // seg_size * seg_size)
            moved = 0
            pending: list[tuple[int, bytes, int]] = []   # (ks_id, key, marker)
            for ks_id, cell in self.table.all_cells():
                ks = self.table.ks(ks_id)
                with ks.row_lock(cell.cell_id):
                    disk = self.table._load_disk_entries(ks, cell) \
                        if cell.state in (CellState.UNLOADED,
                                          CellState.DIRTY_UNLOADED) else []
                    candidates = {k: p for k, p in disk
                                  if p < cutoff and cell.mem.get(k) is None}
                    for k, m in cell.mem.items():
                        if real_pos(m) < cutoff:
                            candidates[k] = m
                pending.extend((ks_id, k, m) for k, m in candidates.items())
            recs = self.wal.read_records_batch(
                [real_pos(m) for _, _, m in pending if not is_tombstone(m)])
            batch: list = []
            batch_bytes = 0
            for i, (ks_id, key, marker) in enumerate(pending):
                pos = real_pos(marker)
                if is_tombstone(marker):
                    action = self._maybe_relocate(ks_id, key, None, 0,
                                                  pos, True, filt)
                    rtype, payload, epoch = \
                        T_TOMBSTONE, encode_tombstone(ks_id, key, 0), 0
                else:
                    rec = recs.get(pos)
                    if rec is None:
                        continue           # already pruned / concurrent GC
                    rtype, payload = rec
                    if rtype != T_ENTRY:
                        continue
                    _, _, value, epoch = decode_entry(payload)
                    action = self._maybe_relocate(ks_id, key, value, epoch,
                                                  pos, False, filt)
                if action == Decision.STOP:
                    self._flush_batch(batch)
                    # Candidates after the STOP item are unprocessed and may
                    # sit anywhere below the cutoff: never advance the
                    # watermark past the oldest of them.
                    rest = [real_pos(m) for _, _, m in pending[i:]]
                    bound = min([aligned] + rest)
                    self.wal.advance_gc_watermark(
                        bound // seg_size * seg_size)
                    return moved
                if action == Decision.KEEP:
                    batch.append((rtype, payload, ks_id, key, pos, epoch))
                    batch_bytes += len(payload)
                    moved += 1
                    if (len(batch) >= self.batch_records
                            or batch_bytes >= self.batch_bytes):
                        self._flush_batch(batch)
                        batch, batch_bytes = [], 0
            self._flush_batch(batch)
            self.wal.advance_gc_watermark(aligned)
            return moved

    # ------------------------------------------------------ batched scanning
    def _begin_pass(self, cutoff: Optional[int]) -> bool:
        """Arm the scan cursor for a new pass (discarding any half-done
        incremental scan — its completed batches already committed)."""
        cut = self._effective_cutoff(cutoff)
        start = self.wal.first_live_pos
        # Iterate to the processed watermark (always record-aligned) and
        # stop manually at the cutoff: a record *straddling* an arbitrary
        # byte cutoff is still scanned, so advancing the GC watermark to the
        # cutoff afterwards can never orphan an unexamined live record.
        self._scan_pos, self._scan_cutoff = start, cut
        self._scan_stop = self.wal.tracker.last_processed
        self._pass_stats = {"scanned_records": 0, "scanned_bytes": 0,
                            "live_bytes": 0, "moved": 0}
        if cut <= start:
            self._scan_pos = None
            return False
        return True

    def _run_scan(self, filt: Optional[RelocationFilter],
                  max_records: Optional[int]) -> tuple[int, int, bool]:
        """Harvest [scan_pos, scan_cutoff), flushing full batches as they
        fill.  Returns (moved, scanned, pass_exhausted)."""
        moved = scanned = 0
        batch: list = []
        batch_bytes = 0
        pos_after = self._scan_pos
        stopped = False
        st = self._pass_stats
        for pos, rtype, payload in self.wal.iter_records(self._scan_pos,
                                                         self._scan_stop):
            if pos >= self._scan_cutoff:
                break
            end = pos + HEADER_SIZE + len(payload)
            if not entry_framed(rtype, payload):
                # Header-torn zero phantom (CRC-valid but structurally
                # impossible): dead bytes, never a live record to move.
                pos_after = end
                continue
            if rtype == T_ENTRY:
                ks_id, key, value, epoch = decode_entry(payload)
                action = self._maybe_relocate(ks_id, key, value, epoch,
                                              pos, False, filt)
            elif rtype == T_TOMBSTONE:
                ks_id, key, epoch = decode_tombstone(payload)
                action = self._maybe_relocate(ks_id, key, None, epoch,
                                              pos, True, filt)
            else:
                pos_after = end
                continue
            if action == Decision.STOP:
                stopped = True
                self._scan_cutoff = pos        # everything below pos is clear
                break
            scanned += 1
            st["scanned_records"] += 1
            st["scanned_bytes"] += end - pos
            if action == Decision.KEEP:
                st["live_bytes"] += end - pos
                batch.append((rtype, payload, ks_id, key, pos, epoch))
                batch_bytes += len(payload)
                moved += 1
                if (len(batch) >= self.batch_records
                        or batch_bytes >= self.batch_bytes):
                    self._flush_batch(batch)
                    batch, batch_bytes = [], 0
            pos_after = end
            if max_records is not None and scanned >= max_records:
                self._flush_batch(batch)
                self._scan_pos = pos_after
                st["moved"] += moved
                return moved, scanned, False
        self._flush_batch(batch)
        st["moved"] += moved
        # Pass complete: every harvested batch is CASed (above), so the
        # watermark may now advance — never the other way around, or a
        # mid-pass snapshot could persist pointers into deleted segments.
        # Advance to the END of the last scanned record, not the raw byte
        # cutoff: a record straddling the cutoff was scanned (so its bytes
        # are dead), and a mid-record watermark would make the NEXT pass
        # start inside that record, read garbage, and silently skip the
        # real records behind it.  On STOP the (shrunk) cutoff is the
        # STOP record's start — itself a valid boundary.
        self.wal.advance_gc_watermark(max(self._scan_cutoff, pos_after))
        self._scan_pos = None
        self.last_pass = dict(st, cutoff=self._scan_cutoff, stopped=stopped)
        return moved, scanned, True

    def _flush_batch(self, batch: list) -> None:
        """Commit one harvest batch through the batched write protocol:
        ONE ``append_many`` (reserve under the allocation lock, parallel
        copies on the CopyPool), then the whole batch CASes against the
        positions captured at harvest.  Payloads re-append verbatim — they
        are the exact encoded records read off the log."""
        if not batch:
            return
        positions = self.wal.append_many(
            [(rtype, payload) for rtype, payload, *_ in batch],
            app_bytes=0, epochs=[it[5] for it in batch])
        ok = self.table.compare_and_set_many(
            [(it[2], it[3], it[4],
              (TOMB_FLAG | new_pos) if it[0] == T_TOMBSTONE else new_pos)
             for it, new_pos in zip(batch, positions)])
        # Every re-appended record is fully copied (append_many returns only
        # then), so all of them advance the processed watermark — CAS losers
        # included: their bytes are simply dead on arrival.
        self.wal.mark_processed_many(
            (new_pos, len(it[1])) for it, new_pos in zip(batch, positions))
        won = sum(ok)
        self.metrics.add(
            relocation_batches=1,
            relocated_entries=won,
            relocation_cas_fail=len(batch) - won,
            relocated_bytes=sum(len(it[1]) for it, o in zip(batch, ok) if o))

    # --------------------------------------------------------------- helpers
    def _effective_cutoff(self, cutoff: Optional[int]) -> int:
        # Never reclaim past the processed watermark (the paper's L).
        last = self.wal.tracker.last_processed
        if cutoff is None:
            return last
        return min(cutoff, last)

    def _maybe_relocate(self, ks_id: int, key: bytes, value: Optional[bytes],
                        epoch: int, pos: int, tombstone: bool,
                        filt: Optional[RelocationFilter]) -> Decision:
        """Per-record relocation *decision* (liveness + filter).  KEEP means
        the caller queues the record for the next batched re-append; the
        only side effects here are REMOVE's, which touch index state alone.
        """
        # Liveness: index must still point exactly at this position (§4.4).
        cur = self.table.get_position(ks_id, key) if not tombstone else None
        if tombstone:
            ks = self.table.ks(ks_id)
            cell = ks.cell_for_key(key, create=False)
            if cell is None:
                return Decision.REMOVE
            with ks.row_lock(cell.cell_id):
                marker, _ = self.table._position_locked(ks, cell, key)
            live = marker is not None and is_tombstone(marker) \
                and real_pos(marker) == pos
        else:
            live = cur == pos
        if not live:
            return Decision.REMOVE             # dead bytes: nothing to move
        if filt is not None:
            d = filt(key, value, epoch)
            if d == Decision.STOP:
                return d
            if d == Decision.REMOVE:
                if tombstone:
                    # Dropping a live tombstone = forgetting the delete: only
                    # safe because the covering index has no older value (we
                    # drop tombstones at flush), so just erase from mem.
                    self._erase_mem_tombstone(ks_id, key, pos)
                else:
                    self.table.compare_and_set(ks_id, key, pos,
                                               TOMB_FLAG | pos)
                return Decision.REMOVE
        return Decision.KEEP

    def _erase_mem_tombstone(self, ks_id: int, key: bytes, pos: int) -> None:
        ks = self.table.ks(ks_id)
        cell = ks.cell_for_key(key, create=False)
        if cell is None:
            return
        with ks.row_lock(cell.cell_id):
            m = cell.mem.get(key)
            if m is not None and is_tombstone(m) and real_pos(m) == pos:
                del cell.mem[key]
                self.table._bump_mem(-1)

    # --------------------------------------------------------- epoch pruning
    def prune_epochs_below(self, epoch: int) -> int:
        """Drop whole WAL segments whose epoch range expired (§4.4 /
        blockchain pruning) — mid-log segments included.  Zero bytes
        relocated; reads of pruned positions resolve to absent via
        ``Wal.pos_live``."""
        segs = self.wal.segments_expired_below_epoch(epoch)
        if not segs:
            return 0
        dropped = self.wal.drop_segments(segs)
        if dropped:
            self.metrics.add(segments_pruned=dropped)
        return dropped


class PruneController:
    """Trigger policy + pacing for space reclamation; owned by ``TideDB``.

    Two triggers, evaluated independently:

    - **Epoch expiry** (``retain_epochs``): segments whose whole epoch range
      has aged out of the newest N epochs drop for free.
    - **Space amplification** (``space_amp_trigger``): a relocation pass
      runs when the physical WAL span exceeds the trigger × the estimated
      live bytes.  The estimate self-corrects: each completed pass reports
      its observed live fraction, which reprojects over the current span.
      Until a first pass calibrates it, any span ≥ ``min_reclaim_bytes``
      triggers.
    """

    def __init__(self, relocator: Relocator, opts: Optional[PruneOptions] = None):
        self.relocator = relocator
        self.opts = opts or PruneOptions()
        self._lock = threading.Lock()
        self._live_bytes_est: Optional[int] = None

    # ----------------------------------------------------------- policy
    def _span(self) -> int:
        wal = self.relocator.wal
        return wal.tail - wal.first_live_pos

    def space_amp(self) -> float:
        """Physical span / estimated live bytes (∞ until calibrated)."""
        span = self._span()
        est = self._live_bytes_est
        if est is None or est <= 0:
            return float("inf") if span > 0 else 1.0
        return span / est

    def should_relocate(self, opts: Optional[PruneOptions] = None) -> bool:
        o = opts or self.opts
        span = self._span()
        if span < o.min_reclaim_bytes:
            return False
        est = self._live_bytes_est
        if est is None:
            return True                        # calibration pass
        return span >= o.space_amp_trigger * max(est, 1)

    def epoch_floor(self, opts: Optional[PruneOptions] = None) -> Optional[int]:
        o = opts or self.opts
        if o.retain_epochs is None:
            return None
        epochs = self.relocator.wal.segment_epochs()
        if not epochs:
            return None
        newest = max(hi for _, hi in epochs.values())
        return newest - o.retain_epochs + 1

    def _expiry_filter(self, floor: Optional[int]) -> Optional[RelocationFilter]:
        """Relocation-side epoch expiry: records whose epoch aged out are
        REMOVEd (retired) instead of copied to the tail.  Without this, a
        relocated old-epoch record would both cost a pointless copy and
        poison its landing segment's epoch range, blocking that segment's
        own future expiry.  Untagged records (epoch 0) always survive."""
        if floor is None:
            return None

        def filt(key: bytes, value: Optional[bytes], epoch: int) -> Decision:
            return Decision.REMOVE if 0 < epoch < floor else Decision.KEEP
        return filt

    def _update_estimate(self) -> None:
        lp = self.relocator.last_pass
        scanned = lp.get("scanned_bytes", 0)
        if scanned <= 0:
            return
        live = lp.get("live_bytes", 0)
        frac = live / scanned
        # The pass's survivors sit at the tail and are live by construction
        # (modulo lost CAS races); project the observed live fraction only
        # over the REST of the span.  Projecting it over the whole span
        # would tag a freshly-compacted, all-live store with the pre-pass
        # dead fraction and re-trigger a pointless pass.
        span = self._span()
        self._live_bytes_est = max(1, live + int(frac * max(0, span - live)))

    # ------------------------------------------------------------ grains
    def prune_once(self, opts: Optional[PruneOptions] = None, *,
                   force: bool = True,
                   filt: Optional[RelocationFilter] = None) -> dict:
        """One full reclamation pass: epoch expiry first (free), then — if
        forced or triggered — a relocation pass over ``reclaim_fraction``
        of the live span.  Returns a summary dict."""
        o = opts or self.opts
        with self._lock:
            out = {"segments_pruned": 0, "relocated": 0, "triggered": False}
            floor = self.epoch_floor(o)
            if floor is not None:
                out["segments_pruned"] = \
                    self.relocator.prune_epochs_below(floor)
            if filt is None:
                filt = self._expiry_filter(floor)
            if force or self.should_relocate(o):
                wal = self.relocator.wal
                cutoff = wal.first_live_pos + int(self._span()
                                                  * o.reclaim_fraction)
                if o.strategy == "index":
                    out["relocated"] = \
                        self.relocator.relocate_index_based(cutoff, filt)
                else:
                    out["relocated"] = \
                        self.relocator.relocate_wal_based(cutoff, filt)
                out["triggered"] = True
                self._update_estimate()
            out["space_amp"] = self.space_amp()
            return out

    def maybe_prune(self, opts: Optional[PruneOptions] = None) -> dict:
        """Trigger-respecting pass — what the background thread runs."""
        return self.prune_once(opts, force=False)

    def step(self, opts: Optional[PruneOptions] = None) -> int:
        """One bounded relocation slice — the serving loop's unit of
        reclamation work.  Never blocks on another pruner (a busy lock
        means reclamation is already being paid for elsewhere); starts a
        pass only when the trigger policy says so, then keeps draining it
        one ``batch_records`` slice at a time.  Returns records scanned."""
        o = opts or self.opts
        if not self._lock.acquire(blocking=False):
            return 0
        try:
            rel = self.relocator
            floor = self.epoch_floor(o)
            filt = self._expiry_filter(floor)
            if not rel.scanning:
                if floor is not None:
                    rel.prune_epochs_below(floor)
                if not self.should_relocate(o):
                    return 0
                wal = rel.wal
                cutoff = wal.first_live_pos + int(self._span()
                                                  * o.reclaim_fraction)
                scanned = rel.relocate_step(o.batch_records, cutoff, filt)
            else:
                scanned = rel.relocate_step(o.batch_records, filt=filt)
            if not rel.scanning:               # pass just completed
                self._update_estimate()
            return scanned
        finally:
            self._lock.release()


class PruneThread:
    """Single background reclaimer (§5: 'A single relocator thread'), now
    driving the PruneController's trigger policy instead of unconditionally
    relocating every interval."""

    def __init__(self, controller: PruneController, interval_s: float = 1.0):
        self.controller = controller
        self.interval = interval_s
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="tide-prune")

    def start(self) -> None:
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.controller.maybe_prune()
            except Exception:  # pragma: no cover
                import traceback
                traceback.print_exc()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
