"""Segmented append-only Write-Ahead Log — the permanent value store (§3.1).

Design notes (mapping to the paper):

- The WAL is a sequence of fixed-size *segments* (the paper's memory-mapped
  "maps" / files).  A global byte position addresses the whole log:
  ``segment = pos // segment_size``, ``offset = pos % segment_size``.
- **Atomic allocation, parallel copy** (§3.1, reserve → copy → commit):
  the allocation lock covers only position reservation and bookkeeping
  (tail bump, segment rolls, fd resolution, dirty-segment marking); the
  record bytes — header *and* payload — are copied outside the lock with
  ``os.pwritev``, whose iovec is the record parts themselves (no staging
  ``b"".join`` copy) and which releases the GIL, so concurrent writers
  genuinely saturate the device.  Batched appends additionally split their
  coalesced same-segment runs across a pool of copier threads
  (``CopyPool``), the paper's parallel-copy claim at 48 writer threads.
- **Visibility/durability gate**: positions are returned (and therefore
  index-applied and ``mark_processed``-ed) only after their copies
  complete.  Every reservation opens a completion latch under the
  allocation lock; ``flush()`` waits for all latches open at its start
  before fsyncing, so a sync-acknowledged record can never sit above a
  reserved-but-unwritten hole at fsync time.  After a crash, such a hole
  reads as zeros — a ``T_PAD`` header — and replay treats it exactly like
  a torn tail: the remainder of that segment is dropped (only
  fully-copied records are ever visible), later segments replay normally.
- **Batched appends** (``append_many``): one allocation-lock acquisition
  reserves positions for a whole batch (rolls handled vectorized), then the
  records are written as coalesced per-segment runs — one ``pwritev`` per
  run, split into sub-runs across the copy pool when runs are large.
  Positions are byte-identical to N sequential ``append`` calls; batched
  appends are *not* atomic — each record replays independently, and batch
  atomicity stays with ``append_batch``'s outer BATCH record.
- Records never span segments: if a record does not fit in the remainder of
  the current segment the tail jumps to the next segment boundary and the
  remainder stays zero (type 0 == padding == "go to next segment").
- The *asynchronous controller* is two background threads, mirroring §5:
  a **mapper** (pre-allocates the next segment file; deletes segments below
  the GC watermark) and a **syncer** (fsyncs finalized segments).  Position
  completion tracking (the paper's third thread) is the inline
  ``PositionTracker``.
- Batches (§3.1 "Atomic batch writes") are one outer BATCH record whose
  payload is a sequence of ordinary sub-records; replay validates every
  sub-record CRC and discards the whole batch on a torn write.

The Index Store reuses this exact class (§4.3: "The Index Store shares the
same append-only implementation as the Value WAL").
"""
from __future__ import annotations

import os
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Iterator, Optional

import numpy as np

from .faults import (DEFAULT_IO, CorruptionError, IoBackend, TornRecordError,
                     UnrepairedHoleError, WalHoleError)
from .util import Metrics, PositionTracker, crc32, crc32_parts

# ``os.pwritev`` is POSIX-only (and absent on some exotic builds); the
# module-level flag routes every run write so tests can force the fallback
# and keep both branches covered.
HAVE_PWRITEV = hasattr(os, "pwritev")
try:
    _IOV_MAX = os.sysconf("SC_IOV_MAX")
    if _IOV_MAX <= 0:
        _IOV_MAX = 1024
except (AttributeError, OSError, ValueError):
    _IOV_MAX = 1024


def write_parts(fd, parts, off: int, io: Optional[IoBackend] = None) -> int:
    """Positional vectored write: the iovec list is the caller's buffers
    themselves, so record headers and payloads reach the kernel without a
    staging ``b"".join`` copy.  Handles short vectored writes (resume where
    the kernel stopped) and iovec lists longer than ``IOV_MAX``.  Platforms
    without ``os.pwritev`` take the single-``pwrite`` fallback — one staged
    join, the pre-parallel-copy write path.  All bytes go through ``io``
    (the fault-injection seam).  Returns bytes written."""
    if io is None:
        io = DEFAULT_IO
    if not HAVE_PWRITEV or not io.have_pwritev:
        buf = parts[0] if len(parts) == 1 else b"".join(parts)
        mv = memoryview(buf)
        done = 0
        while done < len(buf):
            n = io.pwrite(fd, mv[done:], off + done)
            if n <= 0:                    # defensive: no forward progress
                raise OSError(f"pwrite wrote {n} of {len(buf) - done} bytes")
            done += n
        return len(buf)
    total = 0
    pending = [p for p in parts if len(p)]
    while pending:
        n = io.pwritev(fd, pending[:_IOV_MAX], off)
        if n <= 0:                        # defensive: no forward progress
            raise OSError(f"pwritev wrote {n} bytes")
        total += n
        off += n
        k = 0
        while k < len(pending) and n >= len(pending[k]):
            n -= len(pending[k])
            k += 1
        pending = pending[k:]
        if n and pending:
            pending[0] = memoryview(pending[0])[n:]
    return total


class CopyPool:
    """Shared pool of payload-copier threads (§3.1 parallel copy).

    ``threads`` is the number of concurrent copiers *including the calling
    thread*, so the executor holds ``threads - 1`` workers and the caller
    always copies the first sub-run itself — ``threads <= 1`` degenerates
    to inline copies with zero dispatch overhead.  One pool may serve any
    number of ``Wal`` instances: ``TideDB`` shares one between its value
    and index WALs, and ``ShardedTideDB`` hands every shard the same pool
    so N shards × M copiers never oversubscribes the host.  ``pwritev``
    releases the GIL, so copies genuinely run in parallel.

    ``threads=None`` builds an *adaptive* pool: the effective copier count
    starts at the host core budget and may be retuned at runtime via
    ``resize`` (a ``system.CopierGovernor`` drives it from observed load —
    the replacement for the manual ``DbConfig.copy_threads`` knob).
    ``capacity`` bounds how far ``resize`` may grow the pool; the executor
    is sized once at capacity (workers spawn lazily, so an idle headroom
    thread costs nothing) and ``resize`` is a plain int swap — safe while
    copies are in flight, affecting only how future batches are planned.
    """

    def __init__(self, threads: Optional[int] = 1,
                 capacity: Optional[int] = None):
        if threads is None:                  # adaptive: start at core budget
            cores = os.cpu_count() or 1
            capacity = cores if capacity is None else capacity
            threads = min(cores, capacity)
        self.capacity = max(1, int(capacity if capacity is not None
                                   else threads))
        self.threads = max(1, min(int(threads), self.capacity))
        self.governor = None                 # set by the owning engine
        self._pool = (ThreadPoolExecutor(max_workers=self.capacity - 1,
                                         thread_name_prefix="tide-copy")
                      if self.capacity > 1 else None)

    def resize(self, threads: int) -> int:
        """Retune the effective copier count within [1, capacity]; returns
        the new count.  Callers planning sub-runs read ``self.threads`` at
        batch start, so an in-flight batch finishes under its old plan."""
        self.threads = max(1, min(int(threads), self.capacity))
        return self.threads

    def run(self, fn, jobs) -> None:
        """Run ``fn`` over ``jobs``, fanned across the copiers.  Always
        waits for every job before returning — even when one raises — so a
        caller's completion latch never releases with a copy still in
        flight; the first exception is re-raised after the barrier."""
        if self._pool is None or len(jobs) <= 1:
            for job in jobs:
                fn(job)
            return
        futures = [self._pool.submit(fn, job) for job in jobs[1:]]
        err = None
        try:
            fn(jobs[0])                   # the calling thread is a copier too
        except BaseException as e:
            err = e
        for f in futures:
            try:
                f.result()
            except BaseException as e:
                if err is None:
                    err = e
        if err is not None:
            raise err

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)

# Record types.
T_PAD = 0        # zeroed space at segment end: jump to next segment
T_ENTRY = 1      # key/value insert
T_TOMBSTONE = 2  # key delete
T_BATCH = 3      # atomic batch: payload is a run of sub-records
T_INDEX = 4      # serialized cell index blob (Index Store)
T_FILTER = 5     # serialized cell Bloom filter, persisted next to its index

_HDR = struct.Struct("<BII")     # type, payload_len, payload_crc
HEADER_SIZE = _HDR.size          # 9 bytes
_ENTRY_HDR = struct.Struct("<HHQ")  # keyspace_id, key_len, epoch


def encode_entry(ks: int, key: bytes, value: bytes, epoch: int = 0) -> bytes:
    return _ENTRY_HDR.pack(ks, len(key), epoch) + key + value


def decode_entry(payload: bytes) -> tuple[int, bytes, bytes, int]:
    ks, klen, epoch = _ENTRY_HDR.unpack_from(payload, 0)
    off = _ENTRY_HDR.size
    return ks, payload[off:off + klen], payload[off + klen:], epoch


def encode_tombstone(ks: int, key: bytes, epoch: int = 0) -> bytes:
    return _ENTRY_HDR.pack(ks, len(key), epoch) + key


def decode_tombstone(payload: bytes) -> tuple[int, bytes, int]:
    ks, klen, epoch = _ENTRY_HDR.unpack_from(payload, 0)
    off = _ENTRY_HDR.size
    return ks, payload[off:off + klen], epoch


def make_record(rtype: int, payload: bytes) -> bytes:
    return _HDR.pack(rtype, len(payload), crc32(payload)) + payload


def entry_framed(rtype: int, payload: bytes) -> bool:
    """True iff an entry/tombstone payload is structurally complete.

    CRC alone cannot reject every torn record: a write torn inside the
    9-byte record header over a preallocated (zero-filled) segment can
    leave ``type=T_ENTRY, length=0, crc=0`` — and ``crc32(b"") == 0``, so
    the empty phantom validates.  ``encode_entry``/``encode_tombstone``
    never emit payloads shorter than the entry header + key, so anything
    shorter is torn, not data.

    The WAL itself stays payload-opaque (``iter_records`` yields any
    CRC-valid record); this check belongs to the consumers that DECODE
    entries — replay and relocation harvesting — which must skip a
    phantom instead of letting ``decode_entry`` raise ``struct.error``
    and fail the reopen."""
    if rtype not in (T_ENTRY, T_TOMBSTONE):
        return True
    if len(payload) < _ENTRY_HDR.size:
        return False
    _, klen, _ = _ENTRY_HDR.unpack_from(payload, 0)
    need = _ENTRY_HDR.size + klen
    return len(payload) >= need if rtype == T_ENTRY else len(payload) == need


def _parts_of(payload) -> list:
    """Normalize a record payload to its iovec parts.  A payload may be a
    single buffer or a list of buffers (e.g. ``[entry_header, key, value]``)
    — multi-part payloads reach the kernel as separate iovec entries, so a
    large value is never staged through a concatenation copy anywhere
    between the caller and ``pwritev``."""
    if isinstance(payload, (bytes, bytearray, memoryview)):
        return [payload]
    return list(payload)


def payload_len(payload) -> int:
    """Byte length of a (possibly multi-part) record payload."""
    if isinstance(payload, (bytes, bytearray, memoryview)):
        return len(payload)
    return sum(len(p) for p in payload)


@dataclass
class WalConfig:
    segment_size: int = 4 * 1024 * 1024
    sync_interval_s: float = 0.05
    preallocate: bool = True
    background: bool = True       # run mapper/syncer threads
    copy_threads: int = 1         # concurrent payload copiers per batch
    # Runs below this size are never split across copiers: the pool
    # dispatch would cost more than the memcpy it parallelizes.  1 MiB is
    # the one default, configured per WalConfig (tests pass a tiny value
    # to force multi-sub-run batches out of small records).
    copy_split_bytes: int = 1 << 20


class Wal:
    """Append-only segmented log with atomic position allocation."""

    def __init__(self, directory: str, name: str, config: WalConfig | None = None,
                 metrics: Metrics | None = None, *,
                 copy_threads: Optional[int] = None,
                 copy_pool: Optional[CopyPool] = None,
                 io: Optional[IoBackend] = None):
        self.dir = directory
        self.name = name
        self.cfg = config or WalConfig()
        self.metrics = metrics or Metrics()
        self.io = io or DEFAULT_IO
        os.makedirs(directory, exist_ok=True)

        # Payload-copier pool (reserve → parallel copy → commit).  A shared
        # pool may be injected (``TideDB``/``ShardedTideDB`` do); otherwise
        # the WAL owns one sized by ``copy_threads`` (kwarg wins over cfg).
        if copy_pool is not None:
            self._copy_pool, self._owns_copy_pool = copy_pool, False
        else:
            n = self.cfg.copy_threads if copy_threads is None else copy_threads
            self._copy_pool, self._owns_copy_pool = CopyPool(n), True
        # Test hook: called with the sub-run index before each copy; raising
        # (or blocking) simulates a writer killed mid-batch for the
        # crash-consistency fuzz and the flush-latch tests.
        self.copy_fault: Optional[Callable[[int], None]] = None
        # Completion latches for in-flight copies: opened under _alloc_lock
        # at reservation, closed when the reservation's bytes are on (or
        # past) the page cache.  flush() waits on every latch open at its
        # start — the durability gate that keeps a sync-acknowledged record
        # from sitting above an unwritten hole at fsync time.
        self._inflight_lock = threading.Lock()
        self._inflight: dict[int, threading.Event] = {}
        self._inflight_seq = 0
        # Poison headers that could not be written after a failed copy
        # (see _copy_subrun): flush() must drain this before fsyncing or
        # raise — sync durability is never acknowledged over a hole.
        self._poison_backlog: list[tuple[int, int, bytes]] = []

        # Positions whose payload failed its CRC (latent corruption, not a
        # benign stale/relocated read): quarantined so repeated lookups of a
        # known-bad position don't re-pay the read, and so the scrubber and
        # __system can report them.  {pos: observation count}.
        self._quarantine_lock = threading.Lock()
        self._quarantine: dict[int, int] = {}
        self._repaired: set[int] = set()

        self._alloc_lock = threading.Lock()
        self._fd_lock = threading.Lock()
        self._fds: dict[int, int] = {}
        # _dirty_segments is touched from appenders (under _alloc_lock) and
        # the syncer/flush paths (previously under _fd_lock): a single
        # dedicated lock guards every access so a concurrent append can
        # never lose a dirty mark to a racing clear.
        self._dirty_lock = threading.Lock()
        self._dirty_segments: set[int] = set()
        self._synced_upto = 0       # all segments below this idx fsynced+final
        self.tracker = PositionTracker()

        # Per-segment epoch ranges for epoch-granular pruning (§4.4 adapted):
        # rebuilt on replay, persisted via the control region snapshot.
        self._segment_epochs: dict[int, tuple[int, int]] = {}
        self._epoch_lock = threading.Lock()

        # Segments epoch-pruned out of the middle of the live span
        # (drop_segments): their positions read as absent via pos_live and
        # replay skips the holes.  On reopen the set is inferred from the
        # gaps between the surviving segment files.
        self._dropped_segments: set[int] = set()
        # fds retired by GC/pruning await close here for one mapper cycle;
        # guarded by its own lock since droppers and the mapper both touch it.
        self._grave_lock = threading.Lock()
        self._fd_graveyard: list[int] = []

        existing = self._scan_segments()
        self.first_live_pos = (min(existing) * self.cfg.segment_size) if existing else 0
        self._tail = (max(existing) * self.cfg.segment_size) if existing else 0
        if existing:
            self._tail = self._recover_tail(max(existing))
            self._dropped_segments = \
                set(range(min(existing), max(existing) + 1)) - set(existing)
        self.tracker.reset(self._tail)

        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        if self.cfg.background:
            for fn, label in ((self._mapper_loop, "mapper"), (self._syncer_loop, "syncer")):
                t = threading.Thread(target=fn, name=f"{name}-{label}", daemon=True)
                t.start()
                self._threads.append(t)

    # ------------------------------------------------------------- segments
    def _segment_path(self, idx: int) -> str:
        return os.path.join(self.dir, f"{self.name}-{idx:010d}.seg")

    def _scan_segments(self) -> list[int]:
        out = []
        prefix = f"{self.name}-"
        for fn in os.listdir(self.dir):
            if fn.startswith(prefix) and fn.endswith(".seg"):
                out.append(int(fn[len(prefix):-4]))
        return sorted(out)

    def _fd(self, idx: int, create: bool = False) -> int:
        with self._fd_lock:
            fd = self._fds.get(idx)
            if fd is not None:
                return fd
            path = self._segment_path(idx)
            flags = os.O_RDWR | (os.O_CREAT if create else 0)
            fd = self.io.open(path, flags, 0o644)
            if create and self.cfg.preallocate:
                try:
                    self.io.ftruncate(fd, self.cfg.segment_size)
                except OSError:
                    os.close(fd)
                    raise
            self._fds[idx] = fd
            return fd

    def _recover_tail(self, last_idx: int) -> int:
        """Walk the last segment's records to find the append tail."""
        pos = last_idx * self.cfg.segment_size
        end = pos + self.cfg.segment_size
        while pos < end:
            hdr = self._pread_raw(pos, HEADER_SIZE)
            if len(hdr) < HEADER_SIZE:
                break
            rtype, length, crc = _HDR.unpack(hdr)
            if rtype == T_PAD:
                break
            nxt = pos + HEADER_SIZE + length
            if nxt > end:
                break
            pos = nxt
        return pos

    # ------------------------------------------------------ copy latches
    def _latch_open(self) -> tuple[int, threading.Event]:
        """Register an in-flight copy; called under ``_alloc_lock`` so any
        ``flush()`` that starts after our reservation is visible (i.e. any
        flush whose fsync could cover acknowledged data above our hole)
        is guaranteed to see — and wait on — this latch."""
        ev = threading.Event()
        with self._inflight_lock:
            self._inflight_seq += 1
            token = self._inflight_seq
            self._inflight[token] = ev
        return token, ev

    def _latch_close(self, token: int, ev: threading.Event) -> None:
        ev.set()
        with self._inflight_lock:
            self._inflight.pop(token, None)

    def _repair_poison_backlog(self) -> None:
        """Retry the poison-header writes a failed copy left behind;
        raises ``UnrepairedHoleError`` if any hole still cannot be
        repaired (the store-level trigger for degraded mode)."""
        with self._inflight_lock:
            if not self._poison_backlog:
                return
            backlog, self._poison_backlog = self._poison_backlog, []
        failed = []
        for fd, pos, hdr in backlog:
            try:
                self.io.pwrite(fd, hdr, pos)
            except OSError:
                failed.append((fd, pos, hdr))
        if failed:
            with self._inflight_lock:
                self._poison_backlog.extend(failed)
            raise UnrepairedHoleError(
                f"{len(failed)} unrepaired WAL hole(s): "
                "durability cannot be acknowledged")

    def wait_copies(self) -> None:
        """Block until every copy in flight at call time has completed (the
        per-batch completion latch).  New reservations made after this call
        starts are *not* waited for: their positions are above every record
        already acknowledged, so they can never hide one on replay."""
        with self._inflight_lock:
            events = list(self._inflight.values())
        for ev in events:
            ev.wait()

    def _copy_subrun(self, job) -> None:
        """One copier's unit of work: assemble the sub-run's iovec — the
        per-record CRC + header packing happens HERE, on the copier thread,
        where ``zlib.crc32``'s GIL release lets checksums of different
        sub-runs run in parallel — then issue a single vectored positional
        write.  ``copy_fault`` (test hook) fires first so crash fuzz can
        kill selected sub-runs before their bytes land.

        If the copy fails with an I/O error (ENOSPC, EIO — the process is
        still alive, unlike a crash), the sub-run's record *headers* are
        re-written before the error propagates: each failed record then
        replays as a torn payload (skipped by its header length) instead
        of a zero hole that would truncate every later record in the
        segment.  Headers that cannot be written either go onto a repair
        backlog that ``flush()`` must drain before it may fsync — so a
        later sync-acknowledged record can never sit above a hole that
        replay would read as padding.  The caller sees the original
        exception either way."""
        idx, fd, off, nbytes, parts_fn, hdrs_fn = job
        try:
            if self.copy_fault is not None:
                self.copy_fault(idx)
            write_parts(fd, parts_fn(), off, self.io)
        except OSError:
            backlog = []
            for rel, hdr in hdrs_fn():
                try:
                    self.io.pwrite(fd, hdr, off + rel)
                except OSError:
                    backlog.append((fd, off + rel, hdr))
            if backlog:
                with self._inflight_lock:
                    self._poison_backlog.extend(backlog)
            raise

    # ------------------------------------------------------------- appends
    def _pre_resolve_fd(self, rec_len: int) -> None:
        """Resolve (and possibly create + ftruncate) the segment fd this
        record will land in *before* the allocation lock is taken.

        File creation + preallocation can take milliseconds; doing it under
        ``_alloc_lock`` (as ``append`` once did when the mapper hadn't
        pre-allocated the next segment) stalls every concurrent writer.  The
        tail snapshot here is racy — if another writer rolls the segment
        between the snapshot and our reservation, ``_fd`` inside the lock
        pays the creation once — but in the steady state this turns the
        in-lock ``_fd`` call into a dict hit.
        """
        seg_size = self.cfg.segment_size
        tail = self._tail                  # racy snapshot: see docstring
        seg = tail // seg_size
        if rec_len > seg_size - tail % seg_size:
            seg += 1                       # this record will roll
        try:
            self._fd(seg, create=True)
        except OSError:
            pass

    def append(self, rtype: int, payload: bytes, epoch: int = 0,
               app_bytes: Optional[int] = None) -> int:
        """Append one record; returns its WAL position — reserve → copy →
        commit, the scalar instance of the lock-free write protocol.

        The allocation lock covers only the reservation (tail bump, fd
        resolution, dirty mark, epoch note, latch open); header AND payload
        are copied outside it as one vectored write, so concurrent scalar
        writers from independent threads overlap their copies (§3.1's
        lock-free claim, not just the batched one).  Until the copy
        completes the reservation is a hole of zeros; the completion latch
        keeps ``flush()`` from fsync-acknowledging anything above it, and
        crash replay reads the hole as padding (torn tail).

        ``payload`` may be a single buffer or a list of buffers (e.g.
        ``[entry_header, key, value]``); multi-part payloads go to the
        kernel as separate iovec entries, never concatenated.  The CRC and
        header are computed on this thread but outside the lock, so
        concurrent scalar writers checksum in parallel too (``zlib.crc32``
        releases the GIL).

        The caller must later call ``mark_processed(pos)`` once the index
        update for this record has been applied (write-flow step 4, §3.1).
        """
        parts = _parts_of(payload)
        plen = sum(len(p) for p in parts)
        rec_len = HEADER_SIZE + plen
        if rec_len > self.cfg.segment_size:
            raise ValueError(f"record of {rec_len} B exceeds segment size")
        self._pre_resolve_fd(rec_len)
        with self._alloc_lock:
            pos = self._reserve(rec_len)
            seg = pos // self.cfg.segment_size
            fd = self._fd(seg, create=True)
            if epoch or rtype in (T_ENTRY, T_TOMBSTONE, T_BATCH):
                self._note_epoch(seg, epoch)
            with self._dirty_lock:
                self._dirty_segments.add(seg)
            token, ev = self._latch_open()
        try:
            self._copy_subrun((
                0, fd, pos % self.cfg.segment_size, rec_len,
                lambda: [_HDR.pack(rtype, plen, crc32_parts(parts)), *parts],
                lambda: [(0, _HDR.pack(rtype, plen, crc32_parts(parts)))]))
        finally:
            self._latch_close(token, ev)
        self.metrics.add(bytes_written_disk=rec_len, wal_appends=1,
                         bytes_written_app=app_bytes if app_bytes is not None else rec_len)
        return pos

    def append_many(self, records: list[tuple[int, bytes]], epoch: int = 0,
                    app_bytes: Optional[int] = None,
                    epochs: Optional[list[int]] = None,
                    parallel: Optional[bool] = None) -> list[int]:
        """Append N independent records: ONE allocation-lock acquisition
        reserves the whole batch, then the payload copies run in parallel
        OUTSIDE the lock (§3.1: atomic allocation, parallel copy).

        Only record *lengths* are needed before the lock (positions are
        pure length arithmetic); the segment fds the batch will land in are
        pre-resolved (file creation included) outside the critical section.
        Inside the lock, position arithmetic runs vectorized — segment
        rolls via cumsum + searchsorted per touched segment, not a
        per-record branch — producing positions byte-identical to N
        sequential ``append`` calls.  The lock then releases; the coalesced
        same-segment runs are chopped into sub-runs (record-aligned,
        ≥ ``copy_split_bytes`` each) and fanned across the copy pool.  Each
        copier assembles its sub-run's headers — per-record CRCs are
        computed *on the copier thread* (``zlib.crc32`` releases the GIL,
        so checksumming parallelizes with the copies) — and issues one
        ``pwritev`` whose iovec is the record parts themselves: payloads
        may be multi-part (``[entry_header, key, value]``), and no staging
        ``b"".join`` copy exists anywhere on the path.

        Positions are returned only after every copy completes, so callers
        index-apply and ``mark_processed`` only fully-written records.  A
        completion latch (opened under the lock) makes ``flush()`` wait for
        this batch, preserving the invariant the in-lock writes used to: a
        later writer can never be acknowledged durable while this batch's
        bytes are still a hole of zeros.  After a crash such a hole reads
        as padding — replay drops that segment's suffix, exactly the torn
        tail rule.  ``parallel=False`` keeps the copies on the calling
        thread (still outside the lock); ``None`` uses the pool.

        Unlike ``append_batch`` this is NOT atomic: every record replays
        independently, exactly as if appended by N ``append`` calls, and a
        torn tail drops only the suffix of the final run.  Returns the
        per-record WAL positions aligned with ``records``.

        ``epochs`` optionally carries one epoch per record (aligned with
        ``records``); without it every record takes ``epoch``.  Segment
        epoch ranges are noted per record on the segment the record
        actually lands in — identical to N scalar appends — so one batch
        spanning segments (or carrying mixed epochs) can never widen a
        segment's pruning range beyond the records it holds.
        """
        if not records:
            return []
        if epochs is not None and len(epochs) != len(records):
            raise ValueError("epochs must align 1:1 with records")
        seg_size = self.cfg.segment_size
        eps = (np.asarray(list(epochs), dtype=np.int64) if epochs is not None
               else np.full(len(records), epoch, dtype=np.int64))
        note = np.zeros(len(records), dtype=bool)
        rec_parts: list[list] = []
        plens: list[int] = []
        lens = np.empty(len(records), dtype=np.int64)
        for i, (rtype, payload) in enumerate(records):
            # Inlined _parts_of + payload_len: two function calls per
            # record are measurable at small-value batch sizes.  Keep the
            # accepted payload types in sync with _parts_of.
            if isinstance(payload, (bytes, bytearray, memoryview)):
                parts, plen = [payload], len(payload)
            else:
                parts = list(payload)
                plen = sum(map(len, parts))
            rec_len = HEADER_SIZE + plen
            if rec_len > seg_size:
                raise ValueError(f"record of {rec_len} B exceeds segment size")
            rec_parts.append(parts)
            plens.append(plen)
            lens[i] = rec_len
            note[i] = bool(eps[i]) or rtype in (T_ENTRY, T_TOMBSTONE, T_BATCH)
        cum = np.empty(len(records) + 1, dtype=np.int64)
        cum[0] = 0
        np.cumsum(lens, out=cum[1:])
        total = int(cum[-1])
        # Pre-resolve every segment the batch could touch (racy tail
        # snapshot + one segment of roll slack): in the steady state the
        # in-lock ``_fd`` calls below are dict hits, never file creation.
        tail_guess = self._tail
        for s in range(tail_guess // seg_size,
                       (tail_guess + total) // seg_size + 2):
            try:
                self._fd(s, create=True)
            except OSError:
                break
        positions = np.empty(len(records), dtype=np.int64)
        run_bounds: list[tuple[int, int, int, int]] = []  # (start, i, j, fd)
        with self._alloc_lock:
            i, n = 0, len(records)
            while i < n:
                rem = seg_size - self._tail % seg_size
                # Largest j with cum[j] - cum[i] <= rem: records i..j-1 fit
                # in the current segment's remainder.
                j = int(np.searchsorted(cum, cum[i] + rem, side="right")) - 1
                if j <= i:
                    # Roll: zero padding, marked processed immediately
                    # (same as the scalar _reserve).
                    self.tracker.mark(self._tail, self._tail + rem)
                    self._tail += rem
                    continue
                # One contiguous run: records i..j-1 land back to back in
                # the current segment.
                run_start = self._tail
                for r in range(i, j):
                    positions[r] = run_start + int(cum[r] - cum[i])
                run_bounds.append((run_start, i, j,
                                   self._fd(run_start // seg_size, create=True)))
                self._tail += int(cum[j] - cum[i])
                i = j
            rec_segs = positions // seg_size
            segs = np.unique(rec_segs)
            for s in segs:
                m = note & (rec_segs == s)
                if m.any():
                    e = eps[m]
                    self._note_epoch_range(int(s), int(e.min()), int(e.max()))
            with self._dirty_lock:
                self._dirty_segments.update(int(s) for s in segs)
            token, ev = self._latch_open()
        # --- parallel copy, outside the allocation lock ---
        use_pool = parallel is not False
        subruns = self._plan_subruns(run_bounds, records, rec_parts, plens,
                                     cum,
                                     self._copy_pool.threads if use_pool else 1)
        try:
            if use_pool:
                self._copy_pool.run(self._copy_subrun, subruns)
            else:
                for job in subruns:
                    self._copy_subrun(job)
        finally:
            self._latch_close(token, ev)
        self.metrics.add(bytes_written_disk=total, wal_appends=len(records),
                         batched_write_records=len(records),
                         batched_append_runs=len(run_bounds),
                         parallel_copy_subruns=len(subruns),
                         bytes_written_app=(app_bytes if app_bytes is not None
                                            else total))
        return positions.tolist()

    def _plan_subruns(self, run_bounds, records, rec_parts, plens, cum,
                      copiers: int) -> list:
        """Chop each coalesced same-segment run into record-aligned
        sub-runs of roughly ``run_bytes / copiers`` (never below
        ``copy_split_bytes``) so one large run parallelizes across the
        pool.  Each sub-run is (index, fd, segment_offset, nbytes,
        parts_fn, hdrs_fn); ``parts_fn`` assembles the alternating
        header/payload iovec on the copier thread — that is where the
        per-record CRCs are computed, deliberately inside the parallel
        region — and ``hdrs_fn`` yields (relative_offset, header) pairs
        for the I/O-error poison pass."""
        seg_size = self.cfg.segment_size
        split = max(1, self.cfg.copy_split_bytes)
        subruns: list = []

        def builder(lo: int, hi: int):
            def hdr_of(r: int) -> bytes:
                parts = rec_parts[r]
                crc = (crc32(parts[0]) if len(parts) == 1
                       else crc32_parts(parts))
                return _HDR.pack(records[r][0], plens[r], crc)

            def build():
                iov: list = []
                for r in range(lo, hi):
                    iov.append(hdr_of(r))
                    iov.extend(rec_parts[r])
                return iov

            def hdrs():
                base = int(cum[lo])
                return [(int(cum[r]) - base, hdr_of(r))
                        for r in range(lo, hi)]

            return build, hdrs

        for run_start, i, j, fd in run_bounds:
            run_bytes = int(cum[j] - cum[i])
            chunk = max(split, -(-run_bytes // max(1, copiers)))
            r = i
            while r < j:
                sub_start = int(cum[r])
                sub_pos = run_start + (sub_start - int(cum[i]))
                e = r
                while e < j and int(cum[e + 1]) - sub_start <= chunk:
                    e += 1
                if e == r:                 # single record larger than chunk
                    e += 1
                build, hdrs = builder(r, e)
                subruns.append((len(subruns), fd, sub_pos % seg_size,
                                int(cum[e]) - sub_start, build, hdrs))
                r = e
        return subruns

    def append_batch(self, subrecords: list[tuple[int, bytes]],
                     epoch: int = 0,
                     app_bytes: Optional[int] = None) -> tuple[int, list[int]]:
        """Atomically append a batch (§3.1).  Returns (batch_pos, sub_positions).

        The outer BATCH payload is assembled as interleaved header/payload
        *parts* (sub-payloads may themselves be multi-part) and handed to
        ``append`` unjoined — the iovec carries them straight to the
        kernel.  Sub-record CRCs are computed here (they live inside the
        outer payload); the outer CRC rides the normal copy path."""
        parts: list = []
        sub_lens: list[int] = []
        for t, p in subrecords:
            sub = _parts_of(p)
            plen = sum(len(x) for x in sub)
            parts.append(_HDR.pack(t, plen, crc32_parts(sub)))
            parts.extend(sub)
            sub_lens.append(plen)
        pos = self.append(T_BATCH, parts, epoch=epoch, app_bytes=app_bytes)
        sub_positions = []
        off = pos + HEADER_SIZE
        for plen in sub_lens:
            sub_positions.append(off)
            off += HEADER_SIZE + plen
        return pos, sub_positions

    def _reserve(self, rec_len: int) -> int:
        """Bump the tail; roll to the next segment if the record won't fit."""
        seg_size = self.cfg.segment_size
        rem = seg_size - (self._tail % seg_size)
        if rec_len > rem:
            # Leave zero padding; replay jumps segments.  The padding counts
            # as processed immediately or the watermark would stall here.
            self.tracker.mark(self._tail, self._tail + rem)
            self._tail += rem
        pos = self._tail
        self._tail += rec_len
        return pos

    def _note_epoch(self, seg: int, epoch: int) -> None:
        self._note_epoch_range(seg, epoch, epoch)

    def _note_epoch_range(self, seg: int, lo: int, hi: int) -> None:
        with self._epoch_lock:
            cur = self._segment_epochs.get(seg)
            if cur is None:
                self._segment_epochs[seg] = (lo, hi)
            else:
                self._segment_epochs[seg] = (min(cur[0], lo), max(cur[1], hi))

    def mark_processed(self, pos: int, payload_len: int) -> int:
        return self.tracker.mark(pos, pos + HEADER_SIZE + payload_len)

    def mark_processed_many(self, items) -> int:
        """Batched ``mark_processed``: ``items`` is an iterable of
        (pos, payload_len); one tracker-lock acquisition covers them all and
        contiguous records merge into one range before hitting the heap."""
        return self.tracker.mark_many(
            (pos, pos + HEADER_SIZE + plen) for pos, plen in items)

    @property
    def tail(self) -> int:
        with self._alloc_lock:
            return self._tail

    # --------------------------------------------------------------- reads
    def _pread_raw(self, pos: int, n: int) -> bytes:
        seg = pos // self.cfg.segment_size
        off = pos % self.cfg.segment_size
        n = min(n, self.cfg.segment_size - off)
        try:
            fd = self._fd(seg)
        except FileNotFoundError:
            return b""
        data = self.io.pread(fd, n, off)
        self.metrics.add(bytes_read_disk=len(data))
        return data

    def pread(self, pos: int, n: int) -> bytes:
        """Raw positional read (used for optimistic index windows)."""
        return self._pread_raw(pos, n)

    # Bounded retry for transient read errors (EIO from a loaded device,
    # injected faults): a handful of attempts with exponential backoff, then
    # the error surfaces as a typed WalHoleError.
    READ_RETRIES = 3

    def _pread_retry(self, pos: int, n: int) -> bytes:
        delay = 0.0005
        for attempt in range(self.READ_RETRIES):
            try:
                return self._pread_raw(pos, n)
            except OSError:
                if attempt == self.READ_RETRIES - 1:
                    raise
                self.metrics.add(read_retries=1)
                time.sleep(delay)
                delay *= 4

    def _quarantine_pos(self, pos: int) -> None:
        with self._quarantine_lock:
            if self.segment_missing(pos // self.cfg.segment_size):
                # Dropped or GC'd under the reader: its bytes are gone, not
                # corrupt, and the next GC would prune the entry anyway.
                return
            if pos in self._repaired:
                # Already repaired: the index no longer references these
                # bytes (a healthy copy sits at a later position), so a
                # stale read or scrub pass re-tripping over the carcass is
                # not a new failure and must not resurrect the quarantine.
                return
            first = pos not in self._quarantine
            self._quarantine[pos] = self._quarantine.get(pos, 0) + 1
        # crc_failures counts *distinct* corrupt positions: every scrub
        # pass (and every read retry) re-detects the same bad bytes, and
        # counting each observation would make one rotted record look like
        # an ongoing corruption storm.  Observation counts stay per-position
        # in the quarantine map.
        self.metrics.add(crc_failures=1 if first else 0,
                         quarantined_positions=1 if first else 0)

    def quarantined(self) -> dict[int, int]:
        """Positions whose payload failed CRC, with observation counts."""
        with self._quarantine_lock:
            return dict(self._quarantine)

    def mark_repaired(self, pos: int) -> bool:
        """A healthy copy of the record at ``pos`` was re-appended (or the
        position is otherwise dead to the index): remove it from quarantine
        and remember it as repaired so later reads/scrub passes of the
        stale bytes neither re-quarantine nor re-report it.  The repaired
        set is pruned with the quarantine map once segment GC reclaims the
        bytes.  Returns True when the position was quarantined."""
        with self._quarantine_lock:
            was = self._quarantine.pop(pos, None) is not None
            self._repaired.add(pos)
        if was:
            self.metrics.add(repaired_positions=1)
        return was

    def repaired(self) -> frozenset:
        """Positions cleared from quarantine by repair (bytes still on
        disk until GC; scrub skips them)."""
        with self._quarantine_lock:
            return frozenset(self._repaired)

    def read_record(self, pos: int, verify: bool = True) -> tuple[int, bytes]:
        """Read + verify one record.  Failures raise the typed taxonomy
        (all subclasses of ``KeyError``, so position-retry loops upstream
        keep working): ``WalHoleError`` for unreadable/dropped positions,
        ``TornRecordError`` for truncated payloads, ``CorruptionError``
        for CRC mismatches (which also quarantine the position)."""
        try:
            hdr = self._pread_retry(pos, HEADER_SIZE)
        except OSError as e:
            raise WalHoleError(f"WAL position {pos} unreadable: {e}",
                               pos) from e
        if len(hdr) < HEADER_SIZE:
            raise WalHoleError(f"WAL position {pos} unreadable", pos)
        rtype, length, crc = _HDR.unpack(hdr)
        try:
            payload = self._pread_retry(pos + HEADER_SIZE, length)
        except OSError as e:
            raise WalHoleError(f"WAL record at {pos} unreadable: {e}",
                               pos) from e
        if len(payload) < length:
            raise TornRecordError(f"WAL record at {pos} truncated", pos)
        if verify and crc32(payload) != crc:
            self._quarantine_pos(pos)
            raise CorruptionError(f"WAL record at {pos} failed CRC", pos)
        return rtype, payload

    def read_records_batch(self, positions, *, max_run_bytes: int = 1 << 20,
                           max_gap: int = 32 * 1024) -> dict:
        """Coalesced positional reads for a batch of record positions.

        Positions are sorted and grouped into runs (same segment, bounded
        gap between neighbours, bounded total span); each run is served by a
        single pread covering every member's header, with at most one extra
        pread for the run's final record payload.  Returns
        ``{pos: (rtype, payload)}``; positions whose header/CRC checks fail
        (e.g. relocated underneath the caller) are simply absent — callers
        retry those through the scalar path.
        """
        out: dict[int, tuple[int, bytes]] = {}
        uniq = sorted(set(positions))
        if not uniq:
            return out
        seg_size = self.cfg.segment_size
        runs: list[list[int]] = [[uniq[0]]]
        for p in uniq[1:]:
            cur = runs[-1]
            if (p // seg_size == cur[0] // seg_size
                    and p - cur[-1] <= max_gap
                    and p + HEADER_SIZE - cur[0] <= max_run_bytes):
                cur.append(p)
            else:
                runs.append([p])
        for run in runs:
            start = run[0]
            buf = self._pread_raw(start, run[-1] + HEADER_SIZE - start)
            self.metrics.add(batched_read_runs=1)
            # Header parse: one fancy-indexing gather for long runs (the
            # numpy fixed cost amortizes), per-record struct unpacks below
            # that.
            if len(run) >= 32 and len(buf) >= HEADER_SIZE:
                offs = np.asarray(run, dtype=np.int64) - start
                ok = offs + HEADER_SIZE <= len(buf)
                safe = np.where(ok, offs, 0)
                bufn = np.frombuffer(buf, dtype=np.uint8)
                hdrs = bufn[safe[:, None] + np.arange(HEADER_SIZE)]
                rtypes = hdrs[:, 0].astype(np.int64)
                lengths = hdrs[:, 1:5].copy().view("<u4").reshape(-1)
                crcs = hdrs[:, 5:9].copy().view("<u4").reshape(-1)
                parsed = [(int(offs[i]), int(rtypes[i]), int(lengths[i]),
                           int(crcs[i])) if ok[i] else None
                          for i in range(len(run))]
            else:
                parsed = []
                for p in run:
                    off = p - start
                    if off + HEADER_SIZE > len(buf):
                        parsed.append(None)
                        continue
                    rtype, length, crc = _HDR.unpack_from(buf, off)
                    parsed.append((off, rtype, length, crc))
            # CRC verification over zero-copy memoryview slices (ROADMAP
            # item): payload bytes materialize only for records that pass,
            # so a run full of stale/relocated positions costs no copies.
            # Only the run's tail record, which can extend past the
            # buffer, still pays a scalar pread + post-copy check.
            mv = memoryview(buf)
            for p, rec in zip(run, parsed):
                if rec is None:
                    continue                      # short read: caller retries
                off, rtype, length, crc = rec
                if p % seg_size + HEADER_SIZE + length > seg_size:
                    continue                      # impossible span: stale pos
                view = mv[off + HEADER_SIZE:off + HEADER_SIZE + length]
                if len(view) == length:
                    if crc32(view) != crc:
                        continue
                    payload = bytes(view)
                else:
                    payload = bytes(view) + self._pread_raw(
                        p + HEADER_SIZE + len(view), length - len(view))
                    if len(payload) < length or crc32(payload) != crc:
                        continue
                out[p] = (rtype, payload)
        return out

    def iter_records(self, from_pos: int = 0,
                     stop_pos: Optional[int] = None) -> Iterator[tuple[int, int, bytes]]:
        """Replay iterator: yields (pos, type, payload); expands batches into
        their sub-records (skipping torn batches wholesale)."""
        seg_size = self.cfg.segment_size
        pos = max(from_pos, self.first_live_pos)
        tail = stop_pos if stop_pos is not None else self.tail
        while pos < tail:
            if seg_size - pos % seg_size < HEADER_SIZE:
                pos = (pos // seg_size + 1) * seg_size   # tiny tail padding
                continue
            hdr = self._pread_raw(pos, HEADER_SIZE)
            if len(hdr) < HEADER_SIZE:
                # Short read mid-log: the segment file was dropped by epoch
                # pruning (possibly between the snapshot this replay started
                # from and now).  Skip the hole, not the whole suffix.
                seg = pos // seg_size
                if self.segment_missing(seg) and (seg + 1) * seg_size < tail:
                    pos = (seg + 1) * seg_size
                    continue
                break
            rtype, length, crc = _HDR.unpack(hdr)
            if rtype == T_PAD:
                pos = (pos // seg_size + 1) * seg_size       # segment jump
                continue
            nxt = pos + HEADER_SIZE + length
            if nxt > (pos // seg_size + 1) * seg_size or nxt > tail:
                break                                        # torn tail
            payload = self._pread_raw(pos + HEADER_SIZE, length)
            if crc32(payload) != crc:
                # Torn payload (poisoned header from a failed copy, or
                # latent corruption): skipped, never yielded.
                self.metrics.add(replay_torn_records=1)
                pos = nxt
                continue
            if rtype == T_BATCH:
                yield from self._iter_batch(pos, payload)
            else:
                yield pos, rtype, payload
            pos = nxt

    def _iter_batch(self, batch_pos: int, body: bytes) -> Iterator[tuple[int, int, bytes]]:
        subs, off = [], 0
        while off < len(body):
            if off + HEADER_SIZE > len(body):
                return                                       # torn batch: drop
            rtype, length, crc = _HDR.unpack_from(body, off)
            payload = body[off + HEADER_SIZE:off + HEADER_SIZE + length]
            if len(payload) < length or crc32(payload) != crc:
                return                                       # torn batch: drop
            subs.append((batch_pos + HEADER_SIZE + off, rtype, payload))
            off += HEADER_SIZE + length
        yield from subs

    # -------------------------------------------------- background threads
    def _mapper_loop(self) -> None:
        while not self._stop.wait(self.cfg.sync_interval_s):
            self._mapper_once()

    def _mapper_once(self) -> None:
        # Pre-allocate the segment after the tail so writers never block on
        # file creation (the paper's pre-allocated map buffer).
        if self.cfg.preallocate:
            nxt = self.tail // self.cfg.segment_size + 1
            try:
                self._fd(nxt, create=True)
            except OSError:
                pass
        self._gc_segments()

    def _gc_segments(self) -> None:
        # Close fds unlinked on a *previous* cycle: in-flight preads holding
        # an old index/value pointer keep working across the unlink (POSIX),
        # and the deferred close removes the read-after-close race.
        with self._grave_lock:
            graveyard, self._fd_graveyard = self._fd_graveyard, []
        for fd in graveyard:
            try:
                os.close(fd)
            except OSError:
                pass

        first_seg = self.first_live_pos // self.cfg.segment_size
        with self._fd_lock:
            dead = [i for i in self._fds
                    if i < first_seg or i in self._dropped_segments]
        for i in sorted(dead):
            with self._fd_lock:
                fd = self._fds.pop(i, None)
            if fd is not None:
                with self._grave_lock:
                    self._fd_graveyard.append(fd)
            try:
                os.unlink(self._segment_path(i))
                self.metrics.add(segments_deleted=1)
            except FileNotFoundError:
                pass
            with self._epoch_lock:
                self._segment_epochs.pop(i, None)
        # Dropped segments that sank below the watermark need no further
        # pos_live screening — the first_live_pos check subsumes them.
        if self._dropped_segments:
            self._dropped_segments = \
                {s for s in self._dropped_segments if s >= first_seg}
        # Quarantined/repaired positions whose bytes were reclaimed are moot.
        with self._quarantine_lock:
            if self._quarantine:
                self._quarantine = {p: c for p, c in self._quarantine.items()
                                    if self.pos_live(p)}
            if self._repaired:
                self._repaired = {p for p in self._repaired
                                  if self.pos_live(p)}

    def advance_gc_watermark(self, pos: int) -> None:
        """Files entirely below ``pos`` may be deleted (§4.4, file-granular GC)."""
        self.first_live_pos = max(self.first_live_pos, pos)
        if not self.cfg.background:
            self._gc_segments()

    def _syncer_loop(self) -> None:
        while not self._stop.wait(self.cfg.sync_interval_s):
            self._sync_finalized()

    def _sync_finalized(self) -> None:
        """fsync segments that are finalized (fully below the processed
        watermark) — the paper's asynchronous durability tier."""
        final_seg = self.tracker.last_processed // self.cfg.segment_size
        with self._dirty_lock:
            todo = sorted(s for s in self._dirty_segments if s < final_seg)
            self._dirty_segments.difference_update(todo)
        for s in todo:
            try:
                self.io.fsync(self._fd(s))
            except (OSError, FileNotFoundError):
                pass

    def flush(self) -> None:
        """Synchronous durability: fsync every dirty segment (explicit flush
        for applications needing kernel-crash durability, §3.1).

        Waits first for every payload copy in flight at entry (the
        completion latch): an fsync must never acknowledge durability for
        bytes that sit *above* a reserved-but-unwritten hole, or a crash
        would replay the hole as padding and silently drop the acknowledged
        record.  Copies reserved after this flush starts are not waited for
        — their positions are above everything this flush can acknowledge.

        Raises ``OSError`` if a failed copy's poison headers still cannot
        be written (see ``_copy_subrun``): acknowledging durability over
        an unrepaired hole would let crash replay read it as padding and
        drop records above it."""
        self.wait_copies()
        self._repair_poison_backlog()
        # Clear marks *before* fsyncing: a concurrent append that re-dirties
        # a segment mid-flush re-adds its mark (an extra fsync later) rather
        # than having it lost to the post-fsync discard.
        with self._dirty_lock:
            todo = sorted(self._dirty_segments)
            self._dirty_segments.clear()
        for s in todo:
            try:
                self.io.fsync(self._fd(s))
            except FileNotFoundError:
                pass                      # segment pruned underneath us
            except OSError:
                # fsync failed: restore the mark so the next flush retries
                # instead of silently reporting durability.
                with self._dirty_lock:
                    self._dirty_segments.add(s)

    def has_dirty(self) -> bool:
        """True while segments still carry dirty marks.  ``flush()``
        swallows per-segment fsync failures (re-marking the segment for the
        next attempt), so "flush returned but marks survived" is the signal
        that durability was NOT established — ``TideDB.try_recover`` uses
        it to refuse declaring the disk healthy."""
        with self._dirty_lock:
            return bool(self._dirty_segments)

    def has_poison_backlog(self) -> bool:
        """True while failed copies still have unrepaired poison headers
        queued (``flush()`` must drain them before acknowledging)."""
        with self._inflight_lock:
            return bool(self._poison_backlog)

    # ----------------------------------------------------------- epochs/gc
    def segment_epochs(self) -> dict[int, tuple[int, int]]:
        with self._epoch_lock:
            return dict(self._segment_epochs)

    def segments_expired_below_epoch(self, epoch: int) -> list[int]:
        """Whole segments whose max epoch < ``epoch`` — droppable without
        relocating a single byte (the paper's epoch-based pruning).

        Expired segments anywhere in the live span qualify, not just a
        prefix: ``drop_segments`` supports mid-log holes, so an old-epoch
        segment sandwiched between newer ones is reclaimed immediately
        instead of waiting for relocation to clear everything below it.
        Segments with no recorded epoch range (e.g. ranges lost to a crash
        before the next control-region snapshot) are never dropped."""
        first_seg = self.first_live_pos // self.cfg.segment_size
        tail_seg = self.tail // self.cfg.segment_size
        out = []
        with self._epoch_lock:
            for seg in range(first_seg, tail_seg):
                if seg in self._dropped_segments:
                    continue
                rng = self._segment_epochs.get(seg)
                if rng is not None and rng[1] < epoch:
                    out.append(seg)
        return out

    def pos_live(self, pos: int) -> bool:
        """False for positions reclaimed by GC or epoch pruning: below the
        file-granular watermark, or inside a dropped mid-log segment."""
        if pos < self.first_live_pos:
            return False
        return not self._dropped_segments or \
            pos // self.cfg.segment_size not in self._dropped_segments

    def segment_missing(self, seg: int) -> bool:
        """True when ``seg``'s file no longer exists (GC'd or dropped)."""
        if seg < self.first_live_pos // self.cfg.segment_size:
            return True
        return seg in self._dropped_segments

    def drop_segments(self, segs) -> int:
        """Unlink whole expired segments (§4.4 epoch pruning), mid-log drops
        included.  Zero bytes relocated: readers observe the hole through
        ``pos_live`` and replay skips it.  fds are retired through the
        mapper graveyard (deferred close), so an in-flight pread racing the
        drop still reads the unlinked file instead of a closed fd."""
        seg_size = self.cfg.segment_size
        tail_seg = self.tail // seg_size
        dropped = 0
        for s in sorted(segs):
            if s >= tail_seg:
                continue                   # never the open tail segment
            self._dropped_segments.add(s)
            try:
                os.unlink(self._segment_path(s))
                self.metrics.add(segments_deleted=1)
            except FileNotFoundError:
                pass
            with self._epoch_lock:
                self._segment_epochs.pop(s, None)
            dropped += 1
        with self._dirty_lock:
            self._dirty_segments.difference_update(self._dropped_segments)
        # Fold a dropped prefix into the watermark so file-granular GC (and
        # the pos_live fast path) see the simplest possible live span.
        first = self.first_live_pos // seg_size
        while first < tail_seg and first in self._dropped_segments:
            first += 1
        self.advance_gc_watermark(first * seg_size)
        return dropped

    def close(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)
        try:
            self.flush()                  # waits for in-flight copies too
        except OSError:
            # Best-effort durability at teardown: the failure was already
            # surfaced to the writer that hit it (and degraded the store);
            # close must still release threads and descriptors.
            pass
        if self._owns_copy_pool:
            self._copy_pool.close()
        with self._fd_lock:
            for fd in self._fds.values():
                os.close(fd)
            self._fds.clear()
        with self._grave_lock:
            graveyard, self._fd_graveyard = self._fd_graveyard, []
        for fd in graveyard:
            try:
                os.close(fd)
            except OSError:
                pass

    def abandon(self) -> None:
        """Simulate a crash: release threads and descriptors WITHOUT
        flushing, repairing poison headers, or fsyncing anything.  The
        on-disk state is exactly what a kill -9 would leave; used by the
        crash-consistency fuzz (see ``TideDB.crash``)."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)
        self.wait_copies()                # join in-flight copier pwritevs only
        if self._owns_copy_pool:
            self._copy_pool.close()
        with self._fd_lock:
            for fd in self._fds.values():
                os.close(fd)
            self._fds.clear()
        with self._grave_lock:
            graveyard, self._fd_graveyard = self._fd_graveyard, []
        for fd in graveyard:
            try:
                os.close(fd)
            except OSError:
                pass
