"""Shared utilities for the tidestore engine.

Implements the paper's "guard-based position tracking" (§3.1, §5): writers
allocate WAL positions atomically, complete out of order, and a tracker
maintains the highest *contiguous* fully-processed position.  That watermark
is what snapshots persist (replay-from bound) and what relocation uses as its
compare-and-set horizon ``L`` (§4.4).
"""
from __future__ import annotations

import heapq
import threading
import zlib
from dataclasses import dataclass, field


def crc32(payload: bytes) -> int:
    return zlib.crc32(payload) & 0xFFFFFFFF


def crc32_parts(parts, base: int = 0) -> int:
    """CRC of the concatenation of ``parts`` without materializing it —
    ``crc32_parts([a, b]) == crc32(a + b)``.  ``zlib.crc32`` releases the
    GIL on large buffers, so copier threads checksum in parallel."""
    c = base
    for p in parts:
        c = zlib.crc32(p, c)
    return c & 0xFFFFFFFF


class PositionTracker:
    """Tracks completion of [start, end) ranges and exposes the highest
    contiguous watermark.  Mirrors the paper's asynchronous-controller
    position tracking: writes complete in any order; ``last_processed``
    advances only when every preceding byte has been processed."""

    def __init__(self, start: int = 0):
        self._lock = threading.Lock()
        self._watermark = start
        self._heap: list[tuple[int, int]] = []

    def mark(self, start: int, end: int) -> int:
        """Mark [start, end) processed; returns the new watermark."""
        with self._lock:
            heapq.heappush(self._heap, (start, end))
            while self._heap and self._heap[0][0] <= self._watermark:
                s, e = heapq.heappop(self._heap)
                if e > self._watermark:
                    self._watermark = e
            return self._watermark

    def mark_many(self, ranges) -> int:
        """Mark many [start, end) ranges under one lock acquisition.

        Adjacent ranges are merged before they reach the heap, so a batched
        append of N contiguous records costs O(runs) heap pushes, not O(N).
        """
        with self._lock:
            run_s = run_e = None
            for s, e in ranges:
                if run_s is None:
                    run_s, run_e = s, e
                elif s == run_e:
                    run_e = e
                else:
                    heapq.heappush(self._heap, (run_s, run_e))
                    run_s, run_e = s, e
            if run_s is not None:
                heapq.heappush(self._heap, (run_s, run_e))
            while self._heap and self._heap[0][0] <= self._watermark:
                s, e = heapq.heappop(self._heap)
                if e > self._watermark:
                    self._watermark = e
            return self._watermark

    @property
    def last_processed(self) -> int:
        with self._lock:
            return self._watermark

    def reset(self, position: int) -> None:
        with self._lock:
            self._watermark = position
            self._heap.clear()


@dataclass
class Metrics:
    """Engine counters.  ``bytes_written_disk / bytes_written_app`` is the
    write-amplification figure the paper reports (§2.2, §6)."""

    bytes_written_app: int = 0
    bytes_written_disk: int = 0
    bytes_read_disk: int = 0
    wal_appends: int = 0
    index_flushes: int = 0
    index_lookups: int = 0
    index_lookup_iterations: int = 0
    batched_append_runs: int = 0       # coalesced pwrite runs (append_many)
    batched_blob_reads: int = 0        # whole-cell index reads (multi_get)
    batched_kernel_lookups: int = 0    # queries resolved via the lookup kernel
    batched_read_keys: int = 0         # keys entering multi_get/multi_exists
    batched_read_runs: int = 0         # coalesced WAL pread runs issued
    batched_write_records: int = 0     # records entering append_many
    blob_cache_hits: int = 0           # memoized parsed-blob reuses
    bloom_negative: int = 0
    bloom_lazy_rebuilds: int = 0       # filters rebuilt on first post-reopen probe
    bloom_filters_persisted: int = 0   # filters written next to index blobs
    bloom_filters_loaded: int = 0      # persisted filters loaded on reopen
    fused_bloom_probes: int = 0        # fused ragged probes (1 per batch)
    parallel_copy_subruns: int = 0     # pwritev sub-runs issued by append_many
    cache_hits: int = 0
    cache_misses: int = 0
    copy_threads_clamped: int = 0      # requested − effective CopyPool threads
    copy_pool_resizes: int = 0         # adaptive CopyPool retunes (governor)
    system_folds: int = 0              # StatsCollector folds into __system
    system_rows_written: int = 0       # rows written by those folds
    relocated_entries: int = 0
    relocated_bytes: int = 0
    relocation_batches: int = 0        # append_many batches issued by relocation
    relocation_cas_fail: int = 0       # relocations lost to a concurrent write
    segments_deleted: int = 0
    segments_pruned: int = 0           # whole segments dropped by epoch expiry
    crc_failures: int = 0              # payload CRC mismatches on reads
    quarantined_positions: int = 0     # distinct positions quarantined
    read_retries: int = 0              # transient read errors retried
    replay_torn_records: int = 0       # torn payloads skipped during replay
    scrub_passes: int = 0              # full scrub sweeps completed
    scrub_records_checked: int = 0     # records CRC-verified by the scrubber
    scrub_corruptions_found: int = 0   # corrupt records the scrubber flagged
    degraded_transitions: int = 0      # ok -> degraded (read-only) flips
    degraded_recoveries: int = 0       # degraded -> ok via try_recover
    recover_probes: int = 0            # try_recover disk re-probes attempted
    recover_probes_skipped: int = 0    # re-probes refused by the rate limit
    read_failovers: int = 0            # replicated reads served off-primary
    replica_write_misses: int = 0      # replica writes shed to resync debt
    repaired_positions: int = 0        # quarantined positions cleared by repair
    repair_appends: int = 0            # healthy copies re-appended by repair
    repair_cas_fail: int = 0           # repairs lost to a concurrent write
    repair_fetch_failures: int = 0     # repairs with no healthy peer copy
    resync_records: int = 0            # records replayed into a rejoined shard
    resync_runs: int = 0               # anti-entropy resyncs completed
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def add(self, **kwargs: int) -> None:
        with self._lock:
            for k, v in kwargs.items():
                setattr(self, k, getattr(self, k) + v)

    @property
    def write_amplification(self) -> float:
        if self.bytes_written_app == 0:
            return 0.0
        return self.bytes_written_disk / self.bytes_written_app

    def snapshot(self) -> dict:
        with self._lock:
            return {
                k: getattr(self, k)
                for k in self.__dataclass_fields__
                if not k.startswith("_")
            }
