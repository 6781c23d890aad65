"""Asynchronous index flushing (§4.3).

The flusher captures a snapshot of a cell's dirty buffer, serializes (or
merges with the previous on-disk index) in the background while the cell
keeps accepting writes, appends the new index blob to the Index Store, and
finally performs the *unmerge*: entries included in the flush are removed
from the in-memory buffer, keeping only entries that arrived after the flush
began.  Readers concurrently use the old index pointer until the atomic
pointer swap — readers and writers operate on disjoint Index Store regions.
"""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from .index import FORMATS, is_tombstone, real_pos
from .large_table import Cell, CellState, LargeTable
from .util import Metrics
from .wal import HEADER_SIZE, T_FILTER, T_INDEX, Wal


class Flusher:
    def __init__(self, table: LargeTable, index_wal: Wal, value_wal: Wal,
                 n_threads: int = 2, metrics: Optional[Metrics] = None,
                 persist_filters: bool = True):
        self.table = table
        self.index_wal = index_wal
        self.value_wal = value_wal
        self.metrics = metrics or Metrics()
        # Persist each flush's Bloom filter as a T_FILTER record right
        # after its index blob, so reopen restores filters with one pread
        # instead of a lazy rebuild (DbConfig.persist_filters gates it).
        self.persist_filters = persist_filters
        # Optional StatsCollector (the __system keyspace subsystem): flush
        # events feed the per-keyspace rollups.  Set by TideDB after
        # construction; None = no observation.
        self.collector = None
        # Optional failure callback (set by TideDB): background flushes run
        # on pool threads where an exception has no caller to propagate to,
        # so unrecoverable I/O errors are reported here and can degrade the
        # store instead of dying in a stack trace.
        self.on_error = None
        self.pool = ThreadPoolExecutor(max_workers=n_threads,
                                       thread_name_prefix="tide-flusher")
        self._closed = False

    # ------------------------------------------------------------ schedule
    def flush_dirty(self, threshold: int = 0, wait: bool = False) -> int:
        futures = []
        for ks_id, cell in self.table.dirty_cells(threshold):
            futures.append(self.submit(ks_id, cell))
        if wait:
            for f in futures:
                f.result()
        return len(futures)

    def flush_all(self) -> None:
        """Synchronous full flush (used by close/snapshot-now paths)."""
        self.flush_dirty(threshold=1, wait=True)

    def submit(self, ks_id: int, cell: Cell):
        return self.pool.submit(self._safe_flush, ks_id, cell)

    def _safe_flush(self, ks_id: int, cell: Cell) -> None:
        try:
            self.flush_cell(ks_id, cell)
        except Exception as e:
            # I/O errors with a registered handler are *expected* failures
            # (disk full, injected faults): the handler classifies them and
            # degrades the store if terminal — no stack-trace spam.  Logic
            # bugs (anything else) still print in full.
            if not (isinstance(e, OSError) and self.on_error is not None):
                import traceback
                traceback.print_exc()
            with self.table.ks(ks_id).row_lock(cell.cell_id):
                cell.flushing = False
            if self.on_error is not None:
                try:
                    self.on_error(e)
                except Exception:
                    pass

    # ------------------------------------------------------------ the work
    def flush_cell(self, ks_id: int, cell: Cell) -> bool:
        ks = self.table.ks(ks_id)
        cfg = ks.cfg

        # Phase 1 (under row lock): snapshot the dirty buffer + watermark.
        with ks.row_lock(cell.cell_id):
            if cell.flushing or cell.dirty_count == 0:
                return False
            cell.flushing = True
            snapshot = dict(cell.mem)
            was_loaded = cell.state == CellState.DIRTY_LOADED
            old_disk = (cell.disk_pos, cell.disk_len, cell.disk_count)
            new_flushed_upto = self.value_wal.tracker.last_processed

        try:
            # Phase 2 (no lock): merge + serialize + append to Index Store.
            merged = dict(snapshot)
            if not was_loaded and old_disk[0] is not None and old_disk[2] > 0:
                for k, p in self.table._load_disk_entries(ks, cell):
                    cur = merged.get(k)
                    if cur is None or real_pos(cur) < p:
                        merged[k] = p
            serialize, _, _ = FORMATS[cfg.index_format]
            blob, count = serialize(merged, cfg.key_len)
            rec_pos = self.index_wal.append(T_INDEX, blob)
            self.index_wal.mark_processed(rec_pos, len(blob))
            payload_pos = rec_pos + HEADER_SIZE
            self.metrics.add(index_flushes=1)

            # Rebuild the bloom filter over the complete live key set.
            bloom = None
            if cfg.use_bloom:
                from .bloom import BloomFilter
                bloom = BloomFilter(max(count, 64), cfg.bloom_bits_per_key)
                for k, p in merged.items():
                    if not is_tombstone(p):
                        bloom.add(k)

            # Persist the filter next to its index blob (serialized NOW,
            # before phase 3 seeds post-snapshot dirty keys into the live
            # filter: the persisted bits must cover exactly the blob's key
            # set, so a reopen-time load is bit-identical to a rebuild —
            # dirty-buffer keys re-seed from the WAL replay either way).
            filter_pos, filter_len = None, 0
            if bloom is not None and self.persist_filters:
                fblob = bloom.to_bytes()
                frec = self.index_wal.append(T_FILTER, fblob)
                self.index_wal.mark_processed(frec, len(fblob))
                filter_pos, filter_len = frec + HEADER_SIZE, len(fblob)
                self.metrics.add(bloom_filters_persisted=1)

            if self.collector is not None:
                self.collector.note_flush(ks_id, len(blob) + filter_len)

            # Phase 3 (under row lock): unmerge + atomic pointer swap.
            with ks.row_lock(cell.cell_id):
                removed = 0
                for k, p in snapshot.items():
                    if cell.mem.get(k) == p:
                        del cell.mem[k]
                        removed += 1
                self.table._bump_mem(-removed)
                cell.disk_pos = payload_pos
                cell.disk_len = len(blob)
                cell.disk_count = count
                cell.flushed_upto = new_flushed_upto
                cell.bloom = bloom
                cell.filter_pos, cell.filter_len = filter_pos, filter_len
                cell.approx_keys = count
                if cell.mem:
                    cell.state = CellState.DIRTY_UNLOADED
                    cell.min_dirty_pos = min(real_pos(p) for p in cell.mem.values())
                    if bloom is not None:
                        for k, p in cell.mem.items():
                            if not is_tombstone(p):
                                bloom.add(k)
                else:
                    cell.state = CellState.UNLOADED
                    cell.min_dirty_pos = None
            # The old blob is no longer referenced: return its memo budget
            # now instead of waiting for LRU aging (relocation of the Index
            # Store reuses positions never, so this can't evict live data).
            if old_disk[0] is not None:
                self.table.blob_cache.invalidate(old_disk[0])
            return True
        finally:
            with ks.row_lock(cell.cell_id):
                cell.flushing = False

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self.pool.shutdown(wait=True)
