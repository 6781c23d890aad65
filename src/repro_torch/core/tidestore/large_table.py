"""The Large Table: sharded, lazily-resident key → WAL-position index (§4.1).

- Keys partition into **cells**.  Uniform keyspaces (hash keys) use a
  pre-allocated fixed array of cells; prefix keyspaces grow a dynamic map
  (the paper's B-tree mode) keyed by the key prefix.
- Cells group into **rows** protected by sharded mutexes, so operations on
  different key ranges never contend.
- Each cell is in one of five states (paper Fig./§4.1):
  EMPTY, LOADED, UNLOADED, DIRTY_LOADED, DIRTY_UNLOADED.  DirtyUnloaded is
  the crucial one: a write to a cold cell buffers only the new entry and
  never forces a multi-megabyte index load.
- Reads on unloaded cells go through the optimistic (or header) on-disk
  lookup — a point read into the Index Store, not a full load (§3.2).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Iterator, Optional

import numpy as np

from .bloom import BloomFilter
from .cache import BlobArrayCache
from .index import (FORMATS, blob_to_arrays, entry_size, is_tombstone,
                    load_blob_arrays, real_pos)
from .util import Metrics

# Below this many disk-resolved queries per batch, the lookup kernel's launch
# and copies cost more than the host searchsorted it replaces.  On the CPU
# the JAX package's value, so that the counters equal the reference's.  On
# the card the value ``chip_smoke.py``'s sweeps measured on two layouts,
# phase 3's store (2^20 keys, 256 cells) and one shard of phase 8's (2^18
# keys, 64 cells, as full a cell): on both the host route won below 2048
# queries, 4096 was unresolved, and the kernel route won at 8192, 16384
# and 32768 (PERF.md §6).  Other layouts were not measured.
_KERNEL_MIN_QUERIES = {"cpu": 128, "cuda": 8192}


def kernel_min_queries(device: str) -> int:
    """The lookup kernel's routing threshold on ``device`` ("cuda:0" → its
    type's)."""
    return _KERNEL_MIN_QUERIES[device.split(":")[0]]


def _lookup_host(q32: np.ndarray, u32: np.ndarray):
    """The host route of the batched lookup: each query's lower bound in
    the sorted ``u32`` → (idx, found), as the kernel's resolve entry."""
    idx = np.searchsorted(u32, q32, side="left").astype(np.int64)
    safe = np.minimum(idx, len(u32) - 1)
    return idx, (idx < len(u32)) & (u32[safe] == q32)


class CellState(Enum):
    EMPTY = 0
    LOADED = 1
    UNLOADED = 2
    DIRTY_LOADED = 3
    DIRTY_UNLOADED = 4


@dataclass
class KeyspaceConfig:
    name: str
    key_len: int = 32
    distribution: str = "uniform"          # "uniform" | "prefix"
    n_cells: int = 256                     # uniform: fixed cell array size
    prefix_len: int = 4                    # prefix mode: bytes of key per cell
    n_rows: int = 64                       # sharded mutex count
    index_format: str = "optimistic"       # "optimistic" | "header"
    window_entries: int = 800              # optimistic read window (§4.2)
    bloom_bits_per_key: int = 10
    use_bloom: bool = True
    dirty_flush_threshold: int = 4096      # entries before background flush


class Cell:
    __slots__ = ("cell_id", "state", "mem", "disk_pos", "disk_len", "disk_count",
                 "flushed_upto", "min_dirty_pos", "bloom", "flushing", "approx_keys",
                 "filter_pos", "filter_len")

    def __init__(self, cell_id):
        self.cell_id = cell_id
        self.state = CellState.EMPTY
        self.mem: dict[bytes, int] = {}
        self.disk_pos: Optional[int] = None   # Index Store payload offset
        self.disk_len: int = 0
        self.disk_count: int = 0
        self.filter_pos: Optional[int] = None  # persisted Bloom filter offset
        self.filter_len: int = 0
        self.flushed_upto: int = 0             # WAL covered by the disk index
        self.min_dirty_pos: Optional[int] = None
        self.bloom: Optional[BloomFilter] = None
        self.flushing = False
        self.approx_keys = 0                   # for bloom sizing

    @property
    def dirty_count(self) -> int:
        if self.state in (CellState.DIRTY_LOADED, CellState.DIRTY_UNLOADED):
            return len(self.mem)
        return 0

    def has_disk(self) -> bool:
        return self.disk_pos is not None and self.disk_count > 0


class Keyspace:
    def __init__(self, ks_id: int, cfg: KeyspaceConfig, metrics: Metrics):
        self.ks_id = ks_id
        self.cfg = cfg
        self.metrics = metrics
        self._rows = [threading.RLock() for _ in range(cfg.n_rows)]
        if cfg.distribution == "uniform":
            # Pre-allocated fixed-size cell array (§4.1, uniform keys).
            self.cells: dict = {i: Cell(i) for i in range(cfg.n_cells)}
            self._prefixes = None
        else:
            # Dynamic prefix map — grows with new prefixes (B-tree mode).
            self.cells = {}
            self._prefixes: list[bytes] = []   # kept sorted (bisect)
            self._prefix_lock = threading.Lock()

    # ---------------------------------------------------------- cell lookup
    def cell_id_for_key(self, key: bytes) -> object:
        if self.cfg.distribution == "uniform":
            h = int.from_bytes(key[:4].ljust(4, b"\x00"), "big")
            return (h * self.cfg.n_cells) >> 32
        return key[: self.cfg.prefix_len]

    def cell_for_key(self, key: bytes, create: bool = True) -> Optional[Cell]:
        cid = self.cell_id_for_key(key)
        cell = self.cells.get(cid)
        if cell is None and self.cfg.distribution == "prefix" and create:
            import bisect
            with self._prefix_lock:
                cell = self.cells.get(cid)
                if cell is None:
                    cell = Cell(cid)
                    self.cells[cid] = cell
                    bisect.insort(self._prefixes, cid)
        return cell

    def row_lock(self, cell_id) -> threading.RLock:
        return self._rows[hash(cell_id) % self.cfg.n_rows]

    def ordered_cell_ids(self) -> list:
        if self.cfg.distribution == "uniform":
            return list(range(self.cfg.n_cells))
        with self._prefix_lock:
            return list(self._prefixes)

    def prev_cell_id(self, cid) -> Optional[object]:
        if self.cfg.distribution == "uniform":
            return cid - 1 if cid > 0 else None
        import bisect
        with self._prefix_lock:
            i = bisect.bisect_left(self._prefixes, cid)
            return self._prefixes[i - 1] if i > 0 else None


class LargeTable:
    """All keyspaces + the read/update protocol against the Index Store."""

    def __init__(self, keyspaces: list[KeyspaceConfig], index_pread,
                 metrics: Optional[Metrics] = None,
                 blob_cache_bytes: int = 8 * 1024 * 1024,
                 reserved=None, device: str = "cuda"):
        """``keyspaces`` get positional ids (list index = ks_id, the stable
        user contract).  ``reserved`` is an optional list of (ks_id, cfg)
        pairs with EXPLICIT ids outside the positional range — engine-owned
        keyspaces (``__system``) whose persisted rows must never re-attach
        to a user keyspace when the configured list changes across
        reopens.  ``device`` is where the batched read kernels run ("cuda",
        or "cpu" for their plain PyTorch versions)."""
        self.metrics = metrics or Metrics()
        self.device = device
        self.keyspaces = [Keyspace(i, cfg, self.metrics)
                          for i, cfg in enumerate(keyspaces)]
        self.by_name = {cfg.name: i for i, cfg in enumerate(keyspaces)}
        for ks_id, cfg in (reserved or ()):
            if ks_id < len(keyspaces) or cfg.name in self.by_name:
                raise ValueError(
                    f"reserved keyspace {cfg.name!r} (id {ks_id}) collides "
                    f"with a positional keyspace")
            self.keyspaces.append(Keyspace(ks_id, cfg, self.metrics))
            self.by_name[cfg.name] = ks_id
        self._by_id = {ks.ks_id: ks for ks in self.keyspaces}
        self._index_pread = index_pread        # (pos, n) -> bytes, Index Store
        self.blob_cache = BlobArrayCache(blob_cache_bytes)
        self.mem_entries = 0                   # global residency counter
        self._mem_lock = threading.Lock()

    def ks(self, ks_id: int) -> Keyspace:
        return self._by_id[ks_id]

    def has_ks(self, ks_id: int) -> bool:
        return ks_id in self._by_id

    def _bump_mem(self, delta: int) -> None:
        with self._mem_lock:
            self.mem_entries += delta

    # --------------------------------------------------------------- writes
    def apply(self, ks_id: int, key: bytes, pos_marker: int) -> bool:
        """Apply a write (insert or tombstone, per TOMB_FLAG) to the table.
        Conflict rule (§3.1): the operation with the higher WAL position wins.
        Returns True if the table changed."""
        ks = self.ks(ks_id)
        cell = ks.cell_for_key(key)
        with ks.row_lock(cell.cell_id):
            cur = cell.mem.get(key)
            if cur is not None and real_pos(cur) >= real_pos(pos_marker):
                return False
            if cur is None:
                self._bump_mem(1)
            cell.mem[key] = pos_marker
            p = real_pos(pos_marker)
            if cell.min_dirty_pos is None or p < cell.min_dirty_pos:
                cell.min_dirty_pos = p
            if not is_tombstone(pos_marker):
                cell.approx_keys += 0 if cur is not None else 1
                if cell.bloom is not None:
                    cell.bloom.add(key)
            if cell.state == CellState.EMPTY:
                cell.state = CellState.DIRTY_LOADED
            elif cell.state == CellState.LOADED:
                cell.state = CellState.DIRTY_LOADED
            elif cell.state == CellState.UNLOADED:
                cell.state = CellState.DIRTY_UNLOADED   # buffer only (§4.1)
            return True

    def apply_many(self, items) -> int:
        """Batched ``apply`` (§3.1 vectorized index update): ``items`` is a
        list of (ks_id, key, pos_marker) in WAL-position order.

        Markers group per cell; each touched cell takes its row lock ONCE
        for the whole group, new keys feed one vectorized ``bloom.add_many``
        per cell, the state transition runs once per cell, and the global
        mem-budget counter bumps once for the whole batch.  List order is
        preserved inside each cell, so same-key markers resolve exactly as
        sequential ``apply`` calls (higher WAL position wins).  Returns the
        number of markers that changed the table.
        """
        groups: dict[tuple[int, object], tuple[Cell, list]] = {}
        for ks_id, key, marker in items:
            cell = self.ks(ks_id).cell_for_key(key)
            ent = groups.get((ks_id, cell.cell_id))
            if ent is None:
                ent = groups[(ks_id, cell.cell_id)] = (cell, [])
            ent[1].append((key, marker))
        changed = 0
        mem_delta = 0
        for (ks_id, cid), (cell, kv) in groups.items():
            ks = self.ks(ks_id)
            with ks.row_lock(cid):
                cell_changed = 0
                bloom_keys = []
                for key, marker in kv:
                    cur = cell.mem.get(key)
                    if cur is not None and real_pos(cur) >= real_pos(marker):
                        continue
                    if cur is None:
                        mem_delta += 1
                    cell.mem[key] = marker
                    p = real_pos(marker)
                    if cell.min_dirty_pos is None or p < cell.min_dirty_pos:
                        cell.min_dirty_pos = p
                    if not is_tombstone(marker):
                        if cur is None:
                            cell.approx_keys += 1
                        if cell.bloom is not None:
                            bloom_keys.append(key)
                    cell_changed += 1
                if cell_changed:
                    if bloom_keys:
                        cell.bloom.add_many(bloom_keys)
                    if cell.state in (CellState.EMPTY, CellState.LOADED):
                        cell.state = CellState.DIRTY_LOADED
                    elif cell.state == CellState.UNLOADED:
                        cell.state = CellState.DIRTY_UNLOADED
                changed += cell_changed
        if mem_delta:
            self._bump_mem(mem_delta)
        return changed

    def compare_and_set(self, ks_id: int, key: bytes,
                        expect_pos: Optional[int],
                        new_marker: int) -> bool:
        """Relocation CAS (§4.4): update only if the key still points at
        ``expect_pos``; a concurrent write to a higher position wins.
        ``expect_pos=None`` means "only while still absent" — the repair
        path's insert CAS for keys whose corrupt record was dropped at
        replay (the index holds nothing, so any concurrent foreground
        write makes the slot non-absent and the repair copy loses)."""
        ks = self.ks(ks_id)
        cell = ks.cell_for_key(key)
        with ks.row_lock(cell.cell_id):
            cur, _ = self._position_locked(ks, cell, key)
            if expect_pos is None:
                if cur is not None:
                    return False
            elif cur is None or real_pos(cur) != expect_pos:
                return False
            if cell.mem.get(key) is None:
                self._bump_mem(1)
            cell.mem[key] = new_marker
            p = real_pos(new_marker)
            if cell.min_dirty_pos is None or p < cell.min_dirty_pos:
                cell.min_dirty_pos = p
            if cell.state == CellState.UNLOADED:
                cell.state = CellState.DIRTY_UNLOADED
            elif cell.state == CellState.LOADED:
                cell.state = CellState.DIRTY_LOADED
            elif cell.state == CellState.EMPTY:
                cell.state = CellState.DIRTY_LOADED
            return True

    def compare_and_set_many(self, items) -> list[bool]:
        """Batched relocation CAS (§4.4): ``items`` is a list of
        (ks_id, key, expect_pos, new_marker).  Returns one success flag per
        item, aligned with the input.

        Grouped per cell like ``apply_many`` — each touched cell takes its
        row lock ONCE for its whole group and the global mem-budget counter
        bumps once per batch — but the conflict rule is strictly CAS, never
        higher-position-wins: a relocated copy sits at the WAL tail yet
        carries the *old* value, so it must lose to any concurrent write
        that moved the key off the captured position."""
        items = list(items)
        groups: dict[tuple[int, object], tuple[Cell, list]] = {}
        for idx, (ks_id, key, expect_pos, new_marker) in enumerate(items):
            cell = self.ks(ks_id).cell_for_key(key)
            ent = groups.get((ks_id, cell.cell_id))
            if ent is None:
                ent = groups[(ks_id, cell.cell_id)] = (cell, [])
            ent[1].append((idx, key, expect_pos, new_marker))
        out = [False] * len(items)
        mem_delta = 0
        for (ks_id, cid), (cell, group) in groups.items():
            ks = self.ks(ks_id)
            with ks.row_lock(cid):
                cell_changed = 0
                for idx, key, expect_pos, new_marker in group:
                    cur, _ = self._position_locked(ks, cell, key)
                    if cur is None or real_pos(cur) != expect_pos:
                        continue
                    if cell.mem.get(key) is None:
                        mem_delta += 1
                    cell.mem[key] = new_marker
                    p = real_pos(new_marker)
                    if cell.min_dirty_pos is None or p < cell.min_dirty_pos:
                        cell.min_dirty_pos = p
                    out[idx] = True
                    cell_changed += 1
                if cell_changed:
                    if cell.state == CellState.UNLOADED:
                        cell.state = CellState.DIRTY_UNLOADED
                    elif cell.state in (CellState.LOADED, CellState.EMPTY):
                        cell.state = CellState.DIRTY_LOADED
        if mem_delta:
            self._bump_mem(mem_delta)
        return out

    # ---------------------------------------------------------------- reads
    def _bounded_pread(self, base: int, lim: int):
        """Index Store pread clamped to the blob at [base, base + lim):
        the single source of the bound arithmetic every disk-index reader
        shares (an ``off`` at/past ``lim`` degenerates to a short read the
        callers already treat as a GC race)."""
        return lambda off, n: self._index_pread(base + off, min(n, lim - off))

    def _ensure_bloom(self, ks: Keyspace, cell: Cell) -> None:
        """Restore a missing Bloom filter on first probe after reopen
        (§3.2): recovery restores cell disk pointers but not in-memory
        filters, so a freshly reopened store would answer every cold
        ``exists`` through Index Store reads until the first flush.

        Fast path: flush persisted the filter next to the index blob (a
        ``T_FILTER`` record; the control region carries its position), so
        the first probe loads it back with one small pread — no index
        parse, no key rehashing.  Fallback: rebuild from the on-disk index
        exactly as before (stores written before filters were persisted,
        or a filter record lost to Index Store GC).  Either way the work
        happens *outside* the row lock (paid once per cell per process),
        the filter is seeded with the live dirty buffer under the lock,
        and installs only if the cell still points at the same blob — a
        racing flush installs its own complete filter and wins.  Keys
        applied after the install reach the filter through the normal
        ``apply`` path (bloom is non-None from then on)."""
        if cell.bloom is not None or not ks.cfg.use_bloom:
            return
        # Unlocked pre-check (racy reads, re-verified under the lock): a
        # never-flushed cell has no disk blob to rebuild from, and must not
        # pay a second row-lock acquisition on every probe forever.
        if cell.disk_pos is None or cell.state not in (
                CellState.UNLOADED, CellState.DIRTY_UNLOADED):
            return
        with ks.row_lock(cell.cell_id):
            if (cell.bloom is not None
                    or cell.state not in (CellState.UNLOADED,
                                          CellState.DIRTY_UNLOADED)
                    or not cell.has_disk()):
                return
            snap = (cell.disk_pos, cell.disk_len, cell.disk_count,
                    cell.filter_pos, cell.filter_len)
        bloom = None
        if snap[3] is not None and snap[4] > 0:
            try:
                raw = self._index_pread(snap[3], snap[4])
                if len(raw) == snap[4]:
                    bloom = BloomFilter.from_bytes(raw)
                    self.metrics.add(bloom_filters_loaded=1)
            except Exception:
                bloom = None     # torn/GCed filter record: rebuild below
        if bloom is None:
            _, _, load_fn = FORMATS[ks.cfg.index_format]
            try:
                entries = load_fn(self._bounded_pread(snap[0], snap[1]),
                                  snap[2], ks.cfg.key_len)
            except Exception:
                return   # GC/flush race: keep answering through disk reads
            if len(entries) < snap[2]:
                return   # short read (blob replaced underneath us)
            bloom = BloomFilter(max(snap[2], 64), ks.cfg.bloom_bits_per_key)
            bloom.add_many([k for k, p in entries if not is_tombstone(p)])
            self.metrics.add(bloom_lazy_rebuilds=1)
        with ks.row_lock(cell.cell_id):
            if cell.bloom is None and cell.disk_pos == snap[0]:
                bloom.add_many([k for k, p in cell.mem.items()
                                if not is_tombstone(p)])
                cell.bloom = bloom

    def _disk_lookup(self, ks: Keyspace, cell: Cell, key: bytes) -> Optional[int]:
        if not cell.has_disk():
            return None
        _, lookup_cls, _ = FORMATS[ks.cfg.index_format]
        pread = self._bounded_pread(cell.disk_pos, cell.disk_len)
        lk = lookup_cls(pread, cell.disk_count, ks.cfg.key_len,
                        window_entries=ks.cfg.window_entries, metrics=self.metrics)
        pos, _ = lk.lookup(key)
        return pos

    def _position_locked(self, ks: Keyspace, cell: Cell,
                         key: bytes) -> tuple[Optional[int], bool]:
        """Effective position marker for key; (marker, was_from_disk)."""
        cur = cell.mem.get(key)
        if cur is not None:
            return cur, False
        if cell.state in (CellState.LOADED, CellState.DIRTY_LOADED):
            return None, False                 # fully resident: absent
        disk = self._disk_lookup(ks, cell, key)
        return (disk, True) if disk is not None else (None, True)

    def get_position(self, ks_id: int, key: bytes) -> Optional[int]:
        """Key → WAL position marker (tombstones yield None)."""
        ks = self.ks(ks_id)
        cell = ks.cell_for_key(key, create=False)
        if cell is None:
            return None
        with ks.row_lock(cell.cell_id):
            marker, _ = self._position_locked(ks, cell, key)
        if marker is None or is_tombstone(marker):
            return None
        return real_pos(marker)

    def exists(self, ks_id: int, key: bytes, min_live_pos: int = 0,
               pos_live=None) -> bool:
        """Existence check resolved entirely from index state (§3.2) —
        never touches the Value WAL.  This is the 15.6× operation.  The
        Bloom gate routes through the same ``probe_cells`` arithmetic as
        the fused batch path (single-query numpy fast path), so scalar and
        batched answers can never diverge.

        ``pos_live`` (optional ``pos -> bool``, typically
        ``Wal.pos_live``) screens positions inside mid-log segments dropped
        by epoch pruning: the watermark check alone cannot see those holes
        because this path never touches the WAL."""
        ks = self.ks(ks_id)
        cell = ks.cell_for_key(key, create=False)
        if cell is None:
            return False
        self._ensure_bloom(ks, cell)       # first probe after reopen rebuilds
        with ks.row_lock(cell.cell_id):
            if cell.bloom is not None and not cell.bloom.might_contain(key):
                self.metrics.add(bloom_negative=1)
                return False
            marker, _ = self._position_locked(ks, cell, key)
        if marker is None or is_tombstone(marker):
            return False
        p = real_pos(marker)
        if p < min_live_pos:
            return False
        return pos_live is None or pos_live(p)

    # -------------------------------------------------------- batched reads
    def _fused_bloom_pass(self, ks: Keyspace, probe, out, use_kernel) -> list:
        """ONE ragged Bloom probe across every (cell, keys, bloom) group in
        ``probe``: keys hash once, the touched cells' bitsets pack into one
        ``probe_cells`` call — a single kernel launch per store per batch
        however many cells the batch touches.  Negatives are recorded
        as absent in ``out``; returns the surviving (cell, keys) groups.

        Runs OUTSIDE the row locks (the kernel's launch and its device
        round trip must not stall writers sharing a row lock;
        the bits arrays only ever gain bits, so a concurrent add cannot
        produce a false negative for keys already present).  The bloom
        references were snapshotted under each cell's row lock.
        """
        from .bloom import key_hashes_many, probe_cells
        flat = [k for _, keys, _ in probe for k in keys]
        if not flat:
            return []
        h1, h2 = key_hashes_many(flat)
        groups, base = [], 0
        for _, keys, _ in probe:
            groups.append(np.arange(base, base + len(keys)))
            base += len(keys)
        ok = probe_cells([bloom for _, _, bloom in probe], h1, h2, groups,
                         use_kernel=use_kernel, device=self.device)
        self.metrics.add(fused_bloom_probes=1,
                         bloom_negative=int(len(flat) - ok.sum()))
        survivors = []
        for (cell, keys, _), g in zip(probe, groups):
            hits = ok[g]
            for k, hit in zip(keys, hits):
                if not hit:
                    out[k] = None
            kept = [k for k, hit in zip(keys, hits) if hit]
            if kept:
                survivors.append((cell, kept))
        return survivors

    def get_positions_batch(self, ks_id: int, keys, *, use_bloom: bool = True,
                            use_kernel: bool = True) -> list:
        """Batched key → position-marker resolution (§3.2 batched).

        Per cell (in cell-id order): check the in-memory buffer under the
        row lock, then run ONE fused Bloom probe across every disk-resident
        cell the batch touches (``_fused_bloom_pass``), and resolve the
        survivors either by whole-blob batched resolution — the parsed blob
        comes from the memo cache or one pread, feeding one
        ``optimistic_lookup`` kernel call across *all* such cells (their
        concatenated u32 key prefixes stay globally sorted, §4.2) — or,
        when a cell is large relative to its query count, or keys are
        variable-width/prefix-distributed, by the per-key windowed path.
        Cells whose parsed blob is already memoized skip the Bloom pass:
        their resolution is exact and in-memory, so the filter could only
        add hashing work.  Returns raw markers aligned with ``keys``
        (tombstone bits preserved; ``None`` = absent).
        """
        if not keys:
            return []
        ks = self.ks(ks_id)
        out: dict[bytes, Optional[int]] = {}
        uniq = list(dict.fromkeys(keys))
        if ks.cfg.distribution != "uniform":
            self._prefix_resolve(ks, uniq, out, use_bloom, use_kernel)
            return [out[k] for k in keys]

        by_cell: dict = {}
        for k in uniq:
            by_cell.setdefault(ks.cell_id_for_key(k), []).append(k)

        pend = []           # (cell, missing|None, snap, memoized, fmt_ok)
        probe = []          # (cell, keys, bloom) → one fused Bloom pass
        for cid in sorted(by_cell):
            cell = ks.cells.get(cid)
            qs = by_cell[cid]
            if cell is None:
                for k in qs:
                    out[k] = None
                continue
            if use_bloom:
                self._ensure_bloom(ks, cell)   # lazy rebuild after reopen
            with ks.row_lock(cid):
                missing = []
                for k in qs:
                    cur = cell.mem.get(k)
                    if cur is not None:
                        out[k] = cur
                    else:
                        missing.append(k)
                if not missing:
                    continue
                if cell.state in (CellState.LOADED, CellState.DIRTY_LOADED,
                                  CellState.EMPTY) or not cell.has_disk():
                    for k in missing:
                        out[k] = None
                    continue
                snap = (cell.disk_pos, cell.disk_len, cell.disk_count)
                bloom = cell.bloom
            blob_fmt_ok = ks.cfg.index_format in ("optimistic", "header")
            memoized = blob_fmt_ok and snap[0] in self.blob_cache
            if not memoized and use_bloom and bloom is not None:
                # Queued for the fused probe; a memoized cell skips it (its
                # exact resolution is already in memory, so the filter
                # could only add hashing work — but for a cold cell a
                # negative spares an all-absent batch the whole-blob read).
                probe.append((cell, missing, bloom))
                pend.append((cell, None, snap, memoized, blob_fmt_ok))
            else:
                pend.append((cell, missing, snap, memoized, blob_fmt_ok))
        surv = ({cell.cell_id: kept for cell, kept in
                 self._fused_bloom_pass(ks, probe, out, use_kernel)}
                if probe else {})

        blob_cells = []     # (cell, missing_keys, disk_pos, disk_len, count)
        perkey = []         # (cell, key) fallback work
        esz = entry_size(ks.cfg.key_len)
        for cell, missing, snap, memoized, blob_fmt_ok in pend:
            if missing is None:
                missing = surv.get(cell.cell_id)
                if not missing:
                    continue
            # Cost model: one whole-blob read beats len(missing) windowed
            # lookups iff the blob is smaller — and a memoized blob costs
            # no read at all, so it always wins.
            per_key_bytes = min(ks.cfg.window_entries * esz, snap[2] * esz)
            if memoized or (blob_fmt_ok and
                            len(missing) * per_key_bytes >= snap[2] * esz):
                blob_cells.append((cell, missing) + snap)
            else:
                perkey.extend((cell, k) for k in missing)

        if blob_cells:
            self._blob_resolve(ks, blob_cells, out, use_kernel, perkey)
        if perkey:
            self._perkey_resolve(ks, perkey, out, use_bloom=False)
        return [out[k] for k in keys]

    def _prefix_resolve(self, ks: Keyspace, uniq, out, use_bloom,
                        use_kernel) -> None:
        """Prefix-keyspace batched resolution: the windowed per-key path,
        but behind the same single fused Bloom probe as the uniform path.
        Only keys that would actually go to disk (cell unloaded, key not in
        the dirty buffer at snapshot time) are gated by the filter — keys
        resident in memory resolve regardless, so tombstone markers keep
        their bits."""
        probe = []          # (cell, keys, bloom)
        work = []           # (cell, key) per-key lookups
        by_cell: dict = {}
        for k in uniq:
            cell = ks.cell_for_key(k, create=False)
            if cell is None:
                out[k] = None
                continue
            by_cell.setdefault(cell.cell_id, (cell, []))[1].append(k)
        for cell, qs in by_cell.values():
            gated, bloom = [], None
            if use_bloom:
                self._ensure_bloom(ks, cell)   # lazy rebuild after reopen
                with ks.row_lock(cell.cell_id):
                    if cell.has_disk() and cell.state in (
                            CellState.UNLOADED, CellState.DIRTY_UNLOADED):
                        bloom = cell.bloom
                    if bloom is not None:
                        gated = [k for k in qs if cell.mem.get(k) is None]
            if gated:
                probe.append((cell, gated, bloom))
                gset = set(gated)
                qs = [k for k in qs if k not in gset]
            work.extend((cell, k) for k in qs)
        for cell, kept in self._fused_bloom_pass(ks, probe, out, use_kernel):
            work.extend((cell, k) for k in kept)
        self._perkey_resolve(ks, work, out, use_bloom=False)

    def _blob_resolve(self, ks: Keyspace, blob_cells, out, use_kernel,
                      perkey) -> None:
        """Whole-blob batched resolution across cells: per cell, parsed
        ``(u32, pos, keys)`` arrays come from the memo cache or one pread +
        parse (then memoized); one kernel (or searchsorted) call runs over
        the concatenation."""
        key_len = ks.cfg.key_len
        fmt = ks.cfg.index_format
        parts = []                       # (missing, u32_c, pos_c, keys_c)
        for cell, missing, dpos, dlen, dcount in blob_cells:
            ent = self.blob_cache.get(dpos)
            if ent is None:
                pread = self._bounded_pread(dpos, dlen)
                buf, n = load_blob_arrays(pread, dcount, key_len, fmt)
                if n < dcount:          # short read (GC race): per-key retry
                    perkey.extend((cell, k) for k in missing)
                    continue
                u32_c, pos_c, keys_c, nbytes = blob_to_arrays(buf, n, key_len)
                if cell.disk_pos == dpos:
                    # A flush that raced this read already invalidated dpos
                    # and swapped the cell to a new blob; memoizing the old
                    # one would strand dead budget until LRU aging.
                    self.blob_cache.put(dpos, (u32_c, pos_c, keys_c), nbytes)
                self.metrics.add(batched_blob_reads=1)
            else:
                u32_c, pos_c, keys_c = ent
                self.metrics.add(blob_cache_hits=1)
            parts.append((missing, u32_c, pos_c, keys_c))
        if not parts:
            return
        u32 = (parts[0][1] if len(parts) == 1
               else np.concatenate([p[1] for p in parts]))
        pos = (parts[0][2] if len(parts) == 1
               else np.concatenate([p[2] for p in parts]))
        keybuf = (parts[0][3] if len(parts) == 1
                  else b"".join(p[3] for p in parts))
        total = len(u32)
        queries = [k for missing, _, _, _ in parts for k in missing]
        q32 = np.frombuffer(
            b"".join(k[:4].ljust(4, b"\x00") for k in queries),
            dtype=">u4").astype(np.uint32)
        if use_kernel and len(queries) >= kernel_min_queries(self.device):
            from ...kernels.optimistic_lookup.ops import lookup_indices_batch
            idx, found = lookup_indices_batch(q32, u32,
                                              window=ks.cfg.window_entries,
                                              device=self.device)
            self.metrics.add(batched_kernel_lookups=len(queries))
        else:
            idx, found = _lookup_host(q32, u32)
        self.metrics.add(index_lookups=len(queries))
        # Vectorized full-key verification: in the common case (no u32
        # prefix collision) the landing index either IS the query key or
        # the key is absent — one gathered row compare decides all queries
        # at once.  Only collision runs fall back to the per-query walk.
        idx = np.asarray(idx, dtype=np.int64)
        found = np.asarray(found, dtype=bool)
        safe = np.minimum(idx, total - 1)
        if all(len(k) == key_len for k in queries):
            qmat = np.frombuffer(b"".join(queries),
                                 np.uint8).reshape(len(queries), key_len)
            karr = np.frombuffer(keybuf, np.uint8).reshape(total, key_len)
            exact = found & (karr[safe] == qmat).all(axis=1)
        else:
            exact = np.zeros(len(queries), dtype=bool)
        has_run = found & ~exact
        for qi in np.flatnonzero(exact):
            out[queries[qi]] = int(pos[safe[qi]])
        for qi in np.flatnonzero(~found):
            out[queries[qi]] = None
        for qi in np.flatnonzero(has_run):
            k, q, j = queries[qi], q32[qi], int(idx[qi])
            marker = None
            # The kernel may land mid-run when several keys share a u32
            # prefix (its window rank counts strictly-smaller entries
            # from the window start, not the array start): rewind to the
            # run's first entry, then walk forward comparing full keys.
            while j > 0 and u32[j - 1] == q:
                j -= 1
            while j < total and u32[j] == q:
                if keybuf[j * key_len:(j + 1) * key_len] == k:
                    marker = int(pos[j])
                    break
                j += 1
            out[k] = marker

    def _perkey_resolve(self, ks: Keyspace, work, out, use_bloom) -> None:
        """Per-key path: row lock + (bloom +) point lookup.  The batch
        entry points pass ``use_bloom=False`` — their filtering already
        happened in the fused pass; the scalar bloom branch remains for
        direct callers."""
        for cell, key in work:
            if cell is None:
                out[key] = None
                continue
            with ks.row_lock(cell.cell_id):
                if use_bloom and cell.bloom is not None and \
                        cell.mem.get(key) is None and \
                        not cell.bloom.might_contain(key):
                    self.metrics.add(bloom_negative=1)
                    out[key] = None
                    continue
                marker, _ = self._position_locked(ks, cell, key)
            out[key] = marker

    # -------------------------------------------------------- load / evict
    def load_cell(self, ks_id: int, cell: Cell) -> None:
        """Bring a cell fully into memory (disk index ∪ dirty buffer)."""
        ks = self.ks(ks_id)
        with ks.row_lock(cell.cell_id):
            if cell.state in (CellState.LOADED, CellState.DIRTY_LOADED,
                              CellState.EMPTY):
                return
            disk_entries = self._load_disk_entries(ks, cell)
            added = 0
            for k, p in disk_entries:
                cur = cell.mem.get(k)
                if cur is None:
                    cell.mem[k] = p
                    added += 1
                # else: mem entry is newer (higher pos) by construction
            self._bump_mem(added)
            cell.state = (CellState.DIRTY_LOADED
                          if cell.state == CellState.DIRTY_UNLOADED
                          else CellState.LOADED)

    def _load_disk_entries(self, ks: Keyspace, cell: Cell) -> list[tuple[bytes, int]]:
        if not cell.has_disk():
            return []
        _, _, load_fn = FORMATS[ks.cfg.index_format]
        pread = self._bounded_pread(cell.disk_pos, cell.disk_len)
        return load_fn(pread, cell.disk_count, ks.cfg.key_len)

    def evict_cell(self, ks_id: int, cell: Cell) -> bool:
        """LOADED → UNLOADED under memory pressure (clean cells only)."""
        ks = self.ks(ks_id)
        with ks.row_lock(cell.cell_id):
            if cell.state != CellState.LOADED or cell.flushing:
                return False
            self._bump_mem(-len(cell.mem))
            cell.mem = {}
            cell.state = CellState.UNLOADED if cell.has_disk() else CellState.EMPTY
            return True

    # ------------------------------------------------------------ iteration
    def dirty_cells(self, threshold: int = 0) -> Iterator[tuple[int, Cell]]:
        for ks in self.keyspaces:
            th = threshold if threshold > 0 else ks.cfg.dirty_flush_threshold
            for cell in list(ks.cells.values()):
                if cell.dirty_count >= max(1, th) and not cell.flushing:
                    yield ks.ks_id, cell

    def all_cells(self) -> Iterator[tuple[int, Cell]]:
        for ks in self.keyspaces:
            for cell in list(ks.cells.values()):
                yield ks.ks_id, cell

    def min_index_store_pos(self) -> Optional[int]:
        """Oldest Index Store payload still referenced (Index Store GC bound)."""
        out = None
        for _, cell in self.all_cells():
            if cell.has_disk():
                out = cell.disk_pos if out is None else min(out, cell.disk_pos)
        return out

    def replay_from(self, last_processed: int) -> int:
        """Snapshot replay-from (§3.3): min over cells of the earliest
        unflushed position; cells with no dirty data contribute nothing."""
        out = last_processed
        for _, cell in self.all_cells():
            if cell.dirty_count > 0 and cell.min_dirty_pos is not None:
                out = min(out, cell.min_dirty_pos)
        return out

    # -------------------------------------------------------- reverse iter
    def predecessor(self, ks_id: int, key: bytes,
                    min_live_pos: int = 0) -> tuple[Optional[bytes], Optional[int]]:
        """Largest key strictly smaller than ``key`` with a live value
        position (the paper's reverse-iterator read op)."""
        ks = self.ks(ks_id)
        cid = ks.cell_id_for_key(key)
        probe = key
        while cid is not None:
            cell = ks.cells.get(cid)
            if cell is not None:
                found = self._cell_predecessor(ks, cell, probe, min_live_pos)
                if found is not None:
                    return found
            cid = ks.prev_cell_id(cid)
            probe = b"\xff" * ks.cfg.key_len     # max key for earlier cells
        return None, None

    def _cell_predecessor(self, ks: Keyspace, cell: Cell, key: bytes,
                          min_live_pos: int):
        with ks.row_lock(cell.cell_id):
            # Candidates from the in-memory buffer (may include tombstones).
            mem_items = sorted(k for k in cell.mem if k < key)
            disk_arr = None
            if cell.state in (CellState.UNLOADED, CellState.DIRTY_UNLOADED) \
                    and cell.has_disk():
                _, lookup_cls, _ = FORMATS[ks.cfg.index_format]
                pread = self._bounded_pread(cell.disk_pos, cell.disk_len)
                lk = lookup_cls(pread, cell.disk_count, ks.cfg.key_len,
                                window_entries=ks.cfg.window_entries,
                                metrics=self.metrics)
                disk_arr = lk
            probe = key
            while True:
                best_key, best_marker = None, None
                while mem_items and mem_items[-1] >= probe:
                    mem_items.pop()
                if mem_items:
                    best_key = mem_items[-1]
                    best_marker = cell.mem[best_key]
                if disk_arr is not None:
                    dk, dp, _ = disk_arr.predecessor(probe)
                    if dk is not None and (best_key is None or dk > best_key):
                        best_key, best_marker = dk, dp
                    elif dk is not None and dk == best_key:
                        pass                     # mem wins (newer)
                if best_key is None:
                    return None
                if not is_tombstone(best_marker) \
                        and real_pos(best_marker) >= min_live_pos:
                    return best_key, real_pos(best_marker)
                probe = best_key                 # skip tombstone, continue left
