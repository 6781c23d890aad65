"""The ``__system`` keyspace — a self-observing store (ROADMAP item).

Scylla-style system tables (cf. ``system.large_partitions`` /
``large_rows`` / ``large_cells``) inside the engine itself: ``TideDB``
reserves a keyspace named ``__system`` and periodically folds a set of
low-overhead workload counters into it, so operators can find the whale
keys that dominate WAL growth, the hottest cells, and per-keyspace
traffic rollups *through the normal Engine API* — ``db.keyspace(
"__system")``, ``multi_get``, and ``prev``-based prefix scans.  Nothing
here bypasses the engine: rows are ordinary WAL entries, they flush,
snapshot, replay, and survive crash-reopen exactly like user data.

Tables (one fixed-width 16-byte row key each; values are msgpack dicts):

- ``keyspace_stats`` — per-keyspace rollups: puts/deletes/reads/exists
  counts, application bytes written, index flush count/bytes, and the
  store-wide write amplification at fold time.
- ``large_values``  — the top-N largest values per keyspace (rank-ordered
  rows; ``{"key": ..., "size": ...}``).
- ``hot_cells``     — the cells with the most read/write traffic per
  keyspace (rank-ordered rows; ``{"cell_id": ..., "reads": ...,
  "writes": ...}``; read attribution is sampled).

Row-key layout (``SYSTEM_KEY_LEN`` = 16 bytes, zero padded)::

    [tag u8][keyspace_id u16 BE][rank u16 BE][0 ... 0]

Big-endian fields keep byte order == (tag, keyspace, rank) order, so a
reverse ``prev`` walk from ``prefix + 0xFF...`` enumerates one table (or
one keyspace's slice of it) without any scan API beyond the Engine
protocol.

``StatsCollector`` is the write-side half: per-keyspace counters updated
from the put/read/flush paths without locks (plain int adds — racy by
design, stats tolerate it), a small lock only around the top-N large-value
map (whose contents are exact, matched against an oracle in tests), and
sampled per-cell attribution for read traffic.  ``fold()`` — called from
``TideDB.snapshot_now`` — writes the tables through ``put_many`` /
``delete_many`` on the engine, which is what makes the stats durable.

``CopierGovernor`` closes the first control loop the signals enable:
it retunes the shared ``CopyPool`` from observed host load instead of the
manual ``DbConfig.copy_threads`` knob (``copy_threads=None`` — the
default — builds an adaptive pool and attaches a governor to it).
"""
from __future__ import annotations

import os
import struct
import threading
import time
from typing import Optional

import msgpack

from .large_table import KeyspaceConfig

SYSTEM_KEYSPACE = "__system"
SYSTEM_KEY_LEN = 16
# The reserved keyspace id: the u16 sentinel, never a user list index.  User
# keyspaces get positional ids (0..n-1); persisting __system rows under a
# FIXED id means WAL entries and control-region cells written before a
# keyspace was added/removed can never re-attach to whichever user keyspace
# now occupies the old index.
SYSTEM_KS_ID = 0xFFFF

TAG_KEYSPACE_STATS = 1
TAG_LARGE_VALUES = 2
TAG_HOT_CELLS = 3
# Tags 4/5/6 are written by the integrity subsystem (scrub.py / repair.py)
# and the degraded-mode transition; they are deliberately NOT in TABLES —
# the workload-rollup readers (read_tables / system_tables) keep their
# shape, and scrub/repair findings have their own readers
# (scrub.read_scrub_table, repair.read_repair_table).
TAG_SCRUB = 4
TAG_HEALTH = 5
TAG_REPAIR = 6
TABLES = {"keyspace_stats": TAG_KEYSPACE_STATS,
          "large_values": TAG_LARGE_VALUES,
          "hot_cells": TAG_HOT_CELLS}

_KEY = struct.Struct(">BHH")             # tag, keyspace_id, rank


def system_keyspace_config() -> KeyspaceConfig:
    """The reserved keyspace's shape: a handful of cells (rows are few and
    tiny), fixed 16-byte keys, and a low flush threshold so folded stats
    reach the Index Store on the next snapshot."""
    return KeyspaceConfig(SYSTEM_KEYSPACE, key_len=SYSTEM_KEY_LEN,
                          n_cells=8, n_rows=8, dirty_flush_threshold=256)


def row_key(tag: int, ks_id: int, rank: int = 0) -> bytes:
    return _KEY.pack(tag, ks_id, rank).ljust(SYSTEM_KEY_LEN, b"\x00")


def decode_row_key(key: bytes) -> tuple[int, int, int]:
    """(tag, keyspace_id, rank) of a ``__system`` row key."""
    return _KEY.unpack_from(key)


def _decode_value(raw: bytes) -> dict:
    return msgpack.unpackb(raw, raw=False, strict_map_key=False)


def scan_rows(engine, tag: int, ks_id: Optional[int] = None) -> list:
    """Enumerate one table (optionally one keyspace's slice) ascending, as
    ``[(key_bytes, value_dict), ...]`` — dogfooding ``Engine.prev``: walk
    predecessors down from the prefix's upper bound until the key leaves
    the prefix.  Works on any Engine whose ``prev`` sees the rows (i.e. a
    single ``TideDB``; the sharded merge is ``ShardedTideDB.
    system_tables``, which runs this per shard)."""
    prefix = (struct.pack(">B", tag) if ks_id is None
              else struct.pack(">BH", tag, ks_id))
    probe = prefix + b"\xff" * (SYSTEM_KEY_LEN - len(prefix))
    out = []
    while True:
        got = engine.prev(probe, keyspace=SYSTEM_KEYSPACE)
        if got is None or not got[0].startswith(prefix):
            break
        out.append((got[0], _decode_value(got[1])))
        probe = got[0]
    out.reverse()
    return out


def read_tables(engine, ks_names: Optional[dict] = None) -> dict:
    """Decode every system table into a friendly dict, keyed by keyspace
    name when ``ks_names`` (ks_id → name) is given, else by ks_id::

        {"keyspace_stats": {ks: {...rollup...}},
         "large_values":   {ks: [{"key":..., "size":...}, ...]},   # rank order
         "hot_cells":      {ks: [{"cell_id":..., "reads":..., "writes":...}]}}
    """
    def label(ks_id):
        return ks_names.get(ks_id, ks_id) if ks_names else ks_id

    out: dict = {"keyspace_stats": {}, "large_values": {}, "hot_cells": {}}
    for name, tag in TABLES.items():
        for key, value in scan_rows(engine, tag):
            _, ks_id, _rank = decode_row_key(key)
            if tag == TAG_KEYSPACE_STATS:
                out[name][label(ks_id)] = value
            else:
                out[name].setdefault(label(ks_id), []).append(value)
    return out


class StatsCollector:
    """Workload observation folded into ``__system`` (the write-side half).

    Hot-path cost model: ``note_*`` calls do one or two un-locked int adds
    per *batch* plus an O(items) sweep that is dominated by integer
    compares (the large-value floor check).  Per-cell read attribution is
    sampled 1-in-``sample`` and scaled, so huge read batches don't pay a
    per-key hash.  The only lock guards the top-N large-value map, taken
    just when a value beats the current floor.

    The top-N map is exact up to ``capacity`` (= 4×top_n) distinct whale
    keys between trims; beyond that, a key trimmed out of the map can
    re-enter only by beating the floor again — the standard top-K sketch
    trade, documented in docs/API.md.
    """

    def __init__(self, db, top_n: int = 8, sample: int = 8):
        self._db = db
        self.top_n = max(1, top_n)
        self.capacity = self.top_n * 4
        self.sample = max(1, sample)
        self._sys_ks = db._system_ks_id
        self._names = {i: cfg.name for i, cfg in enumerate(db.cfg.keyspaces)}
        self._lock = threading.Lock()        # large-value map + fold snapshot
        self._fold_lock = threading.Lock()   # one fold at a time
        self._counts: dict[int, dict] = {}   # ks_id -> delta counters
        self._totals: dict[int, dict] = {}   # ks_id -> persisted rollup
        self._large: dict[int, dict] = {}    # ks_id -> {key: size}
        self._floor: dict[int, int] = {}     # ks_id -> top-N admission floor
        self._hot: dict[int, dict] = {}      # ks_id -> {cell_id: [rd, wr]}
        self._prev_rows: dict[tuple, int] = {}  # (tag, ks_id) -> rows written
        self._tick = 0                       # sampling cursor (racy, fine)
        self._dirty = False

    # ------------------------------------------------------------ tracking
    def _c(self, ks_id: int) -> dict:
        c = self._counts.get(ks_id)
        if c is None:
            c = self._counts.setdefault(ks_id, {
                "puts": 0, "deletes": 0, "reads": 0, "exists": 0,
                "app_bytes": 0, "index_flushes": 0, "index_bytes": 0})
        return c

    def _note_large(self, ks_id: int, key: bytes, size: int) -> None:
        floor = self._floor.get(ks_id, 0)
        large = self._large.get(ks_id)
        if size < floor and (large is None or key not in large):
            return
        with self._lock:
            if large is None:
                large = self._large.setdefault(ks_id, {})
            large[key] = size
            if len(large) > self.capacity:
                keep = sorted(large.items(), key=lambda kv: (-kv[1], kv[0]))
                del keep[self.top_n:]
                large.clear()
                large.update(keep)
                self._floor[ks_id] = keep[-1][1]

    def _hot_bump(self, ks_id: int, cell_id, slot: int, n: int) -> None:
        hot = self._hot.setdefault(ks_id, {})
        ent = hot.get(cell_id)
        if ent is None:
            ent = hot.setdefault(cell_id, [0, 0])
        ent[slot] += n

    def note_put(self, ks_id: int, key: bytes, vsize: int) -> None:
        if ks_id == self._sys_ks:
            return
        c = self._c(ks_id)
        c["puts"] += 1
        c["app_bytes"] += len(key) + vsize
        self._note_large(ks_id, key, vsize)
        self._hot_bump(ks_id, self._cell_of(ks_id, key), 1, 1)
        self._dirty = True

    def note_put_many(self, ks_id: int, items) -> None:
        """``items`` yields (key, value[, ...]) — the put_many shape."""
        if ks_id == self._sys_ks or not items:
            return
        c = self._c(ks_id)
        n = len(items)
        c["puts"] += n
        bytes_ = 0
        for it in items:
            key, value = it[0], it[1]
            bytes_ += len(key) + len(value)
            self._note_large(ks_id, key, len(value))
        c["app_bytes"] += bytes_
        self._attribute_cells(ks_id, [it[0] for it in items], slot=1)
        self._dirty = True

    def note_delete_many(self, ks_id: int, keys) -> None:
        if ks_id == self._sys_ks or not keys:
            return
        c = self._c(ks_id)
        c["deletes"] += len(keys)
        large = self._large.get(ks_id)
        if large:
            with self._lock:
                for k in keys:
                    large.pop(k, None)
        self._attribute_cells(ks_id, keys, slot=1)
        self._dirty = True

    def note_reads(self, ks_id: int, keys, kind: str = "reads") -> None:
        """``kind`` is "reads" (get/multi_get) or "exists"."""
        if ks_id == self._sys_ks or not keys:
            return
        self._c(ks_id)[kind] += len(keys)
        self._attribute_cells(ks_id, keys, slot=0)
        self._dirty = True

    def note_flush(self, ks_id: int, blob_bytes: int) -> None:
        if ks_id == self._sys_ks:
            return
        c = self._c(ks_id)
        c["index_flushes"] += 1
        c["index_bytes"] += blob_bytes
        self._dirty = True

    def _cell_of(self, ks_id: int, key: bytes):
        return self._db.table.ks(ks_id).cell_id_for_key(key)

    def _attribute_cells(self, ks_id: int, keys, slot: int) -> None:
        """Sampled per-cell traffic attribution: hash 1-in-``sample`` keys
        and scale the count, so a 4096-key batch pays ~512 cell-id
        computations, not 4096."""
        step = self.sample
        start = self._tick % step
        self._tick += len(keys)
        picked = keys[start::step]
        if not picked and keys:
            picked = keys[:1]
        scale = max(1, round(len(keys) / max(1, len(picked))))
        for k in picked:
            self._hot_bump(ks_id, self._cell_of(ks_id, k), slot, scale)

    # ------------------------------------------------------------- folding
    def fold(self) -> int:
        """Merge the deltas into the rollups and write the tables through
        the engine's own batched write path.  Returns rows written.  A
        no-op when nothing changed since the last fold (so an idle store's
        snapshot loop does not grow the WAL)."""
        if not self._dirty:
            return 0
        with self._fold_lock:
            if not self._dirty:
                return 0
            self._dirty = False
            with self._lock:
                deltas = self._counts
                self._counts = {}
                large = {ks: sorted(m.items(),
                                    key=lambda kv: (-kv[1], kv[0]))[:self.top_n]
                         for ks, m in self._large.items()}
                hot = {ks: sorted(m.items(),
                                  key=lambda kv: (-(kv[1][0] + kv[1][1]),
                                                  str(kv[0])))[:self.top_n]
                       for ks, m in self._hot.items()}
            for ks, d in deltas.items():
                t = self._totals.setdefault(ks, dict.fromkeys(d, 0))
                for k, v in d.items():
                    t[k] = t.get(k, 0) + v
            rows, dels = [], []
            wa = self._db.metrics.write_amplification
            for ks in sorted(self._totals):
                v = dict(self._totals[ks])
                v["keyspace"] = self._names.get(ks, str(ks))
                v["write_amp_store"] = wa
                rows.append((row_key(TAG_KEYSPACE_STATS, ks), _pack(v)))
            for tag, per_ks in ((TAG_LARGE_VALUES, large),
                                (TAG_HOT_CELLS, hot)):
                for ks, ranked in per_ks.items():
                    for rank, item in enumerate(ranked):
                        if tag == TAG_LARGE_VALUES:
                            val = {"key": item[0], "size": item[1]}
                        else:
                            cid, (rd, wr) = item
                            val = {"cell_id": cid, "reads": rd, "writes": wr}
                        rows.append((row_key(tag, ks, rank), _pack(val)))
                    prev = self._prev_rows.get((tag, ks), 0)
                    dels += [row_key(tag, ks, r)
                             for r in range(len(ranked), prev)]
                    self._prev_rows[(tag, ks)] = len(ranked)
            db = self._db
            try:
                with db._allow_system_writes():
                    if rows:
                        db.put_many(rows, keyspace=self._sys_ks)
                    if dels:
                        db.delete_many(dels, keyspace=self._sys_ks)
            except (OSError, RuntimeError):
                # Degraded/failing store: stats are best-effort and must
                # never wedge a snapshot.  Totals live in memory and every
                # fold rewrites the full rollup, so nothing is lost —
                # re-arm the dirty flag and try again next fold.
                self._dirty = True
                return 0
            db.metrics.add(system_folds=1, system_rows_written=len(rows))
            return len(rows)

    def load(self) -> None:
        """Seed the rollups from the persisted tables after reopen, so
        folding keeps accumulating instead of restarting from zero.  Never
        fails the open: a torn row just starts that slice fresh."""
        try:
            by_name = {v: k for k, v in self._names.items()}
            for key, val in scan_rows(self._db, TAG_KEYSPACE_STATS):
                _, ks_id, _ = decode_row_key(key)
                self._totals[ks_id] = {
                    k: v for k, v in val.items()
                    if isinstance(v, int) and k != "keyspace"}
            for key, val in scan_rows(self._db, TAG_LARGE_VALUES):
                _, ks_id, _ = decode_row_key(key)
                self._large.setdefault(ks_id, {})[val["key"]] = val["size"]
                self._prev_rows[(TAG_LARGE_VALUES, ks_id)] = \
                    self._prev_rows.get((TAG_LARGE_VALUES, ks_id), 0) + 1
            for key, val in scan_rows(self._db, TAG_HOT_CELLS):
                _, ks_id, _ = decode_row_key(key)
                cid = val["cell_id"]
                self._hot.setdefault(ks_id, {})[cid] = [val["reads"],
                                                        val["writes"]]
                self._prev_rows[(TAG_HOT_CELLS, ks_id)] = \
                    self._prev_rows.get((TAG_HOT_CELLS, ks_id), 0) + 1
            del by_name
        except Exception:  # pragma: no cover - defensive: stats never
            pass           # block an open
        self._dirty = False

    def tables(self) -> dict:
        """Decoded system tables keyed by keyspace *name* (read helper
        over ``read_tables``; call ``fold()`` first for fresh numbers)."""
        return read_tables(self._db, self._names)


def _pack(value: dict) -> bytes:
    return msgpack.packb(value, use_bin_type=True)


class CopierGovernor:
    """Auto-sizes an adaptive ``CopyPool`` from observed host load — the
    write path's last manual knob (``DbConfig.copy_threads``) replaced by
    a control loop.

    Target: the host's core budget minus load *external* to the pool
    (1-minute loadavg beyond the pool's own copiers), clamped to
    [1, capacity].  On an idle box the pool sits at the core count; when
    the host is oversubscribed by other work the pool shrinks instead of
    thrashing — and it can never exceed the core budget, so the ct8-on-2-
    cores oversubscription the ROADMAP flagged cannot be configured back
    in.  ``maybe_adjust`` is rate-limited (one loadavg sample per
    ``interval_s``), cheap enough to call from every snapshot tick; both
    the core count and the load source are injectable for tests.
    """

    def __init__(self, pool, metrics=None, *, cores: Optional[int] = None,
                 load_fn=None, interval_s: float = 0.5):
        self.pool = pool
        self.metrics = metrics
        self.cores = max(1, cores if cores is not None
                         else (os.cpu_count() or 1))
        self.load_fn = load_fn if load_fn is not None \
            else (lambda: os.getloadavg()[0])
        self.interval_s = interval_s
        self._next_at = 0.0
        self._lock = threading.Lock()

    def target(self, load1: float) -> int:
        external = max(0.0, load1 - self.pool.threads)
        return max(1, min(self.pool.capacity, self.cores,
                          self.cores - int(round(external))))

    def maybe_adjust(self) -> Optional[int]:
        """One rate-limited control step; returns the new thread count
        when a resize happened, else None."""
        now = time.monotonic()
        with self._lock:
            if now < self._next_at:
                return None
            self._next_at = now + self.interval_s
        try:
            load1 = self.load_fn()
        except OSError:  # pragma: no cover - loadavg unavailable
            return None
        t = self.target(load1)
        if t == self.pool.threads:
            return None
        t = self.pool.resize(t)
        if self.metrics is not None:
            self.metrics.add(copy_pool_resizes=1)
        return t
