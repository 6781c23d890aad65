"""Public engine surface: the ``Engine`` protocol, keyspace handles, typed
write batches, and per-call option dataclasses.

Every front end (embedded ``TideDB``, the sharded ``ShardedTideDB``, the
serving-path ``KvBatchServer``) speaks this one contract, so scale-out
composes behind it (ROADMAP north star; cf. Neon's phase-1 static sharding
RFC: pick the engine protocol first, then shard behind it).

- ``KeyspaceHandle`` replaces positional ``keyspace=`` threading: bind the
  keyspace once (``db.keyspace("objects")``) and call ``get``/``put``/...
  without repeating it.
- ``WriteBatch`` replaces raw ``("put", ks, key, value)`` tuples with a
  typed builder applied atomically via one ``Wal.append_batch`` record.
- ``ReadOptions``/``WriteOptions`` stop per-call behaviour accreting as
  kwargs: cache-fill policy, kernel routing, snapshot-consistent min-live
  pinning, durability class, and epoch all live in two small dataclasses.

Legacy call signatures keep working: tuple batches go through a shim that
emits ``DeprecationWarning`` (removed after one release); the
``keyspace=``/``epoch=`` kwargs remain supported protocol-level spellings
(``epoch=`` silently folds into ``WriteOptions``).
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Iterable, Optional, Protocol, runtime_checkable


def deprecated_call(message: str) -> None:
    """One-liner shim marker: warns without breaking legacy callers.

    stacklevel walks out of this helper, ``coerce_batch``, and the engine's
    ``write_batch`` so the warning points at the legacy call site."""
    warnings.warn(message, DeprecationWarning, stacklevel=4)


# ------------------------------------------------------------------ options
@dataclass(frozen=True)
class ReadOptions:
    """Per-call read behaviour.

    - ``fill_cache``: populate the value LRU with what this read fetched
      (turn off for scans that would churn the working set).
    - ``use_kernel``: route batched resolution through the CUDA kernel
      wrappers; ``None`` defers to the engine's configured default.
    - ``min_live_pin``: snapshot-consistency floor.  A batch issued with a
      pinned position treats everything below ``max(pin, first_live_pos)``
      as pruned, so concurrent epoch pruning cannot change visibility
      mid-batch.  Capture the pin with ``Engine.min_live()``.  Pinned
      reads bypass the value cache (cached values carry no position to
      check against the pin).
    - ``strict_errors``: surface unreadable live positions as the typed
      ``WalReadError`` taxonomy instead of the fail-safe ``None``.
      ``get`` raises; ``multi_get`` places the exception *instance* in
      that key's result slot (the rest of the batch still resolves).  The
      replicated read path (``ShardedTideDB`` failover) reads with this
      set so a corrupt primary copy routes the key to a replica rather
      than silently reporting absence.
    """
    fill_cache: bool = True
    use_kernel: Optional[bool] = None
    min_live_pin: Optional[int] = None
    strict_errors: bool = False


@dataclass(frozen=True)
class WriteOptions:
    """Per-call write behaviour.

    - ``durability``: ``"async"`` (OS page cache now, fsync via the syncer —
      the paper's default tier, §3.1) or ``"sync"`` (fsync before return).
      Sync durability waits for every payload copy in flight before the
      fsync (the WAL's completion latch), so an acknowledged record can
      never be dropped by crash replay in favour of an unwritten hole.
    - ``epoch``: epoch tag for segment-granular pruning (§4.4).
    - ``parallel_copy``: route this call's payload copies across the
      engine's copier pool (``DbConfig.copy_threads``).  ``None`` (default)
      uses the pool; ``False`` keeps the copies on the calling thread —
      still outside the allocation lock, so concurrent writers overlap
      regardless.  Has no effect on scalar ``put``/``delete`` (one record
      copies inline either way) or on atomic ``write_batch``.
    """
    durability: str = "async"
    epoch: int = 0
    parallel_copy: Optional[bool] = None

    def __post_init__(self):
        if self.durability not in ("async", "sync"):
            raise ValueError(f"unknown durability class {self.durability!r}")


@dataclass(frozen=True)
class PruneOptions:
    """Per-call space-reclamation behaviour (§4.4), the pruning analogue of
    ``WriteOptions``.

    - ``strategy``: ``"wal"`` (sequential scan of the oldest segments) or
      ``"index"`` (iterate cells, read only below-cutoff values).
    - ``reclaim_fraction``: fraction of the live WAL span one full pass
      scans.
    - ``space_amp_trigger``: a non-forced pass runs only when the physical
      span ≥ trigger × estimated live bytes.
    - ``min_reclaim_bytes``: never trigger below this span (keeps tiny
      stores from churning).
    - ``retain_epochs``: keep only the newest N epochs — segments whose
      whole epoch range aged out drop for free, no bytes relocated; records
      that aged out inside still-mixed segments are *retired* (tombstoned)
      by the next relocation pass instead of being copied to the tail.
      ``None`` disables the epoch trigger (explicit
      ``prune_epochs_below`` still works).
    - ``batch_records`` / ``batch_bytes``: harvest bounds per batched
      re-append (one ``Wal.append_many`` — one allocation-lock acquisition,
      one CopyPool fan-out — per batch).
    """
    strategy: str = "wal"
    reclaim_fraction: float = 0.5
    space_amp_trigger: float = 2.0
    min_reclaim_bytes: int = 4 * 1024 * 1024
    retain_epochs: Optional[int] = None
    batch_records: int = 512
    batch_bytes: int = 4 * 1024 * 1024

    def __post_init__(self):
        if self.strategy not in ("wal", "index"):
            raise ValueError(f"unknown prune strategy {self.strategy!r}")
        if not (0.0 < self.reclaim_fraction <= 1.0):
            raise ValueError("reclaim_fraction must be in (0, 1]")
        if self.space_amp_trigger < 1.0:
            raise ValueError("space_amp_trigger must be >= 1.0")
        if self.batch_records < 1 or self.batch_bytes < 1:
            raise ValueError("batch bounds must be positive")
        if self.retain_epochs is not None and self.retain_epochs < 1:
            raise ValueError("retain_epochs must be >= 1 (or None)")


READ_DEFAULTS = ReadOptions()
WRITE_DEFAULTS = WriteOptions()
PRUNE_DEFAULTS = PruneOptions()


# ------------------------------------------------------------------ batches
class WriteBatch:
    """Typed atomic batch builder (§3.1 "Atomic batch writes").

    Ops accumulate in submission order and apply atomically — one WAL
    allocation covers the whole batch, and a torn batch is dropped
    wholesale on replay.  A batch may be bound to a default keyspace
    (``handle.batch()``) or span keyspaces by passing ``keyspace=`` per op.
    """

    __slots__ = ("_ops", "default_keyspace")

    def __init__(self, default_keyspace=None):
        self._ops: list[tuple] = []
        self.default_keyspace = default_keyspace

    def put(self, key: bytes, value: bytes, keyspace=None) -> "WriteBatch":
        self._ops.append(("put", self._ks(keyspace), key, value))
        return self

    def delete(self, key: bytes, keyspace=None) -> "WriteBatch":
        self._ops.append(("del", self._ks(keyspace), key))
        return self

    def _ks(self, keyspace):
        if keyspace is not None:
            return keyspace
        return self.default_keyspace if self.default_keyspace is not None else 0

    @property
    def ops(self) -> tuple:
        """The accumulated ops as legacy-shaped tuples (engine-internal)."""
        return tuple(self._ops)

    def extend(self, ops: Iterable[tuple]) -> "WriteBatch":
        """Absorb legacy-shaped tuples (shim for old call sites)."""
        for op in ops:
            if op[0] == "put":
                _, ks, key, value = op
                self.put(key, value, keyspace=ks)
            elif op[0] == "del":
                _, ks, key = op
                self.delete(key, keyspace=ks)
            else:
                raise ValueError(f"unknown batch op {op[0]!r}")
        return self

    def clear(self) -> None:
        self._ops.clear()

    def __len__(self) -> int:
        return len(self._ops)

    def __bool__(self) -> bool:
        return bool(self._ops)


def coerce_batch(ops) -> WriteBatch:
    """Accept a ``WriteBatch`` or legacy tuple iterable (deprecation shim)."""
    if isinstance(ops, WriteBatch):
        return ops
    deprecated_call("tuple-based write_batch ops are deprecated; build a "
                    "WriteBatch (wb.put(k, v) / wb.delete(k)) instead")
    return WriteBatch().extend(ops)


# ------------------------------------------------------------------ handles
class KeyspaceHandle:
    """A keyspace-bound view of an engine.

    ``db.keyspace("objects")`` returns a handle whose methods never take a
    ``keyspace`` argument — the binding happened once, at handle creation.
    Handles are cheap, stateless, and safe to share across threads.
    """

    __slots__ = ("engine", "name")

    def __init__(self, engine: "Engine", name):
        self.engine = engine
        self.name = name

    # reads
    def get(self, key: bytes, opts: Optional[ReadOptions] = None):
        return self.engine.get(key, keyspace=self.name, opts=opts)

    def exists(self, key: bytes, opts: Optional[ReadOptions] = None) -> bool:
        return self.engine.exists(key, keyspace=self.name, opts=opts)

    def multi_get(self, keys, opts: Optional[ReadOptions] = None) -> list:
        return self.engine.multi_get(keys, keyspace=self.name, opts=opts)

    def multi_exists(self, keys, opts: Optional[ReadOptions] = None) -> list:
        return self.engine.multi_exists(keys, keyspace=self.name, opts=opts)

    def prev(self, key: bytes):
        return self.engine.prev(key, keyspace=self.name)

    def scan_prefix(self, prefix: bytes, limit: Optional[int] = None) -> list:
        """All (key, value) pairs whose key starts with ``prefix``,
        ascending, built from repeated ``prev`` steps walking down from the
        prefix's upper bound (the reverse-iterator read op is the engine's
        only ordered primitive).  ``limit`` bounds the result count,
        keeping the LAST ``limit`` pairs in key order (the walk is
        highest-key-first).  The __system tables read through this.

        The upper-bound probe must compare above every real key sharing the
        prefix: pad with 0xff out to the keyspace's configured key width
        when the engine exposes it (``key_len``), else a 64-byte fallback —
        a fixed pad shorter than ``key_len - len(prefix)`` would silently
        skip keys whose suffix starts with 0xff bytes."""
        key_len_of = getattr(self.engine, "key_len", None)
        klen = key_len_of(self.name) if key_len_of is not None else 0
        # +1: a key that IS prefix + all-0xff padding would equal an
        # exact-width probe, and ``prev`` is strictly-less-than.
        pad = max(64, (klen or 0) - len(prefix) + 1)
        probe = prefix + b"\xff" * pad
        out: list = []
        while True:
            got = self.engine.prev(probe, keyspace=self.name)
            if got is None or not got[0].startswith(prefix):
                break
            out.append(got)
            if limit is not None and len(out) >= limit:
                break
            probe = got[0]
        out.reverse()
        return out

    # writes
    def put(self, key: bytes, value: bytes,
            opts: Optional[WriteOptions] = None) -> int:
        return self.engine.put(key, value, keyspace=self.name, opts=opts)

    def delete(self, key: bytes, opts: Optional[WriteOptions] = None) -> int:
        return self.engine.delete(key, keyspace=self.name, opts=opts)

    def put_many(self, items, opts: Optional[WriteOptions] = None) -> list:
        """Batched put of (key, value) pairs — the vectorized write
        pipeline.  NOT atomic (each record replays independently); use
        ``write_batch`` for all-or-nothing semantics."""
        return self.engine.put_many(items, keyspace=self.name, opts=opts)

    def delete_many(self, keys, opts: Optional[WriteOptions] = None,
                    epochs=None) -> list:
        """Batched delete; ``epochs`` optionally tags each tombstone
        individually (aligned with ``keys``), mirroring ``put_many``'s
        (key, value, epoch) triples."""
        return self.engine.delete_many(keys, keyspace=self.name, opts=opts,
                                       epochs=epochs)

    # maintenance
    def prune(self, opts: Optional[PruneOptions] = None) -> dict:
        """Run one reclamation pass.  Pruning is store-wide (the Value WAL
        is shared across keyspaces); the handle spelling exists so serving
        code holding only a handle can still schedule reclamation."""
        return self.engine.prune(opts)

    def batch(self) -> WriteBatch:
        """A ``WriteBatch`` whose ops default to this keyspace."""
        return WriteBatch(default_keyspace=self.name)

    def write_batch(self, batch: WriteBatch,
                    opts: Optional[WriteOptions] = None):
        return self.engine.write_batch(batch, opts=opts)

    def __repr__(self) -> str:
        return f"KeyspaceHandle({self.name!r} @ {type(self.engine).__name__})"


# ----------------------------------------------------------------- protocol
@runtime_checkable
class Engine(Protocol):
    """The engine contract every front end implements.

    ``TideDB`` implements it embedded and single-store; ``ShardedTideDB``
    implements it by statically partitioning keys across N ``TideDB``
    shards; ``KvBatchServer`` consumes it (any Engine serves the queue).
    """

    def keyspace(self, name) -> KeyspaceHandle: ...

    def get(self, key: bytes, keyspace=0,
            opts: Optional[ReadOptions] = None) -> Optional[bytes]: ...

    def exists(self, key: bytes, keyspace=0,
               opts: Optional[ReadOptions] = None) -> bool: ...

    def multi_get(self, keys, keyspace=0,
                  opts: Optional[ReadOptions] = None) -> list: ...

    def multi_exists(self, keys, keyspace=0,
                     opts: Optional[ReadOptions] = None) -> list: ...

    def prev(self, key: bytes, keyspace=0): ...

    def put(self, key: bytes, value: bytes, keyspace=0,
            opts: Optional[WriteOptions] = None) -> int: ...

    def delete(self, key: bytes, keyspace=0,
               opts: Optional[WriteOptions] = None) -> int: ...

    def put_many(self, items, keyspace=0,
                 opts: Optional[WriteOptions] = None) -> list: ...

    def delete_many(self, keys, keyspace=0,
                    opts: Optional[WriteOptions] = None,
                    epochs=None) -> list: ...

    def write_batch(self, ops,
                    opts: Optional[WriteOptions] = None) -> list: ...

    def prune(self, opts: Optional["PruneOptions"] = None) -> dict: ...

    def prune_step(self, opts: Optional["PruneOptions"] = None) -> int: ...

    def prune_epochs_below(self, epoch: int) -> int: ...

    def scrub(self) -> dict: ...

    def scrub_step(self, max_segments: int = 1) -> int: ...

    def min_live(self) -> int: ...

    def flush(self) -> None: ...

    def stats(self) -> dict: ...

    def system_tables(self) -> dict: ...

    def close(self, flush: bool = True) -> None: ...
