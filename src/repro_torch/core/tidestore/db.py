"""TideDB — the public engine API (paper §3).

Write flow (§3.1): allocate WAL position (atomic) → write entry (parallel)
→ update Large Table → mark position processed.  Durability against app
crashes is immediate (the OS page cache holds the write); kernel-crash
durability arrives asynchronously via the syncer, or synchronously via
``flush()``.

Read flow (§3.2): LRU cache → per-cell Bloom filter → Large Table (memory,
else optimistic point-lookup into the Index Store) → Value WAL read.
"""
from __future__ import annotations

import errno
import os
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field, replace
from typing import Optional

import msgpack

from .api import (KeyspaceHandle, PruneOptions, ReadOptions, WriteBatch,
                  WriteOptions, coerce_batch)
from .cache import LruCache
from .faults import (DEFAULT_IO, DegradedError, IoBackend, KeyWidthError,
                     UnrepairedHoleError, WalReadError)
from .flush import Flusher
from .index import TOMB_FLAG, is_tombstone, real_pos
from .large_table import CellState, KeyspaceConfig, LargeTable
from .relocate import PruneController, PruneThread, Relocator
from .scrub import ScrubConfig, Scrubber, ScrubThread
from .snapshot import (SnapshotThread, capture_state, read_control_region,
                       write_control_region)
from .system import (SYSTEM_KEYSPACE, SYSTEM_KS_ID, TAG_HEALTH,
                     CopierGovernor, StatsCollector, read_tables, row_key,
                     system_keyspace_config)
from .util import Metrics
from .wal import (_ENTRY_HDR, HEADER_SIZE, T_ENTRY, T_INDEX, T_TOMBSTONE,
                  CopyPool, Wal, WalConfig, decode_entry, decode_tombstone,
                  encode_entry, encode_tombstone, entry_framed, payload_len)

# Values below this stage through one ``encode_entry`` concatenation; at or
# above it the entry rides to ``pwritev`` as uncopied iovec parts.  For tiny
# values the staging copy is cheaper than the multi-part bookkeeping (extra
# crc32 calls, longer iovecs); for large values the copy is the cost the
# parallel-copy protocol exists to remove.
_STAGE_VALUE_MAX = 4096


def clamp_copy_threads(requested: int, metrics: Optional[Metrics] = None) -> int:
    """Cap copier threads at the machine's cores (oversubscribed copiers
    only thrash); the shaved count lands in ``Metrics.copy_threads_clamped``
    so config sweeps can see requested vs effective."""
    cores = os.cpu_count() or 1
    eff = max(1, min(requested, cores))
    if metrics is not None and eff < requested:
        metrics.add(copy_threads_clamped=requested - eff)
    return eff


@dataclass
class DbConfig:
    keyspaces: list = field(default_factory=lambda: [KeyspaceConfig("default")])
    wal: WalConfig = field(default_factory=WalConfig)
    index_wal: WalConfig = field(default_factory=lambda: WalConfig(
        segment_size=64 * 1024 * 1024))
    cache_bytes: int = 32 * 1024 * 1024
    flusher_threads: int = 2
    snapshot_interval_s: float = 0.25
    background_snapshots: bool = True
    relocation: bool = False               # background prune thread
    relocation_interval_s: float = 1.0
    prune: Optional["PruneOptions"] = None  # trigger policy; None = defaults
    mem_budget_entries: int = 2_000_000    # Large Table residency budget
    batched_kernels: bool = True           # route multi_get/multi_exists
                                           # through the kernel wrappers
    blob_cache_bytes: int = 8 * 1024 * 1024  # parsed index-blob memo budget
    copy_threads: Optional[int] = None     # parallel payload copiers (§3.1);
                                           # None = adaptive (pool sized to
                                           # the host's core budget and
                                           # retuned from observed load by a
                                           # CopierGovernor); an int pins the
                                           # count (1 = inline copies, still
                                           # lock-free)
    clamp_copy_threads: bool = True        # cap an explicit copy_threads at
                                           # the machine's cores (tests opt
                                           # out to exercise oversubscribed
                                           # pools); adaptive pools are
                                           # always core-capped
    persist_filters: bool = True           # write each flush's Bloom filter
                                           # next to its index blob so reopen
                                           # loads it instead of rebuilding
    system_stats: bool = True              # observe the workload into the
                                           # reserved __system keyspace (the
                                           # keyspace itself always exists)
    system_top_n: int = 8                  # rows per __system ranking table
    system_sample: int = 8                 # 1-in-N read-traffic sampling
    io: Optional[IoBackend] = None         # os-call seam; None = real I/O
                                           # (tests inject faults.FaultyIo)
    scrub: bool = False                    # background CRC scrub thread
    scrub_interval_s: float = 5.0          # one scrub_step per interval
    scrub_cfg: Optional["ScrubConfig"] = None  # findings cap / publish policy;
                                           # None = ScrubConfig() defaults
    device: str = "cuda"                   # where the batched read kernels
                                           # run; "cpu" takes their plain
                                           # PyTorch versions (tests)


def check_device(cfg: DbConfig) -> None:
    """Refuse a CUDA ``device`` when no card is available, before any I/O.
    PyTorch is imported here, not with the module, so the host engine and
    the KV server import without it."""
    import torch
    if torch.device(cfg.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise RuntimeError(
            f"DbConfig(device={cfg.device!r}) needs a CUDA card and none is "
            f"available; pass device='cpu' to run the kernels' plain "
            f"versions on the host")


class TideDB:
    def __init__(self, path: str, config: Optional[DbConfig] = None, *,
                 copy_pool: Optional[CopyPool] = None):
        self.path = path
        self.cfg = config or DbConfig()
        check_device(self.cfg)
        os.makedirs(path, exist_ok=True)
        self.metrics = Metrics()
        self._io = self.cfg.io or DEFAULT_IO

        # Degraded mode: unrecoverable write failures (ENOSPC, an
        # unrepairable poison backlog) flip the store to explicit read-only
        # instead of wedging — reads keep serving, writes raise
        # DegradedError, and health is visible in stats()/__system.
        self._health_lock = threading.Lock()
        self._degraded_reason: Optional[str] = None
        self._last_recover_attempt: Optional[float] = None

        # The reserved __system keyspace (self-observation tables) lives at
        # the FIXED sentinel id SYSTEM_KS_ID (0xFFFF), never a position in
        # the user's keyspace list: rows persisted under it (WAL entries,
        # control-region cell pointers) stay attached to __system across
        # reopens even when the user adds or removes keyspaces — a
        # positional id would silently re-attach them to whichever user
        # keyspace inherited the index.  It ALWAYS exists — even with
        # system_stats=False — so replay of system rows written under a
        # previous configuration never dangles.
        for ks_cfg in self.cfg.keyspaces:
            if ks_cfg.name == SYSTEM_KEYSPACE:
                raise ValueError(
                    f"keyspace name {SYSTEM_KEYSPACE!r} is reserved for the "
                    f"engine's system tables")
        if len(self.cfg.keyspaces) >= SYSTEM_KS_ID:
            raise ValueError(
                f"at most {SYSTEM_KS_ID - 1} user keyspaces (the u16 id "
                f"space minus the reserved {SYSTEM_KEYSPACE!r} sentinel)")
        self._system_ks_id = SYSTEM_KS_ID
        self._system_writes = threading.local()

        # One copier pool shared by both WALs (an injected pool — e.g. from
        # ShardedTideDB — is shared wider and owned by the injector).  With
        # copy_threads=None (the default) the pool is adaptive: sized to the
        # host's core budget and retuned from observed load by a
        # CopierGovernor on every snapshot tick.  An explicit int pins the
        # count, capped at the machine's cores unless clamp_copy_threads is
        # off: copiers beyond the cores only add context-switch overhead
        # (BENCH_kvwrite ct8 on the 2-core box), and the clamp is recorded
        # in Metrics so a sweep can see the requested/effective gap.
        if copy_pool is None:
            if self.cfg.copy_threads is None:
                self._copy_pool = CopyPool(None)
                self._copy_pool.governor = CopierGovernor(self._copy_pool,
                                                          self.metrics)
            else:
                eff = (clamp_copy_threads(self.cfg.copy_threads, self.metrics)
                       if self.cfg.clamp_copy_threads
                       else self.cfg.copy_threads)
                self._copy_pool = CopyPool(eff)
            self._owns_copy_pool = True
        else:
            self._copy_pool = copy_pool
            self._owns_copy_pool = False
        self.value_wal = Wal(path, "value", self.cfg.wal, self.metrics,
                             copy_pool=self._copy_pool, io=self._io)
        self.index_wal = Wal(path, "index", self.cfg.index_wal, self.metrics,
                             copy_pool=self._copy_pool, io=self._io)
        self.table = LargeTable(
            self.cfg.keyspaces, self.index_wal.pread, self.metrics,
            blob_cache_bytes=self.cfg.blob_cache_bytes,
            reserved=[(SYSTEM_KS_ID, system_keyspace_config())],
            device=self.cfg.device)
        self.cache = LruCache(self.cfg.cache_bytes)
        self.flusher = Flusher(self.table, self.index_wal, self.value_wal,
                               self.cfg.flusher_threads, self.metrics,
                               persist_filters=self.cfg.persist_filters)
        # Background flushes have no caller to raise to: unrecoverable I/O
        # failures there must still degrade the store.
        self.flusher.on_error = self._note_write_failure
        prune_opts = self.cfg.prune or PruneOptions()
        self.relocator = Relocator(self.table, self.value_wal, self.metrics,
                                   batch_records=prune_opts.batch_records,
                                   batch_bytes=prune_opts.batch_bytes)
        self.prune_controller = PruneController(self.relocator, prune_opts)
        self._ks_by_name = self.table.by_name
        self._closed = False

        self._recover()

        # The workload observer folds into __system on snapshot ticks;
        # load() re-seeds its rollups from the persisted tables so stats
        # accumulate across reopens instead of restarting from zero.
        self.system: Optional[StatsCollector] = None
        if self.cfg.system_stats:
            self.system = StatsCollector(self, top_n=self.cfg.system_top_n,
                                         sample=self.cfg.system_sample)
            self.flusher.collector = self.system
            self.system.load()

        # Corruption scrubber (integrity subsystem): always constructed so
        # scrub()/scrub_step() work on demand; the thread is opt-in.
        self.scrubber = Scrubber(self, config=self.cfg.scrub_cfg)
        self._snapshot_thread = None
        if self.cfg.background_snapshots:
            self._snapshot_thread = SnapshotThread(self, self.cfg.snapshot_interval_s)
            self._snapshot_thread.start()
        self._prune_thread = None
        if self.cfg.relocation:
            self._prune_thread = PruneThread(
                self.prune_controller, self.cfg.relocation_interval_s)
            self._prune_thread.start()
        self._scrub_thread = None
        if self.cfg.scrub:
            self._scrub_thread = ScrubThread(self, self.cfg.scrub_interval_s)
            self._scrub_thread.start()

    # ------------------------------------------------------------- recovery
    def _recover(self) -> None:
        """§3.4: read Control Region, restore cell pointers, replay the WAL
        suffix.  Cells start UNLOADED; indices load lazily on demand."""
        state = read_control_region(self.path)
        replay_from = self.value_wal.first_live_pos
        if state is not None:
            replay_from = max(state["replay_from"], self.value_wal.first_live_pos)
            self.value_wal.first_live_pos = max(self.value_wal.first_live_pos,
                                                state["value_first_live"])
            self.index_wal.first_live_pos = max(self.index_wal.first_live_pos,
                                                state["index_first_live"])
            for seg, rng in state.get("segment_epochs", {}).items():
                seg = int(seg)
                # Segments pruned between the snapshot capture and this
                # replay left holes: resurrecting their epoch ranges would
                # re-offer already-deleted files to the pruner.
                if self.value_wal.segment_missing(seg):
                    continue
                self.value_wal._segment_epochs[seg] = (rng[0], rng[1])
            for entry in state["cells"]:
                # Seed snapshots carry 6-tuples; newer ones append the
                # persisted-Bloom pointer (filter_pos, filter_len).  An old
                # control region simply rebuilds filters lazily.
                ks_id, cid, dpos, dlen, dcount, upto = entry[:6]
                if not self.table.has_ks(ks_id):
                    continue                 # keyspace no longer configured
                ks = self.table.ks(ks_id)
                if isinstance(cid, (bytes, bytearray)):
                    cell = ks.cell_for_key(bytes(cid))
                else:
                    cell = ks.cells.get(cid)
                if cell is None:
                    continue
                cell.disk_pos, cell.disk_len, cell.disk_count = dpos, dlen, dcount
                cell.flushed_upto = upto
                cell.filter_pos = entry[6] if len(entry) > 6 else None
                cell.filter_len = entry[7] if len(entry) > 7 else 0
                cell.approx_keys = dcount
                cell.state = CellState.UNLOADED if dcount > 0 else CellState.EMPTY
            replay_from = max(replay_from, self.value_wal.first_live_pos)

        # Replay the WAL suffix into the Large Table.  Re-note per-segment
        # epoch ranges as we go: records appended after the last snapshot
        # have no range in the control region, and without one their
        # segments could never be epoch-pruned.
        seg_size = self.value_wal.cfg.segment_size
        for pos, rtype, payload in self.value_wal.iter_records(replay_from):
            if not entry_framed(rtype, payload):
                # A write torn inside the record header over a preallocated
                # (zero-filled) segment leaves ``type=T_ENTRY, length=0,
                # crc=0`` — and crc32(b"") == 0, so the phantom passes CRC.
                # Structurally impossible frames are torn bytes, not data.
                self.metrics.add(replay_torn_records=1)
                continue
            if rtype == T_ENTRY:
                ks_id, key, _value, epoch = decode_entry(payload)
                marker = pos
            elif rtype == T_TOMBSTONE:
                ks_id, key, epoch = decode_tombstone(payload)
                marker = TOMB_FLAG | pos
            else:
                continue
            self.value_wal._note_epoch(pos // seg_size, epoch)
            if not self.table.has_ks(ks_id):
                # Keyspace no longer configured (or rows persisted under a
                # legacy positional __system id): the record is unreachable
                # but must not fail the open.
                self.metrics.add(replay_orphan_records=1)
                continue
            cell = self.table.ks(ks_id).cell_for_key(key)
            if pos < cell.flushed_upto:
                continue                     # already covered by flushed index
            self.table.apply(ks_id, key, marker)
        self.value_wal.tracker.reset(self.value_wal.tail)

    # --------------------------------------------------------------- writes
    def _ks_id(self, keyspace) -> int:
        if isinstance(keyspace, int):
            return keyspace
        return self._ks_by_name[keyspace]

    @contextmanager
    def _allow_system_writes(self):
        """Thread-local gate the StatsCollector's fold holds while writing
        __system rows through the public batched write path."""
        self._system_writes.ok = True
        try:
            yield
        finally:
            self._system_writes.ok = False

    def _check_writable(self, ks_id: int) -> None:
        if ks_id == self._system_ks_id:
            if not getattr(self._system_writes, "ok", False):
                raise ValueError(
                    f"keyspace {SYSTEM_KEYSPACE!r} is read-only: its rows "
                    f"are maintained by the engine's StatsCollector")
            # Engine-internal rows (stats folds, scrub findings, the health
            # row) stay best-effort in degraded mode: they may still fail at
            # the device, but the gate must not block the diagnosis.
            return
        if self._degraded_reason is not None:
            raise DegradedError(self._degraded_reason)

    def _check_keys(self, ks_id: int, keys) -> None:
        """Reject wrong-width keys at the write entrypoint with a typed
        error.  Index blobs are fixed-width (``build_sorted_blob`` reshapes
        to ``key_len``), so a mismatched key accepted here would later kill
        the *background* flush — long after the write was acknowledged.
        Reads stay width-tolerant (prefix-scan probes are deliberately
        longer than ``key_len``)."""
        klen = self.table.ks(ks_id).cfg.key_len
        for k in keys:
            if len(k) != klen:
                name = self.table.ks(ks_id).cfg.name
                raise KeyWidthError(
                    f"key of {len(k)} B in keyspace {name!r}: configured "
                    f"key_len is {klen} B (index blobs are fixed-width)")

    # ------------------------------------------------------- failure domain
    @contextmanager
    def _io_guard(self):
        """Classify I/O failures escaping a write/flush path: unrecoverable
        ones transition the store to degraded before re-raising."""
        try:
            yield
        except OSError as e:
            self._note_write_failure(e)
            raise

    def _note_write_failure(self, exc: BaseException) -> None:
        if isinstance(exc, UnrepairedHoleError):
            self._enter_degraded(str(exc))
            return
        en = getattr(exc, "errno", None)
        if en in (errno.ENOSPC, errno.EDQUOT, errno.EROFS):
            self._enter_degraded(getattr(exc, "strerror", None) or str(exc))

    def _enter_degraded(self, reason: str) -> None:
        """Idempotent ok → degraded flip.  Reads keep serving; writes are
        refused with ``DegradedError``; the transition is counted and a
        best-effort health row lands in ``__system`` (it may itself fail —
        the disk is the thing that is broken)."""
        with self._health_lock:
            if self._degraded_reason is not None:
                return
            self._degraded_reason = reason
        self.metrics.add(degraded_transitions=1)
        try:
            row = msgpack.packb(
                {"health": "degraded", "reason": reason, "time": time.time()},
                use_bin_type=True)
            with self._allow_system_writes():
                self.put(row_key(TAG_HEALTH, 0, 0), row,
                         keyspace=self._system_ks_id)
        except Exception:
            pass

    @property
    def health(self) -> str:
        """"ok" or "degraded" (read-only after an unrecoverable failure)."""
        return "degraded" if self._degraded_reason is not None else "ok"

    @property
    def degraded(self) -> bool:
        return self._degraded_reason is not None

    @property
    def writable(self) -> bool:
        """True while this store can accept writes.  For a single store
        this is just "not degraded"; ShardedTideDB overrides the notion
        ring-wise so a replicated store with one degraded shard still
        reports writable (writes shed to ring peers)."""
        return self._degraded_reason is None

    @property
    def degraded_reason(self) -> Optional[str]:
        return self._degraded_reason

    def try_recover(self, *, min_retry_interval_s: float = 0.25) -> bool:
        """Operator escape hatch out of degraded mode WITHOUT a reopen.

        Re-probes the disk: a test write + fsync of a scratch file through
        the configured I/O backend, then a full ``flush()`` of both WALs —
        which drains the poison-header repair backlog and fsyncs every
        dirty segment.  Only if all of that lands (and no dirty mark or
        backlog entry survives — per-segment fsync failures are swallowed
        and re-marked, not raised) does the degraded flag clear and the
        write surface reopen.  Returns True when the store is healthy
        afterwards; a store that was never degraded returns True at once.

        Failed probes are rate-limited: a call within
        ``min_retry_interval_s`` of a failed attempt returns False without
        touching the disk, so an operator loop (or a serving tier retrying
        on every shed write) cannot flap the device with probe traffic.
        """
        with self._health_lock:
            if self._degraded_reason is None:
                return True
            last = self._last_recover_attempt
            if last is not None and \
                    time.monotonic() - last < min_retry_interval_s:
                self.metrics.add(recover_probes_skipped=1)
                return False
            # Stamp before probing so concurrent callers rate-limit against
            # this attempt instead of racing their own probes.
            self._last_recover_attempt = time.monotonic()
        self.metrics.add(recover_probes=1)
        probe = os.path.join(self.path, "recover.probe")
        try:
            fd = self._io.open(probe,
                               os.O_CREAT | os.O_WRONLY | os.O_TRUNC)
            try:
                self._io.pwrite(fd, b"tide-recover-probe", 0)
                self._io.fsync(fd)
            finally:
                os.close(fd)
            self.value_wal.flush()       # drains the poison backlog too
            self.index_wal.flush()
            if self.value_wal.has_poison_backlog() \
                    or self.value_wal.has_dirty() \
                    or self.index_wal.has_dirty():
                raise OSError(
                    errno.EIO, "dirty segments or poison backlog survived "
                               "the re-probe flush")
        except OSError:
            return False                 # stays degraded; stamp rate-limits
        finally:
            try:
                os.unlink(probe)
            except OSError:
                pass
        with self._health_lock:
            recovered_from = self._degraded_reason
            self._degraded_reason = None
            self._last_recover_attempt = None
        self.metrics.add(degraded_recoveries=1)
        # Findings the scrubber collected through the dead device are
        # outage artifacts; re-verify everything with healthy I/O.
        self.scrubber.rescan()
        try:
            row = msgpack.packb(
                {"health": "ok", "recovered_from": recovered_from,
                 "time": time.time()}, use_bin_type=True)
            with self._allow_system_writes():
                self.put(row_key(TAG_HEALTH, 0, 0), row,
                         keyspace=self._system_ks_id)
        except Exception:
            pass
        return True

    def keyspace(self, name) -> KeyspaceHandle:
        """Bind a keyspace once; the handle's methods never re-thread it."""
        self._ks_id(name)                    # validate eagerly
        return KeyspaceHandle(self, name)

    def key_len(self, keyspace=0) -> int:
        """The keyspace's configured fixed key width (bytes).  Prefix-scan
        helpers size their upper-bound probes from this so a probe always
        compares above every real key sharing the prefix."""
        return self.table.ks(self._ks_id(keyspace)).cfg.key_len

    @staticmethod
    def _wopts(opts: Optional[WriteOptions], epoch) -> WriteOptions:
        # Legacy epoch= kwarg shim: fold into WriteOptions.  Both spellings
        # at once must agree — silently preferring either would mis-tag the
        # record for epoch pruning.
        if opts is None:
            return WriteOptions(epoch=epoch) if epoch else WriteOptions()
        if epoch and opts.epoch and epoch != opts.epoch:
            raise ValueError(
                f"conflicting epochs: epoch={epoch} kwarg vs "
                f"WriteOptions(epoch={opts.epoch})")
        if epoch and not opts.epoch:
            return replace(opts, epoch=epoch)
        return opts

    @staticmethod
    def _entry_parts(ks_id: int, key: bytes, value: bytes, epoch: int):
        """The entry payload for the WAL: small values staged through one
        ``encode_entry`` concatenation (cheaper than multi-part
        bookkeeping), large values as iovec parts — the value buffer then
        rides to ``pwritev`` uncopied."""
        if len(value) < _STAGE_VALUE_MAX:
            return encode_entry(ks_id, key, value, epoch)
        return [_ENTRY_HDR.pack(ks_id, len(key), epoch), key, value]

    def put(self, key: bytes, value: bytes, keyspace=0, epoch: int = 0,
            opts: Optional[WriteOptions] = None) -> int:
        opts = self._wopts(opts, epoch)
        ks_id = self._ks_id(keyspace)
        self._check_writable(ks_id)
        self._check_keys(ks_id, (key,))
        payload = self._entry_parts(ks_id, key, value, opts.epoch)
        with self._io_guard():
            pos = self.value_wal.append(T_ENTRY, payload, opts.epoch,
                                        app_bytes=len(key) + len(value))
        self.table.apply(ks_id, key, pos)
        self.value_wal.mark_processed(pos, payload_len(payload))
        self.cache.invalidate(self._cache_key(ks_id, key))
        if self.system is not None:
            self.system.note_put(ks_id, key, len(value))
        if opts.durability == "sync":
            with self._io_guard():
                self.value_wal.flush()
        return pos

    def delete(self, key: bytes, keyspace=0, epoch: int = 0,
               opts: Optional[WriteOptions] = None) -> int:
        opts = self._wopts(opts, epoch)
        ks_id = self._ks_id(keyspace)
        self._check_writable(ks_id)
        self._check_keys(ks_id, (key,))
        payload = encode_tombstone(ks_id, key, opts.epoch)
        with self._io_guard():
            pos = self.value_wal.append(T_TOMBSTONE, payload, opts.epoch,
                                        app_bytes=len(key))
        self.table.apply(ks_id, key, TOMB_FLAG | pos)
        self.value_wal.mark_processed(pos, len(payload))
        self.cache.invalidate(self._cache_key(ks_id, key))
        if self.system is not None:
            self.system.note_delete_many(ks_id, (key,))
        if opts.durability == "sync":
            with self._io_guard():
                self.value_wal.flush()
        return pos

    def _write_many(self, ks_id: int, records, keys, marker_of,
                    app_bytes: int, opts: WriteOptions,
                    epochs=None) -> list:
        """The batched write pipeline, shared by ``put_many`` and
        ``delete_many``: append (one allocation-lock acquisition, payload
        copies fanned across the copier pool outside the lock) → apply (one
        row-lock acquisition per cell) → mark processed (one tracker
        acquisition) → one cache invalidation sweep → optional sync flush.
        The ordering is correctness-critical and mirrors the scalar write
        flow (§3.1 steps 1–4); ``append_many`` returns only after every
        copy completes, so markers are applied for fully-written records
        only, and the sync flush rides the WAL's completion latch."""
        with self._io_guard():
            positions = self.value_wal.append_many(records, opts.epoch,
                                                   app_bytes=app_bytes,
                                                   epochs=epochs,
                                                   parallel=opts.parallel_copy)
        self.table.apply_many(
            [(ks_id, key, marker_of(pos))
             for key, pos in zip(keys, positions)])
        self.value_wal.mark_processed_many(
            (pos, payload_len(p)) for pos, (_, p) in zip(positions, records))
        self.cache.invalidate_many(
            [self._cache_key(ks_id, k) for k in keys])
        if opts.durability == "sync":
            with self._io_guard():
                self.value_wal.flush()
        return positions

    def put_many(self, items, keyspace=0, epoch: int = 0,
                 opts: Optional[WriteOptions] = None) -> list:
        """Batched ``put`` (§3.1 vectorized): ``items`` is a list of
        (key, value) pairs — or (key, value, epoch) triples to tag records
        individually (a triple overrides the batch-level epoch; per-record
        epochs tag only the segment each record lands in, exactly as N
        scalar puts would, so mixed-epoch batches never widen a segment's
        pruning range).

        One allocation-lock acquisition reserves WAL positions for the whole
        batch; records land as coalesced per-segment ``pwrite`` runs; the
        Large Table applies all markers with one row-lock acquisition per
        touched cell; one cache sweep invalidates every key.  NOT atomic —
        semantically identical to N ``put`` calls (each record replays
        independently, so a crash can admit a prefix); use ``write_batch``
        for all-or-nothing semantics.  Returns WAL positions aligned with
        ``items``.
        """
        items = list(items)       # may be a one-shot iterable; read twice
        if not items:
            return []
        opts = self._wopts(opts, epoch)
        ks_id = self._ks_id(keyspace)
        self._check_writable(ks_id)
        self._check_keys(ks_id, (it[0] for it in items))
        if self.system is not None:
            self.system.note_put_many(ks_id, items)
        records, app_bytes = [], 0
        epochs, mixed = [], False
        for item in items:
            key, value = item[0], item[1]
            e = item[2] if len(item) > 2 else opts.epoch
            mixed = mixed or e != opts.epoch
            epochs.append(e)
            records.append((T_ENTRY, self._entry_parts(ks_id, key, value, e)))
            app_bytes += len(key) + len(value)
        return self._write_many(ks_id, records, [it[0] for it in items],
                                lambda pos: pos, app_bytes, opts,
                                epochs=epochs if mixed else None)

    def delete_many(self, keys, keyspace=0, epoch: int = 0,
                    opts: Optional[WriteOptions] = None,
                    epochs=None) -> list:
        """Batched ``delete``; same pipeline and non-atomicity as
        ``put_many``.  Returns WAL positions aligned with ``keys``.

        ``epochs`` optionally carries one epoch per key (aligned with
        ``keys``), the tombstone twin of ``put_many``'s (key, value, epoch)
        triples: each tombstone tags only the segment it lands in, exactly
        as N scalar deletes would, so mixed-epoch batches never widen a
        segment's pruning range."""
        keys = list(keys)         # may be a one-shot iterable; read twice
        if not keys:
            return []
        opts = self._wopts(opts, epoch)
        ks_id = self._ks_id(keyspace)
        self._check_writable(ks_id)
        self._check_keys(ks_id, keys)
        if self.system is not None:
            self.system.note_delete_many(ks_id, keys)
        if epochs is not None:
            epochs = list(epochs)
            if len(epochs) != len(keys):
                raise ValueError("epochs must align 1:1 with keys")
            if all(e == opts.epoch for e in epochs):
                epochs = None     # uniform: batch-level tagging is identical
        eps = epochs if epochs is not None else [opts.epoch] * len(keys)
        records = [(T_TOMBSTONE, encode_tombstone(ks_id, key, e))
                   for key, e in zip(keys, eps)]
        return self._write_many(ks_id, records, keys,
                                lambda pos: TOMB_FLAG | pos,
                                sum(len(k) for k in keys), opts,
                                epochs=epochs)

    def write_batch(self, ops, epoch: int = 0,
                    opts: Optional[WriteOptions] = None) -> list:
        """Atomic batch (§3.1): one WAL allocation covers the whole batch.

        ``ops`` is a ``WriteBatch`` (preferred) or a legacy iterable of
        ("put", ks, key, value) / ("del", ks, key) tuples (deprecation
        shim).  Returns the sub-record WAL positions aligned with the ops.
        """
        batch = coerce_batch(ops)
        opts = self._wopts(opts, epoch)
        subrecords, metas = [], []
        app_bytes = 0
        for op in batch.ops:
            if op[0] == "put":
                _, ks, key, value = op
                ks_id = self._ks_id(ks)
                self._check_writable(ks_id)
                self._check_keys(ks_id, (key,))
                subrecords.append((T_ENTRY, self._entry_parts(
                    ks_id, key, value, opts.epoch)))
                metas.append((ks_id, key, False))
                app_bytes += len(key) + len(value)
                if self.system is not None:
                    self.system.note_put(ks_id, key, len(value))
            else:
                _, ks, key = op
                ks_id = self._ks_id(ks)
                self._check_writable(ks_id)
                self._check_keys(ks_id, (key,))
                subrecords.append((T_TOMBSTONE,
                                   encode_tombstone(ks_id, key, opts.epoch)))
                metas.append((ks_id, key, True))
                app_bytes += len(key)
                if self.system is not None:
                    self.system.note_delete_many(ks_id, (key,))
        if not subrecords:
            return []
        with self._io_guard():
            batch_pos, sub_positions = self.value_wal.append_batch(
                subrecords, opts.epoch, app_bytes=app_bytes)
        self.table.apply_many(
            [(ks_id, key, (TOMB_FLAG | pos) if is_del else pos)
             for (ks_id, key, is_del), pos in zip(metas, sub_positions)])
        self.cache.invalidate_many(
            [self._cache_key(ks_id, key) for ks_id, key, _ in metas])
        body_len = sum(HEADER_SIZE + payload_len(p) for _, p in subrecords)
        self.value_wal.mark_processed(batch_pos, body_len)
        if opts.durability == "sync":
            with self._io_guard():
                self.value_wal.flush()
        return sub_positions

    # ---------------------------------------------------------------- reads
    def _cache_key(self, ks_id: int, key: bytes) -> bytes:
        # Two bytes cover the whole u16 id space (incl. the 0xFFFF
        # __system sentinel); one byte would alias ids 256 apart.
        return ks_id.to_bytes(2, "big") + key

    def min_live(self) -> int:
        """Current visibility floor; pass as ``ReadOptions.min_live_pin``
        for a snapshot-consistent view across a batch of reads."""
        return self.value_wal.first_live_pos

    def _min_live(self, opts: ReadOptions) -> int:
        # The pin is a floor: pruning that already ran still wins, but a
        # prune racing the batch cannot split visibility across it.
        base = self.value_wal.first_live_pos
        if opts.min_live_pin is not None:
            return max(base, opts.min_live_pin)
        return base

    def _use_kernel(self, opts: ReadOptions) -> bool:
        return (self.cfg.batched_kernels if opts.use_kernel is None
                else opts.use_kernel)

    def get(self, key: bytes, keyspace=0,
            opts: Optional[ReadOptions] = None) -> Optional[bytes]:
        opts = opts or ReadOptions()
        ks_id = self._ks_id(keyspace)
        if self.system is not None:
            self.system.note_reads(ks_id, (key,))
        min_live = self._min_live(opts)
        ck = self._cache_key(ks_id, key)
        if opts.min_live_pin is None:
            # Pinned reads bypass the cache: a cached value carries no
            # position, so it can't be checked against the pin.
            v = self.cache.get(ck)
            if v is not None:
                self.metrics.add(cache_hits=1)
                return v
        self.metrics.add(cache_misses=1)
        last_err: Optional[WalReadError] = None
        for _attempt in range(2):           # retry once across concurrent GC
            pos = self.table.get_position(ks_id, key)
            if pos is None or pos < min_live \
                    or not self.value_wal.pos_live(pos):
                return None                  # absent or epoch-pruned
            try:
                rtype, payload = self.value_wal.read_record(pos)
            except WalReadError as e:
                last_err = e
                continue                     # relocated underneath us: retry
            except KeyError:
                continue
            if rtype == T_TOMBSTONE:
                return None
            _, _, value, _ = decode_entry(payload)
            if opts.fill_cache:
                self.cache.put(ck, value)
            return value
        # Both attempts resolved a live position and failed to read it:
        # that is real unreadability (corrupt/torn bytes, dead device), not
        # a relocation race.  The default stays fail-safe None; a strict
        # caller (the replicated failover path) gets the typed error so it
        # can route the key to a replica.
        if opts.strict_errors and last_err is not None:
            raise last_err
        return None

    def exists(self, key: bytes, keyspace=0,
               opts: Optional[ReadOptions] = None) -> bool:
        opts = opts or ReadOptions()
        ks_id = self._ks_id(keyspace)
        if self.system is not None:
            self.system.note_reads(ks_id, (key,), kind="exists")
        if opts.min_live_pin is None and \
                self.cache.get(self._cache_key(ks_id, key)) is not None:
            self.metrics.add(cache_hits=1)
            return True
        return self.table.exists(ks_id, key, self._min_live(opts),
                                 pos_live=self.value_wal.pos_live)

    # -------------------------------------------------------- batched reads
    def _live_positions(self, ks_id: int, keys, opts: ReadOptions,
                        min_live: int) -> list:
        """``get_positions_batch``, then again for the keys whose position
        died while the batch ran, until none moves.  Relocation CASes a
        key's index entry to its new copy before it advances the watermark
        past the old one, so a position found dead after resolution either
        moved (the index holds the new one) or was pruned (it still holds
        the dead one, which the caller skips).  Without this a batch racing
        a pruning slice answered absent for keys it had only relocated.
        (The JAX package's batched reads resolve once.)"""
        live = self.value_wal.pos_live
        use_kernel = self._use_kernel(opts)

        def dead(m) -> bool:
            return m is not None and not is_tombstone(m) and (
                real_pos(m) < min_live or not live(real_pos(m)))

        markers = self.table.get_positions_batch(ks_id, keys,
                                                 use_kernel=use_kernel)
        todo = [j for j, m in enumerate(markers) if dead(m)]
        while todo:
            again = self.table.get_positions_batch(
                ks_id, [keys[j] for j in todo], use_kernel=use_kernel)
            moved = [j for j, m in zip(todo, again) if m != markers[j]]
            for j, m in zip(todo, again):
                markers[j] = m
            todo = [j for j in moved if dead(markers[j])]
        return markers

    def multi_get(self, keys, keyspace=0,
                  opts: Optional[ReadOptions] = None) -> list:
        """Batched point lookups (§3.2, batched): resolve a whole batch of
        keys in one pipeline pass — one cache sweep, grouped per-cell index
        resolution (Bloom pass + one vectorized lookup across resident cell
        blobs), coalesced position-sorted WAL preads, and a single cache
        fill at the end.  Returns values aligned with ``keys`` (``None`` =
        absent/deleted).  Equivalent to ``[db.get(k) for k in keys]``,
        measured ≥2× faster at batch sizes ≥256 (benchmarks/kv_throughput).
        """
        if not keys:
            return []
        opts = opts or ReadOptions()
        ks_id = self._ks_id(keyspace)
        if self.system is not None:
            self.system.note_reads(ks_id, keys)
        min_live = self._min_live(opts)
        self.metrics.add(batched_read_keys=len(keys))
        results: list = [None] * len(keys)
        cks = [self._cache_key(ks_id, k) for k in keys]
        if opts.min_live_pin is None:
            cached = self.cache.get_many(cks)
        else:
            # Pinned reads bypass the cache (cached values carry no
            # position to check against the pin).
            cached = [None] * len(keys)
        miss_idx = [i for i, v in enumerate(cached) if v is None]
        for i, v in enumerate(cached):
            if v is not None:
                results[i] = v
        self.metrics.add(cache_hits=len(keys) - len(miss_idx),
                         cache_misses=len(miss_idx))
        if not miss_idx:
            return results
        markers = self._live_positions(ks_id, [keys[i] for i in miss_idx],
                                       opts, min_live)
        want: dict[int, list[int]] = {}
        for i, marker in zip(miss_idx, markers):
            if marker is None or is_tombstone(marker):
                continue
            pos = real_pos(marker)
            if pos < min_live or not self.value_wal.pos_live(pos):
                continue                 # epoch-pruned (watermark or mid-log)
            want.setdefault(pos, []).append(i)
        records = self.value_wal.read_records_batch(want) if want else {}
        fills = []
        for pos, slots in want.items():
            rec = records.get(pos)
            if rec is None:
                # Relocated underneath us: the scalar path re-resolves.
                # Under strict_errors the scalar retry surfaces persistent
                # unreadability as the typed error, embedded per-slot so
                # one corrupt key cannot fail the whole batch (the
                # failover layer retries exactly those slots on replicas).
                for i in slots:
                    if opts.strict_errors:
                        try:
                            results[i] = self.get(keys[i], keyspace,
                                                  opts=opts)
                        except WalReadError as e:
                            results[i] = e
                    else:
                        results[i] = self.get(keys[i], keyspace, opts=opts)
                continue
            rtype, payload = rec
            if rtype == T_TOMBSTONE:
                continue
            _, _, value, _ = decode_entry(payload)
            for i in slots:
                results[i] = value
                fills.append((cks[i], value))
        if opts.fill_cache:
            self.cache.put_many(fills)   # single cache fill at the end
        return results

    def multi_exists(self, keys, keyspace=0,
                     opts: Optional[ReadOptions] = None) -> list:
        """Batched existence checks resolved entirely from index state —
        the 15.6× op (§3.2), vectorized: one cache sweep, then ONE fused
        ragged Bloom probe over precomputed hashes — a single
        ``bloom_check`` kernel dispatch per store however many cells the
        batch touches (``ReadOptions.use_kernel`` routes it; batches below
        the dispatch threshold take the identical fused numpy pass) — and
        one batched Large Table resolution.  Never touches the Value WAL.
        Equivalent to ``[db.exists(k) for k in keys]``."""
        if not keys:
            return []
        opts = opts or ReadOptions()
        ks_id = self._ks_id(keyspace)
        if self.system is not None:
            self.system.note_reads(ks_id, keys, kind="exists")
        self.metrics.add(batched_read_keys=len(keys))
        results = [False] * len(keys)
        if opts.min_live_pin is None:
            cached = self.cache.get_many(
                [self._cache_key(ks_id, k) for k in keys])
        else:
            cached = [None] * len(keys)      # pinned: bypass the cache
        miss_idx = [i for i, v in enumerate(cached) if v is None]
        for i, v in enumerate(cached):
            if v is not None:
                results[i] = True
        self.metrics.add(cache_hits=len(keys) - len(miss_idx))
        if not miss_idx:
            return results
        min_live = self._min_live(opts)
        markers = self._live_positions(ks_id, [keys[i] for i in miss_idx],
                                       opts, min_live)
        pos_live = self.value_wal.pos_live
        for i, marker in zip(miss_idx, markers):
            results[i] = (marker is not None and not is_tombstone(marker)
                          and real_pos(marker) >= min_live
                          and pos_live(real_pos(marker)))
        return results

    def prev(self, key: bytes, keyspace=0) -> Optional[tuple[bytes, bytes]]:
        """Reverse iterator step: largest (key', value) with key' < key."""
        ks_id = self._ks_id(keyspace)
        k, pos = self.table.predecessor(ks_id, key, self.value_wal.first_live_pos)
        while k is not None:
            try:
                rtype, payload = self.value_wal.read_record(pos)
            except KeyError:
                k, pos = self.table.predecessor(ks_id, k,
                                                self.value_wal.first_live_pos)
                continue
            if rtype == T_ENTRY:
                _, _, value, _ = decode_entry(payload)
                return k, value
            k, pos = self.table.predecessor(ks_id, k,
                                            self.value_wal.first_live_pos)
        return None

    # ------------------------------------------------------------- lifecycle
    def snapshot_now(self, flush_threshold: int = 1) -> dict:
        """Flush eligible cells, persist the Control Region, GC old indices.

        Also the engine's control-loop tick: workload counters fold into the
        __system keyspace first (so the snapshot covers them), and the
        adaptive copier pool takes one rate-limited retune step."""
        if self.system is not None:
            self.system.fold()
        gov = getattr(self._copy_pool, "governor", None)
        if gov is not None:
            gov.maybe_adjust()
        self.flusher.flush_dirty(threshold=flush_threshold, wait=True)
        state = capture_state(self.table, self.value_wal, self.index_wal)
        with self._io_guard():
            write_control_region(self.path, state, self._io)
        min_idx = self.table.min_index_store_pos()
        if min_idx is not None:
            # One-segment slack so in-flight readers of just-replaced blobs
            # never observe a closed fd.
            slack = self.index_wal.cfg.segment_size
            self.index_wal.advance_gc_watermark(max(0, min_idx - HEADER_SIZE - slack))
        self._maybe_evict()
        return state

    def _maybe_evict(self) -> None:
        """Unload clean cells when the Large Table exceeds its budget."""
        if self.table.mem_entries <= self.cfg.mem_budget_entries:
            return
        for ks_id, cell in self.table.all_cells():
            if self.table.mem_entries <= self.cfg.mem_budget_entries * 0.9:
                break
            if cell.state == CellState.LOADED:
                self.table.evict_cell(ks_id, cell)

    def flush(self) -> None:
        """Strong durability point: everything fsynced + control updated."""
        self.snapshot_now(flush_threshold=1)
        with self._io_guard():
            self.value_wal.flush()
            self.index_wal.flush()

    def prune_epochs_below(self, epoch: int) -> int:
        return self.relocator.prune_epochs_below(epoch)

    def prune(self, opts: Optional[PruneOptions] = None) -> dict:
        """One forced reclamation pass (epoch expiry + relocation over
        ``reclaim_fraction`` of the live span); returns its summary.
        Relocation rides the batched write protocol and never blocks
        ``flush()`` acknowledgement — concurrent writers keep flowing."""
        return self.prune_controller.prune_once(opts)

    def prune_step(self, opts: Optional[PruneOptions] = None) -> int:
        """One bounded, trigger-respecting reclamation slice (at most one
        harvest batch); the unit ``KvBatchServer`` interleaves between
        serving stages.  Returns records scanned (0 = nothing to do)."""
        return self.prune_controller.step(opts)

    # ------------------------------------------------------------ integrity
    def scrub(self) -> dict:
        """One full CRC-verification pass over every sealed WAL segment;
        returns the report (findings, corruption count, records checked)
        and publishes it into ``__system`` (tag TAG_SCRUB)."""
        return self.scrubber.run()

    def scrub_step(self, max_segments: int = 1) -> int:
        """One bounded scrub slice (``KvBatchServer`` idle-tick unit);
        returns records verified."""
        return self.scrubber.step(max_segments)

    def close(self, flush: bool = True) -> None:
        if self._closed:
            return
        self._closed = True
        if self._prune_thread:
            self._prune_thread.stop()
        if self._scrub_thread:
            self._scrub_thread.stop()
        if self._snapshot_thread:
            self._snapshot_thread.stop()
        if flush:
            try:
                self.flush()
            except OSError:
                # A degraded store can't make new durability promises at
                # close; the failure already surfaced to a writer.
                if not self.degraded:
                    raise
        self.flusher.close()
        self.value_wal.close()
        self.index_wal.close()
        if self._owns_copy_pool:
            self._copy_pool.close()

    def crash(self) -> None:
        """Simulate kill -9 for crash-consistency tests: tear down threads
        and descriptors WITHOUT flushing, snapshotting, or repairing
        anything — the on-disk state is exactly what the OS already holds.
        A subsequent ``TideDB(path)`` exercises real recovery."""
        if self._closed:
            return
        self._closed = True
        if self._prune_thread:
            self._prune_thread.stop()
        if self._scrub_thread:
            self._scrub_thread.stop()
        if self._snapshot_thread:
            self._snapshot_thread.stop()
        self.flusher.pool.shutdown(wait=False, cancel_futures=True)
        self.flusher._closed = True
        self.value_wal.abandon()
        self.index_wal.abandon()
        if self._owns_copy_pool:
            self._copy_pool.close()

    # ------------------------------------------------------------- insights
    def stats(self) -> dict:
        s = self.metrics.snapshot()
        s.update(
            wal_tail=self.value_wal.tail,
            wal_live_bytes=self.value_wal.tail - self.value_wal.first_live_pos,
            mem_entries=self.table.mem_entries,
            copy_pool_threads=self._copy_pool.threads,
            health=self.health,
            degraded_reason=self._degraded_reason or "",
            quarantine_size=len(self.value_wal.quarantined()),
        )
        return s

    def system_tables(self) -> dict:
        """The decoded __system tables (keyspace_stats / large_values /
        hot_cells), keyed by keyspace name.  Folds pending counters first so
        the view is fresh; with ``system_stats=False`` it reads whatever a
        previous observer persisted."""
        if self.system is not None:
            self.system.fold()
            return self.system.tables()
        names = {i: cfg.name for i, cfg in enumerate(self.cfg.keyspaces)}
        return read_tables(self, names)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
