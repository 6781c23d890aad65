"""ShardedTideDB — static key-space sharding behind the ``Engine`` protocol.

Phase-1 scale-out (cf. Neon's static key-space sharding RFC, PAPERS.md):
keys partition across N independent ``TideDB`` shards by a stable hash of
the key; each shard owns its own Value WAL, Index Store, Large Table, and
cache, so shards share *nothing* and batched reads fan out across a thread
pool — the row-lock discipline already makes per-shard work independent,
and the heavy lifting in each shard (preads, numpy parsing, kernel
launches) drops the GIL.

Semantics vs a single ``TideDB``:

- ``get``/``put``/``delete``/``exists``/``multi_get``/``multi_exists``
  are exact: the shard function is deterministic, so every key always
  resolves through the same shard.
- ``write_batch`` is atomic *per shard*: ops split into one
  ``Wal.append_batch`` per shard, so a crash can admit a subset of shards'
  sub-batches.  Single-shard batches (including every per-handle batch
  whose keys land together) keep full atomicity.
- ``prev`` consults every shard and returns the globally largest
  predecessor.
- WAL positions (returned by writes, used by ``ReadOptions.min_live_pin``)
  are *per-shard* byte offsets.  ``min_live()`` returns the most
  conservative (minimum) floor across shards; cross-shard snapshot pinning
  is an open item (ROADMAP).

Replication (``replication=R``, default 1 = the semantics above): every
key additionally writes to the R−1 *successor* shards on the crc32 ring
(``(primary + j) % n_shards``), fanned through the same batched
``put_many``/``write_batch`` protocol, so per-shard atomicity and
sync-durability semantics carry over per replica.  Reads serve from the
primary and transparently fail over — in ring order — on
``CorruptionError``/``TornRecordError``/quarantine or when the primary
shard is degraded/stale (``Metrics.read_failovers`` counts off-primary
serves); results stay scalar-identical to a healthy single store.  A
replica write that fails on a degraded shard while ≥1 replica lands is
*shed*, recorded as resync debt, and replayed from the surviving peers by
an anti-entropy resync after ``try_recover`` succeeds — the shard rejoins
the read path only once its debt drains.  ``RepairController``
(``repair.py``, surfaced as ``repair()``/``repair_step()``) closes the
loop for latent corruption: quarantined positions are re-replicated from
a healthy peer copy.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from .api import (KeyspaceHandle, PruneOptions, ReadOptions, WriteBatch,
                  WriteOptions, coerce_batch)
from .db import DbConfig, TideDB, check_device, clamp_copy_threads
from .faults import DegradedError, WalReadError
from .repair import RepairController
from .wal import CopyPool, T_TOMBSTONE, decode_entry

# A replica write failing with one of these is *shed* (recorded as resync
# debt) as long as at least one replica landed; anything else (validation
# errors, wrong key width) propagates — it would fail identically on every
# replica.
_SHED_ERRORS = (DegradedError, OSError)


def _per_shard_config(cfg: DbConfig, n_shards: int) -> DbConfig:
    """Each shard holds ~1/N of the keys, so divide the pre-allocated cell
    array (uniform keyspaces) and the per-store resource budgets (value
    LRU, blob memo, Large Table residency, flusher threads) accordingly —
    the *aggregate* footprint and per-cell occupancy then match a
    single-store deployment, and neither the per-cell costs of a batched
    read nor the memory budget multiply by N."""
    keyspaces = [dataclasses.replace(ks, n_cells=max(8, ks.n_cells // n_shards))
                 if ks.distribution == "uniform" else ks
                 for ks in cfg.keyspaces]
    return dataclasses.replace(
        cfg, keyspaces=keyspaces,
        cache_bytes=cfg.cache_bytes // n_shards,
        blob_cache_bytes=cfg.blob_cache_bytes // n_shards,
        mem_budget_entries=max(1, cfg.mem_budget_entries // n_shards),
        flusher_threads=max(1, cfg.flusher_threads // n_shards))


class ShardedTideDB:
    """N ``TideDB`` shards behind one ``Engine`` surface."""

    def __init__(self, path: str, config: Optional[DbConfig] = None, *,
                 n_shards: int = 4, threads: Optional[int] = None,
                 scale_cells: bool = True, shard_ios=None,
                 replication: int = 1):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if not 1 <= replication <= n_shards:
            raise ValueError(
                f"replication must be in [1, n_shards] "
                f"(got {replication} for {n_shards} shards)")
        if shard_ios is not None and len(shard_ios) != n_shards:
            raise ValueError(
                f"shard_ios must align 1:1 with shards "
                f"({len(shard_ios)} backends for {n_shards} shards)")
        self.path = path
        self.cfg = config or DbConfig()
        check_device(self.cfg)
        self.n_shards = n_shards
        self.replication = replication
        shard_cfg = (_per_shard_config(self.cfg, n_shards) if scale_cells
                     else self.cfg)
        os.makedirs(path, exist_ok=True)
        # ONE copier pool shared by every shard's WALs: parallel payload
        # copies stay bounded at cfg.copy_threads for the whole store, not
        # N shards × M copiers (each shard's fan-out thread additionally
        # copies its own first sub-run, so per-shard writes still overlap).
        # The same pool serves per-shard relocation batches, so reclamation
        # concurrency is bounded store-wide too.  copy_threads=None builds
        # an adaptive pool with ONE store-wide governor (attached to the
        # shared pool; every shard's snapshot tick calls maybe_adjust, the
        # governor's own rate limit dedupes them).
        if self.cfg.copy_threads is None:
            self._copy_pool = CopyPool(None)
            from .system import CopierGovernor
            self._copy_pool.governor = CopierGovernor(self._copy_pool)
        else:
            self._copy_pool = CopyPool(
                clamp_copy_threads(self.cfg.copy_threads)
                if self.cfg.clamp_copy_threads else self.cfg.copy_threads)
        # Per-shard fault schedules (explorer/fuzz harnesses): ``shard_ios``
        # carries one ``IoBackend`` per shard — a ``None`` entry keeps the
        # shared config's backend — so one shard's disk can die or degrade
        # while its siblings run on healthy I/O.
        def _shard_cfg(i: int) -> DbConfig:
            if shard_ios is None or shard_ios[i] is None:
                return shard_cfg
            return dataclasses.replace(shard_cfg, io=shard_ios[i])

        self.shards = [TideDB(os.path.join(path, f"shard-{i:02d}"),
                              _shard_cfg(i), copy_pool=self._copy_pool)
                       for i in range(n_shards)]
        # The clamp happened before any shard metrics existed; record it
        # once (shard 0) so the summed stats() surface shows the gap.
        if self.cfg.copy_threads is not None:
            shaved = self.cfg.copy_threads - self._copy_pool.threads
            if shaved > 0:
                self.shards[0].metrics.add(copy_threads_clamped=shaved)
        self._pool = ThreadPoolExecutor(max_workers=threads or n_shards,
                                        thread_name_prefix="tide-shard")
        self._prune_rr = 0
        self._scrub_rr = 0
        self._closed = False
        # Resync debt: per shard, the (ks_id, key) pairs whose replica
        # write was shed while the shard was degraded (insertion-ordered
        # dict = dedup + replay order).  A shard with debt is *stale* —
        # demoted in the read order — until ``try_recover`` drains it from
        # the surviving peers.
        self._missed: list[dict] = [dict() for _ in range(n_shards)]
        self._missed_lock = threading.Lock()
        self.repairer = (RepairController(self) if replication > 1
                         else None)

    # ------------------------------------------------------------- routing
    def shard_of(self, key: bytes) -> int:
        """Stable key → shard map.  crc32 (not the cell hash: the Large
        Table cells key on the first 4 bytes) keeps each shard's key
        distribution uniform over the whole keyspace, which the optimistic
        index's interpolation search relies on."""
        return (zlib.crc32(key) * self.n_shards) >> 32

    def replicas_of(self, primary: int) -> tuple:
        """Placement ring: the primary plus its R−1 successors (mod N)."""
        return tuple((primary + j) % self.n_shards
                     for j in range(self.replication))

    def _is_stale(self, sid: int) -> bool:
        """A shard that is degraded or carries unresynced replica writes
        must not serve reads it may have missed."""
        return self.shards[sid].degraded or bool(self._missed[sid])

    def _read_order(self, primary: int) -> list[int]:
        """Failover order for a key: the replica ring, with degraded/stale
        shards demoted to last (still tried — a stale copy of an old key
        beats no answer when every fresh replica is unreadable)."""
        ring = self.replicas_of(primary)
        if self.replication == 1:
            return list(ring)
        fresh = [s for s in ring if not self._is_stale(s)]
        return fresh + [s for s in ring if self._is_stale(s)]

    def _group_indices(self, keys) -> dict[int, list[int]]:
        groups: dict[int, list[int]] = {}
        for i, k in enumerate(keys):
            groups.setdefault(self.shard_of(k), []).append(i)
        return groups

    def _ks_id(self, keyspace) -> int:
        return self.shards[0]._ks_id(keyspace)

    def keyspace(self, name) -> KeyspaceHandle:
        self._ks_id(name)                    # validate eagerly
        return KeyspaceHandle(self, name)

    def key_len(self, keyspace=0) -> int:
        """Configured fixed key width; identical across shards."""
        return self.shards[0].key_len(keyspace)

    # --------------------------------------------------------------- reads
    def get(self, key: bytes, keyspace=0,
            opts: Optional[ReadOptions] = None):
        primary = self.shard_of(key)
        if self.replication == 1:
            return self.shards[primary].get(key, keyspace, opts=opts)
        # strict_errors turns a CRC/torn/hole failure on a live position
        # into an exception instead of a silent None, so unreadable-here is
        # distinguishable from absent-everywhere and the next replica gets
        # a turn.  A clean miss (None) is authoritative: replicas hold the
        # same keys, so the first healthy answer wins.
        strict = dataclasses.replace(opts or ReadOptions(),
                                     strict_errors=True)
        for sid in self._read_order(primary):
            try:
                val = self.shards[sid].get(key, keyspace, opts=strict)
            except (WalReadError, DegradedError, OSError):
                # OSError covers a dead disk surfacing through the *index*
                # pread (before any WAL read gets a chance to wrap it).
                continue
            if sid != primary:
                self.shards[primary].metrics.add(read_failovers=1)
            return val
        return None        # every replica unreadable: same fail-safe as TideDB

    def exists(self, key: bytes, keyspace=0,
               opts: Optional[ReadOptions] = None) -> bool:
        primary = self.shard_of(key)
        if self.replication == 1:
            return self.shards[primary].exists(key, keyspace, opts=opts)
        # Index-only: no payload read to fail, so the first non-stale
        # replica normally answers outright; a dead disk under the index
        # still fails over.
        order = self._read_order(primary)
        for sid in order:
            try:
                found = self.shards[sid].exists(key, keyspace, opts=opts)
            except (DegradedError, OSError):
                continue
            if sid != primary:
                self.shards[primary].metrics.add(read_failovers=1)
            return found
        return False

    def multi_get(self, keys, keyspace=0,
                  opts: Optional[ReadOptions] = None) -> list:
        if self.replication == 1 or not keys:
            return self._multi(keys, keyspace, opts, "multi_get", None)
        return self._multi_get_replicated(list(keys), keyspace, opts)

    def _multi_get_replicated(self, keys, keyspace, opts) -> list:
        """Hop-based failover: hop h fans each still-pending key to the
        h-th shard in its read order (one batched ``multi_get`` per shard
        per hop).  ``strict_errors`` embeds the read failure in the slot,
        so a failed key stays pending for the next hop while its healthy
        batch-mates resolve; keys unreadable on every replica fall back to
        None (scalar parity)."""
        base = opts or ReadOptions()
        if base.use_kernel is None:
            # The multi-shard host route, as in ``_multi`` (see there).
            base = dataclasses.replace(base, use_kernel=False)
        strict = dataclasses.replace(base, strict_errors=True)
        prims = [self.shard_of(k) for k in keys]
        orders = [self._read_order(p) for p in prims]
        results: list = [None] * len(keys)
        pending = list(range(len(keys)))
        failovers: dict[int, int] = {}
        for hop in range(self.replication):
            if not pending:
                break
            groups: dict[int, list[int]] = {}
            for i in pending:
                groups.setdefault(orders[i][hop], []).append(i)

            def work(sid, idx):
                try:
                    return self.shards[sid].multi_get(
                        [keys[i] for i in idx], keyspace, strict)
                except (DegradedError, OSError) as e:
                    # Whole-shard failure (index pread on a dead disk):
                    # every slot stays pending for the next hop.
                    return [e] * len(idx)

            if len(groups) == 1:
                ((sid, idx),) = groups.items()
                outs = {sid: work(sid, idx)}
            else:
                futures = {sid: self._pool.submit(work, sid, idx)
                           for sid, idx in groups.items()}
                outs = {sid: f.result() for sid, f in futures.items()}
            still: list[int] = []
            for sid, idx in groups.items():
                for i, v in zip(idx, outs[sid]):
                    if isinstance(v, (WalReadError, DegradedError, OSError)):
                        still.append(i)
                        continue
                    results[i] = v
                    if sid != prims[i]:
                        failovers[prims[i]] = failovers.get(prims[i], 0) + 1
            pending = sorted(still)
        for sid, n in failovers.items():
            self.shards[sid].metrics.add(read_failovers=n)
        return results

    def multi_exists(self, keys, keyspace=0,
                     opts: Optional[ReadOptions] = None) -> list:
        """Batched existence fan-out: each shard's sub-batch coalesces its
        cross-cell Bloom probes into ONE fused ``probe_cells`` call — one
        probe per shard per batch, not one per touched cell (the kernel
        routes per ``ReadOptions.use_kernel``; the multi-shard default is
        the identical fused numpy pass, see ``_multi``).  Under
        replication, keys whose primary is stale route to their first
        healthy replica (index-only, so one hop suffices)."""
        return self._multi(keys, keyspace, opts, "multi_exists", False)

    def _multi(self, keys, keyspace, opts, method: str, default) -> list:
        """Fan a batched read per shard across the pool; merge aligned."""
        if not keys:
            return []
        if self.replication > 1:
            groups: dict[int, list[int]] = {}
            failovers: dict[int, int] = {}
            for i, k in enumerate(keys):
                primary = self.shard_of(k)
                sid = self._read_order(primary)[0]
                if sid != primary:
                    failovers[primary] = failovers.get(primary, 0) + 1
                groups.setdefault(sid, []).append(i)
            for sid, n in failovers.items():
                self.shards[sid].metrics.add(read_failovers=n)
        else:
            groups = self._group_indices(keys)
        if len(groups) == 1:
            ((sid, _),) = groups.items()
            return getattr(self.shards[sid], method)(keys, keyspace, opts=opts)
        if opts is None or opts.use_kernel is None:
            # The JAX package's default, kept for parity: it was set against
            # JAX's concurrent jit dispatch from shard threads, which
            # serializes on that runtime's locks (and the GIL), while the
            # host resolution path releases the GIL in its numpy bulk work.
            # On the card ``chip_smoke.py`` phase 8 alternated both routes 15
            # times on 4 shards, each shard's batch over the lookup's
            # threshold (median (IQR) ms, host / kernel, on an H100):
            # multi_exists of 73728 keys 858.06 (74.59) / 841.40 (125.25),
            # multi_get of 36864 keys 2141.12 (525.17) / 2471.07 (482.77).
            # Neither route won by more than the spread, so the host route
            # stays there too (PERF.md §6).
            # Routing never changes answers; an explicit
            # ReadOptions(use_kernel=True) overrides.
            opts = dataclasses.replace(opts or ReadOptions(),
                                       use_kernel=False)
        def work(sid, idx):
            # Sub-list construction runs inside the worker too, so the main
            # thread only fans out and merges.
            return getattr(self.shards[sid], method)(
                [keys[i] for i in idx], keyspace, opts)

        futures = {sid: self._pool.submit(work, sid, idx)
                   for sid, idx in groups.items()}
        results = [default] * len(keys)
        for sid, idx in groups.items():
            for i, v in zip(idx, futures[sid].result()):
                results[i] = v
        return results

    def prev(self, key: bytes, keyspace=0):
        """Globally largest (key', value) with key' < key: every shard may
        hold the predecessor, so ask all of them and take the max."""
        futures = [self._pool.submit(sh.prev, key, keyspace)
                   for sh in self.shards]
        best = None
        for f in futures:
            got = f.result()
            if got is not None and (best is None or got[0] > best[0]):
                best = got
        return best

    # -------------------------------------------------------------- writes
    def _record_misses(self, sid: int, pairs) -> None:
        """A replica write was shed on ``sid``: remember the (ks_id, key)
        pairs so the anti-entropy resync can replay them from a peer, and
        count the shed."""
        pairs = list(pairs)
        if not pairs:
            return
        with self._missed_lock:
            d = self._missed[sid]
            for p in pairs:
                d[p] = None
        self.shards[sid].metrics.add(replica_write_misses=len(pairs))

    def put(self, key: bytes, value: bytes, keyspace=0, epoch: int = 0,
            opts: Optional[WriteOptions] = None) -> int:
        primary = self.shard_of(key)
        if self.replication == 1:
            return self.shards[primary].put(key, value, keyspace,
                                            epoch, opts=opts)
        return self._replicated_scalar(
            primary, key, keyspace,
            lambda sh: sh.put(key, value, keyspace, epoch, opts=opts))

    def delete(self, key: bytes, keyspace=0, epoch: int = 0,
               opts: Optional[WriteOptions] = None) -> int:
        primary = self.shard_of(key)
        if self.replication == 1:
            return self.shards[primary].delete(key, keyspace, epoch,
                                               opts=opts)
        return self._replicated_scalar(
            primary, key, keyspace,
            lambda sh: sh.delete(key, keyspace, epoch, opts=opts))

    def _replicated_scalar(self, primary, key, keyspace, write) -> int:
        """Fan one scalar write over the key's replica ring.  The write
        succeeds if ANY replica lands (primary's position preferred);
        replicas that shed it accrue resync debt.  Only when EVERY replica
        fails does the first error propagate — the write took nowhere."""
        pos = None
        first_err = None
        failed: list[int] = []
        ks_id = self._ks_id(keyspace)
        for sid in self.replicas_of(primary):
            try:
                p = write(self.shards[sid])
            except _SHED_ERRORS as e:
                if first_err is None:
                    first_err = e
                failed.append(sid)
                continue
            if sid == primary or pos is None:
                pos = p
        if pos is None:
            # Landed nowhere: no durable copy exists, so there is nothing
            # to resync — surface the failure instead of recording debt.
            raise first_err
        for sid in failed:
            self._record_misses(sid, [(ks_id, bytes(key))])
        return pos

    def _fanout_writes(self, method: str, items: list, key_of,
                       keyspace, epoch, opts, epochs=None) -> list:
        """Shared scatter/gather for the batched write entry points: group
        item indices per shard, single-shard fast path, pool fan-out,
        aligned merge of per-shard positions.  An aligned ``epochs`` vector
        splits per shard alongside the items.

        Under replication every item fans to its whole replica ring (one
        batched call per shard covering every item the shard replicates);
        per-item success = ≥1 replica landed, with shed replicas accruing
        resync debt.  Positions stay primary-relative whenever the primary
        landed."""
        if not items:
            return []
        if epochs is not None and len(epochs) != len(items):
            raise ValueError("epochs must align 1:1 with keys")
        keys = [key_of(it) for it in items]
        if self.replication > 1:
            return self._fanout_replicated(method, items, keys, keyspace,
                                           epoch, opts, epochs)
        groups = self._group_indices(keys)

        def kwargs_for(idx):
            if epochs is None:
                return {}
            return {"epochs": [epochs[j] for j in idx]}

        if len(groups) == 1:
            ((sid, idx),) = groups.items()
            return getattr(self.shards[sid], method)(items, keyspace, epoch,
                                                     opts=opts,
                                                     **kwargs_for(idx))

        def work(sid, idx):
            return getattr(self.shards[sid], method)(
                [items[j] for j in idx], keyspace, epoch, opts=opts,
                **kwargs_for(idx))

        futures = {sid: self._pool.submit(work, sid, idx)
                   for sid, idx in groups.items()}
        positions: list = [None] * len(items)
        for sid, idx in groups.items():
            for j, pos in zip(idx, futures[sid].result()):
                positions[j] = pos
        return positions

    def _fanout_replicated(self, method, items, keys, keyspace, epoch,
                           opts, epochs) -> list:
        """Replicated scatter/gather (see ``_fanout_writes``): each shard
        receives ONE batched call with every item whose ring includes it,
        so a replicated put_many still costs one allocation-lock
        acquisition per touched shard, not one per copy."""
        prims = [self.shard_of(k) for k in keys]
        groups: dict[int, list[int]] = {}
        for j, p in enumerate(prims):
            for sid in self.replicas_of(p):
                groups.setdefault(sid, []).append(j)

        def work(sid, idx):
            kw = ({} if epochs is None
                  else {"epochs": [epochs[j] for j in idx]})
            return getattr(self.shards[sid], method)(
                [items[j] for j in idx], keyspace, epoch, opts=opts, **kw)

        futures = {sid: self._pool.submit(work, sid, idx)
                   for sid, idx in groups.items()}
        positions: list = [None] * len(items)
        landed = [0] * len(items)
        first_err = None
        shed: dict[int, list[int]] = {}
        for sid, idx in groups.items():
            try:
                res = futures[sid].result()
            except _SHED_ERRORS as e:
                if first_err is None:
                    first_err = e
                shed[sid] = idx
                continue
            for j, pos in zip(idx, res):
                landed[j] += 1
                if prims[j] == sid or positions[j] is None:
                    positions[j] = pos
        ks_id = self._ks_id(keyspace)
        for sid, idx in shed.items():
            # Debt only for items that landed elsewhere: an item with no
            # durable copy has nothing a resync could replay.
            self._record_misses(sid, ((ks_id, bytes(keys[j])) for j in idx
                                      if landed[j] > 0))
        if any(n == 0 for n in landed):
            # At least one item landed nowhere.  Like TideDB.put_many this
            # path is not atomic — other items' copies are already
            # durable — but the caller must see the failure.
            raise first_err if first_err is not None else DegradedError(
                "replicated write landed nowhere")
        return positions

    def put_many(self, items, keyspace=0, epoch: int = 0,
                 opts: Optional[WriteOptions] = None) -> list:
        """Batched put fanned out per shard: one ``append_many`` (one
        allocation-lock acquisition, parallel payload copies through the
        store-wide copier pool) per shard with the work submitted to the
        thread pool.  Positions are per-shard offsets aligned with
        ``items``; like ``TideDB.put_many`` this is NOT atomic."""
        return self._fanout_writes("put_many", list(items),
                                   lambda it: it[0], keyspace, epoch, opts)

    def delete_many(self, keys, keyspace=0, epoch: int = 0,
                    opts: Optional[WriteOptions] = None,
                    epochs=None) -> list:
        """Batched delete fanned out per shard (see ``put_many``).  The
        optional ``epochs`` vector (one per key, aligned) splits per shard
        with its keys, so each tombstone tags its shard's segment exactly
        as a scalar delete with that epoch would."""
        return self._fanout_writes("delete_many", list(keys),
                                   lambda k: k, keyspace, epoch, opts,
                                   epochs=list(epochs) if epochs is not None
                                   else None)

    def write_batch(self, ops, epoch: int = 0,
                    opts: Optional[WriteOptions] = None) -> list:
        """Split ops per shard; one atomic ``append_batch`` per shard.
        Returns per-shard WAL positions aligned with the ops.  Under
        replication each shard's sub-batch holds every op whose replica
        ring includes it (atomicity stays per shard per copy); an op
        succeeds if ≥1 replica's sub-batch landed."""
        batch = coerce_batch(ops)
        if not batch:
            return []
        per_shard: dict[int, list[tuple[int, tuple]]] = {}
        for j, op in enumerate(batch.ops):
            for sid in self.replicas_of(self.shard_of(op[2])):
                per_shard.setdefault(sid, []).append((j, op))
        positions: list = [None] * len(batch.ops)
        futures = []
        for sid, items in per_shard.items():
            wb = WriteBatch().extend(op for _, op in items)
            futures.append((sid, items, self._pool.submit(
                self.shards[sid].write_batch, wb, epoch, opts)))
        if self.replication == 1:
            for _, items, f in futures:
                for (j, _), pos in zip(items, f.result()):
                    positions[j] = pos
            return positions
        landed = [0] * len(batch.ops)
        first_err = None
        shed: list[tuple[int, list]] = []
        for sid, items, f in futures:
            try:
                res = f.result()
            except _SHED_ERRORS as e:
                if first_err is None:
                    first_err = e
                shed.append((sid, items))
                continue
            for (j, op), pos in zip(items, res):
                landed[j] += 1
                if self.shard_of(op[2]) == sid or positions[j] is None:
                    positions[j] = pos
        for sid, items in shed:
            # Debt only for ops that landed elsewhere: an op with no
            # durable copy has nothing a resync could replay.
            self._record_misses(
                sid, ((self._ks_id(op[1]), bytes(op[2]))
                      for j, op in items if landed[j] > 0))
        if any(n == 0 for n in landed):
            raise first_err if first_err is not None else DegradedError(
                "replicated batch landed nowhere")
        return positions

    # ----------------------------------------------------------- lifecycle
    def min_live(self) -> int:
        return min(sh.min_live() for sh in self.shards)

    def flush(self) -> None:
        for f in [self._pool.submit(sh.flush) for sh in self.shards]:
            f.result()

    def snapshot_now(self, flush_threshold: int = 1) -> list[dict]:
        futures = [self._pool.submit(sh.snapshot_now, flush_threshold)
                   for sh in self.shards]
        return [f.result() for f in futures]

    def prune_epochs_below(self, epoch: int) -> int:
        return sum(sh.prune_epochs_below(epoch) for sh in self.shards)

    def prune(self, opts: Optional[PruneOptions] = None) -> dict:
        """One forced reclamation pass on every shard, fanned across the
        pool.  Each shard's relocation batches re-append through its own
        WAL but share the store-wide CopyPool.  Counters sum across shards;
        ``space_amp`` reports the worst shard."""
        futures = [self._pool.submit(sh.prune, opts) for sh in self.shards]
        out: dict = {}
        for f in futures:
            for k, v in f.result().items():
                if k == "space_amp":
                    out[k] = max(out.get(k, 0.0), v)
                elif k == "triggered":
                    out[k] = out.get(k, False) or v
                else:
                    out[k] = out.get(k, 0) + v
        return out

    def prune_step(self, opts: Optional[PruneOptions] = None) -> int:
        """One bounded reclamation slice, round-robined across shards so a
        serving loop's per-stage budget stays one harvest batch."""
        sid = self._prune_rr % self.n_shards
        self._prune_rr += 1
        return self.shards[sid].prune_step(opts)

    # ------------------------------------------------------------ integrity
    @property
    def health(self) -> str:
        """``"degraded"`` if ANY shard is degraded: writes hash across all
        shards, so one read-only shard makes the store's write surface
        unreliable (a put may or may not land depending on its key)."""
        return ("degraded" if any(sh.degraded for sh in self.shards)
                else "ok")

    @property
    def degraded(self) -> bool:
        return self.health == "degraded"

    @property
    def writable(self) -> bool:
        """True while every placement ring has at least one healthy
        member — i.e. every key still has somewhere to land.  With
        replication=1 this degenerates to "no shard degraded" (a
        degraded shard owns keys no peer can absorb); with
        replication>1 a single degraded shard leaves the store fully
        writable: the write sheds to its ring peers, the miss is
        recorded as resync debt, and anti-entropy replays it when the
        shard rejoins."""
        down = [sh.degraded for sh in self.shards]
        if not any(down):
            return True
        n, r = self.n_shards, self.replication
        return all(not all(down[(p + j) % n] for j in range(r))
                   for p in range(n))

    @property
    def degraded_reason(self):
        for i, sh in enumerate(self.shards):
            if sh.degraded:
                return f"shard {i}: {sh.degraded_reason}"
        return None

    def try_recover(self, **kw) -> bool:
        """Fan the operator disk re-probe (``TideDB.try_recover``) across
        shards; True only when EVERY shard is healthy afterwards.  Healthy
        shards return True without probing, so this is safe to call when
        only one shard is degraded.  Under replication a shard that passes
        the probe is anti-entropy resynced before it counts as recovered:
        every (ks_id, key) it shed while degraded replays from a surviving
        peer, so the rejoined shard serves no stale reads."""
        ok = True
        for sid, sh in enumerate(self.shards):
            if not sh.try_recover(**kw):
                ok = False
                continue
            if self.replication > 1 and self._missed[sid]:
                ok = self._resync_shard(sid) and ok
        return ok

    def _resync_shard(self, sid: int) -> bool:
        """Replay the shard's resync debt from peer replicas.  Each missed
        key is fetched fresh (a later fanned write already made the peers
        current, so replaying the *current* peer state is idempotent) and
        re-applied as a normal foreground write; drained entries clear even
        on partial failure so the next recovery resumes where this one
        stopped."""
        with self._missed_lock:
            todo = list(self._missed[sid].keys())
        sh = self.shards[sid]
        ok = True
        done = []
        for ks_id, key in todo:
            try:
                ent = self._fetch_from_peers(ks_id, key, exclude=sid)
                if ent is None:
                    sh.delete(key, ks_id)
                else:
                    value, epoch = ent
                    sh.put(key, value, ks_id, epoch)
            except _SHED_ERRORS:
                ok = False
                break
            done.append((ks_id, key))
        with self._missed_lock:
            for item in done:
                self._missed[sid].pop(item, None)
        if done:
            sh.metrics.add(resync_records=len(done))
        if ok and todo:
            sh.metrics.add(resync_runs=1)
        return ok

    def _fetch_from_peers(self, ks_id: int, key: bytes,
                          exclude: int):
        """Read one key's healthy copy (value, epoch) directly off a peer
        replica's WAL — raw ``read_record`` so the peer's cache and read
        options don't color the bytes.  Returns None when every peer agrees
        the key is absent/deleted (a peer tombstone is authoritative), and
        skips peers whose copy is unreadable."""
        primary = self.shard_of(key)
        for sid in self.replicas_of(primary):
            if sid == exclude:
                continue
            sh = self.shards[sid]
            try:
                pos = sh.table.get_position(ks_id, key)
                if pos is None or not sh.value_wal.pos_live(pos):
                    continue
                rtype, payload = sh.value_wal.read_record(pos)
            except (KeyError, OSError):
                continue          # unreadable here; another peer may serve
            if rtype == T_TOMBSTONE:
                return None
            eks, ekey, value, epoch = decode_entry(payload)
            if eks != ks_id or ekey != key:
                continue
            return (value, epoch)
        return None

    def repair(self) -> dict:
        """One full repair pass (``RepairController.run``): re-replicate
        every quarantined position from a healthy peer copy.  No-op dict
        under replication=1 (no peer holds a second copy)."""
        if self.repairer is None:
            return {"examined": 0, "repaired": 0, "cas_lost": 0,
                    "unrepaired": 0, "skipped": 0}
        return self.repairer.run()

    def repair_step(self, max_repairs: int = 8) -> dict:
        """One bounded repair slice (serving-loop friendly)."""
        if self.repairer is None:
            return {"examined": 0, "repaired": 0, "cas_lost": 0,
                    "unrepaired": 0, "skipped": 0}
        return self.repairer.step(max_repairs=max_repairs)

    def scrub(self) -> dict:
        """One full CRC pass on every shard, fanned across the pool.
        Findings merge (tagged with their shard id); counters sum."""
        futures = [self._pool.submit(sh.scrub) for sh in self.shards]
        out: dict = {"findings": [], "corruptions": 0,
                     "records_checked": 0, "segments_checked": 0}
        for sid, f in enumerate(futures):
            rep = f.result()
            out["findings"].extend(dict(r, shard=sid)
                                   for r in rep["findings"])
            for k in ("corruptions", "records_checked", "segments_checked"):
                out[k] += rep[k]
        return out

    def scrub_step(self, max_segments: int = 1) -> int:
        """One bounded scrub slice, round-robined like ``prune_step``."""
        sid = self._scrub_rr % self.n_shards
        self._scrub_rr += 1
        return self.shards[sid].scrub_step(max_segments)

    def clear_caches(self) -> None:
        """Benchmark/test hook: drop every shard's value LRU."""
        for sh in self.shards:
            sh.cache.clear()

    def stats(self) -> dict:
        """Merged counters: numeric values sum across shards.  Health is
        aggregated explicitly (the numeric merge drops strings): the store
        is degraded if any shard is, and ``degraded_shards`` counts them."""
        out: dict = {"n_shards": self.n_shards}
        for sh in self.shards:
            for k, v in sh.stats().items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    out[k] = out.get(k, 0) + v
        out["health"] = self.health
        out["degraded_shards"] = sum(1 for sh in self.shards if sh.degraded)
        out["degraded_reason"] = self.degraded_reason or ""
        out["replication"] = self.replication
        out["resync_backlog"] = sum(len(d) for d in self._missed)
        return out

    def system_tables(self) -> dict:
        """Merged __system view: every shard observes only its own key
        subset and writes rows under IDENTICAL row keys, so the sharded
        ``prev`` (which dedupes equal keys across shards) cannot read
        them — each shard's tables are scanned directly and merged here.
        keyspace_stats sums counters; large_values re-ranks across shards;
        hot_cells re-ranks and tags each row with its shard id (cell ids
        are per-shard)."""
        per_shard = [self._pool.submit(sh.system_tables)
                     for sh in self.shards]
        top_n = self.shards[0].cfg.system_top_n
        stats: dict = {}
        large: dict = {}
        hot: dict = {}
        agg = self.stats()
        wa = (agg["bytes_written_disk"] / agg["bytes_written_app"]
              if agg.get("bytes_written_app") else 0.0)
        for sid, fut in enumerate(per_shard):
            t = fut.result()
            for ks, row in t["keyspace_stats"].items():
                dst = stats.setdefault(ks, {})
                for k, v in row.items():
                    if isinstance(v, bool) or not isinstance(v, (int, float)):
                        dst[k] = v
                    elif k == "write_amp_store":
                        dst[k] = wa          # store-wide, not per-shard
                    else:
                        dst[k] = dst.get(k, 0) + v
            for ks, rows in t["large_values"].items():
                large.setdefault(ks, []).extend(rows)
            for ks, rows in t["hot_cells"].items():
                hot.setdefault(ks, []).extend(
                    dict(r, shard=sid) for r in rows)
        for ks in large:
            large[ks] = sorted(large[ks],
                               key=lambda r: (-r["size"], r["key"]))[:top_n]
        for ks in hot:
            hot[ks] = sorted(hot[ks],
                             key=lambda r: (-(r["reads"] + r["writes"]),
                                            r["shard"],
                                            str(r["cell_id"])))[:top_n]
        return {"keyspace_stats": stats, "large_values": large,
                "hot_cells": hot}

    def close(self, flush: bool = True) -> None:
        if self._closed:
            return
        self._closed = True
        for f in [self._pool.submit(sh.close, flush) for sh in self.shards]:
            f.result()
        self._pool.shutdown(wait=True)
        self._copy_pool.close()

    def crash(self) -> None:
        """Simulate kill -9 across every shard (see ``TideDB.crash``): no
        flush, no snapshot, no repair — plus the store-wide pools, which the
        shards don't own."""
        if self._closed:
            return
        self._closed = True
        for sh in self.shards:
            sh.crash()
        self._pool.shutdown(wait=False, cancel_futures=True)
        self._copy_pool.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
