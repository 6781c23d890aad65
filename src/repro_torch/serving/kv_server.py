"""Storage-side serving: continuous batching for a *mixed* KV stream over
any ``Engine`` (embedded ``TideDB`` or the sharded ``ShardedTideDB``).

Queued get/exists/put/delete requests keep one queue discipline: each step
drains a batch and serves it as maximal same-kind runs in arrival order —
reads collapse into ``multi_get``/``multi_exists`` calls (§3.2's 1.7×/15.6×
wins at serving scale), writes collapse into batched
``put_many``/``delete_many`` calls (one WAL allocation-lock acquisition,
payload copies fanned across the engine's copier pool outside the lock;
per-shard fan-out when the engine is sharded).  Run boundaries preserve
scalar semantics: a read submitted after a write to the same key always
observes it.

This is the JAX package's ``KvBatchServer`` (``repro/serving/engine.py``),
in a module of its own so that it imports neither PyTorch nor the model
stack; ``repro_torch.serving.engine`` re-exports its names.  One deliberate
difference: the auto-recover rate limit starts at minus infinity, so the
first probe is never refused (see ``_maybe_recover``).
"""
from __future__ import annotations

import collections
import dataclasses
import math
import threading
import time
from typing import Optional

from repro_torch.core.tidestore.api import WriteBatch
from repro_torch.core.tidestore.system import SYSTEM_KEYSPACE
from repro_torch.serving.admission import AdmissionController, Overloaded


@dataclasses.dataclass
class KvRead:
    """A pending batched read; ``value``/``found`` are set once served.
    ``error`` carries the serve-stage exception when the engine failed this
    request — it's done (the submitter never hangs) but ``result()``
    re-raises."""
    key: bytes
    keyspace: int = 0
    op: str = "get"                     # "get" | "exists"
    value: Optional[bytes] = None
    found: Optional[bool] = None
    done: bool = False
    error: Optional[BaseException] = None
    t_submit: float = dataclasses.field(default_factory=time.time)
    t_done: Optional[float] = None

    def result(self):
        if self.error is not None:
            raise self.error
        return self.found if self.op == "exists" else self.value


@dataclasses.dataclass
class KvWrite:
    """A pending batched write; ``pos`` (the WAL position — per-shard when
    the engine is sharded) is set once the step's ``write_batch`` lands.
    ``error`` carries the serve-stage exception when the engine failed this
    request; ``result()`` re-raises it."""
    key: bytes
    value: Optional[bytes] = None       # None for deletes
    keyspace: int = 0
    op: str = "put"                     # "put" | "delete"
    pos: Optional[int] = None
    done: bool = False
    error: Optional[BaseException] = None
    t_submit: float = dataclasses.field(default_factory=time.time)
    t_done: Optional[float] = None

    def result(self):
        if self.error is not None:
            raise self.error
        return self.pos


class KvBatchServer:
    """Continuous batching for a mixed KV stream over any ``Engine``.

    Clients ``submit_get``/``submit_exists``/``submit_put``/
    ``submit_delete``; each ``step`` drains up to ``max_batch`` queued
    requests and serves them as maximal same-kind *runs* in arrival order:
    a read run becomes one ``multi_get``/``multi_exists`` per (op,
    keyspace) group, a write run retires through the vectorized write
    pipeline — one ``put_many``/``delete_many`` per (op, keyspace) group,
    falling back to one atomic ``write_batch`` when a key sees both ops in
    the same stage — the storage analogue of the decode engine's slot
    batching.  Run boundaries keep
    scalar semantics: reads never jump over an earlier write to the same
    key (and batched results are identical to scalar execution).
    Single-threaded step loop by design; submission is thread-safe.
    """

    def __init__(self, db, *, max_batch: int = 256, write_opts=None,
                 prune_opts=None, admission=None, scrub: bool = False,
                 auto_recover: bool = False,
                 recover_interval_s: float = 0.5):
        self.db = db
        self.max_batch = max_batch
        # Overload control at the submission edge (see serving/admission):
        # an AdmissionController (or an AdmissionConfig, wrapped here)
        # bounds the queue by request *cost* — submit_* raises Overloaded
        # (policy="shed") or blocks until the queue drains to the low
        # watermark (policy="backpressure") instead of growing the deque
        # without limit.  None keeps the seed behavior: unbounded queue.
        if admission is not None and not isinstance(admission,
                                                    AdmissionController):
            admission = AdmissionController(admission)
        self.admission = admission
        # Per-stage write options (WriteOptions): carries the durability
        # class and the parallel-copy routing knob into every retired write
        # stage — a server over an engine configured with
        # DbConfig.copy_threads=N fans each stage's payload copies across
        # that engine's copier pool (shared store-wide when sharded).
        self.write_opts = write_opts
        # Pruning rides the serving loop: when prune_opts is set (and the
        # engine exposes prune_step), one bounded relocation slice runs
        # after every served stage and on every idle step() — reclamation
        # progresses between serving stages instead of stalling them, and
        # idle servers converge toward the space-amp target for free.
        # Engines without prune_step (e.g. the LSM baseline) disable this.
        self.prune_opts = prune_opts
        self._prune_step = (getattr(db, "prune_step", None)
                            if prune_opts is not None else None)
        self.prune_steps = 0
        self.prune_scanned = 0
        # Scrubbing rides idle steps the same way pruning does: when
        # scrub=True (and the engine exposes scrub_step), an idle step()
        # CRC-verifies one sealed WAL segment — a busy server defers
        # integrity work to lulls, an idle one sweeps the store for free.
        self._scrub_step = (getattr(db, "scrub_step", None)
                            if scrub else None)
        self.scrub_steps = 0
        self.scrub_checked = 0
        self._lock = threading.Lock()
        self.queue: collections.deque = collections.deque()
        self._closed = False
        # The engine's reserved keyspace id, resolved once: writes to it
        # must be rejected at SUBMIT time — letting them reach step() would
        # fail the whole drained stage for every other client.
        self._reserved_ks = None
        norm = getattr(db, "_ks_id", None)
        if norm is not None:
            try:
                self._reserved_ks = norm(SYSTEM_KEYSPACE)
            except Exception:       # engine without a __system keyspace
                self._reserved_ks = None
        self.batches_served = 0
        self.keys_served = 0
        self.exists_served = 0
        self.writes_served = 0
        # Write-path counters: per-retired-stage records/bytes, so the
        # serving benchmark can report write amplification next to req/s
        # (engine-side disk bytes come from db.stats()).
        self.write_stages = 0
        self.write_bytes = 0
        self.serve_errors = 0           # failed stages (requests got .error)
        self.writes_shed_degraded = 0   # writes refused while engine degraded
        self.recover_attempts = 0       # try_recover calls routed to engine
        self.recoveries = 0             # ... that left the engine healthy
        # Operator-less recovery: when auto_recover=True, an *idle* step()
        # on a degraded engine probes db.try_recover(), rate-limited
        # server-side to recover_interval_s, so a transient disk outage
        # heals without anyone paging an operator.  Busy steps never probe
        # (serving traffic always comes first), and healthy engines pay
        # one attribute check per idle tick.
        self.auto_recover = auto_recover
        self.recover_interval_s = recover_interval_s
        # Never probed: the first idle probe always fires.  time.monotonic
        # counts from boot on Linux, so a start of 0.0 would refuse it
        # within recover_interval_s of a machine's boot.
        self._last_recover_probe = -math.inf
        self.auto_recover_probes = 0    # idle-tick probes attempted
        self.auto_recoveries = 0        # ... that brought the engine back

    def _engine_writable(self) -> bool:
        w = getattr(self.db, "writable", None)
        if w is None:   # engine predates the writable contract
            return getattr(self.db, "health", "ok") != "degraded"
        return bool(w)

    def _submit(self, req):
        if self._closed:
            raise RuntimeError("KvBatchServer is closed")
        # Validate the keyspace here so a bad spelling raises to the
        # submitter instead of poisoning a whole drained batch in step() —
        # and reject writes to the engine-maintained reserved keyspace
        # before any admission cost is charged or queue slot taken.
        norm = getattr(self.db, "_ks_id", None)
        if norm is not None:
            ks_id = norm(req.keyspace)
            if (isinstance(req, KvWrite) and self._reserved_ks is not None
                    and ks_id == self._reserved_ks):
                raise ValueError(
                    f"keyspace {SYSTEM_KEYSPACE!r} is read-only: its rows "
                    f"are maintained by the engine's StatsCollector")
        if isinstance(req, KvWrite) and not self._engine_writable():
            # An unwritable engine is read-only: shed the write at submit
            # time through the same Overloaded channel as admission
            # control, so clients with retry/backoff logic need no new
            # error handling — and reads/exists keep flowing untouched.
            # Note "unwritable", not "degraded": a replicated store with
            # one degraded shard stays writable (the engine sheds the
            # write to ring peers and resyncs the shard on rejoin), so
            # its clients see zero write impact during the outage.
            self.writes_shed_degraded += 1
            reason = getattr(self.db, "degraded_reason", None) or "unknown"
            raise Overloaded(
                0.0, reason=f"engine degraded (read-only): {reason}")
        if self.admission is not None:
            # Charge BEFORE enqueueing: a shed request never enters the
            # queue, a backpressured submitter blocks here.  The charged
            # cost rides the request so step() can release exactly it.
            cost = self.admission.cost_of(req)
            self.admission.admit(cost)   # may raise Overloaded / block
            req._cost = cost
        with self._lock:
            self.queue.append(req)
        return req

    def submit_get(self, key: bytes, keyspace=0) -> KvRead:
        return self._submit(KvRead(key=key, keyspace=keyspace, op="get"))

    def submit_exists(self, key: bytes, keyspace=0) -> KvRead:
        return self._submit(KvRead(key=key, keyspace=keyspace, op="exists"))

    def submit_put(self, key: bytes, value: bytes, keyspace=0) -> KvWrite:
        return self._submit(KvWrite(key=key, value=value, keyspace=keyspace,
                                    op="put"))

    def submit_delete(self, key: bytes, keyspace=0) -> KvWrite:
        return self._submit(KvWrite(key=key, keyspace=keyspace, op="delete"))

    def step(self) -> int:
        """Serve one drained batch as ordered same-kind stages; returns
        requests completed.

        Ops schedule into the earliest same-kind stage that keeps per-key
        program order: a read and a write to the same (keyspace, key) never
        reorder, and same-key writes keep their submission order (last
        write wins).  Ops on unrelated keys commute freely, so a mixed
        stream still forms large batches instead of breaking at every
        read/write boundary — while results stay identical to scalar
        execution.
        """
        with self._lock:
            take = [self.queue.popleft()
                    for _ in range(min(self.max_batch, len(self.queue)))]
        if not take:
            self._maybe_prune()          # idle steps still make progress
            self._maybe_scrub()          # ... and verify integrity in lulls
            self._maybe_recover()        # ... and probe a degraded engine
            return 0
        # Conflict keys normalize the keyspace (engines accept an index or
        # a name for the same keyspace; both spellings must collide here).
        norm = getattr(self.db, "_ks_id", lambda ks: ks)
        stages: list[tuple[bool, list, set]] = []   # (is_write, ops, keys)
        for r in take:
            is_write = isinstance(r, KvWrite)
            rk = (norm(r.keyspace), r.key)
            floor = 0                    # first stage index this op may join
            for si in range(len(stages) - 1, -1, -1):
                s_write, _, s_keys = stages[si]
                if rk in s_keys and s_write != is_write:
                    floor = si + 1       # read/write on same key: keep order
                    break
                if rk in s_keys and s_write and is_write:
                    floor = si           # write/write same key: same stage ok
                    break
            for si in range(floor, len(stages)):
                if stages[si][0] == is_write:
                    stages[si][1].append(r)
                    stages[si][2].add(rk)
                    break
            else:
                stages.append((is_write, [r], {rk}))
        served = 0
        for is_write, ops, _ in stages:
            try:
                served += (self._serve_writes(ops) if is_write
                           else self._serve_reads(ops))
            except Exception as exc:
                # A failing stage (I/O error, engine validation) must not
                # poison the loop: every not-yet-served request in it
                # completes with the error attached (result() re-raises to
                # that submitter), the other stages still serve.
                now = time.time()
                for r in ops:
                    if not r.done:
                        r.error, r.done, r.t_done = exc, True, now
                self.serve_errors += 1
                served += len(ops)
            finally:
                # Return each stage's admission cost promptly — success or
                # failure — so backpressured submitters wake as soon as the
                # drain crosses the low watermark, and a failing stage never
                # leaks budget (a leak would permanently shrink capacity).
                if self.admission is not None:
                    self.admission.release(
                        sum(getattr(r, "_cost", 0.0) for r in ops))
            # One bounded relocation slice between serving stages: the
            # slice scans at most PruneOptions.batch_records WAL records
            # and re-appends survivors through one append_many, so a stage
            # of foreground traffic is never starved by reclamation.
            self._maybe_prune()
        return served

    def _maybe_prune(self) -> None:
        if self._prune_step is None:
            return
        scanned = self._prune_step(self.prune_opts)
        if scanned:
            self.prune_steps += 1
            self.prune_scanned += scanned

    def _maybe_scrub(self) -> None:
        if self._scrub_step is None:
            return
        checked = self._scrub_step(1)
        if checked:
            self.scrub_steps += 1
            self.scrub_checked += checked

    def _maybe_recover(self) -> None:
        if not self.auto_recover:
            return
        if getattr(self.db, "health", "ok") != "degraded":
            return
        now = time.monotonic()
        if now - self._last_recover_probe < self.recover_interval_s:
            return
        self._last_recover_probe = now
        self.auto_recover_probes += 1
        if self.try_recover():
            self.auto_recoveries += 1

    def _serve_reads(self, reqs: list) -> int:
        # One multi-call per (op, keyspace) group present in the run.
        groups: dict[tuple, list[KvRead]] = {}
        for r in reqs:
            groups.setdefault((r.op, r.keyspace), []).append(r)
        for (op, ks), group in groups.items():
            keys = [r.key for r in group]
            if op == "get":
                values = self.db.multi_get(keys, keyspace=ks)
                for r, v in zip(group, values):
                    r.value, r.found = v, v is not None
            else:
                # One multi_exists per (exists, keyspace) group = one fused
                # Bloom probe per store per stage (per shard when the
                # engine is sharded), never one dispatch per touched cell.
                flags = self.db.multi_exists(keys, keyspace=ks)
                for r, f in zip(group, flags):
                    r.found = f
                self.exists_served += len(group)
            now = time.time()
            for r in group:
                r.done, r.t_done = True, now
            self.batches_served += 1
            self.keys_served += len(group)
        return len(reqs)

    def _serve_writes(self, reqs: list) -> int:
        # A same-kind stage retires through the vectorized write pipeline:
        # one ``put_many``/``delete_many`` per (op, keyspace) group — one
        # WAL allocation-lock acquisition + coalesced pwrite runs instead
        # of N appends.  If the same (keyspace, key) appears under BOTH ops
        # in this stage (the scheduler allows write/write same-key in one
        # stage), splitting by op would reorder them, so the whole stage
        # falls back to one atomic ``write_batch`` in submission order.
        # Engines without the batched entry points take the same fallback.
        norm = getattr(self.db, "_ks_id", lambda ks: ks)
        put_many = getattr(self.db, "put_many", None)
        delete_many = getattr(self.db, "delete_many", None)
        put_keys = {(norm(r.keyspace), r.key) for r in reqs if r.op == "put"}
        del_keys = {(norm(r.keyspace), r.key) for r in reqs
                    if r.op != "put"}
        if put_many is None or delete_many is None or (put_keys & del_keys):
            wb = WriteBatch()
            for r in reqs:
                if r.op == "put":
                    wb.put(r.key, r.value, keyspace=r.keyspace)
                else:
                    wb.delete(r.key, keyspace=r.keyspace)
            positions = self.db.write_batch(wb, opts=self.write_opts)
            for r, pos in zip(reqs, positions):
                r.pos = pos
        else:
            # Group on the NORMALIZED keyspace: aliased spellings (0 vs
            # "default") must land in one group, or same-key writes split
            # across groups and the later group's higher WAL position
            # would invert submission order.
            groups: dict[tuple, list[KvWrite]] = {}
            for r in reqs:
                groups.setdefault((r.op, norm(r.keyspace)), []).append(r)
            for (op, ks), group in groups.items():
                if op == "put":
                    positions = put_many([(r.key, r.value) for r in group],
                                         keyspace=ks, opts=self.write_opts)
                else:
                    positions = delete_many([r.key for r in group],
                                            keyspace=ks, opts=self.write_opts)
                for r, pos in zip(group, positions):
                    r.pos = pos
        now = time.time()
        for r in reqs:
            r.done, r.t_done = True, now
        self.batches_served += 1
        self.writes_served += len(reqs)
        self.write_stages += 1
        self.write_bytes += sum(
            len(r.key) + (len(r.value) if r.value is not None else 0)
            for r in reqs)
        return len(reqs)

    def try_recover(self) -> bool:
        """Operator path out of degraded mode without bouncing the engine:
        delegate to ``db.try_recover()`` (disk re-probe + repair-backlog
        drain).  On success the submit-time degraded check reads the
        engine's live health, so writes stop being shed immediately — no
        server restart, no reopen.  Engines without ``try_recover`` just
        report their current health."""
        fn = getattr(self.db, "try_recover", None)
        if fn is None:
            return getattr(self.db, "health", "ok") == "ok"
        self.recover_attempts += 1
        ok = bool(fn())
        if ok:
            self.recoveries += 1
        return ok

    def run_until_drained(self, max_steps: int = 100_000) -> int:
        total = 0
        for _ in range(max_steps):
            n = self.step()
            total += n
            if n == 0:
                break
        return total

    def close(self) -> int:
        """Stop accepting submissions and fail every still-queued request
        (``result()`` raises ``RuntimeError``), releasing their admission
        costs so blocked backpressure submitters wake instead of waiting on
        budget that will never drain.  Returns the number of requests
        discarded.  The engine itself is NOT closed (the server doesn't own
        it)."""
        self._closed = True
        with self._lock:
            dropped = list(self.queue)
            self.queue.clear()
        exc = RuntimeError("KvBatchServer closed before serving request")
        now = time.time()
        for r in dropped:
            r.error, r.done, r.t_done = exc, True, now
        if self.admission is not None:
            self.admission.release(
                sum(getattr(r, "_cost", 0.0) for r in dropped))
        return len(dropped)

    def stats(self) -> dict:
        with self._lock:                 # consistent vs concurrent submitters
            queued = len(self.queue)
        return {"batches_served": self.batches_served,
                "keys_served": self.keys_served,
                "exists_served": self.exists_served,
                "writes_served": self.writes_served,
                "write_stages": self.write_stages,
                "write_bytes": self.write_bytes,
                "mean_write_stage_records": (self.writes_served
                                             / self.write_stages
                                             if self.write_stages else 0.0),
                "mean_batch": ((self.keys_served + self.writes_served)
                               / self.batches_served
                               if self.batches_served else 0.0),
                "prune_steps": self.prune_steps,
                "prune_scanned": self.prune_scanned,
                "scrub_steps": self.scrub_steps,
                "scrub_checked": self.scrub_checked,
                "serve_errors": self.serve_errors,
                "writes_shed_degraded": self.writes_shed_degraded,
                "recover_attempts": self.recover_attempts,
                "recoveries": self.recoveries,
                "auto_recover_probes": self.auto_recover_probes,
                "auto_recoveries": self.auto_recoveries,
                "health": getattr(self.db, "health", "ok"),
                "queued": queued,
                **(self.admission.stats() if self.admission is not None
                   else {})}
