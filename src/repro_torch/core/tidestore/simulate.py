"""Deterministic crash-schedule explorer with a model-based durability oracle.

The WAL *is* the permanent store (paper §3.1), so the only integrity story
Tidehunter has is crash consistency: an acknowledged-durable write must
survive ANY crash, and an unacknowledged write may be present or absent but
never torn or interleaved.  The fuzz tier (``benchmarks/faults.py``) samples
random fault schedules; this module explores *systematically*: it replays
one seeded workload trace, counts every injectable I/O call the trace
performs (the *fault points*), then forks one run per point that crashes at
exactly that call, reopens the store, and checks the recovered state against
a model-based oracle.

Components:

- ``SimulatedCrash``: the crash signal.  Deliberately a ``BaseException``
  — engine code legitimately catches ``OSError``/``Exception`` on many
  write paths (fsync retry marks, poison-header repair, background flush
  classification), and none of those handlers may swallow a machine-off
  event.  As swallow-proofing, the harness ALSO checks ``io.crashed_at``
  after every op: an op that *acknowledges success* past the crash point is
  reported as a violation even if the exception got replaced in a
  ``finally`` block.
- ``CrashPointIo``: an ``IoBackend`` that counts injectable calls and fires
  one fault at a chosen index.  Styles: ``"clean"`` (the call does nothing,
  then crash), ``"torn"`` (a strict random prefix of the write lands, then
  crash) and ``"enospc"`` (the process survives but the device is full:
  every mutating op fails with ENOSPC until ``heal()``).  After a crash
  fires, the backend blacks out — all further I/O fails — so error-path
  cleanup (e.g. poison-header rewrites) cannot touch the dead disk.
- ``ShadowModel``: a plain-dict oracle.  Per key it tracks the write
  history and the last global ack point (a successful ``flush()`` or
  sync-durability write acks everything written before it, because
  ``Wal.flush`` fsyncs every dirty segment).  The legal post-crash values
  for a key are: the acked state, plus any state written after the ack
  (present-or-absent), and nothing else — torn or interleaved values are
  impossible by construction of the legal set.  Atomic batches are checked
  for all-or-nothing application.
- ``explore_trace`` / ``explore_sharded_trace``: the harnesses.  The sharded
  variant gives ONE shard a fault schedule (via ``ShardedTideDB``'s
  ``shard_ios``) and checks that siblings keep serving, that exactly the
  dead shard degrades, and that ``try_recover`` exits degraded mode after
  the device heals — and refuses to when it hasn't.

Determinism contract: ``explorer_config`` pins every source of scheduling
noise (one flusher thread, inline payload copies, no background WAL/snapshot
/prune/scrub threads, no __system stats sampling), so the discovery run and
every fork perform the same I/O calls in the same order up to the fault
point.
"""
from __future__ import annotations

import errno
import os
import random
import shutil
import tempfile
import threading
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .api import PruneOptions, ReadOptions, WriteBatch, WriteOptions
from .db import DbConfig, TideDB
from .faults import DEFAULT_IO, DegradedError, IoBackend
from .large_table import KeyspaceConfig
from .shard import ShardedTideDB
from .wal import HEADER_SIZE, WalConfig, _ENTRY_HDR

KEY_LEN = 8
KEYSPACES = ("alpha", "beta")

# Fault styles a fork may crash with.  "clean" and "torn" kill the process
# (crash + reopen); "enospc" keeps it alive on a full device (degraded mode
# + try_recover).
CRASH_STYLES = ("clean", "torn")


class SimulatedCrash(BaseException):
    """The machine died at injectable I/O call ``point``.

    A ``BaseException`` on purpose: every ``except OSError`` /
    ``except Exception`` handler in the engine (fsync retry marks, poison
    repair, background-flush classification) must let this through — a
    powered-off machine does not run error handlers.
    """

    def __init__(self, point: int):
        super().__init__(f"simulated crash at fault point {point}")
        self.point = point


class CrashPointIo(IoBackend):
    """Counts injectable I/O calls; fires one scheduled fault.

    Construct, build the store (construction I/O is not counted), then
    ``arm(point, style)``.  ``arm(None)`` is discovery mode: count calls,
    never fire.  ``calls`` after a discovery run is the number of fault
    points the workload reaches.  After the fault fires, ``crashed_at``
    holds the call index and the backend blacks out: crash styles fail ALL
    ops with EIO (the disk is gone with the machine), ``"enospc"`` fails
    only mutating ops (the device is full, reads still serve).  ``heal()``
    ends the blackout.
    """

    MUTATING = ("pwrite", "pwritev", "fsync", "ftruncate")

    def __init__(self, inner: Optional[IoBackend] = None, seed: int = 0):
        self.inner = inner or DEFAULT_IO
        self.have_pwritev = self.inner.have_pwritev
        self._lock = threading.Lock()
        self._rng = random.Random(seed)
        self.armed = False
        self.point: Optional[int] = None
        self.style = "clean"
        self.calls = 0                      # injectable calls since arm()
        self.crashed_at: Optional[int] = None
        self.blackout = False

    # -- scheduling ---------------------------------------------------------
    def arm(self, point: Optional[int], style: str = "clean") -> None:
        if style not in ("clean", "torn", "enospc"):
            raise ValueError(f"unknown crash style {style!r}")
        with self._lock:
            self.armed = True
            self.point = point
            self.style = style
            self.calls = 0
            self.crashed_at = None
            self.blackout = False

    def disarm(self) -> None:
        """Stop counting (and firing); teardown I/O stays invisible."""
        with self._lock:
            self.armed = False
            self.point = None

    def heal(self) -> None:
        """The device came back (disk freed / machine replaced): end the
        blackout.  ``crashed_at`` is kept for coverage accounting."""
        with self._lock:
            self.blackout = False
            self.point = None

    def _tick(self) -> bool:
        """Count one injectable call; True when it is the fault point."""
        with self._lock:
            if not self.armed:
                return False
            n = self.calls
            self.calls = n + 1
            if self.point is not None and n == self.point \
                    and self.crashed_at is None:
                self.crashed_at = n
                self.blackout = True
                return True
            return False

    def _gate(self, mutating: bool) -> bool:
        """Run the per-call fault logic.  Returns True when the caller
        should perform style-specific crash behaviour (torn prefix); raises
        directly for errno-style faults and the post-fault blackout."""
        fire = self._tick()
        if self.style == "enospc":
            if (fire or self.blackout) and mutating:
                raise OSError(errno.ENOSPC, "injected: device full "
                              f"(fault point {self.crashed_at})")
            return False
        if fire:
            return True
        if self.blackout:
            raise OSError(errno.EIO, "post-crash blackout: the machine "
                          f"died at fault point {self.crashed_at}")
        return False

    def _prefix(self, total: int) -> int:
        with self._lock:
            return self._rng.randrange(total) if total > 0 else 0

    # -- faulted ops --------------------------------------------------------
    def open(self, path: str, flags: int, mode: int = 0o644) -> int:
        if self._gate(False):
            raise SimulatedCrash(self.crashed_at)
        return self.inner.open(path, flags, mode)

    def pread(self, fd: int, n: int, off: int) -> bytes:
        if self._gate(False):
            raise SimulatedCrash(self.crashed_at)
        return self.inner.pread(fd, n, off)

    def fsync(self, fd: int) -> None:
        if self._gate(True):
            raise SimulatedCrash(self.crashed_at)
        self.inner.fsync(fd)

    def ftruncate(self, fd: int, length: int) -> None:
        if self._gate(True):
            raise SimulatedCrash(self.crashed_at)
        self.inner.ftruncate(fd, length)

    def pwrite(self, fd: int, data, off: int) -> int:
        if self._gate(True):
            if self.style == "torn":
                buf = bytes(data)
                n = self._prefix(len(buf))
                if n:
                    self.inner.pwrite(fd, buf[:n], off)
            raise SimulatedCrash(self.crashed_at)
        return self.inner.pwrite(fd, data, off)

    def pwritev(self, fd: int, bufs: Sequence, off: int) -> int:
        if self._gate(True):
            if self.style == "torn":
                flat = b"".join(bytes(b) for b in bufs)
                n = self._prefix(len(flat))
                if n:
                    self.inner.pwrite(fd, flat[:n], off)
            raise SimulatedCrash(self.crashed_at)
        return self.inner.pwritev(fd, bufs, off)


# ---------------------------------------------------------------------------
# Workload traces
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TraceOp:
    """One deterministic workload step.

    ``kind`` is one of ``put`` / ``delete`` / ``put_many`` / ``write_batch``
    / ``flush`` / ``prune_step`` / ``scrub_step``.  Write kinds carry the
    concrete keyspace, keys and values (generation bakes in per-key version
    counters, so every written value is globally unique — the oracle's
    set-membership check then distinguishes versions exactly).
    """

    kind: str
    ks: str = KEYSPACES[0]
    items: tuple = ()          # put_many: ((key, value), ...); delete: (key,)
    batch: tuple = ()          # write_batch: (("put", ks, key, value) |
                               #               ("del", ks, key), ...)
    epoch: int = 0
    sync: bool = False         # put with durability="sync" (a global ack)


def key_of(i: int) -> bytes:
    return b"%0*d" % (KEY_LEN, i)


def _value(rng: random.Random, seed: int, key: bytes, version: int) -> bytes:
    """Globally unique, self-describing value with a varied length (small
    staged writes and >4 KiB iovec-path writes both get exercised)."""
    head = b"v:%d:%s:%d:" % (seed, key, version)
    n = rng.choice((0, 5, 24, 300, 1200, 5000))
    return head + bytes((version + j) & 0xFF for j in range(n))


def generate_trace(seed: int, *, n_ops: int = 18, n_keys: int = 12) -> list:
    """The seeded workload: deterministic in (seed, n_ops, n_keys)."""
    rng = random.Random(seed)
    versions: Dict[bytes, int] = {}

    def fresh(key: bytes) -> bytes:
        v = versions.get(key, 0) + 1
        versions[key] = v
        return _value(rng, seed, key, v)

    ops: List[TraceOp] = []
    for _ in range(n_ops):
        ks = rng.choice(KEYSPACES)
        epoch = rng.randrange(4)
        r = rng.random()
        if r < 0.30:
            k = key_of(rng.randrange(n_keys))
            ops.append(TraceOp("put", ks, items=((k, fresh(k)),),
                               epoch=epoch, sync=rng.random() < 0.15))
        elif r < 0.40:
            ops.append(TraceOp("delete", ks,
                               items=(key_of(rng.randrange(n_keys)),),
                               epoch=epoch))
        elif r < 0.60:
            idx = rng.sample(range(n_keys), k=rng.randint(2, 5))
            items = tuple((key_of(i), fresh(key_of(i))) for i in idx)
            ops.append(TraceOp("put_many", ks, items=items, epoch=epoch))
        elif r < 0.75:
            idx = rng.sample(range(n_keys), k=rng.randint(2, 4))
            batch = []
            for i in idx:
                k = key_of(i)
                if rng.random() < 0.75:
                    batch.append(("put", ks, k, fresh(k)))
                else:
                    batch.append(("del", ks, k))
            ops.append(TraceOp("write_batch", ks, batch=tuple(batch),
                               epoch=epoch))
        elif r < 0.85:
            ops.append(TraceOp("flush"))
        elif r < 0.93:
            ops.append(TraceOp("prune_step"))
        else:
            ops.append(TraceOp("scrub_step"))
    # Every trace ends on a durability point so at least one ack exists and
    # late fault points land inside a flush (the interesting fsync paths).
    ops.append(TraceOp("flush"))
    return ops


# ---------------------------------------------------------------------------
# The oracle
# ---------------------------------------------------------------------------


class ShadowModel:
    """Plain-dict durability oracle for post-crash states.

    Writes are recorded *before* the engine attempts them (a crashed op may
    have partially landed); acks are recorded only after the engine returns
    success.  The legal post-crash observation for a key is:

    - the state of its last write at-or-before the last global ack
      (``None`` = absent, if the key had no acked write or the acked write
      was a delete), **plus**
    - the state of any write after the ack barrier (each may or may not
      have reached the WAL).

    Nothing else is legal — a value not in this set is torn, interleaved,
    resurrected or fabricated.  Atomic batches additionally must apply
    all-or-nothing (checked on batches whose keys were not overwritten
    later and which contain at least two distinguishable puts).
    """

    def __init__(self):
        self._seq = 0
        self._hist: Dict[Tuple[str, bytes], List[Tuple[int, Optional[bytes]]]] = {}
        self._ack_barrier = -1              # highest acked seq
        self._batches: List[dict] = []

    # -- recording ----------------------------------------------------------
    def _record(self, ks: str, key: bytes, state: Optional[bytes]) -> int:
        self._seq += 1
        self._hist.setdefault((ks, key), []).append((self._seq, state))
        return self._seq

    def apply_put(self, ks: str, key: bytes, value: bytes) -> None:
        self._record(ks, key, value)

    def apply_delete(self, ks: str, key: bytes) -> None:
        self._record(ks, key, None)

    def apply_batch(self, ops: Sequence[tuple]) -> None:
        writes: Dict[Tuple[str, bytes], Optional[bytes]] = {}
        for op in ops:
            if op[0] == "put":
                _, ks, key, value = op
                writes[(ks, key)] = value
            else:
                _, ks, key = op
                writes[(ks, key)] = None
        seqs = [self._record(ks, key, st) for (ks, key), st in writes.items()]
        self._batches.append({"writes": writes, "max_seq": max(seqs)})

    def ack(self) -> None:
        """A global durability point succeeded (``flush()`` or a sync write
        — ``Wal.flush`` fsyncs every dirty segment, so everything written
        before it is now guaranteed)."""
        self._ack_barrier = self._seq

    # -- the legality rule --------------------------------------------------
    def keys(self) -> List[Tuple[str, bytes]]:
        return sorted(self._hist.keys())

    def legal_states(self, ks: str, key: bytes) -> Set[Optional[bytes]]:
        hist = self._hist.get((ks, key), [])
        acked = [st for seq, st in hist if seq <= self._ack_barrier]
        later = [st for seq, st in hist if seq > self._ack_barrier]
        base = acked[-1] if acked else None
        return {base} | set(later)

    # -- checking -----------------------------------------------------------
    def check(self, db, *, label: str = "") -> List[str]:
        """Read every touched key back; returns violation strings."""
        violations: List[str] = []
        observed: Dict[Tuple[str, bytes], Optional[bytes]] = {}
        for ks, key in self.keys():
            try:
                obs = db.get(key, keyspace=ks)
            except Exception as e:
                violations.append(
                    f"{label}get({ks}/{key!r}) raised {e!r}")
                continue
            observed[(ks, key)] = obs
            if obs not in self.legal_states(ks, key):
                violations.append(
                    f"{label}illegal state for {ks}/{key!r}: "
                    f"observed {_describe(obs)}, legal "
                    f"{{{', '.join(sorted(_describe(s) for s in self.legal_states(ks, key)))}}}")
        violations.extend(self._check_batches(observed, label))
        return violations

    def _check_batches(self, observed, label) -> List[str]:
        """All-or-nothing for unacked batches whose keys were never written
        again: either every put of the batch is observed, or none is.
        (Acked batches are covered by the per-key rule; clobbered batches
        can't be judged from final state.)"""
        out: List[str] = []
        for i, b in enumerate(self._batches):
            if b["max_seq"] <= self._ack_barrier:
                continue
            clobbered = any(self._hist[(ks, key)][-1][0] > b["max_seq"]
                            or self._hist[(ks, key)][-1][1] != st
                            for (ks, key), st in b["writes"].items())
            if clobbered:
                continue
            puts = {(ks, key): st for (ks, key), st in b["writes"].items()
                    if st is not None}
            if len(puts) < 2 or any(k not in observed for k in puts):
                continue
            applied = sum(1 for k, st in puts.items() if observed[k] == st)
            if 0 < applied < len(puts):
                out.append(f"{label}torn atomic batch #{i}: {applied} of "
                           f"{len(puts)} puts applied")
        return out


def _describe(state: Optional[bytes]) -> str:
    if state is None:
        return "<absent>"
    head = state.split(b":", 4)[:4]
    return b":".join(head).decode("latin1")


# ---------------------------------------------------------------------------
# Store configuration and the trace runner
# ---------------------------------------------------------------------------


def explorer_config(io: Optional[IoBackend] = None, *,
                    device: str = "cuda") -> DbConfig:
    """A fully deterministic store: one flusher thread, inline payload
    copies, no background threads, no __system observation — so every fork
    performs the discovery run's I/O calls in the discovery run's order up
    to its fault point.  ``device`` is the store's (``DbConfig.device``):
    "cuda" needs a card, "cpu" runs anywhere."""
    return DbConfig(
        keyspaces=[KeyspaceConfig("alpha", key_len=KEY_LEN, n_cells=8,
                                  prefix_len=2, window_entries=64,
                                  dirty_flush_threshold=32),
                   KeyspaceConfig("beta", key_len=KEY_LEN, n_cells=4,
                                  prefix_len=2, window_entries=64,
                                  dirty_flush_threshold=32)],
        wal=WalConfig(segment_size=16 * 1024, background=False,
                      copy_threads=1),
        index_wal=WalConfig(segment_size=64 * 1024, background=False,
                            copy_threads=1),
        flusher_threads=1,
        background_snapshots=False,
        copy_threads=1,
        system_stats=False,
        batched_kernels=False,
        prune=PruneOptions(min_reclaim_bytes=0),
        io=io,
        device=device,
    )


def apply_op(db, model: Optional[ShadowModel], op: TraceOp) -> None:
    """Execute one trace op against any Engine, keeping the oracle in step.
    The model is told about writes BEFORE the engine attempts them and
    about acks only AFTER the engine confirms them."""
    if op.kind == "put":
        key, value = op.items[0]
        if model is not None:
            model.apply_put(op.ks, key, value)
        db.put(key, value, keyspace=op.ks, opts=WriteOptions(
            epoch=op.epoch, durability="sync" if op.sync else "async"))
        if op.sync and model is not None:
            model.ack()
    elif op.kind == "delete":
        (key,) = op.items
        if model is not None:
            model.apply_delete(op.ks, key)
        db.delete(key, keyspace=op.ks, epoch=op.epoch)
    elif op.kind == "put_many":
        if model is not None:
            for key, value in op.items:
                model.apply_put(op.ks, key, value)
        db.put_many(list(op.items), keyspace=op.ks, epoch=op.epoch)
    elif op.kind == "write_batch":
        if model is not None:
            model.apply_batch(op.batch)
        wb = WriteBatch()
        for o in op.batch:
            if o[0] == "put":
                wb.put(o[2], o[3], keyspace=o[1])
            else:
                wb.delete(o[2], keyspace=o[1])
        db.write_batch(wb, epoch=op.epoch)
    elif op.kind == "flush":
        db.flush()
        if model is not None:
            model.ack()
    elif op.kind == "prune_step":
        db.prune_step()
    elif op.kind == "scrub_step":
        db.scrub_step()
    else:
        raise ValueError(f"unknown trace op {op.kind!r}")


def run_trace(db, trace: Sequence[TraceOp],
              model: Optional[ShadowModel] = None,
              io: Optional[CrashPointIo] = None) -> dict:
    """Drive a trace to completion or to the crash point.

    Returns ``{"completed", "crashed", "crash_op", "violations"}``.  The
    swallow-proofing lives here: after EVERY op the harness checks
    ``io.crashed_at`` — an op that returned success even though the machine
    died inside it acknowledged a write it cannot have made durable, which
    is a violation regardless of what happened to the ``SimulatedCrash``
    exception on its way up.
    """
    violations: List[str] = []
    for i, op in enumerate(trace):
        try:
            apply_op(db, model, op)
        except SimulatedCrash:
            return {"completed": False, "crashed": True, "crash_op": i,
                    "violations": violations}
        except Exception as e:
            if io is not None and io.crashed_at is not None:
                # The crash surfaced as a replaced exception (a cleanup
                # path failed inside the blackout) — still a crash, and
                # nothing was acknowledged.  Not a violation.
                return {"completed": False, "crashed": True, "crash_op": i,
                        "violations": violations}
            raise RuntimeError(
                f"trace op {i} ({op.kind}) failed without a crash") from e
        if io is not None and io.crashed_at is not None:
            violations.append(
                f"op {i} ({op.kind}) acknowledged success past the crash "
                f"at fault point {io.crashed_at}")
            return {"completed": False, "crashed": True, "crash_op": i,
                    "violations": violations}
    return {"completed": True, "crashed": False, "crash_op": None,
            "violations": violations}


# ---------------------------------------------------------------------------
# Single-store exploration
# ---------------------------------------------------------------------------


def explore_trace(seed: int, *, n_ops: int = 18, n_keys: int = 12,
                  base_dir: Optional[str] = None,
                  styles: Sequence[str] = CRASH_STYLES,
                  max_points: Optional[int] = None,
                  device: str = "cuda") -> dict:
    """Crash the seeded trace at every injectable fault point it reaches.

    Phase 1 (discovery) runs the trace on a counting backend to learn the
    fault-point universe.  Phase 2 forks one store per point p: replay the
    trace, crash at call p (styles alternate clean/torn by index), tear the
    process down via ``TideDB.crash()``, reopen with healthy I/O, and check
    every touched key against the ``ShadowModel`` oracle.  Returns the
    coverage report; ``violations`` empty means every reachable crash
    schedule recovered to a legal state.
    """
    trace = generate_trace(seed, n_ops=n_ops, n_keys=n_keys)
    base = base_dir or tempfile.mkdtemp(prefix=f"tide-explore-{seed}-")
    owns_base = base_dir is None
    report = {"seed": seed, "ops": len(trace), "fault_points": 0,
              "forks": 0, "style_counts": {}, "violations": [],
              "unreached_points": [], "fork_points": []}
    try:
        # -- discovery ------------------------------------------------------
        dio = CrashPointIo(seed=seed)
        ddir = os.path.join(base, "discover")
        db = TideDB(ddir, explorer_config(dio, device=device))
        dio.arm(None)
        res = run_trace(db, trace, ShadowModel(), dio)
        assert res["completed"], "discovery run must not crash"
        n_points = dio.calls
        dio.disarm()
        db.close()
        shutil.rmtree(ddir)
        report["fault_points"] = n_points

        # -- forks ----------------------------------------------------------
        points = range(n_points) if max_points is None \
            else range(0, n_points, max(1, n_points // max_points))
        for p in points:
            style = styles[p % len(styles)]
            report["style_counts"][style] = \
                report["style_counts"].get(style, 0) + 1
            fdir = os.path.join(base, f"fork-{p:05d}")
            fio = CrashPointIo(seed=seed * 1_000_003 + p)
            fdb = TideDB(fdir, explorer_config(fio, device=device))
            fio.arm(p, style)
            model = ShadowModel()
            res = run_trace(fdb, trace, model, fio)
            report["violations"].extend(
                f"seed {seed} point {p} ({style}): {v}"
                for v in res["violations"])
            report["forks"] += 1
            report["fork_points"].append(fio.crashed_at)
            if not res["crashed"]:
                # Fork diverged from discovery (should be impossible under
                # the determinism contract): record it, close cleanly.
                report["unreached_points"].append(p)
                fio.disarm()
                fdb.close()
                shutil.rmtree(fdir)
                continue
            fdb.crash()                     # kill -9: no flush, no repair
            fio.heal()
            try:
                vdb = TideDB(fdir, explorer_config(None, device=device))
            except Exception as e:
                report["violations"].append(
                    f"seed {seed} point {p} ({style}): reopen after crash "
                    f"failed: {e!r}")
            else:
                report["violations"].extend(
                    f"seed {seed} point {p} ({style}): {v}"
                    for v in model.check(vdb))
                vdb.close()
            shutil.rmtree(fdir, ignore_errors=True)
    finally:
        if owns_base:
            shutil.rmtree(base, ignore_errors=True)
    return report


# ---------------------------------------------------------------------------
# Sharded exploration (one shard's device fails; the process survives)
# ---------------------------------------------------------------------------


class _LiveModel:
    """Exact live-process oracle for the sharded/ENOSPC explorer.

    No crash or replay happens here, so post-op state is knowable — except
    that a failed op may have raised before OR after its marker applied
    (e.g. a sync put failing at the flush stage is applied; one failing in
    ``append`` is not).  Failed writes therefore widen the key's allowed
    set instead of replacing it.
    """

    def __init__(self):
        self.allowed: Dict[Tuple[str, bytes], Set[Optional[bytes]]] = {}

    def _set(self, ks, key, state):
        self.allowed[(ks, key)] = {state}

    def _widen(self, ks, key, state):
        self.allowed.setdefault((ks, key), {None}).add(state)

    def applied(self, ks, key, state):
        self._set(ks, key, state)

    def uncertain(self, ks, key, state):
        self._widen(ks, key, state)

    def check(self, db, *, label: str = "") -> List[str]:
        out: List[str] = []
        keys = sorted(self.allowed.keys())
        for ks, key in keys:
            obs = db.get(key, keyspace=ks)
            if obs not in self.allowed[(ks, key)]:
                out.append(f"{label}illegal live state for {ks}/{key!r}: "
                           f"observed {_describe(obs)}")
        # Cross-shard batched reads must agree with the scalar path even
        # with a degraded shard in the fan-out.
        by_ks: Dict[str, List[bytes]] = {}
        for ks, key in keys:
            by_ks.setdefault(ks, []).append(key)
        for ks, kk in by_ks.items():
            got = db.multi_get(kk, keyspace=ks)
            for key, obs in zip(kk, got):
                if obs not in self.allowed[(ks, key)]:
                    out.append(f"{label}multi_get disagrees for "
                               f"{ks}/{key!r}: {_describe(obs)}")
        return out


# A failed write on the sharded/ENOSPC path surfaces as OSError (the device
# said no mid-op) or DegradedError (the shard refused at the gate).
_SHARD_WRITE_ERRORS = (OSError, DegradedError)


def _sharded_apply(sdb: ShardedTideDB, model: _LiveModel,
                   op: TraceOp) -> None:
    """Apply one trace op to the sharded store, splitting multi-key writes
    per shard IN THE HARNESS so sub-batch success is attributed exactly (the
    engine's pool fan-out completes healthy-shard futures even when the
    dead shard's sub-batch raises, but the harness could not then know which
    writes landed while one was still in flight)."""
    if op.kind == "put":
        key, value = op.items[0]
        try:
            sdb.put(key, value, keyspace=op.ks, opts=WriteOptions(
                epoch=op.epoch, durability="sync" if op.sync else "async"))
            model.applied(op.ks, key, value)
        except _SHARD_WRITE_ERRORS:
            model.uncertain(op.ks, key, value)
    elif op.kind == "delete":
        (key,) = op.items
        try:
            sdb.delete(key, keyspace=op.ks, epoch=op.epoch)
            model.applied(op.ks, key, None)
        except _SHARD_WRITE_ERRORS:
            model.uncertain(op.ks, key, None)
    elif op.kind in ("put_many", "write_batch"):
        if op.kind == "put_many":
            groups: Dict[int, list] = {}
            for key, value in op.items:
                groups.setdefault(sdb.shard_of(key), []).append((key, value))
            for sid in sorted(groups):
                try:
                    sdb.shards[sid].put_many(groups[sid], keyspace=op.ks,
                                             epoch=op.epoch)
                    for key, value in groups[sid]:
                        model.applied(op.ks, key, value)
                except _SHARD_WRITE_ERRORS:
                    for key, value in groups[sid]:
                        model.uncertain(op.ks, key, value)
        else:
            groups = {}
            for o in op.batch:
                groups.setdefault(sdb.shard_of(o[2]), []).append(o)
            for sid in sorted(groups):
                wb = WriteBatch()
                for o in groups[sid]:
                    if o[0] == "put":
                        wb.put(o[2], o[3], keyspace=o[1])
                    else:
                        wb.delete(o[2], keyspace=o[1])
                try:
                    sdb.shards[sid].write_batch(wb, epoch=op.epoch)
                    for o in groups[sid]:
                        model.applied(o[1], o[2],
                                      o[3] if o[0] == "put" else None)
                except _SHARD_WRITE_ERRORS:
                    for o in groups[sid]:
                        model.uncertain(o[1], o[2],
                                        o[3] if o[0] == "put" else None)
    elif op.kind == "flush":
        for sh in sdb.shards:
            try:
                sh.flush()
            except _SHARD_WRITE_ERRORS:
                pass                        # dead shard; acks are moot live
    elif op.kind == "prune_step":
        try:
            sdb.prune_step()
        except _SHARD_WRITE_ERRORS:
            pass
    elif op.kind == "scrub_step":
        sdb.scrub_step()
    else:
        raise ValueError(f"unknown trace op {op.kind!r}")


def explore_sharded_trace(seed: int, *, n_shards: int = 3, n_ops: int = 12,
                          n_keys: int = 12,
                          base_dir: Optional[str] = None,
                          max_points: Optional[int] = None,
                          device: str = "cuda") -> dict:
    """ENOSPC-at-every-point exploration of a sharded store.

    Shard 0 runs on a ``CrashPointIo`` (via ``shard_ios``); every other
    shard has healthy I/O.  For each fault point shard 0's device fills at
    exactly that call; the trace runs to completion (``DegradedError`` /
    ENOSPC on dead-shard writes, siblings unaffected), then the harness
    checks: every key reads back a legal live state (scalar and cross-shard
    ``multi_get``), at most shard 0 is degraded, a healthy-shard write
    still lands — and ``try_recover`` refuses while the device is full
    (odd points) and exits degraded mode once it heals (all points).
    """
    trace = generate_trace(seed, n_ops=n_ops, n_keys=n_keys)
    base = base_dir or tempfile.mkdtemp(prefix=f"tide-shexplore-{seed}-")
    owns_base = base_dir is None
    report = {"seed": seed, "ops": len(trace), "fault_points": 0,
              "forks": 0, "violations": [], "degraded_forks": 0,
              "recovered": 0, "stayed_degraded": 0, "fork_points": []}

    def _build(path, io0):
        return ShardedTideDB(path, explorer_config(None, device=device),
                             n_shards=n_shards,
                             shard_ios=[io0] + [None] * (n_shards - 1))

    def _key_on_shard(start: int, want: int) -> bytes:
        # shard_of is crc32-based and config-independent: (crc32 * n) >> 32.
        return next(key_of(start + j) for j in range(256)
                    if (zlib.crc32(key_of(start + j)) * n_shards) >> 32
                    == want)

    # A key guaranteed to live on a healthy shard (siblings-serve probe).
    probe_key = _key_on_shard(10_000, 1 % n_shards)
    try:
        dio = CrashPointIo(seed=seed)
        ddir = os.path.join(base, "discover")
        sdb = _build(ddir, dio)
        dio.arm(None)
        dmodel = _LiveModel()
        for op in trace:
            _sharded_apply(sdb, dmodel, op)
        n_points = dio.calls
        dio.disarm()
        sdb.close()
        shutil.rmtree(ddir)
        report["fault_points"] = n_points

        points = range(n_points) if max_points is None \
            else range(0, n_points, max(1, n_points // max_points))
        for p in points:
            fdir = os.path.join(base, f"fork-{p:05d}")
            fio = CrashPointIo(seed=seed * 1_000_003 + p)
            fsdb = _build(fdir, fio)
            fio.arm(p, "enospc")
            model = _LiveModel()
            for op in trace:
                _sharded_apply(fsdb, model, op)
            report["forks"] += 1
            report["fork_points"].append(fio.crashed_at)

            def note(v):
                report["violations"].append(f"seed {seed} point {p}: {v}")

            stats = fsdb.stats()
            if stats["degraded_shards"] > 1 or (
                    fsdb.shards[0].health == "ok"
                    and stats["degraded_shards"] != 0):
                note(f"degraded_shards={stats['degraded_shards']} with only "
                     f"shard 0 faulted")
            for v in model.check(fsdb):
                note(v)
            # Siblings must keep accepting writes while shard 0 is down.
            fsdb.put(probe_key, b"sibling-serve-probe", keyspace="alpha")
            if fsdb.get(probe_key, keyspace="alpha") != b"sibling-serve-probe":
                note("healthy-shard write did not land")

            degraded = fsdb.shards[0].degraded
            if degraded:
                report["degraded_forks"] += 1
                if p % 2 == 1:
                    # Device still full: the re-probe must refuse to clear.
                    if fsdb.try_recover(min_retry_interval_s=0.0):
                        note("try_recover cleared degraded mode on a "
                             "still-failing device")
                    elif fsdb.shards[0].degraded:
                        report["stayed_degraded"] += 1
                    else:
                        note("try_recover returned False but cleared the "
                             "degraded flag")
                fio.heal()
                if not fsdb.try_recover(min_retry_interval_s=0.0):
                    note("try_recover failed after the device healed")
                elif fsdb.shards[0].degraded:
                    note("try_recover returned True but shard 0 is still "
                         "degraded")
                else:
                    report["recovered"] += 1
                    # The write surface must be open again, no reopen.
                    k0 = _key_on_shard(20_000, 0)
                    fsdb.put(k0, b"post-recover-probe", keyspace="alpha")
                    if fsdb.get(k0, keyspace="alpha") != b"post-recover-probe":
                        note("post-recover write did not land")
            else:
                fio.heal()
            fsdb.close()
            shutil.rmtree(fdir, ignore_errors=True)
    finally:
        if owns_base:
            shutil.rmtree(base, ignore_errors=True)
    return report


# ---------------------------------------------------------------------------
# Replicated repair/resync exploration (crash DURING the self-healing loop)
# ---------------------------------------------------------------------------

# The repair trace runs on a fixed 2-shard / replication=2 store: every key
# lives on both shards, shard 0 carries the fault schedule, shard 1 stays
# healthy — so any single fault leaves one readable copy of everything.
REPAIR_TRACE_SHARDS = 2


def generate_repair_trace(seed: int, *, n_keys: int = 8) -> list:
    """Scripted replicated-store workload exercising the whole self-healing
    loop, as ``TraceOp``s.  Beyond the base write kinds it uses:

    - ``reads``: live legality check (scalar + ``multi_get`` parity) for
      every (ks, key) in ``items`` — the zero-reads-lost probe.
    - ``plant``: flip one VALUE byte of each ``items`` key's record on
      shard 0's WAL (harness-side ``os.pwrite``, invisible to the fault
      schedule), then drop caches.
    - ``scrub`` / ``repair``: one full detection pass / one full
      ``RepairController`` pass.  After an uncrashed repair the harness
      additionally direct-reads shard 0 with failover disabled and asserts
      the quarantine drained.
    - ``degrade`` / ``recover``: force shard 0 degraded (writes shed to
      resync debt), then ``try_recover`` + anti-entropy resync.

    The script's phases are ordered so a fault point can land inside
    foreground writes, failover reads, scrub, repair, degraded serving,
    resync, or the final ack — ``explore_repair_trace`` records the
    repair/resync fault-point spans so coverage is checkable.
    """
    rng = random.Random(seed)
    prim0: List[bytes] = []            # keys whose primary is shard 0
    prim1: List[bytes] = []
    want1 = max(2, n_keys // 2)
    i = 0
    while len(prim0) < n_keys or len(prim1) < want1:
        k = key_of(i)
        if (zlib.crc32(k) * REPAIR_TRACE_SHARDS) >> 32 == 0:
            if len(prim0) < n_keys:
                prim0.append(k)
        elif len(prim1) < want1:
            prim1.append(k)
        i += 1
    versions: Dict[bytes, int] = {}

    def fresh(key: bytes) -> bytes:
        v = versions.get(key, 0) + 1
        versions[key] = v
        return _value(rng, seed, key, v)

    every = (tuple(("alpha", k) for k in prim0)
             + tuple(("beta", k) for k in prim1))
    return [
        TraceOp("put_many", "alpha",
                items=tuple((k, fresh(k)) for k in prim0)),
        TraceOp("put_many", "beta",
                items=tuple((k, fresh(k)) for k in prim1)),
        # Single-primary batch: replicated write_batch keeps atomicity per
        # shard per copy, so keys sharing a primary stay torn-proof even
        # when post-crash reads resolve through that one primary.
        TraceOp("write_batch", "alpha",
                batch=tuple(("put", "alpha", k, fresh(k))
                            for k in prim0[-2:])),
        TraceOp("flush"),                      # ack: everything above
        TraceOp("reads", items=every),
        TraceOp("plant", "alpha", items=tuple(prim0[:3])),
        TraceOp("reads", items=every),         # failover window: zero lost
        TraceOp("scrub"),
        TraceOp("repair"),
        TraceOp("reads", items=every),
        TraceOp("degrade"),
        TraceOp("put_many", "alpha",           # shed on shard 0 → debt
                items=tuple((k, fresh(k)) for k in prim0[:4])),
        TraceOp("put", "beta", items=((prim1[0], fresh(prim1[0])),)),
        TraceOp("reads", items=every),         # degraded window
        TraceOp("recover"),                    # try_recover + resync
        TraceOp("reads", items=every),
        TraceOp("flush"),                      # ack: resynced writes too
    ]


def _run_repair_trace(sdb: ShardedTideDB, trace: Sequence[TraceOp],
                      model: ShadowModel,
                      io: Optional[CrashPointIo],
                      spans: Optional[dict] = None) -> dict:
    """Drive one repair trace end to end.  The script NEVER aborts on a
    crash: the fault kills shard 0's device only, and the replicated store
    is supposed to keep serving — post-fault ops continue, with shard-0
    failures shed/failed-over and acks suppressed (a flush that cannot
    reach shard 0 guarantees nothing about it).  Returns
    ``{"violations", "lost_reads"}``."""
    violations: List[str] = []
    lost_reads = 0
    planted = [(op.ks, k) for op in trace if op.kind == "plant"
               for k in op.items]

    def crashed() -> bool:
        return io is not None and io.crashed_at is not None

    for i, op in enumerate(trace):
        calls_before = io.calls if io is not None else 0
        try:
            if op.kind == "put":
                key, value = op.items[0]
                model.apply_put(op.ks, key, value)
                sdb.put(key, value, keyspace=op.ks, opts=WriteOptions(
                    epoch=op.epoch,
                    durability="sync" if op.sync else "async"))
                if op.sync and not crashed():
                    model.ack()
            elif op.kind == "put_many":
                for key, value in op.items:
                    model.apply_put(op.ks, key, value)
                sdb.put_many(list(op.items), keyspace=op.ks, epoch=op.epoch)
            elif op.kind == "write_batch":
                model.apply_batch(op.batch)
                wb = WriteBatch()
                for o in op.batch:
                    if o[0] == "put":
                        wb.put(o[2], o[3], keyspace=o[1])
                    else:
                        wb.delete(o[2], keyspace=o[1])
                sdb.write_batch(wb, epoch=op.epoch)
            elif op.kind == "flush":
                sdb.flush()
                if not crashed():
                    model.ack()
            elif op.kind == "reads":
                lost_reads += _repair_reads_check(sdb, model, op, i,
                                                  crashed, violations)
            elif op.kind == "plant":
                _plant_corruption(sdb, op)
            elif op.kind == "scrub":
                sdb.scrub()
            elif op.kind == "repair":
                sdb.repair()
                if not crashed():
                    _check_repaired_shard(sdb, model, planted, i,
                                          violations)
            elif op.kind == "degrade":
                sdb.shards[0]._enter_degraded(
                    "repair trace: forced outage")
            elif op.kind == "recover":
                ok = sdb.try_recover(min_retry_interval_s=0.0)
                if not crashed():
                    if not ok:
                        violations.append(
                            f"op {i}: try_recover failed on a healthy "
                            f"device")
                    elif sdb.stats()["resync_backlog"]:
                        violations.append(
                            f"op {i}: resync left backlog "
                            f"{sdb.stats()['resync_backlog']}")
            else:
                raise ValueError(f"unknown repair-trace op {op.kind!r}")
        except SimulatedCrash:
            pass          # shard 0's device died mid-op; the store lives on
        except Exception as e:
            if not crashed():
                violations.append(
                    f"op {i} ({op.kind}) failed without a crash: {e!r}")
        if spans is not None and io is not None \
                and op.kind in ("repair", "recover"):
            spans[op.kind] = (calls_before, io.calls)
    return {"violations": violations, "lost_reads": lost_reads}


def _repair_reads_check(sdb, model, op, i, crashed, violations) -> int:
    """Scalar + batched legality for every (ks, key): no read may raise,
    and every observation must be in the oracle's legal set.  Reads that
    raise after the device died are counted, not flagged (the post-reopen
    oracle judges final state)."""
    lost = 0
    by_ks: Dict[str, List[bytes]] = {}
    for ks, key in op.items:
        by_ks.setdefault(ks, []).append(key)
        try:
            obs = sdb.get(key, keyspace=ks)
        except Exception as e:
            if crashed():
                lost += 1
                continue
            violations.append(f"op {i}: get({ks}/{key!r}) raised {e!r}")
            continue
        if obs not in model.legal_states(ks, key):
            violations.append(
                f"op {i}: illegal read {ks}/{key!r}: {_describe(obs)}")
    for ks, kk in by_ks.items():
        try:
            got = sdb.multi_get(kk, keyspace=ks)
        except Exception as e:
            if crashed():
                lost += len(kk)
                continue
            violations.append(f"op {i}: multi_get({ks}) raised {e!r}")
            continue
        for key, obs in zip(kk, got):
            if obs not in model.legal_states(ks, key):
                violations.append(
                    f"op {i}: multi_get disagrees for {ks}/{key!r}: "
                    f"{_describe(obs)}")
    return lost


def _plant_corruption(sdb: ShardedTideDB, op: TraceOp) -> None:
    """Flip one VALUE byte of each key's record on shard 0, bypassing the
    fault schedule (``os.pwrite`` on the raw fd — latent disk rot, not an
    injected fault).  Value region only: the entry header and key bytes
    stay intact, so crash replay and repair identification both see the
    true key."""
    sh = sdb.shards[0]
    ks_id = sh._ks_id(op.ks)
    seg_size = sh.value_wal.cfg.segment_size
    for key in op.items:
        pos = sh.table.get_position(ks_id, key)
        if pos is None:
            continue      # never landed on shard 0 (early-crash forks)
        fd = sh.value_wal._fd(pos // seg_size)
        off = (pos % seg_size + HEADER_SIZE + _ENTRY_HDR.size
               + len(key) + 1)
        cur = os.pread(fd, 1, off)
        if cur:
            os.pwrite(fd, bytes((cur[0] ^ 0x5A,)), off)
    sdb.clear_caches()


def _check_repaired_shard(sdb, model, planted, i, violations) -> None:
    """After an uncrashed repair pass: shard 0 must serve every planted key
    by itself (failover disabled via a direct shard read) and its
    quarantine must be empty."""
    if sdb.shards[0].value_wal.quarantined():
        violations.append(
            f"op {i}: quarantine not drained by repair: "
            f"{sorted(sdb.shards[0].value_wal.quarantined())}")
    strict = ReadOptions(strict_errors=True, fill_cache=False)
    for ks, key in planted:
        try:
            obs = sdb.shards[0].get(key, keyspace=ks, opts=strict)
        except Exception as e:
            violations.append(
                f"op {i}: shard-0 read after repair raised {e!r} "
                f"for {ks}/{key!r}")
            continue
        if obs not in model.legal_states(ks, key):
            violations.append(
                f"op {i}: shard-0 state after repair illegal for "
                f"{ks}/{key!r}: {_describe(obs)}")


def explore_repair_trace(seed: int, *, n_keys: int = 8,
                         base_dir: Optional[str] = None,
                         styles: Sequence[str] = CRASH_STYLES,
                         max_points: Optional[int] = None,
                         device: str = "cuda") -> dict:
    """Crash-at-every-point exploration of the replicated self-healing
    loop (2 shards, replication=2, shard 0 faulted).

    Discovery runs ``generate_repair_trace`` clean and records the
    fault-point spans of the repair and resync phases
    (``phase_spans["repair"]`` / ``phase_spans["recover"]``) — a meta-check
    that both phases actually perform injectable I/O, so forks genuinely
    crash *inside* repair and resync.  Each fork crashes shard 0 at one
    point (styles alternate), runs the script to completion on the
    surviving replica, then simulates whole-machine death: ``crash()``,
    heal, reopen replicated, ``scrub()`` + ``repair()``, and checks every
    key against the ``ShadowModel`` — both before and after the post-crash
    repair round, so repair can never "fix" a store into an illegal state.
    """
    trace = generate_repair_trace(seed, n_keys=n_keys)
    base = base_dir or tempfile.mkdtemp(prefix=f"tide-rexplore-{seed}-")
    owns_base = base_dir is None
    report = {"seed": seed, "ops": len(trace), "fault_points": 0,
              "forks": 0, "style_counts": {}, "violations": [],
              "fork_points": [], "phase_spans": {}, "lost_reads": 0}

    def _build(path, io0):
        return ShardedTideDB(path, explorer_config(None, device=device),
                             n_shards=REPAIR_TRACE_SHARDS, replication=2,
                             shard_ios=[io0, None])

    try:
        # -- discovery ------------------------------------------------------
        dio = CrashPointIo(seed=seed)
        ddir = os.path.join(base, "discover")
        sdb = _build(ddir, dio)
        dio.arm(None)
        spans: dict = {}
        res = _run_repair_trace(sdb, trace, ShadowModel(), dio, spans=spans)
        if res["violations"]:
            raise AssertionError(
                "repair-trace discovery run violated the oracle: "
                + "; ".join(res["violations"][:3]))
        n_points = dio.calls
        dio.disarm()
        sdb.close()
        shutil.rmtree(ddir)
        report["fault_points"] = n_points
        report["phase_spans"] = {k: list(v) for k, v in spans.items()}

        # -- forks ----------------------------------------------------------
        points = range(n_points) if max_points is None \
            else range(0, n_points, max(1, n_points // max_points))
        for p in points:
            style = styles[p % len(styles)]
            report["style_counts"][style] = \
                report["style_counts"].get(style, 0) + 1
            fdir = os.path.join(base, f"fork-{p:05d}")
            fio = CrashPointIo(seed=seed * 1_000_003 + p)
            fsdb = _build(fdir, fio)
            fio.arm(p, style)
            model = ShadowModel()
            res = _run_repair_trace(fsdb, trace, model, fio)
            report["forks"] += 1
            report["fork_points"].append(fio.crashed_at)
            report["lost_reads"] += res["lost_reads"]
            report["violations"].extend(
                f"seed {seed} point {p} ({style}): {v}"
                for v in res["violations"])
            fsdb.crash()                    # now the whole machine dies
            fio.heal()
            try:
                vdb = _build(fdir, None)
            except Exception as e:
                report["violations"].append(
                    f"seed {seed} point {p} ({style}): reopen after crash "
                    f"failed: {e!r}")
            else:
                vs = model.check(vdb, label="post-crash ")
                try:
                    vdb.scrub()
                    vdb.repair()
                except Exception as e:
                    vs.append(f"post-crash scrub/repair raised {e!r}")
                vs.extend(model.check(vdb, label="post-repair "))
                report["violations"].extend(
                    f"seed {seed} point {p} ({style}): {v}" for v in vs)
                vdb.close()
            shutil.rmtree(fdir, ignore_errors=True)
    finally:
        if owns_base:
            shutil.rmtree(base, ignore_errors=True)
    return report
