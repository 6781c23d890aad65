"""Fault-injection I/O seam and the store-wide failure taxonomy.

Tidehunter's WAL *is* the permanent store (paper §3.1): values are never
rewritten, so an undetected I/O fault is permanent data loss rather than a
recoverable cache miss.  This module gives every durability claim in the
codebase a way to be tested under hostile I/O:

- ``IoBackend``: a seam wrapping every os-level call the store makes
  (``open``/``pread``/``pwrite``/``pwritev``/``fsync``/``ftruncate``).
  Production uses the passthrough ``DEFAULT_IO``; tests plug in ``FaultyIo``.
- ``FaultyIo``: deterministic, seed-driven injection of EIO / ENOSPC /
  short writes / torn writes / latency at chosen call sites and counts.
- The typed error taxonomy used by the read path, the scrubber, and the
  degraded-mode machinery (``CorruptionError``, ``TornRecordError``,
  ``WalHoleError``, ``UnrepairedHoleError``, ``DegradedError``,
  ``KeyWidthError``).
"""
from __future__ import annotations

import errno
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Error taxonomy
# ---------------------------------------------------------------------------


class WalReadError(KeyError):
    """A WAL position could not be returned as a verified record.

    Subclasses ``KeyError`` so existing retry loops (``db.get`` re-resolving a
    relocated position, batch readers falling back to scalar reads) keep
    working unchanged while callers that care can catch the typed subclass.
    """

    def __init__(self, msg: str, pos: Optional[int] = None):
        super().__init__(msg)
        self.pos = pos

    def __str__(self) -> str:  # KeyError.__str__ repr-quotes; keep it readable
        return self.args[0] if self.args else ""


class CorruptionError(WalReadError):
    """Stored payload bytes fail their CRC — latent corruption."""


class TornRecordError(WalReadError):
    """Record header promises more payload bytes than the WAL holds."""


class WalHoleError(WalReadError):
    """Position falls in a dropped/unreadable region of the WAL."""


class UnrepairedHoleError(OSError):
    """Poison-header repair failed: durability cannot be acknowledged.

    Raised out of ``Wal.flush`` when a failed copy's record header could not
    be rewritten as a torn marker.  Treated as unrecoverable by ``TideDB``
    (transitions the store to degraded mode).
    """


class DegradedError(RuntimeError):
    """The store is in read-only degraded mode; writes are refused."""

    def __init__(self, reason: str):
        super().__init__(f"store is degraded (read-only): {reason}")
        self.reason = reason


class KeyWidthError(ValueError):
    """A write-path key does not match the keyspace's fixed ``key_len``."""


# ---------------------------------------------------------------------------
# I/O backend seam
# ---------------------------------------------------------------------------


class IoBackend:
    """Passthrough backend: every call maps 1:1 onto the ``os`` module."""

    have_pwritev: bool = hasattr(os, "pwritev")

    def open(self, path: str, flags: int, mode: int = 0o644) -> int:
        return os.open(path, flags, mode)

    def pread(self, fd: int, n: int, off: int) -> bytes:
        return os.pread(fd, n, off)

    def pwrite(self, fd: int, data, off: int) -> int:
        return os.pwrite(fd, data, off)

    def pwritev(self, fd: int, bufs: Sequence, off: int) -> int:
        return os.pwritev(fd, bufs, off)

    def fsync(self, fd: int) -> None:
        os.fsync(fd)

    def ftruncate(self, fd: int, length: int) -> None:
        os.ftruncate(fd, length)


DEFAULT_IO = IoBackend()

# Injectable operations and fault kinds, for schedule generators.
FAULT_OPS = ("open", "pread", "pwrite", "pwritev", "fsync", "ftruncate")
FAULT_KINDS = ("eio", "enospc", "short", "torn", "latency")

_ERRNO_OF = {"eio": errno.EIO, "enospc": errno.ENOSPC}


@dataclass
class FaultRule:
    """Inject ``kind`` into calls ``after <= nth < after + count`` of ``op``.

    ``op`` is one of ``FAULT_OPS`` or ``"*"``; ``count=None`` means the rule
    never exhausts (e.g. a persistently full disk).  ``nth`` counts calls of
    that op on the ``FaultyIo`` instance, starting at 0.
    """

    op: str
    kind: str
    after: int = 0
    count: Optional[int] = 1
    latency_s: float = 0.001

    def __post_init__(self):
        if self.op != "*" and self.op not in FAULT_OPS:
            raise ValueError(f"unknown fault op {self.op!r}")
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")


class FaultyIo(IoBackend):
    """Deterministic fault-injecting backend.

    Wraps ``inner`` (default: the real os-backed ``DEFAULT_IO``) and applies
    ``FaultRule``s keyed on per-op call counters, so a given (rules, seed,
    call sequence) triple always produces the same faults.  Under a
    multi-threaded copy pool the call *order* is scheduler-dependent; fuzz
    harnesses that need strict determinism use ``copy_threads=1``.

    Fault semantics per op:
    - ``eio`` / ``enospc``: raise ``OSError`` before any bytes move.
    - ``short``: writes land a prefix and report it (legal short write);
      reads return a prefix of the real data.
    - ``torn``: writes land a prefix, then raise EIO — bytes are on disk but
      the caller sees failure; reads behave like ``short``.
    - ``latency``: sleep ``latency_s`` then pass through.
    """

    def __init__(self, rules: Sequence[FaultRule] = (), seed: int = 0,
                 inner: Optional[IoBackend] = None):
        self.inner = inner or DEFAULT_IO
        self.have_pwritev = self.inner.have_pwritev
        self.rules: List[FaultRule] = list(rules)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.calls: Dict[str, int] = {op: 0 for op in FAULT_OPS}
        self.injected: List[Tuple[str, int, str]] = []  # (op, nth, kind)

    # -- bookkeeping --------------------------------------------------------

    def _arm(self, op: str) -> Optional[FaultRule]:
        """Count one call of ``op``; return the rule firing on it, if any."""
        with self._lock:
            nth = self.calls[op]
            self.calls[op] = nth + 1
            for rule in self.rules:
                if rule.op != "*" and rule.op != op:
                    continue
                if nth < rule.after:
                    continue
                if rule.count is not None and nth >= rule.after + rule.count:
                    continue
                self.injected.append((op, nth, rule.kind))
                return rule
        return None

    def _prefix_len(self, total: int) -> int:
        with self._lock:
            return self._rng.randrange(total) if total > 0 else 0

    def injected_counts(self) -> Dict[str, int]:
        with self._lock:
            out: Dict[str, int] = {}
            for _op, _nth, kind in self.injected:
                out[kind] = out.get(kind, 0) + 1
            return out

    def snapshot(self) -> Dict[str, object]:
        """Consistent view of the per-op call counters and the injected
        log, for per-fork coverage accounting (explorer harnesses)."""
        with self._lock:
            return {"calls": dict(self.calls),
                    "injected": list(self.injected)}

    def reset(self, seed: Optional[int] = None) -> Dict[str, object]:
        """Zero the call counters and the injected log, returning the final
        pre-reset snapshot.

        A ``FaultyIo`` reused across explorer forks otherwise accumulates
        counts forever (rules keyed on call counters would also never fire
        again), so per-fork coverage accounting was inexact.  Passing
        ``seed`` re-arms the prefix RNG too, making the next fork's
        short/torn prefixes reproduce exactly.
        """
        with self._lock:
            out = {"calls": dict(self.calls),
                   "injected": list(self.injected)}
            self.calls = {op: 0 for op in FAULT_OPS}
            self.injected = []
            if seed is not None:
                self._rng = random.Random(seed)
            return out

    # -- faulted ops --------------------------------------------------------

    def open(self, path: str, flags: int, mode: int = 0o644) -> int:
        rule = self._arm("open")
        if rule is not None:
            if rule.kind == "latency":
                time.sleep(rule.latency_s)
            else:
                raise OSError(_ERRNO_OF.get(rule.kind, errno.EIO),
                              f"injected {rule.kind}", path)
        return self.inner.open(path, flags, mode)

    def ftruncate(self, fd: int, length: int) -> None:
        rule = self._arm("ftruncate")
        if rule is not None:
            if rule.kind == "latency":
                time.sleep(rule.latency_s)
            else:
                raise OSError(_ERRNO_OF.get(rule.kind, errno.EIO),
                              f"injected {rule.kind}")
        self.inner.ftruncate(fd, length)

    def fsync(self, fd: int) -> None:
        rule = self._arm("fsync")
        if rule is not None:
            if rule.kind == "latency":
                time.sleep(rule.latency_s)
            else:
                raise OSError(_ERRNO_OF.get(rule.kind, errno.EIO),
                              f"injected {rule.kind}")
        self.inner.fsync(fd)

    def pread(self, fd: int, n: int, off: int) -> bytes:
        rule = self._arm("pread")
        if rule is None:
            return self.inner.pread(fd, n, off)
        if rule.kind == "latency":
            time.sleep(rule.latency_s)
            return self.inner.pread(fd, n, off)
        if rule.kind in ("short", "torn"):
            data = self.inner.pread(fd, n, off)
            return data[: self._prefix_len(len(data))]
        raise OSError(_ERRNO_OF[rule.kind], f"injected {rule.kind}")

    def pwrite(self, fd: int, data, off: int) -> int:
        rule = self._arm("pwrite")
        if rule is None:
            return self.inner.pwrite(fd, data, off)
        if rule.kind == "latency":
            time.sleep(rule.latency_s)
            return self.inner.pwrite(fd, data, off)
        buf = bytes(data)
        if rule.kind == "short":
            n = self._prefix_len(len(buf))
            if n:
                self.inner.pwrite(fd, buf[:n], off)
            return n
        if rule.kind == "torn":
            n = self._prefix_len(len(buf))
            if n:
                self.inner.pwrite(fd, buf[:n], off)
            raise OSError(errno.EIO, "injected torn write")
        raise OSError(_ERRNO_OF[rule.kind], f"injected {rule.kind}")

    def pwritev(self, fd: int, bufs: Sequence, off: int) -> int:
        rule = self._arm("pwritev")
        if rule is None:
            return self.inner.pwritev(fd, bufs, off)
        if rule.kind == "latency":
            time.sleep(rule.latency_s)
            return self.inner.pwritev(fd, bufs, off)
        flat = b"".join(bytes(b) for b in bufs)
        if rule.kind == "short":
            n = self._prefix_len(len(flat))
            if n:
                self.inner.pwrite(fd, flat[:n], off)
            return n
        if rule.kind == "torn":
            n = self._prefix_len(len(flat))
            if n:
                self.inner.pwrite(fd, flat[:n], off)
            raise OSError(errno.EIO, "injected torn write")
        raise OSError(_ERRNO_OF[rule.kind], f"injected {rule.kind}")


def random_schedule(seed: int, *, ops: Sequence[str] = ("pwrite", "pwritev", "fsync"),
                    kinds: Sequence[str] = FAULT_KINDS,
                    max_rules: int = 3, max_after: int = 48,
                    max_count: int = 3) -> List[FaultRule]:
    """Deterministic random fault schedule for the fuzz tier.

    Returns 1..max_rules rules over the given ops/kinds with small counts, so
    most schedules are survivable and exercise recovery rather than only the
    terminal failure paths.
    """
    rng = random.Random(seed)
    rules = []
    for _ in range(rng.randint(1, max_rules)):
        rules.append(FaultRule(
            op=rng.choice(list(ops)),
            kind=rng.choice(list(kinds)),
            after=rng.randrange(max_after),
            count=rng.randint(1, max_count),
            latency_s=0.0005,
        ))
    return rules
