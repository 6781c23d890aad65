"""Leveled-LSM baseline (the paper's RocksDB / BlobDB comparison targets),
the JAX package's ``core/lsm_baseline.py`` on the port's Bloom filter and
counters.  Host-only: no tensor, no kernel.

A deliberately conventional engine, used to measure the paper's ratios
(write amplification, point-read and existence rates) against the same
API as ``TideDB``:

- memtable (dict) → sorted-run files in levels, L0 allows overlap;
- size-tiered compaction with a 10× level ratio: when a level exceeds its
  budget, all its runs merge into the next level (every byte is rewritten —
  this is precisely the write amplification Tidehunter eliminates);
- per-run Bloom filters and binary search over sorted fixed-size entries;
- ``blob_mode=True`` gives the WiscKey/BlobDB variant: values go to an
  append-only vlog, the LSM stores (key → vlog position) only.

The files are the reference's, byte for byte: ``run-%08d.sst`` (an
``<IIQ`` header of count, key and value width, then fixed-size records of
key, u64 meta and value) and ``vlog`` (u32 length, then the value), and
so are the write counters.  One deliberate difference (ROADMAP C.13):
records are read back as the raw bytes of their fixed-width fields.  The
reference reads them through numpy ``S{n}`` fields, which drop trailing
NUL bytes: a value ending in NUL comes back short, a key ending in NUL is
not found in a run, and every BlobDB pointer (``<QI``, whose length's high
bytes are NUL) comes back short of 12 bytes (10 at 1 KiB values) and is
returned unresolved.  Here
each read returns what was written, and BlobDB reads go through the vlog
(so ``bytes_read_disk`` counts them).
"""
from __future__ import annotations

import os
import struct
import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np

from .tidestore.bloom import BloomFilter
from .tidestore.util import Metrics

_RUN_HDR = struct.Struct("<IIQ")   # count, key_len, value_len (fixed sizes)
_META = struct.Struct("<Q")


@dataclass
class LsmConfig:
    key_len: int = 32
    memtable_entries: int = 64 * 1024
    level_ratio: int = 10
    l0_runs: int = 4
    blob_mode: bool = False                 # WiscKey/BlobDB value separation
    blob_threshold: int = 0                 # values >= this go to the vlog
    compaction: bool = True


class _Run:
    """One immutable sorted run with fixed-size entries."""

    def __init__(self, path: str, count: int, key_len: int, value_len: int):
        self.path = path
        self.count = count
        self.key_len = key_len
        self.value_len = value_len
        self.entry = key_len + 8 + value_len  # key, meta(u64 len/flag), value
        self.bloom: Optional[BloomFilter] = None
        self._fd = os.open(path, os.O_RDONLY)

    def _split(self, buf: bytes, i: int) -> tuple[bytes, int, bytes]:
        """Record ``i`` of ``buf`` → (key, meta, value), each field whole."""
        at, kl = i * self.entry, self.key_len
        return (buf[at:at + kl], _META.unpack_from(buf, at + kl)[0],
                buf[at + kl + 8:at + self.entry])

    def records(self) -> tuple[list[tuple[bytes, int, bytes]], int]:
        """Every record in key order, and the bytes read."""
        buf = os.pread(self._fd, self.count * self.entry, _RUN_HDR.size)
        return [self._split(buf, i) for i in range(self.count)], len(buf)

    def get(self, key: bytes, metrics: Metrics) -> Optional[tuple[int, bytes]]:
        if self.bloom is not None and not self.bloom.might_contain(key):
            return None
        lo, hi = 0, self.count
        while lo < hi:                       # binary search over pread blocks
            mid = (lo + hi) // 2
            buf = os.pread(self._fd, self.entry, _RUN_HDR.size + mid * self.entry)
            metrics.add(bytes_read_disk=len(buf))
            k, meta, value = self._split(buf, 0)
            if k == key:
                return meta, value
            if k < key:
                lo = mid + 1
            else:
                hi = mid
        return None

    def close(self) -> None:
        os.close(self._fd)
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass


_TOMB = 1 << 63


class LsmBaseline:
    """Minimal leveled LSM with honest write-amplification accounting."""

    def __init__(self, path: str, config: Optional[LsmConfig] = None):
        self.path = path
        self.cfg = config or LsmConfig()
        os.makedirs(path, exist_ok=True)
        self.metrics = Metrics()
        self._lock = threading.Lock()
        self.memtable: dict[bytes, Optional[bytes]] = {}
        self.levels: list[list[_Run]] = [[]]
        self._run_seq = 0
        self._value_len: Optional[int] = None
        self._vlog_fd: Optional[int] = None
        self._vlog_tail = 0
        if self.cfg.blob_mode:
            self._vlog_fd = os.open(os.path.join(path, "vlog"),
                                    os.O_RDWR | os.O_CREAT, 0o644)

    # --------------------------------------------------------------- writes
    def put(self, key: bytes, value: bytes, **_) -> None:
        with self._lock:
            if self.cfg.blob_mode and len(value) >= self.cfg.blob_threshold:
                off = self._vlog_tail
                blob = struct.pack("<I", len(value)) + value
                os.pwrite(self._vlog_fd, blob, off)
                self._vlog_tail += len(blob)
                self.metrics.add(bytes_written_disk=len(blob))
                stored = struct.pack("<QI", off, len(value))
            else:
                stored = value
            if self._value_len is None:
                self._value_len = len(stored)
            elif len(stored) != self._value_len:
                raise ValueError("LsmBaseline benchmarks use fixed-size values")
            self.memtable[key] = stored
            self.metrics.add(bytes_written_app=len(key) + len(value))
            if len(self.memtable) >= self.cfg.memtable_entries:
                self._flush_memtable()

    def delete(self, key: bytes, **_) -> None:
        with self._lock:
            self.metrics.add(bytes_written_app=len(key))
            self.memtable[key] = None
            if len(self.memtable) >= self.cfg.memtable_entries:
                self._flush_memtable()

    # ---------------------------------------------------------------- reads
    def get(self, key: bytes, **_) -> Optional[bytes]:
        with self._lock:
            if key in self.memtable:
                v = self.memtable[key]
                return self._resolve(v)
            for level in self.levels:
                for run in reversed(level):      # newest first
                    hit = run.get(key, self.metrics)
                    if hit is not None:
                        meta, value = hit
                        if meta & _TOMB:
                            return None
                        return self._resolve(value)
        return None

    def exists(self, key: bytes, **_) -> bool:
        # LSMs must run the same multi-level lookup for exists (§6.2).
        with self._lock:
            if key in self.memtable:
                return self.memtable[key] is not None
            for level in self.levels:
                for run in reversed(level):
                    hit = run.get(key, self.metrics)
                    if hit is not None:
                        return not bool(hit[0] & _TOMB)
        return False

    def _resolve(self, stored: Optional[bytes]) -> Optional[bytes]:
        if stored is None:
            return None
        if self.cfg.blob_mode and len(stored) == 12:
            off, vlen = struct.unpack("<QI", stored)
            blob = os.pread(self._vlog_fd, 4 + vlen, off)
            self.metrics.add(bytes_read_disk=len(blob))
            return blob[4:4 + vlen]
        return stored

    # ----------------------------------------------------------- compaction
    def _flush_memtable(self) -> None:
        if not self.memtable:
            return
        vlen = self._value_len or 0
        items = sorted(self.memtable.items())
        run = self._write_run(
            [(k, (_TOMB if v is None else 0), v or b"") for k, v in items], vlen)
        self.levels[0].append(run)
        self.memtable.clear()
        if self.cfg.compaction:
            self._maybe_compact()

    def _write_run(self, items: list[tuple[bytes, int, bytes]], vlen: int) -> _Run:
        self._run_seq += 1
        path = os.path.join(self.path, f"run-{self._run_seq:08d}.sst")
        klen = self.cfg.key_len
        # ``S{n}`` fields pad with NUL on the write, as the reference's do.
        dtype = np.dtype([("key", f"S{klen}"), ("meta", "<u8"),
                          ("value", f"S{vlen}")])
        arr = np.empty(len(items), dtype=dtype)
        arr["key"] = np.array([k for k, _, _ in items], dtype=f"S{klen}")
        arr["meta"] = np.array([m for _, m, _ in items], dtype=np.uint64)
        arr["value"] = np.array([v for _, _, v in items], dtype=f"S{vlen}")
        blob = _RUN_HDR.pack(len(items), klen, vlen) + arr.tobytes()
        with open(path, "wb") as f:
            f.write(blob)
        self.metrics.add(bytes_written_disk=len(blob))
        run = _Run(path, len(items), klen, vlen)
        run.bloom = BloomFilter(max(len(items), 64))
        run.bloom.add_many([k for k, _, _ in items])
        return run

    def _level_budget(self, level: int) -> int:
        if level == 0:
            return self.cfg.l0_runs
        return self.cfg.memtable_entries * (self.cfg.level_ratio ** level)

    def _maybe_compact(self) -> None:
        """Merge a level into the next when over budget — every record in
        both levels is read and rewritten: the source of its 10–30× write
        amplification."""
        li = 0
        while li < len(self.levels):
            level = self.levels[li]
            size = len(level) if li == 0 else sum(r.count for r in level)
            if size <= self._level_budget(li):
                li += 1
                continue
            if li + 1 >= len(self.levels):
                self.levels.append([])
            merged: dict[bytes, tuple[int, bytes]] = {}
            # Older data first (deeper level, then older runs) so that newer
            # runs overwrite on key collisions.
            for run in self.levels[li + 1] + self.levels[li]:
                records, nbytes = run.records()
                self.metrics.add(bytes_read_disk=nbytes)
                for k, m, v in records:
                    merged[k] = (m, v)
            vlen = self._value_len or 0
            items = sorted((k, m, v) for k, (m, v) in merged.items())
            is_last = li + 1 == len(self.levels) - 1
            if is_last:  # drop tombstones at the bottom level
                items = [(k, m, v) for k, m, v in items if not (m & _TOMB)]
            for run in self.levels[li] + self.levels[li + 1]:
                run.close()
            self.levels[li] = []
            self.levels[li + 1] = [self._write_run(items, vlen)] if items else []
            li += 1

    def flush(self) -> None:
        with self._lock:
            self._flush_memtable()

    def close(self) -> None:
        for level in self.levels:
            for run in level:
                try:
                    os.close(run._fd)
                except OSError:
                    pass
        if self._vlog_fd is not None:
            os.close(self._vlog_fd)

    def stats(self) -> dict:
        return self.metrics.snapshot()
