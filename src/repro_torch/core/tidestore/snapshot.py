"""Control Region snapshots (§3.3).

A snapshot stores *only positions*, never index data: for each cell the
Index Store offset of its latest flushed index and the WAL watermark it
covers, plus a global replay-from position.  Written atomically
(tmp + rename) with a CRC, so a torn snapshot write falls back to the
previous one.
"""
from __future__ import annotations

import os
import struct
import threading
import time
from typing import Optional

import msgpack

from .faults import DEFAULT_IO, IoBackend
from .large_table import CellState, LargeTable
from .util import Metrics, crc32
from .wal import Wal

CONTROL_FILE = "control.bin"
CONTROL_FALLBACK = CONTROL_FILE + ".1"
_MAGIC = b"TIDE0001"


def write_control_region(path: str, state: dict,
                         io: Optional[IoBackend] = None) -> None:
    io = io or DEFAULT_IO
    body = msgpack.packb(state, use_bin_type=True)
    blob = _MAGIC + struct.pack("<I", crc32(body)) + body
    # unique tmp name: concurrent snapshotters (background thread + an
    # explicit flush) must not clobber each other's rename source
    tmp = os.path.join(path, f"{CONTROL_FILE}.tmp.{os.getpid()}."
                             f"{threading.get_ident()}")
    fd = io.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        done = 0
        while done < len(blob):
            n = io.pwrite(fd, memoryview(blob)[done:], done)
            if n <= 0:
                raise OSError(f"control region pwrite wrote {n} bytes")
            done += n
        io.fsync(fd)
    except OSError:
        os.close(fd)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    os.close(fd)
    cur = os.path.join(path, CONTROL_FILE)
    # Rotate the previous snapshot aside before installing the new one:
    # should this write land torn (kernel crash mid-rename aside, a torn
    # file can also mean media corruption), recovery falls back to the
    # previous snapshot.  Snapshots hold only positions, so an older one
    # merely lengthens replay — it never loses acknowledged data.
    if os.path.exists(cur):
        try:
            os.replace(cur, os.path.join(path, CONTROL_FALLBACK))
        except OSError:
            pass
    os.replace(tmp, cur)


def _read_one(fn: str) -> Optional[dict]:
    if not os.path.exists(fn):
        return None
    try:
        with open(fn, "rb") as f:
            blob = f.read()
    except OSError:
        # An unreadable control file is treated exactly like a torn one:
        # fall back to the rotated previous snapshot or a full replay.
        return None
    if len(blob) < 12 or blob[:8] != _MAGIC:
        return None
    (crc,) = struct.unpack_from("<I", blob, 8)
    body = blob[12:]
    if crc32(body) != crc:
        return None
    return msgpack.unpackb(body, raw=False, strict_map_key=False)


def read_control_region(path: str) -> Optional[dict]:
    """Current control region, or the rotated previous one if the current
    file is missing/torn/corrupt (CRC gate).  ``None`` = full replay."""
    for fn in (CONTROL_FILE, CONTROL_FALLBACK):
        state = _read_one(os.path.join(path, fn))
        if state is not None:
            return state
    return None


def capture_state(table: LargeTable, value_wal: Wal, index_wal: Wal) -> dict:
    cells = []
    for ks_id, cell in table.all_cells():
        if not cell.has_disk():
            continue
        cid = cell.cell_id
        # Trailing (filter_pos, filter_len) extends the seed 6-tuple: the
        # persisted-Bloom pointer rides the same record, and recovery
        # accepts both lengths (older control regions simply rebuild
        # filters lazily).
        cells.append((ks_id, cid if isinstance(cid, int) else cid,
                      cell.disk_pos, cell.disk_len, cell.disk_count,
                      cell.flushed_upto, cell.filter_pos, cell.filter_len))
    last = value_wal.tracker.last_processed
    return {
        "replay_from": table.replay_from(last),
        "last_processed": last,
        "value_first_live": value_wal.first_live_pos,
        "index_first_live": index_wal.first_live_pos,
        "segment_epochs": {str(k): list(v)
                           for k, v in value_wal.segment_epochs().items()},
        "cells": cells,
        "time": time.time(),
    }


class SnapshotThread:
    """Background engine (§3.3): periodically flushes cells above the dirty
    threshold, persists the Control Region, and advances the Index Store GC
    watermark to the oldest still-referenced index blob."""

    def __init__(self, db, interval_s: float = 0.25):
        self.db = db
        self.interval = interval_s
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="tide-snapshot")

    def start(self) -> None:
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.db.snapshot_now(flush_threshold=0)
            except Exception:  # pragma: no cover
                import traceback
                traceback.print_exc()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
