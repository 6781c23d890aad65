"""Small statistics the metric readers share, on the harness's own samples."""
from __future__ import annotations

import math
import os


def p95(samples) -> float | None:
    """The 95th percentile by nearest rank: the smallest sample that at
    least 95% of the samples do not exceed."""
    xs = sorted(samples)
    if not xs:
        return None
    return xs[max(0, math.ceil(0.95 * len(xs)) - 1)]


def disk_bytes(path: str) -> int:
    """Bytes the directory's files hold on disk (allocated blocks of 512 B,
    preallocated space included)."""
    total = 0
    for root, _dirs, files in os.walk(path):
        for name in files:
            try:
                total += os.lstat(os.path.join(root, name)).st_blocks * 512
            except FileNotFoundError:      # a segment dropped meanwhile
                pass
    return total


def fsync_tree(path: str) -> int:
    """Write every file under ``path`` through to its disk (``fsync`` of
    each, the harness's own files only); the number of files."""
    n = 0
    for root, _dirs, files in os.walk(path):
        for name in files:
            try:
                fd = os.open(os.path.join(root, name), os.O_RDONLY)
            except FileNotFoundError:
                continue
            try:
                os.fsync(fd)
                n += 1
            finally:
                os.close(fd)
    return n


def space_amp(samples) -> float | None:
    """Mean over (disk bytes, live bytes) samples of their ratio."""
    ratios = [d / live for d, live in samples if live > 0]
    return sum(ratios) / len(ratios) if ratios else None


def wchar() -> int | None:
    """Bytes this process has passed to write calls so far
    (``/proc/self/io``), or None where the kernel does not say."""
    try:
        with open("/proc/self/io") as f:
            for line in f:
                if line.startswith("wchar:"):
                    return int(line.split()[1])
    except OSError:
        return None
    return None


def ratio(num, den) -> float | None:
    if num is None or not den:
        return None
    return num / den
