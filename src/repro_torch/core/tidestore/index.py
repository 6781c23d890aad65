"""On-disk index formats (§4.2, §6.3).

Two formats, exactly as benchmarked in the paper:

- **Optimistic index**: a flat sorted array of fixed-size entries
  (``key_len``-byte key + 8-byte WAL position; 40 bytes for 32-byte keys).
  No header, no directory.  A lookup treats the key as an integer, computes
  its fractional position in the keyspace, multiplies by the file size to get
  an estimated byte offset, reads a window of W entries there, and
  binary-searches.  If the target is outside the window's key range the
  window shifts toward the right end; with uniform keys this converges in
  1–3 iterations (order statistics of U(0,1) samples: the i-th key
  concentrates around i/N with σ ≈ √N, far below one window).
  A bounded linear-probe phase falls back to bisection so that adversarial
  (non-uniform) keys still terminate in O(log N) window reads.

- **Header index** (the paper's baseline): a 128-entry directory bucketing
  keys by their top 7 bits, followed by the same sorted entries.  Exactly two
  reads per lookup regardless of distribution.

Keys are fixed-length byte strings compared lexicographically.  Internally
they are viewed as big-endian u64 column matrices — numpy's ``S`` dtype
silently strips trailing NUL bytes in comparisons, so it is used only as an
inert storage container, never for ordering.

On-disk indices never contain tombstones: every flush serializes a
*complete* cell (DirtyLoaded) or a merge of the previous index with the
dirty buffer (DirtyUnloaded), so deleted keys are simply absent.
"""
from __future__ import annotations

import struct
from typing import Callable, Optional

import numpy as np

from .util import Metrics

# In-memory position markers: bit 63 flags a tombstone; the low bits keep the
# tombstone's own WAL position so "higher WAL position wins" (§3.1) resolves
# concurrent insert/delete races identically before and after replay.
TOMB_FLAG = 1 << 63
POS_MASK = TOMB_FLAG - 1


def is_tombstone(pos: int) -> bool:
    return bool(pos & TOMB_FLAG)


def real_pos(pos: int) -> int:
    return pos & POS_MASK


def entry_size(key_len: int) -> int:
    return key_len + 8


def _nwords(key_len: int) -> int:
    return (key_len + 7) // 8


def _key_words(key: bytes, key_len: int) -> tuple[int, ...]:
    padded = key.ljust(_nwords(key_len) * 8, b"\x00")
    return tuple(int.from_bytes(padded[i * 8:(i + 1) * 8], "big")
                 for i in range(_nwords(key_len)))


def _buf_to_cols(buf: bytes, n: int, key_len: int) -> tuple[np.ndarray, np.ndarray]:
    """Entry buffer → (key column matrix (n, nwords) big-endian u64, pos (n,))."""
    esz = entry_size(key_len)
    raw = np.frombuffer(buf, dtype=np.uint8, count=n * esz).reshape(n, esz)
    keys = raw[:, :key_len]
    nw = _nwords(key_len)
    if key_len % 8:
        padded = np.zeros((n, nw * 8), dtype=np.uint8)
        padded[:, :key_len] = keys
        keys = padded
    cols = np.ascontiguousarray(keys).view(">u8").reshape(n, nw)
    pos = np.ascontiguousarray(raw[:, key_len:]).view("<u8").reshape(n)
    return cols, pos


def _searchsorted_lex(cols: np.ndarray, words: tuple[int, ...]) -> tuple[int, bool]:
    """Lexicographic insertion point of ``words`` in the sorted key matrix.
    Returns (index, exact_match)."""
    lo, hi = 0, len(cols)
    for j, w in enumerate(words):
        if lo >= hi:
            return lo, False
        col = cols[lo:hi, j]
        # The needle must carry the column's (big-endian) dtype: numpy
        # 2.0.x type-promotes a Python-int needle against a byte-swapped
        # array inconsistently between side="left" and side="right",
        # yielding insertion points that disagree with lexicographic
        # order whenever adjacent keys share a leading word.
        needle = np.array(w, dtype=col.dtype)
        l = int(np.searchsorted(col, needle, side="left"))
        r = int(np.searchsorted(col, needle, side="right"))
        lo, hi = lo + l, lo + r
    return lo, lo < hi


def _row_words(cols: np.ndarray, i: int) -> tuple[int, ...]:
    return tuple(int(x) for x in cols[i])


def _row_key(buf: bytes, i: int, key_len: int) -> bytes:
    esz = entry_size(key_len)
    return buf[i * esz:i * esz + key_len]


def build_sorted_blob(entries: dict[bytes, int], key_len: int) -> tuple[bytes, int]:
    """Live entries, sorted lexicographically, packed as [key | u64 pos]*."""
    live = [(k, v) for k, v in entries.items() if not is_tombstone(v)]
    n = len(live)
    if n == 0:
        return b"", 0
    nw = _nwords(key_len)
    keymat = np.zeros((n, nw * 8), dtype=np.uint8)
    kb = np.frombuffer(b"".join(k for k, _ in live), dtype=np.uint8)
    keymat[:, :key_len] = kb.reshape(n, key_len)
    cols = keymat.view(">u8").reshape(n, nw)
    order = np.lexsort(tuple(cols[:, j] for j in reversed(range(nw))))
    esz = entry_size(key_len)
    out = np.empty((n, esz), dtype=np.uint8)
    out[:, :key_len] = keymat[order][:, :key_len]
    pos = np.array([v for _, v in live], dtype="<u8")[order]
    out[:, key_len:] = pos.view(np.uint8).reshape(n, 8)
    return out.tobytes(), n


def _key_fraction(key: bytes) -> float:
    return int.from_bytes(key[:8].ljust(8, b"\x00"), "big") / float(1 << 64)


# --------------------------------------------------------------- optimistic
def serialize_optimistic(entries: dict[bytes, int], key_len: int) -> tuple[bytes, int]:
    return build_sorted_blob(entries, key_len)


def load_optimistic(pread: Callable[[int, int], bytes], count: int,
                    key_len: int) -> list[tuple[bytes, int]]:
    esz = entry_size(key_len)
    buf = pread(0, count * esz)
    _, pos = _buf_to_cols(buf, count, key_len)
    return [(_row_key(buf, i, key_len), int(pos[i])) for i in range(count)]


class OptimisticLookup:
    """Windowed interpolation search over a serialized optimistic index."""

    def __init__(self, pread: Callable[[int, int], bytes], count: int,
                 key_len: int, window_entries: int = 800,
                 linear_probes: int = 4, metrics: Optional[Metrics] = None):
        self.pread = pread
        self.count = count
        self.key_len = key_len
        self.window = max(8, window_entries)
        self.linear_probes = linear_probes
        self.metrics = metrics
        self.esz = entry_size(key_len)

    def _read_window(self, start: int, n: int):
        buf = self.pread(start * self.esz, n * self.esz)
        n = min(n, len(buf) // self.esz)
        cols, pos = _buf_to_cols(buf, n, self.key_len)
        return buf, cols, pos

    def _search(self, key: bytes):
        """Locate the window containing ``key``'s insertion point.
        Returns (buf, cols, pos, window_start_index, iterations)."""
        n, w = self.count, self.window
        if n == 0:
            return b"", np.zeros((0, 1), dtype=">u8"), np.zeros(0, "<u8"), 0, 0
        words = _key_words(key, self.key_len)
        lo, hi = 0, n                       # bounds on the insertion point
        est = int(_key_fraction(key) * n)   # §4.2: fractional position estimate
        iters = 0
        while True:
            start = min(max(est - w // 2, lo), max(hi - w, lo))
            start = max(0, min(start, max(0, n - w)))
            nread = min(w, n - start)
            buf, cols, pos = self._read_window(start, nread)
            iters += 1
            in_left = start == 0 or _row_words(cols, 0) <= words
            in_right = start + nread >= n or words <= _row_words(cols, nread - 1)
            if (in_left and in_right) or nread == 0:
                break
            if not in_left:
                hi = start                  # insertion point strictly left
                est = start - w // 2 if iters <= self.linear_probes \
                    else (lo + hi) // 2
            else:
                lo = start + nread          # insertion point strictly right
                est = start + nread + w // 2 if iters <= self.linear_probes \
                    else (lo + hi) // 2
            if hi <= lo:
                break                       # key falls exactly between windows
            est = min(max(est, lo), max(hi - 1, lo))
        if self.metrics:
            self.metrics.add(index_lookups=1, index_lookup_iterations=iters)
        return buf, cols, pos, start, iters

    def lookup(self, key: bytes) -> tuple[Optional[int], int]:
        buf, cols, pos, start, iters = self._search(key)
        if len(pos) == 0:
            return None, iters
        i, exact = _searchsorted_lex(cols, _key_words(key, self.key_len))
        if exact:
            return int(pos[i]), iters
        return None, iters

    def predecessor(self, key: bytes) -> tuple[Optional[bytes], Optional[int], int]:
        """Largest stored key strictly smaller than ``key`` (reverse iterator)."""
        buf, cols, pos, start, iters = self._search(key)
        if len(pos) == 0:
            return None, None, iters
        i, _exact = _searchsorted_lex(cols, _key_words(key, self.key_len))
        if i == 0:
            if start == 0:
                return None, None, iters
            # The predecessor is the entry just before this window.
            b2, c2, p2 = self._read_window(start - 1, 1)
            return _row_key(b2, 0, self.key_len), int(p2[0]), iters + 1
        return _row_key(buf, i - 1, self.key_len), int(pos[i - 1]), iters


# ------------------------------------------------------------------- header
_HEADER_BUCKETS = 128
_HEADER_FMT = struct.Struct(f"<{_HEADER_BUCKETS + 1}I")


def serialize_header(entries: dict[bytes, int], key_len: int) -> tuple[bytes, int]:
    """Paper §6.3 baseline: 128-bucket directory over the top 7 key bits."""
    blob, n = build_sorted_blob(entries, key_len)
    if n:
        esz = entry_size(key_len)
        first = np.frombuffer(blob, dtype=np.uint8)[::esz][:n]
        buckets = (first >> 1).astype(np.int64)
        starts = np.searchsorted(buckets, np.arange(_HEADER_BUCKETS + 1))
    else:
        starts = np.zeros(_HEADER_BUCKETS + 1, dtype=np.int64)
    hdr = _HEADER_FMT.pack(*[int(s) for s in starts])
    return hdr + blob, n


class HeaderLookup:
    """Always exactly two reads: directory entry, then the bucket slice."""

    def __init__(self, pread: Callable[[int, int], bytes], count: int,
                 key_len: int, metrics: Optional[Metrics] = None, **_):
        self.pread = pread
        self.count = count
        self.key_len = key_len
        self.metrics = metrics
        self.esz = entry_size(key_len)

    def _bucket(self, first_byte: int):
        b = first_byte >> 1
        hdr = self.pread(b * 4, 8)                      # I/O 1: two u32 offsets
        s, e = struct.unpack("<II", hdr)
        if self.metrics:
            self.metrics.add(index_lookups=1, index_lookup_iterations=2)
        if e <= s:
            return b"", np.zeros((0, 1), dtype=">u8"), np.zeros(0, "<u8"), s
        buf = self.pread(_HEADER_FMT.size + s * self.esz, (e - s) * self.esz)
        n = min(e - s, len(buf) // self.esz)
        cols, pos = _buf_to_cols(buf, n, self.key_len)
        return buf, cols, pos, s                        # I/O 2: bucket slice

    def lookup(self, key: bytes) -> tuple[Optional[int], int]:
        buf, cols, pos, _ = self._bucket(key[0] if key else 0)
        if len(pos) == 0:
            return None, 2
        i, exact = _searchsorted_lex(cols, _key_words(key, self.key_len))
        if exact:
            return int(pos[i]), 2
        return None, 2

    def predecessor(self, key: bytes) -> tuple[Optional[bytes], Optional[int], int]:
        words = _key_words(key, self.key_len)
        b = (key[0] if key else 0)
        iters = 0
        first = True
        while b >= 0:
            buf, cols, pos, s = self._bucket(b)
            iters += 2
            if len(pos):
                if first:
                    i, _ = _searchsorted_lex(cols, words)
                else:
                    i = len(pos)            # earlier bucket: take its max
                if i > 0:
                    return (_row_key(buf, i - 1, self.key_len),
                            int(pos[i - 1]), iters)
            b -= 2                          # previous bucket = first_byte - 2
            first = False
        return None, None, iters


def load_header(pread: Callable[[int, int], bytes], count: int,
                key_len: int) -> list[tuple[bytes, int]]:
    esz = entry_size(key_len)
    buf = pread(_HEADER_FMT.size, count * esz)
    _, pos = _buf_to_cols(buf, count, key_len)
    return [(_row_key(buf, i, key_len), int(pos[i])) for i in range(count)]


FORMATS = {
    "optimistic": (serialize_optimistic, OptimisticLookup, load_optimistic),
    "header": (serialize_header, HeaderLookup, load_header),
}

# Byte offset of the sorted entry region within each format's blob.
BLOB_OFFSETS = {"optimistic": 0, "header": _HEADER_FMT.size}


def load_blob_arrays(pread: Callable[[int, int], bytes], count: int,
                     key_len: int, fmt: str = "optimistic"):
    """Read a cell's complete sorted entry region in ONE positional read.

    The batched read path (``TideDB.multi_get``) amortizes a single blob
    read across every query hitting the cell, instead of per-key windowed
    lookups.  Returns (buf, n) — raw entry bytes and how many complete
    entries were actually read (short reads surface as n < count and the
    caller falls back to the per-key path).
    """
    esz = entry_size(key_len)
    buf = pread(BLOB_OFFSETS[fmt], count * esz)
    return buf, min(count, len(buf) // esz)


def blob_to_arrays(buf: bytes, n: int,
                   key_len: int) -> tuple[np.ndarray, np.ndarray, bytes, int]:
    """Parse a sorted entry buffer into self-contained lookup arrays.

    Returns ``(u32 key prefixes, u64 positions, packed key bytes, nbytes)``
    — all copies (nothing views ``buf``), sized for the blob-array memo
    cache.  The key bytes are packed contiguously at ``key_len`` stride so
    full-key verification after a prefix hit is a direct slice compare.
    """
    esz = entry_size(key_len)
    raw = np.frombuffer(buf, dtype=np.uint8, count=n * esz).reshape(n, esz)
    cols, pos = _buf_to_cols(buf, n, key_len)
    u32 = u32_prefixes(cols)
    keys = np.ascontiguousarray(raw[:, :key_len]).tobytes()
    nbytes = u32.nbytes + pos.nbytes + len(keys)
    return u32, pos, keys, nbytes


def u32_prefixes(cols: np.ndarray) -> np.ndarray:
    """First 4 key bytes of each row as uint32.

    For uniform keyspaces the cell id is a monotone function of this prefix,
    so concatenating cells' sorted blobs in cell-id order yields a globally
    sorted u32 column — exactly the input contract of the
    ``optimistic_lookup`` CUDA kernel.
    """
    return (cols[:, 0] >> np.uint64(32)).astype(np.uint32)
