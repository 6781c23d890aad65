"""Byte-budgeted LRU cache for recently read values (§3.2 step 1)."""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional


class LruCache:
    def __init__(self, capacity_bytes: int):
        self.capacity = capacity_bytes
        self._lock = threading.Lock()
        self._data: OrderedDict[bytes, bytes] = OrderedDict()
        self._size = 0

    def get(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            v = self._data.get(key)
            if v is not None:
                self._data.move_to_end(key)
            return v

    def get_many(self, keys) -> list[Optional[bytes]]:
        """Batched lookup under one lock acquisition (order-aligned)."""
        with self._lock:
            out = []
            for key in keys:
                v = self._data.get(key)
                if v is not None:
                    self._data.move_to_end(key)
                out.append(v)
            return out

    def put_many(self, items) -> None:
        """Single cache fill for a batch of (key, value) pairs."""
        if self.capacity <= 0 or not items:
            return
        with self._lock:
            for key, value in items:
                self._put_locked(key, value)

    def put(self, key: bytes, value: bytes) -> None:
        if self.capacity <= 0:
            return
        with self._lock:
            self._put_locked(key, value)

    def _put_locked(self, key: bytes, value: bytes) -> None:
        old = self._data.pop(key, None)
        if old is not None:
            self._size -= len(old) + len(key)
        self._data[key] = value
        self._size += len(value) + len(key)
        while self._size > self.capacity and self._data:
            k, v = self._data.popitem(last=False)
            self._size -= len(v) + len(k)

    def invalidate(self, key: bytes) -> None:
        with self._lock:
            v = self._data.pop(key, None)
            if v is not None:
                self._size -= len(v) + len(key)

    def invalidate_many(self, keys) -> None:
        """Batched invalidation under one lock acquisition (write pipeline:
        one sweep per ``put_many``/``write_batch`` instead of a lock round
        trip per key)."""
        with self._lock:
            for key in keys:
                v = self._data.pop(key, None)
                if v is not None:
                    self._size -= len(v) + len(key)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self._size = 0

    def __len__(self) -> int:
        return len(self._data)


class BlobArrayCache:
    """Byte-budgeted LRU of parsed index-blob arrays, keyed by ``disk_pos``.

    The batched read path re-reads and re-parses a cell's whole index blob
    on every batch that touches the cell; this memoizes the parsed
    ``(u32 prefixes, positions, key bytes)`` triple.  ``disk_pos`` (the
    blob's Index Store payload offset) uniquely identifies blob content —
    the Index Store is append-only — so entries can never be stale; flush
    swaps a cell to a *new* disk_pos and explicitly invalidates the old one
    to return its budget early.  Values are self-contained copies, so Index
    Store segment GC cannot pull data out from under a cached entry.
    """

    def __init__(self, capacity_bytes: int):
        self.capacity = capacity_bytes
        self._lock = threading.Lock()
        self._data: OrderedDict[int, tuple] = OrderedDict()
        self._sizes: dict[int, int] = {}
        self._size = 0

    def get(self, disk_pos: int):
        with self._lock:
            v = self._data.get(disk_pos)
            if v is not None:
                self._data.move_to_end(disk_pos)
            return v

    def put(self, disk_pos: int, value: tuple, nbytes: int) -> None:
        if self.capacity <= 0 or nbytes > self.capacity:
            return
        with self._lock:
            if disk_pos in self._data:
                self._size -= self._sizes[disk_pos]
                del self._data[disk_pos]
            self._data[disk_pos] = value
            self._sizes[disk_pos] = nbytes
            self._size += nbytes
            while self._size > self.capacity and self._data:
                k, _ = self._data.popitem(last=False)
                self._size -= self._sizes.pop(k)

    def __contains__(self, disk_pos: int) -> bool:
        """Peek without promoting (used by read-path cost decisions)."""
        with self._lock:
            return disk_pos in self._data

    def invalidate(self, disk_pos: int) -> None:
        with self._lock:
            if self._data.pop(disk_pos, None) is not None:
                self._size -= self._sizes.pop(disk_pos)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self._sizes.clear()
            self._size = 0

    def __len__(self) -> int:
        return len(self._data)
