"""Keys, values and draws for store traffic, all from ``--seed``.

Keys are 32 uniform bytes from a PCG64 stream of their own: stream 0 holds
every key the run writes, in the order it writes them, and stream 1 keys that
are never written.  A value is its key repeated to the value's size, so any
answer can be checked against the key alone.  The same seed gives the same
keys, draws and sizes; another seed gives other keys and the same sizes.
"""
from __future__ import annotations

import numpy as np

WRITTEN, ABSENT, DRAWS = 0, 1, 2


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64(
        np.random.SeedSequence([seed & 0xFFFFFFFF, seed >> 32, stream])))


def value_of(key: bytes, value_bytes: int) -> bytes:
    reps = -(-value_bytes // len(key))
    return (key * reps)[:value_bytes]


class KeyStream:
    """The keys of one stream, generated in order and kept (32 B a key) so
    that any earlier key can be drawn again."""

    def __init__(self, seed: int, stream: int, key_bytes: int = 32):
        self._rng = _rng(seed, stream)
        self.key_bytes = key_bytes
        self._buf = np.zeros((1 << 16, key_bytes), np.uint8)
        self.n = 0

    def take(self, n: int) -> list[bytes]:
        """The next ``n`` keys of the stream."""
        if self.n + n > self._buf.shape[0]:
            cap = max(self._buf.shape[0] * 2, self.n + n)
            grown = np.zeros((cap, self.key_bytes), np.uint8)
            grown[:self.n] = self._buf[:self.n]
            self._buf = grown
        raw = self._rng.bytes(n * self.key_bytes)
        self._buf[self.n:self.n + n] = np.frombuffer(raw, np.uint8).reshape(
            n, self.key_bytes)
        self.n += n
        kb = self.key_bytes
        return [raw[i * kb:(i + 1) * kb] for i in range(n)]

    def key(self, i: int) -> bytes:
        return self._buf[i].tobytes()

    def keys(self, idx) -> list[bytes]:
        rows = self._buf[np.asarray(idx, np.int64)]
        blob = rows.tobytes()
        kb = self.key_bytes
        return [blob[i * kb:(i + 1) * kb] for i in range(len(rows))]


class Traffic:
    """What one run sends: fresh keys to write, earlier keys to read back,
    keys never written, and the draws between them."""

    def __init__(self, seed: int, key_bytes: int, value_bytes: int):
        self.written = KeyStream(seed, WRITTEN, key_bytes)
        self.absent = KeyStream(seed, ABSENT, key_bytes)
        self.draws = _rng(seed, DRAWS)
        self.value_bytes = value_bytes
        self.epoch_of_index: list[tuple[int, int]] = []   # (first index, epoch)

    def fresh(self, n: int, epoch: int = 0) -> list[tuple[bytes, bytes]]:
        """The next ``n`` keys to write, with their values."""
        if not self.epoch_of_index or self.epoch_of_index[-1][1] != epoch:
            self.epoch_of_index.append((self.written.n, epoch))
        vb = self.value_bytes
        return [(k, value_of(k, vb)) for k in self.written.take(n)]

    def first_index_of_epoch(self, epoch: int) -> int:
        """The first written index whose epoch is at least ``epoch``."""
        for first, e in self.epoch_of_index:
            if e >= epoch:
                return first
        return self.written.n

    def present(self, n: int, lo: int = 0) -> list[bytes]:
        """``n`` keys drawn uniformly, with repeats, from the written keys
        ``[lo, written)``."""
        if self.written.n <= lo:
            raise ValueError("no written keys to draw from")
        return self.written.keys(self.draws.integers(lo, self.written.n, n))

    def never_written(self, n: int) -> list[bytes]:
        return self.absent.take(n)

    def mixed(self, n: int, present_share: float, lo: int = 0) -> list[bytes]:
        """``n`` keys, ``present_share`` of them written (from ``[lo,
        written)``) and the rest never written, shuffled together."""
        n_present = int(round(n * present_share))
        keys = self.present(n_present, lo) + self.never_written(n - n_present)
        order = self.draws.permutation(n)
        return [keys[i] for i in order]
