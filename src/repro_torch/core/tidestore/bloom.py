"""Per-cell Bloom filters for negative-lookup short-circuiting (§3.2 step 2).

The paper resolves ``exists`` queries from memory without touching the index
or the Value WAL; this is the 15.6× existence-check win.  The bitset is a
flat uint32 word array with k double-hashed probes — **bit-identical** to the
``kernels/bloom_check`` CUDA kernel's layout and probe arithmetic
(``idx_i = (h1 + i·h2) mod 2³² mod nbits``, word = idx>>5, bit = idx&31), so
a batch of queries can be tested either host-side (numpy) or through the
kernel's ops wrapper with exactly the same answers — no false negatives can
be introduced by switching paths.

``probe_cells`` is the fused multi-cell entry: the bit arrays of every
touched cell pack into one buffer, each query carries its cell's word
offset and modulus, and the whole ragged (key, cell) batch resolves in ONE
``bloom_check`` launch on ``device`` (or one vectorized numpy pass below the
launch threshold) instead of one launch per cell.
"""
from __future__ import annotations

import hashlib
import struct

import numpy as np

# Below this many queries a touched cell, on average, the kernel's launch
# and copies cost more than the numpy path, which computes the identical
# answer.  On the CPU the JAX package's value, so that the counters equal
# the reference's.  On the card ``chip_smoke.py``'s phase-3 sweep (256
# cells) found the numpy path faster up to 16 queries a cell, the two
# unresolved at 32, and the kernel faster at 64 and 128: the JAX package's
# value stays there too.  On one shard of phase 8 (64 cells) the kernel won
# from 256 a cell; on both stores the crossover lies between 8192 and 16384
# queries a batch (PERF.md §6).
_KERNEL_MIN_BATCH = {"cpu": 64, "cuda": 64}


def kernel_min_batch(device: str) -> int:
    """The fused probe's routing threshold on ``device`` ("cuda:0" → its
    type's), in queries a touched cell."""
    return _KERNEL_MIN_BATCH[device.split(":")[0]]


def key_hashes(key: bytes) -> tuple[int, int]:
    """(h1, h2) uint32 halves for one key; h2 forced odd (double hashing)."""
    d = hashlib.blake2b(key, digest_size=8).digest()
    return (int.from_bytes(d[:4], "little"),
            int.from_bytes(d[4:], "little") | 1)


def key_hashes_many(keys) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized ``key_hashes``: (h1 (Q,) u32, h2 (Q,) u32)."""
    n = len(keys)
    h1 = np.empty(n, dtype=np.uint32)
    h2 = np.empty(n, dtype=np.uint32)
    for i, k in enumerate(keys):
        d = hashlib.blake2b(k, digest_size=8).digest()
        h1[i] = int.from_bytes(d[:4], "little")
        h2[i] = int.from_bytes(d[4:], "little") | 1
    return h1, h2


class BloomFilter:
    __slots__ = ("bits", "nbits", "k")

    def __init__(self, expected_entries: int, bits_per_key: int = 10, k: int = 7):
        # Round the modulus up to a power of two: probe arithmetic is
        # unchanged and the false-positive rate only improves.  The T_FILTER
        # wire form requires it (``from_bytes`` rejects any other modulus),
        # so persisted filters stay readable by the JAX package's engine.
        raw = max(64, expected_entries * bits_per_key)
        nbits = 1 << (raw - 1).bit_length()
        self.nbits = nbits
        self.k = k
        self.bits = np.zeros((nbits + 31) // 32, dtype=np.uint32)

    def _probe_idx(self, h1: np.ndarray, h2: np.ndarray) -> np.ndarray:
        """(Q,) hash halves → (k, Q) probe bit indices, u32 wraparound."""
        i = np.arange(self.k, dtype=np.uint32)[:, None]
        return (h1[None, :] + i * h2[None, :]) % np.uint32(self.nbits)

    def add(self, key: bytes) -> None:
        h1, h2 = key_hashes(key)
        idx = self._probe_idx(np.uint32([h1]), np.uint32([h2]))
        np.bitwise_or.at(self.bits, (idx >> np.uint32(5)).astype(np.int64),
                         np.uint32(1) << (idx & np.uint32(31)))

    def add_many(self, keys) -> None:
        if not len(keys):
            return
        h1, h2 = key_hashes_many(keys)
        idx = self._probe_idx(h1, h2)
        np.bitwise_or.at(self.bits, (idx >> np.uint32(5)).astype(np.int64),
                         np.uint32(1) << (idx & np.uint32(31)))

    def might_contain(self, key: bytes) -> bool:
        # Scalar fast path: the documented probe arithmetic in plain ints
        # (idx_i = (h1 + i·h2) mod 2³² mod nbits, word = idx>>5,
        # bit = idx&31) with early exit on the first clear bit — this runs
        # under row locks, where the numpy small-array overhead of the
        # batched twins is pure latency.  Bit-identical to ``probe_cells``
        # by construction; the parity tier pins it.
        h1, h2 = key_hashes(key)
        bits, nbits = self.bits, self.nbits
        for i in range(self.k):
            idx = ((h1 + i * h2) & 0xFFFFFFFF) % nbits
            if not (int(bits[idx >> 5]) >> (idx & 31)) & 1:
                return False
        return True

    def might_contain_many(self, keys, h1: np.ndarray | None = None,
                           h2: np.ndarray | None = None,
                           use_kernel: bool = True,
                           device: str = "cuda") -> np.ndarray:
        """Vectorized membership for a batch of keys → (Q,) bool.

        A single-cell view of ``probe_cells``: large batches route through
        the fused ragged kernel wrapper (one gather + bit-test per probe, no
        per-query control flow); small batches take the equivalent numpy
        path to skip the kernel launch.  Precomputed (h1, h2) arrays may be
        passed to amortize hashing across the cells of one multi-key read.
        """
        if h1 is None or h2 is None:
            if not len(keys):
                return np.zeros(0, dtype=bool)
            h1, h2 = key_hashes_many(keys)
        return probe_cells([self], h1, h2, [np.arange(len(h1))],
                           use_kernel=use_kernel, device=device)

    @property
    def nbytes(self) -> int:
        return self.bits.nbytes

    # ------------------------------------------------------- serialization
    # Persisted next to the index blob at flush (T_FILTER records in the
    # Index Store) so reopen can skip the lazy rebuild's blob read.  The
    # wire form is the in-memory layout verbatim — (nbits, k) header + the
    # little-endian uint32 word array — so a round-trip is bit-identical
    # to the filter that was flushed.
    _WIRE_HDR = struct.Struct("<QI")     # nbits u64, k u32

    def to_bytes(self) -> bytes:
        return self._WIRE_HDR.pack(self.nbits, self.k) + \
            self.bits.astype("<u4", copy=False).tobytes()

    @classmethod
    def from_bytes(cls, raw: bytes) -> "BloomFilter":
        hdr = cls._WIRE_HDR.size
        if len(raw) < hdr:
            raise ValueError("truncated bloom filter blob")
        nbits, k = cls._WIRE_HDR.unpack_from(raw)
        nwords = (nbits + 31) // 32
        if nbits <= 0 or (nbits & (nbits - 1)) or k < 1 or \
                len(raw) != hdr + nwords * 4:
            raise ValueError("malformed bloom filter blob")
        f = cls.__new__(cls)
        f.nbits = nbits
        f.k = k
        f.bits = np.frombuffer(raw, dtype="<u4", offset=hdr).astype(
            np.uint32, copy=True)
        return f


def _probe_host(h1: np.ndarray, h2: np.ndarray, off: np.ndarray,
                nbits: np.ndarray, bits: np.ndarray, k: int) -> np.ndarray:
    """Numpy twin of the ragged kernel: per-query modulus + word base."""
    i = np.arange(k, dtype=np.uint32)[:, None]
    idx = (h1[None, :] + i * h2[None, :]) % nbits[None, :]
    words = bits[off[None, :].astype(np.int64)
                 + (idx >> np.uint32(5)).astype(np.int64)]
    return np.all((words >> (idx & np.uint32(31))) & np.uint32(1), axis=0)


def probe_cells(cells, h1: np.ndarray, h2: np.ndarray, groups,
                use_kernel: bool = True, device: str = "cuda") -> np.ndarray:
    """Fused membership across many cells' filters → (Q,) bool.

    ``cells[i]`` is a ``BloomFilter`` (or ``None`` to skip) and
    ``groups[i]`` the indices into ``h1``/``h2`` of the queries probing it —
    ragged group shapes welcome, each query index in at most one group.
    Every (query, cell) pair resolves in ONE kernel launch on ``device``
    (the plain PyTorch version when ``device`` is the CPU): the touched
    bitsets pack back to back, each query carries its cell's word offset
    and true modulus.  Below the routing threshold (``kernel_min_batch``;
    or with ``use_kernel=False``) the identical answer comes from one
    vectorized numpy pass — still fused, never per-cell.  Unassigned queries come back
    ``False``.  Bit-for-bit equal to ``cells[i].might_contain(key)`` per
    query: the probe arithmetic never changes, only the batching.

    Kernel routing: one fused launch costs about what ONE per-cell launch
    did, so the kernel engages once every touched cell carries at least the
    single-cell threshold of queries on average (``total ≥
    kernel_min_batch(device) × n_cells``).  With one cell this reduces
    exactly to the small-batch threshold.

    Cells with distinct ``k`` fuse per k-group (one launch each); every
    engine-built filter shares one k, so the batch path stays one launch.
    """
    h1 = np.asarray(h1, dtype=np.uint32)
    h2 = np.asarray(h2, dtype=np.uint32)
    out = np.zeros(len(h1), dtype=bool)
    if not len(h1):
        return out
    by_k: dict[int, list] = {}
    for cell, g in zip(cells, groups):
        g = np.asarray(g, dtype=np.int64)
        if cell is None or g.size == 0:
            continue
        by_k.setdefault(cell.k, []).append((cell, g))
    for k, members in by_k.items():
        if len(members) == 1:                # no packing copy for one cell
            cell, sel = members[0]
            bits = cell.bits
            off = np.zeros(sel.size, np.int32)
            nb = np.full(sel.size, cell.nbits, np.uint32)
        else:
            sizes = [c.bits.shape[0] for c, _ in members]
            bases = np.concatenate([[0], np.cumsum(sizes[:-1])])
            bits = np.concatenate([c.bits for c, _ in members])
            sel = np.concatenate([g for _, g in members])
            off = np.concatenate(
                [np.full(g.size, bases[i], np.int32)
                 for i, (_, g) in enumerate(members)])
            nb = np.concatenate([np.full(g.size, c.nbits, np.uint32)
                                 for c, g in members])
        if use_kernel and sel.size >= kernel_min_batch(device) * len(members):
            from ...kernels.bloom_check.ops import probe_cells_batch
            out[sel] = probe_cells_batch(h1[sel], h2[sel], off, nb, bits, k=k,
                                         device=device)
        else:
            out[sel] = _probe_host(h1[sel], h2[sel], off, nb, bits, k)
    return out
