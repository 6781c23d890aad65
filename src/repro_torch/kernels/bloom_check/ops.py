"""Host-facing entries for bloom_check.

``might_contain`` and ``probe_ragged`` take tensors and pick by the tensors'
device: a CUDA tensor launches the kernel (``kernel.py``, which raises on
what it cannot take), a CPU tensor takes the plain version (``ref.py``).
``might_contain_batch`` is the numpy entry for one cell's bitset;
``probe_cells_batch`` is the fused ragged entry the storage engine's
existence path uses — every touched cell's bit array packed into one
buffer, every (key, cell) pair probed in ONE launch.  Both are numpy in /
numpy out on the named ``device``, and pad the query count and the bitset
words to powers of two exactly as the JAX package's wrappers do.

``ragged_dispatch_count`` counts fused dispatches since import, on either
device — one ``multi_exists`` batch bumps it by exactly one per store,
however many cells the batch touches.
"""
from __future__ import annotations

import numpy as np
import torch

from ..build import on_card
from ..padding import next_pow2
from .kernel import bloom_check, bloom_check_ragged
from .ref import bloom_check_ragged_ref, bloom_check_ref

ragged_dispatch_count = 0


def might_contain(h1: torch.Tensor, h2: torch.Tensor, bits: torch.Tensor, *,
                  k: int = 7, nbits: int | None = None) -> torch.Tensor:
    if on_card(h1, "bloom_check"):
        return bloom_check(h1, h2, bits, k=k, nbits=nbits)
    return bloom_check_ref(h1, h2, bits, k=k, nbits=nbits)


def probe_ragged(h1: torch.Tensor, h2: torch.Tensor, off: torch.Tensor,
                 nbits: torch.Tensor, bits: torch.Tensor, *,
                 k: int = 7) -> torch.Tensor:
    if on_card(h1, "bloom_check_ragged"):
        return bloom_check_ragged(h1, h2, off, nbits, bits, k=k)
    return bloom_check_ragged_ref(h1, h2, off, nbits, bits, k=k)


def _to(a: np.ndarray, dtype, device: str) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)


def might_contain_batch(h1: np.ndarray, h2: np.ndarray, bits: np.ndarray,
                        *, k: int = 7, nbits: int | None = None,
                        device: str = "cuda") -> np.ndarray:
    """Batched membership test: h1/h2 (Q,) u32, bits (nwords,) u32 → (Q,) bool.

    ``nbits`` is the filter's true modulus (it need not equal nwords·32 once
    the word array is padded).  Padding queries probe slot 0 and are sliced
    off; padded bitset words are never indexed because nbits stays fixed.
    """
    q = len(h1)
    if q == 0:
        return np.zeros(0, dtype=bool)
    nbits = nbits if nbits is not None else bits.shape[0] * 32
    qp = next_pow2(q)
    if qp != q:
        h1 = np.concatenate([h1, np.zeros(qp - q, np.uint32)])
        h2 = np.concatenate([h2, np.ones(qp - q, np.uint32)])
    wp = next_pow2(bits.shape[0])
    if wp != bits.shape[0]:
        bits = np.concatenate([bits, np.zeros(wp - bits.shape[0], np.uint32)])
    out = might_contain(_to(h1, np.uint32, device), _to(h2, np.uint32, device),
                        _to(bits, np.uint32, device), k=k, nbits=nbits)
    return out.cpu().numpy()[:q]


def probe_cells_batch(h1: np.ndarray, h2: np.ndarray, off: np.ndarray,
                      nbits: np.ndarray, bits: np.ndarray, *, k: int = 7,
                      device: str = "cuda") -> np.ndarray:
    """Fused ragged membership: h1/h2 (Q,) u32, off (Q,) i32 word bases,
    nbits (Q,) u32 per-query moduli, bits (total_words,) u32 packed cells
    → (Q,) bool, in ONE kernel launch on ``device``.

    Padding queries probe slot 0 of word 0 with a modulus of 32 (always a
    valid index into any non-empty packed buffer) and are sliced off;
    padded bitset words are never indexed because each query's ``nbits``
    bounds its probes inside its own cell.
    """
    q = len(h1)
    if q == 0:
        return np.zeros(0, dtype=bool)
    ends = np.asarray(off, np.int64) + (np.asarray(nbits, np.int64) + 31) // 32
    if np.min(off) < 0 or ends.max() > bits.shape[0] or np.min(nbits) == 0:
        raise ValueError("every query's cell must lie inside bits: "
                         "0 <= off, 0 < nbits, off + nbits/32 <= len(bits)")
    qp = next_pow2(q)
    if qp != q:
        pad = qp - q
        h1 = np.concatenate([h1, np.zeros(pad, np.uint32)])
        h2 = np.concatenate([h2, np.ones(pad, np.uint32)])
        off = np.concatenate([off, np.zeros(pad, np.int32)])
        nbits = np.concatenate([nbits, np.full(pad, 32, np.uint32)])
    wp = next_pow2(bits.shape[0])
    if wp != bits.shape[0]:
        bits = np.concatenate([bits, np.zeros(wp - bits.shape[0], np.uint32)])
    global ragged_dispatch_count
    ragged_dispatch_count += 1
    out = probe_ragged(_to(h1, np.uint32, device), _to(h2, np.uint32, device),
                       _to(off, np.int32, device), _to(nbits, np.uint32, device),
                       _to(bits, np.uint32, device), k=k)
    return out.cpu().numpy()[:q]
