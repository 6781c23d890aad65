"""Plain PyTorch versions of the bloom_check kernels.

The same probe arithmetic as ``csrc/bloom_check.cu`` in tensor operations,
for tensors on any device: the ops take them for CPU tensors, and the chip
check holds the kernels against them on the card.  The values widen to
int64 and the ``h1 + i·h2`` sum is masked back to 32 bits before the
modulus, which is the u32 wraparound of the kernel.
"""
from __future__ import annotations

import torch

from ..u32 import U32_MASK, widen_u32


def _probe(h1, h2, word_base, nbits, bits, k: int) -> torch.Tensor:
    a, b, w = widen_u32(h1), widen_u32(h2), widen_u32(bits)
    result = torch.ones(a.shape, dtype=torch.bool, device=a.device)
    for i in range(k):
        idx = ((a + i * b) & U32_MASK) % nbits
        word = w[word_base + (idx >> 5)]
        result &= ((word >> (idx & 31)) & 1) == 1
    return result


def bloom_check_ref(h1: torch.Tensor, h2: torch.Tensor, bits: torch.Tensor,
                    *, k: int = 7, nbits: int | None = None) -> torch.Tensor:
    """h1, h2 (Q,) uint32; bits (nwords,) uint32 → (Q,) bool."""
    nbits = nbits if nbits is not None else bits.shape[0] * 32
    return _probe(h1, h2, 0, nbits, bits, k)


def bloom_check_ragged_ref(h1: torch.Tensor, h2: torch.Tensor,
                           off: torch.Tensor, nbits: torch.Tensor,
                           bits: torch.Tensor, *, k: int = 7) -> torch.Tensor:
    """Per-query word base ``off`` (Q,) int32 and modulus ``nbits`` (Q,)
    uint32 into the packed ``bits`` → (Q,) bool."""
    return _probe(h1, h2, off.to(torch.int64), widen_u32(nbits), bits, k)
