"""Plain PyTorch versions of the bloom_check kernels, and the host-side
add that builds the bitsets they probe.

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


def bloom_add_ref(h1: torch.Tensor, h2: torch.Tensor, bits: torch.Tensor, *,
                  k: int = 7, nbits: int | None = None) -> torch.Tensor:
    """Host-side add: a new bitset (on ``bits``' device) with every (h1, h2)
    set.  numpy's ``bitwise_or.at`` lets duplicate word indices within one
    batch accumulate, as in the JAX package."""
    import numpy as np
    nbits = nbits if nbits is not None else bits.shape[0] * 32
    b = bits.cpu().numpy().copy()
    h1n, h2n = h1.cpu().numpy(), h2.cpu().numpy()
    for i in range(k):
        idx = (h1n + np.uint32(i) * h2n) % np.uint32(nbits)
        np.bitwise_or.at(b, (idx >> np.uint32(5)).astype(np.int64),
                         np.uint32(1) << (idx & np.uint32(31)))
    return torch.from_numpy(b).to(bits.device)
