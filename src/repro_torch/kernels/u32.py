"""uint32 arithmetic for the plain PyTorch versions of the kernels.

PyTorch's uint32 has no ``+``, ``%``, ``>>``, comparisons or
``searchsorted`` on the CPU, so the plain versions widen u32 values to
int64 and mask sums back to 32 bits where the kernels wrap.
"""
from __future__ import annotations

import torch

U32_MASK = 0xFFFFFFFF


def widen_u32(t: torch.Tensor) -> torch.Tensor:
    """uint32 (or int32 holding u32 bits) → int64 in [0, 2³²)."""
    return t.view(torch.int32).to(torch.int64) & U32_MASK
