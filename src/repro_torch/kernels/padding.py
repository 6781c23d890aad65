"""Shared host-side shape-padding helpers for the kernel ops wrappers."""
from __future__ import annotations


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (1 for n <= 1)."""
    return 1 << max(0, int(n - 1).bit_length())
