"""bloom_check: k-probe Bloom-filter membership as a CUDA kernel.

Launch wrappers for ``csrc/bloom_check.cu``, which replaces the TPU kernels
``bloom_check`` and ``bloom_check_ragged`` of the JAX package's
``kernels/bloom_check/kernel.py`` (the design note is in the source).  The
wrappers take CUDA tensors only and raise on anything else; the plain
PyTorch version for CPU tensors is ``ref.py``, and ``ops.py`` picks between
the two by the tensors' device.

``launches`` counts kernel launches per entry point: a wrapper adds one
where it launches its kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import check, check_tensor, count_launch, load, stream_arg

launches = {"bloom_check": 0, "bloom_check_ragged": 0}

_P = ctypes.c_void_p
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = load("bloom_check")
        lib.bloom_check_ragged.argtypes = [_P] * 6 + [ctypes.c_int,
                                                      ctypes.c_int, _P]
        lib.bloom_check_ragged.restype = ctypes.c_int
        lib.bloom_check.argtypes = [_P] * 4 + [ctypes.c_uint32, ctypes.c_int,
                                               ctypes.c_int, _P]
        lib.bloom_check.restype = ctypes.c_int
        _lib = lib
    return _lib


def bloom_check_ragged(h1: torch.Tensor, h2: torch.Tensor, off: torch.Tensor,
                       nbits: torch.Tensor, bits: torch.Tensor, *,
                       k: int = 7) -> torch.Tensor:
    """Fused multi-cell membership: h1, h2, nbits (Q,) uint32, off (Q,)
    int32 word bases into ``bits`` (total_words,) uint32 → (Q,) bool.
    Every query's probes must stay inside ``bits`` (off + nbits/32 ≤
    total_words), as the engine's packing guarantees."""
    dev = h1.device
    q = h1.shape[0] if h1.dim() == 1 else -1
    check_tensor(h1, "h1", torch.uint32, dev, q)
    check_tensor(h2, "h2", torch.uint32, dev, q)
    check_tensor(off, "off", torch.int32, dev, q)
    check_tensor(nbits, "nbits", torch.uint32, dev, q)
    check_tensor(bits, "bits", torch.uint32, dev)
    out = torch.empty(q, dtype=torch.bool, device=dev)
    if q == 0:
        return out
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.bloom_check_ragged(
            h1.data_ptr(), h2.data_ptr(), off.data_ptr(), nbits.data_ptr(),
            bits.data_ptr(), out.data_ptr(), q, k, stream_arg(h1))
    check(lib, err, "bloom_check_ragged launch")
    count_launch(launches, "bloom_check_ragged")
    return out


def bloom_check(h1: torch.Tensor, h2: torch.Tensor, bits: torch.Tensor, *,
                k: int = 7, nbits: int | None = None) -> torch.Tensor:
    """Single-cell membership: h1, h2 (Q,) uint32; bits (nwords,) uint32;
    ``nbits`` the filter's modulus (default nwords·32, at most that)
    → (Q,) bool."""
    dev = h1.device
    q = h1.shape[0] if h1.dim() == 1 else -1
    check_tensor(h1, "h1", torch.uint32, dev, q)
    check_tensor(h2, "h2", torch.uint32, dev, q)
    check_tensor(bits, "bits", torch.uint32, dev)
    nbits = nbits if nbits is not None else bits.shape[0] * 32
    if not 0 < nbits <= min(bits.shape[0] * 32, 0xFFFFFFFF):
        raise ValueError(f"nbits={nbits} outside (0, {bits.shape[0] * 32}]")
    out = torch.empty(q, dtype=torch.bool, device=dev)
    if q == 0:
        return out
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.bloom_check(h1.data_ptr(), h2.data_ptr(), bits.data_ptr(),
                              out.data_ptr(), nbits, q, k, stream_arg(h1))
    check(lib, err, "bloom_check launch")
    count_launch(launches, "bloom_check")
    return out
