"""optimistic_lookup: the paper's §4.2 interpolation search as a CUDA kernel.

Launch wrapper for ``csrc/optimistic_lookup.cu``, which replaces the TPU
kernel ``optimistic_lookup`` of the JAX package's
``kernels/optimistic_lookup/kernel.py`` (the design note is in the source).
The wrapper takes CUDA tensors only and raises on anything else; the plain
PyTorch version for CPU tensors is ``ref.py``, and ``ops.py`` picks between
the two by the tensors' device.  Two entries: ``optimistic_lookup``, the TPU
kernel's contract (idx -1 where the rounds ran out), and
``optimistic_lookup_resolve``, which resolves those queries in the same
launch by a lower bound over the whole array.

``launches`` counts kernel launches per entry point: a wrapper adds one
where it launches its kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import check, check_tensor, load, stream_arg

launches = {"optimistic_lookup": 0, "optimistic_lookup_resolve": 0}

_P = ctypes.c_void_p
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = load("optimistic_lookup")
        lib.optimistic_lookup.argtypes = [_P] * 5 + [ctypes.c_int] * 4 + [_P]
        lib.optimistic_lookup.restype = ctypes.c_int
        lib.optimistic_lookup_resolve.argtypes = [_P] * 4 + \
            [ctypes.c_int] * 4 + [_P]
        lib.optimistic_lookup_resolve.restype = ctypes.c_int
        _lib = lib
    return _lib


def _checked(queries: torch.Tensor, keys: torch.Tensor, window: int,
             max_iters: int) -> tuple[int, int, int]:
    """(Q, N, window cut to N) after the checks both entries share."""
    check_tensor(queries, "queries", torch.uint32, queries.device)
    check_tensor(keys, "keys", torch.uint32, queries.device)
    q, n = queries.shape[0], keys.shape[0]
    if n == 0 or n >= 2 ** 31:
        raise ValueError(f"keys must hold 1 to 2³¹-1 entries, not {n}")
    window = min(window, n)
    if window < 1 or max_iters < 0:
        raise ValueError(f"window={window}, max_iters={max_iters}")
    return q, n, window


def optimistic_lookup(queries: torch.Tensor, keys: torch.Tensor, *,
                      window: int = 512, max_iters: int = 4):
    """queries (Q,) uint32; keys (N,) uint32 sorted ascending, N ≥ 1.
    → (idx (Q,) int32 [-1 if unresolved], found (Q,) bool,
    iters (Q,) int32)."""
    q, n, window = _checked(queries, keys, window, max_iters)
    dev = queries.device
    idx = torch.empty(q, dtype=torch.int32, device=dev)
    found = torch.empty(q, dtype=torch.bool, device=dev)
    iters = torch.empty(q, dtype=torch.int32, device=dev)
    if q == 0:
        return idx, found, iters
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.optimistic_lookup(
            queries.data_ptr(), keys.data_ptr(), idx.data_ptr(),
            found.data_ptr(), iters.data_ptr(), q, n, window, max_iters,
            stream_arg(queries))
    check(lib, err, "optimistic_lookup launch")
    launches["optimistic_lookup"] += 1
    return idx, found, iters


def optimistic_lookup_resolve(queries: torch.Tensor, keys: torch.Tensor, *,
                              window: int = 512, max_iters: int = 4):
    """The same search, every query resolved: → (idx (Q,) int32, found (Q,)
    bool), idx the window's rank where the rounds found the key's window and
    the lower bound over all of ``keys`` where they ran out."""
    q, n, window = _checked(queries, keys, window, max_iters)
    dev = queries.device
    idx = torch.empty(q, dtype=torch.int32, device=dev)
    found = torch.empty(q, dtype=torch.bool, device=dev)
    if q == 0:
        return idx, found
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.optimistic_lookup_resolve(
            queries.data_ptr(), keys.data_ptr(), idx.data_ptr(),
            found.data_ptr(), q, n, window, max_iters, stream_arg(queries))
    check(lib, err, "optimistic_lookup_resolve launch")
    launches["optimistic_lookup_resolve"] += 1
    return idx, found
