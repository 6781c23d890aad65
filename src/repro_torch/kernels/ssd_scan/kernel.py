"""ssd_scan: the fused Mamba-2 SSD chunk scan as a CUDA kernel.

Launch wrapper for ``csrc/ssd_scan.cu``, which replaces the TPU kernel
``ssd_scan_pallas`` of the JAX package's ``kernels/ssd_scan/kernel.py`` (the
design note is in the source).  The wrapper takes CUDA tensors only and
raises on anything else; the plain PyTorch version for CPU tensors is
``ref.py``, and ``ops.py`` picks between the two by the tensors' device and
pads the sequence to a chunk multiple.

``launches`` counts kernel launches: the wrapper adds one where it launches
its kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import check, check_tensor, load, stream_arg

launches = {"ssd_scan": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ENTRY = {torch.bfloat16: "ssd_scan_bf16", torch.float32: "ssd_scan_f32"}
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = load("ssd_scan")
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = [_P] * 8 + [_I] * 7 + [_P]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int,
             init_state: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (b,l,h,p), Bm and Cm (b,l,n), all bfloat16 or all float32; dt
    (b,l,h) and A (h,) float32 (dt after the softplus, A negative);
    init_state (b,h,p,n) float32 or None (zeros).  ``l`` must be a multiple
    of ``chunk`` (``ops.ssd`` pads).  → (y (b,l,h,p) in x's dtype,
    final_state (b,h,p,n) float32).  A CTA takes a block of 4 heads (2 or
    1 where 4 does not divide h) and shares C·Bᵀ across them."""
    if x.dim() != 4 or Bm.dim() != 3:
        raise ValueError("x must be (b,l,h,p) and Bm, Cm (b,l,n)")
    b, l, h, p = x.shape
    n = Bm.shape[-1]
    dev, dtype = x.device, x.dtype
    if dtype not in _ENTRY:
        raise TypeError(f"ssd_scan takes bfloat16 or float32, not {dtype}")
    if chunk <= 0 or l % chunk:
        raise ValueError(f"sequence length {l} is no multiple of the chunk "
                         f"{chunk}; ops.ssd pads it")
    check_tensor(x, "x", dtype, dev, shape=(b, l, h, p))
    check_tensor(Bm, "Bm", dtype, dev, shape=(b, l, n))
    check_tensor(Cm, "Cm", dtype, dev, shape=(b, l, n))
    check_tensor(dt, "dt", torch.float32, dev, shape=(b, l, h))
    check_tensor(A, "A", torch.float32, dev, shape=(h,))
    if init_state is not None:
        check_tensor(init_state, "init_state", torch.float32, dev,
                     shape=(b, h, p, n))
    for t, name in ((x, "x"), (Bm, "Bm"), (Cm, "Cm"), (dt, "dt"), (A, "A"),
                    (init_state, "init_state")):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    y = torch.empty_like(x)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    if b == 0 or l == 0:
        if init_state is not None:
            state.copy_(init_state)
        else:
            state.zero_()
        return y, state
    hb = next(d for d in (4, 2, 1) if h % d == 0)
    lib = _library()
    with torch.cuda.device(dev):
        err = getattr(lib, _ENTRY[dtype])(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), None if init_state is None else
            init_state.data_ptr(), y.data_ptr(), state.data_ptr(),
            b, l, h, p, n, chunk, hb, stream_arg(x))
    check(lib, err, "ssd_scan launch")
    launches["ssd_scan"] += 1
    return y, state
