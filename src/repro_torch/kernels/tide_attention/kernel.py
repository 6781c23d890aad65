"""tide_attention: decode attention through the KV-WAL slot table as a CUDA
kernel.

Launch wrapper for ``csrc/tide_attention.cu``, which replaces the TPU kernel
``tide_attention`` of the JAX package's ``kernels/tide_attention/kernel.py``
(the design note is in the source).  The wrapper takes CUDA tensors only and
raises on anything else; the plain PyTorch version for CPU tensors is
``ref.py``, and ``ops.py`` picks between the two by the tensors' device.

``launches`` counts kernel launches: the wrapper adds one where it launches
its kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import check, check_tensor, load, stream_arg

launches = {"tide_attention": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ENTRY = {torch.bfloat16: "tide_attention_bf16",
          torch.float32: "tide_attention_f32"}
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = load("tide_attention")
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = [_P] * 7 + [_I] * 8 + [ctypes.c_float, _P]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def tide_attention(q: torch.Tensor, arena_k: torch.Tensor,
                   arena_v: torch.Tensor, table: torch.Tensor,
                   seq_lens: torch.Tensor, first_live: torch.Tensor, *,
                   window: int = 0, scale: float | None = None) -> torch.Tensor:
    """q (B,H,dk); arena_k (B,NB,blk,KH,dk); arena_v (B,NB,blk,KH,dv), all
    bfloat16 or all float32; table (B,NB) int32; seq_lens/first_live (B,)
    int32 → (B,H,dv) in q's dtype.  ``seq_lens`` counts valid slots (the new
    token's entry already appended).  A per-layer slice ``arena[l]`` of a
    contiguous ``(L, …)`` arena is contiguous.  Head dims must fill whole
    16-byte vectors (a multiple of 8 in bf16, of 4 in fp32)."""
    if q.dim() != 3 or arena_k.dim() != 5 or arena_v.dim() != 5:
        raise ValueError("q must be (B,H,dk) and the arenas (B,NB,blk,KH,d)")
    B, H, dk = q.shape
    _, NB, blk, KH, _ = arena_k.shape
    dv = arena_v.shape[-1]
    dev, dt = q.device, q.dtype
    if dt not in _ENTRY:
        raise TypeError(f"tide_attention takes bfloat16 or float32, not {dt}")
    if KH == 0 or H % KH:
        raise ValueError(f"{H} query heads do not group over {KH} kv-heads")
    vec = 16 // q.element_size()
    if dk % vec or dv % vec:
        raise ValueError(f"head dims {dk}, {dv} must be multiples of {vec}")
    check_tensor(q, "q", dt, dev, shape=(B, H, dk))
    check_tensor(arena_k, "arena_k", dt, dev, shape=(B, NB, blk, KH, dk))
    check_tensor(arena_v, "arena_v", dt, dev, shape=(B, NB, blk, KH, dv))
    check_tensor(table, "table", torch.int32, dev, shape=(B, NB))
    check_tensor(seq_lens, "seq_lens", torch.int32, dev, shape=(B,))
    check_tensor(first_live, "first_live", torch.int32, dev, shape=(B,))
    for t, name in ((q, "q"), (arena_k, "arena_k"), (arena_v, "arena_v")):
        if t.data_ptr() % 16:                  # the kernel loads 16 bytes
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty((B, H, dv), dtype=dt, device=dev)
    if B == 0:
        return out
    scale = dk ** -0.5 if scale is None else scale
    lib = _library()
    with torch.cuda.device(dev):
        err = getattr(lib, _ENTRY[dt])(
            q.data_ptr(), arena_k.data_ptr(), arena_v.data_ptr(),
            table.data_ptr(), seq_lens.data_ptr(), first_live.data_ptr(),
            out.data_ptr(), B, H, KH, NB, blk, dk, dv, window, scale,
            stream_arg(q))
    check(lib, err, "tide_attention launch")
    launches["tide_attention"] += 1
    return out
