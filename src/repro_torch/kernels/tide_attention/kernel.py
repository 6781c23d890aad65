"""tide_attention: decode attention through the KV-WAL slot table as a CUDA
kernel.

Launch wrapper for ``csrc/tide_attention.cu``, which replaces the TPU kernel
``tide_attention`` of the JAX package's ``kernels/tide_attention/kernel.py``
(the design note is in the source).  The wrapper takes CUDA tensors only and
raises on anything else; the plain PyTorch version for CPU tensors is
``ref.py``, and ``ops.py`` picks between the two by the tensors' device.

Each call runs a split pass over S slices of every row's live range and,
when S > 1, a combine pass; ``split_plan`` picks S and the tile R from
static shapes alone, so a call never waits on the card.

``launches`` counts kernel launches: the wrapper adds one to
``"tide_attention"`` for each call, and one to ``"tide_attention_combine"``
where it also launches the combine pass, and nowhere else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..build import check, check_tensor, count_launch, load, stream_arg

launches = {"tide_attention": 0, "tide_attention_combine": 0}

ROWS = 16                 # query heads a CTA (the mma's 16 rows)
MAX_SPLITS = 256          # the combine pass's bound on S
STAGE_BUDGET = 180_000    # shared bytes two stages of K/V tiles may take
CTAS_PER_SM = 2

_P = ctypes.c_void_p
_I = ctypes.c_int
_ENTRY = {torch.bfloat16: "tide_attention_bf16",
          torch.float32: "tide_attention_f32"}
# Head dims in whole mma k-steps (bf16) or 16-byte vectors (fp32); the bf16
# path holds at most 256 output columns in registers.
_UNIT = {torch.bfloat16: 16, torch.float32: 4}
_MAX_DV = {torch.bfloat16: 256, torch.float32: None}
_lib = None


def row_bytes(dk: int, dv: int, elem_bytes: int) -> int:
    """Shared bytes of one K row and one V row, each padded to an odd
    number of 16-byte units (as ``padded_row`` in the source)."""
    pad = lambda d: ((d * elem_bytes // 16) | 1) * 16
    return pad(dk) + pad(dv)


def split_plan(B: int, H: int, KH: int, NB: int, blk: int, window: int,
               sms: int, pos_bytes: int) -> tuple[int, int]:
    """(S, R): split each row's live range into S slices of R-position
    tiles.  Static shapes only, never the lengths.  R is the largest of 64,
    32, 16 whose two stages of K and V (``pos_bytes`` of shared memory a
    position, see ``row_bytes``) fit the budget, whatever ``blk``: a tile
    that spans KV blocks is staged a block's run at a time.  S aims at
    two CTAs a streaming multiprocessor over the B x KH x ceil(G / 16) CTAs
    of one split, and stops at the most tiles a row can hold live (a window
    of w positions spans at most ceil(w / R) + 1 tiles)."""
    R = next((r for r in (64, 32, 16)
              if 2 * r * pos_bytes <= STAGE_BUDGET), None)
    if R is None or blk <= 0:
        raise ValueError(f"tide_attention needs rows that fit shared memory "
                         f"and blocks of at least one position, not blk={blk} "
                         f"with {pos_bytes} bytes a position")
    ctas = B * KH * -(-(H // KH) // ROWS)
    tiles = -(-(NB * blk) // R)
    if window > 0:
        tiles = min(tiles, -(-window // R) + 1)
    S = max(1, min(round(CTAS_PER_SM * sms / ctas), tiles, MAX_SPLITS))
    return S, R


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan(q: torch.Tensor, arena_k: torch.Tensor, arena_v: torch.Tensor,
         window: int) -> tuple[int, int]:
    """The (S, R) ``tide_attention`` launches with for these tensors on
    their card."""
    B, H, dk = q.shape
    _, NB, blk, KH, _ = arena_k.shape
    return split_plan(B, H, KH, NB, blk, window, _sm_count(q.device.index),
                      row_bytes(dk, arena_v.shape[-1], q.element_size()))


def _library():
    global _lib
    if _lib is None:
        lib = load("tide_attention")
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = [_P] * 9 + [_I] * 10 + [ctypes.c_float, _P]
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
    contiguous ``(L, …)`` arena is contiguous.  Head dims must be multiples
    of 16 in bf16 (dv at most 256) and of 4 in fp32; ``blk`` may be any
    size."""
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
    unit = _UNIT[dt]
    if dk % unit or dv % unit:
        raise ValueError(f"head dims {dk}, {dv} must be multiples of {unit}")
    if _MAX_DV[dt] and dv > _MAX_DV[dt]:
        raise ValueError(f"dv {dv} is above {_MAX_DV[dt]} for {dt}")
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
    S, R = plan(q, arena_k, arena_v, window)
    scale = dk ** -0.5 if scale is None else scale
    # Each split's (m, l) per query head, then its fp32 accumulator.
    ml = acc = None
    if S > 1:
        part = torch.empty(B * H * S * (2 + dv), dtype=torch.float32,
                           device=dev)
        ml, acc = part.data_ptr(), part[B * H * S * 2:].data_ptr()
    lib = _library()
    with torch.cuda.device(dev):
        err = getattr(lib, _ENTRY[dt])(
            q.data_ptr(), arena_k.data_ptr(), arena_v.data_ptr(),
            table.data_ptr(), seq_lens.data_ptr(), first_live.data_ptr(),
            out.data_ptr(), ml, acc, B, H, KH, NB, blk, dk, dv, window, S, R,
            scale, stream_arg(q))
    check(lib, err, "tide_attention launch")
    count_launch(launches, "tide_attention",
                 *(("tide_attention_combine",) if S > 1 else ()))
    return out
