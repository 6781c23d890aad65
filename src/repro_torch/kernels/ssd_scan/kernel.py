"""ssd_scan: the fused Mamba-2 SSD chunk scan as CUDA kernels.

Launch wrapper for ``csrc/ssd_scan.cu``, which replaces the TPU kernel
``ssd_scan_pallas`` of the JAX package's ``kernels/ssd_scan/kernel.py`` (the
design note is in the source).  A call runs three passes: the chunk states,
the state passing over the chunks, and the chunk output; the fp32 entry runs
a split of its inputs into bf16 parts first.  Every grid comes from the
shapes alone, so a call never waits on the card.  The wrapper takes CUDA
tensors only and raises on anything else; the plain PyTorch version for CPU
tensors is ``ref.py``, and ``ops.py`` picks between the two by the tensors'
device and pads the sequence to a chunk multiple.

``launches`` counts kernel launches: the wrapper adds one to ``"ssd_scan"``
for each call (its chunk-output pass), one to ``"ssd_scan_states"`` and one
to ``"ssd_scan_pass"`` for the other two passes, and one to
``"ssd_scan_split"`` where the fp32 entry splits its inputs, and nowhere
else.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import check, check_tensor, load, stream_arg

launches = {"ssd_scan": 0, "ssd_scan_states": 0, "ssd_scan_pass": 0,
            "ssd_scan_split": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ENTRY = {torch.bfloat16: "ssd_scan_bf16", torch.float32: "ssd_scan_f32"}
# bf16 parts of each computed fp32 operand (and of each fp32 input).
PARTS = {torch.bfloat16: 2, torch.float32: 3}
# The widest state the kernels take (Mamba-2's d_state; no wider one is
# tested on the card).
MAX_N = 128
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = load("ssd_scan")
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = [_P] * 12 + [_I] * 6 + [_P]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def scratch_spec(b: int, l: int, h: int, p: int, n: int, chunk: int,
                 dtype: torch.dtype) -> dict[str, tuple[tuple, torch.dtype]]:
    """(shape, dtype) of each device scratch tensor of one call: ``states``
    (b, nc, h, p, n) fp32, each chunk's own state; ``chunk_cs`` (b, nc, h)
    fp32, each chunk's sum of dt·A; ``prev`` (b, nc, h, parts, p, n) bf16,
    the state each chunk starts from, as bf16 parts; and for fp32 inputs
    ``parts``, three bf16 planes of x, Bm and Cm."""
    nc = l // chunk
    out = dict(states=((b, nc, h, p, n), torch.float32),
               chunk_cs=((b, nc, h), torch.float32),
               prev=((b, nc, h, PARTS[dtype], p, n), torch.bfloat16))
    if dtype == torch.float32:
        out["parts"] = ((3 * b * l * (h * p + 2 * n),), torch.bfloat16)
    return out


def alloc_scratch(b: int, l: int, h: int, p: int, n: int, chunk: int,
                  dtype: torch.dtype, device) -> dict[str, torch.Tensor]:
    """The device scratch of one call (``scratch_spec``), allocated with
    ``torch.empty``."""
    return {name: torch.empty(shape, dtype=kind, device=device) for name,
            (shape, kind) in scratch_spec(b, l, h, p, n, chunk, dtype).items()}


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int,
             init_state: torch.Tensor | None = None,
             _scratch: dict[str, torch.Tensor] | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (b,l,h,p), Bm and Cm (b,l,n), all bfloat16 or all float32; dt
    (b,l,h) and A (h,) float32 (dt after the softplus, A negative);
    init_state (b,h,p,n) float32 or None (zeros).  ``l`` must be a multiple
    of ``chunk`` (``ops.ssd`` pads), p and n multiples of 16, and n at most
    128.  → (y (b,l,h,p) in x's dtype, final_state (b,h,p,n) float32).
    ``_scratch`` replaces the scratch the call would allocate, for the test
    that fills it with NaN first; each of its tensors must have the shape and
    dtype ``scratch_spec`` gives for this call."""
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
    if p % 16 or n % 16 or n > MAX_N:
        raise ValueError(f"p={p} and n={n} must be multiples of 16, n at most "
                         f"{MAX_N}")
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
    if _scratch is None:
        sc = alloc_scratch(b, l, h, p, n, chunk, dtype, dev)
    else:
        spec = scratch_spec(b, l, h, p, n, chunk, dtype)
        if set(_scratch) != set(spec):
            raise ValueError(f"scratch must hold {sorted(spec)}, not "
                             f"{sorted(_scratch)}")
        for name, (shape, kind) in spec.items():
            check_tensor(_scratch[name], f"scratch {name}", kind, dev,
                         shape=shape)
        sc = _scratch
    parts = sc.get("parts")
    lib = _library()
    with torch.cuda.device(dev):
        err = getattr(lib, _ENTRY[dtype])(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), None if init_state is None else
            init_state.data_ptr(), y.data_ptr(), state.data_ptr(),
            sc["states"].data_ptr(), sc["chunk_cs"].data_ptr(),
            sc["prev"].data_ptr(), None if parts is None else
            parts.data_ptr(), b, l, h, p, n, chunk, stream_arg(x))
    check(lib, err, "ssd_scan launch")
    if dtype == torch.float32:
        launches["ssd_scan_split"] += 1
    launches["ssd_scan_states"] += 1
    launches["ssd_scan_pass"] += 1
    launches["ssd_scan"] += 1
    return y, state
