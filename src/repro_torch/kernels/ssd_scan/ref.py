"""Plain PyTorch version of the SSD chunk scan: the chunked SSD of the JAX
package's ``models/ssm.py`` (``_segsum``, ``ssd_scan``), written out.

It lives here rather than in ``models/ssm.py`` because ``models/ssm.py``
calls ``ops.ssd``, which imports this module; ``models/ssm.py`` re-exports
it as ``ssd_scan``.  As in the JAX function, ``C·Bᵀ`` is formed in the
inputs' dtype and widened afterwards (the CUDA kernel, like the Pallas one,
widens first), and everything after it runs in fp32.

``ssd_scan_passes`` mirrors the CUDA kernel's three passes in plain tensor
ops (chunk states, state passing, chunk output) and, with ``split=True``,
its rounding: each fp32 operand of a product as bf16 parts (two for bf16
inputs, three for fp32 inputs, which are split too), and only the products
of parts whose ranks sum to less than the larger count.  The tests hold it
against the JAX package, so the precision of the split is settled on the
CPU; nothing on a path calls it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x (...,c) → (...,c,c) lower-triangular sums out[i,j] = sum_{j<t<=i},
    -inf above the diagonal."""
    c = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))
    return out.masked_fill(~mask, float("-inf"))


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int, init_state=None):
    """Chunked SSD.  x (b,l,h,p); dt (b,l,h) (after the softplus); A (h,)
    negative; Bm, Cm (b,l,n) (one group, shared by every head);
    init_state (b,h,p,n) or None.  → (y (b,l,h,p) in x's dtype,
    final_state (b,h,p,n) fp32)."""
    b, l, h, p = x.shape
    n = Bm.shape[-1]
    c = min(chunk, l)
    orig_l = l
    if l % c:
        # Pad to a chunk multiple: dt = 0 gives decay 1 and no state
        # contribution, so the padding is exactly state-neutral.
        pad = c - l % c
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        l += pad
    nc = l // c
    xr = x.reshape(b, nc, c, h, p)
    dtr = dt.reshape(b, nc, c, h)
    Br = Bm.reshape(b, nc, c, n)
    Cr = Cm.reshape(b, nc, c, n)
    dA = dtr * A[None, None, None, :]                       # (b,z,c,h)
    dA_cs = torch.cumsum(dA, dim=2)

    # Within-chunk (attention-like) term.
    L = torch.exp(_segsum(dA.movedim(-1, -2)))             # (b,z,h,c,c)
    att = torch.einsum("bzin,bzjn->bzij", Cr, Br)           # (b,z,c,c)
    xdt = xr * dtr[..., None]
    y_diag = torch.einsum("bzij,bzhij,bzjhp->bzihp", att.float(), L,
                          xdt.float())

    # Per-chunk states.
    decay_to_end = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)   # (b,z,c,h)
    states = torch.einsum("bzcn,bzchp,bzch->bzhpn", Br.float(), xdt.float(),
                          decay_to_end)

    # Cross-chunk recurrence (a short loop over the chunks).
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])             # (b,z,h)
    carry = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device) \
        if init_state is None else init_state.float()
    prev = []
    for z in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, z, :, None, None] + states[:, z]
    prev_states = torch.stack(prev, dim=1)                  # (b,z,h,p,n)

    decay_from_start = torch.exp(dA_cs)                     # (b,z,c,h)
    y_off = torch.einsum("bzcn,bzhpn,bzch->bzchp", Cr.float(), prev_states,
                         decay_from_start)
    y = (y_diag + y_off).reshape(b, l, h, p).to(x.dtype)
    return y[:, :orig_l], carry


# ------------------------------------------- the kernel's passes, mirrored

def bf16_parts(v: torch.Tensor, k: int) -> list[torch.Tensor]:
    """``v`` (fp32) as ``k`` bf16 values held in fp32, hi first: each part
    rounds what the parts before it left, as the kernel's ``split_pair``."""
    out = []
    for _ in range(k):
        part = v.bfloat16().float()
        out.append(part)
        v = v - part
    return out


def _mix(eq: str, a: list, b: list) -> torch.Tensor:
    """sum of einsum(eq, a[i], b[j]) over the part pairs the kernel
    multiplies: i + j below the larger count."""
    top = max(len(a), len(b))
    return sum(torch.einsum(eq, a[i], b[j]) for i in range(len(a))
               for j in range(len(b)) if i + j < top)


def _parts_of(dtype: torch.dtype, split: bool) -> tuple[int, int]:
    """(parts of an input, parts of a computed fp32 operand)."""
    if not split:
        return 1, 1
    return (1, 2) if dtype == torch.bfloat16 else (3, 3)


def ssd_chunk_states(x, dt, A, Bm, *, chunk: int, split: bool = False):
    """Pass 1.  x (b,l,h,p), dt (b,l,h), Bm (b,l,n), l a multiple of
    ``chunk`` → (states (b,nc,h,p,n) fp32: each chunk's own contribution
    sum_j exp(cs_last - cs_j) dt_j x_j ⊗ B_j; cs (b,nc,c,h) fp32: the
    cumulative sum of dt·A within each chunk)."""
    b, l, h, p = x.shape
    n, nc = Bm.shape[-1], l // chunk
    nr, nw = _parts_of(x.dtype, split)
    xr = x.float().reshape(b, nc, chunk, h, p)
    dtr = dt.float().reshape(b, nc, chunk, h)
    cs = torch.cumsum(dtr * A.float(), dim=2)
    w = torch.exp(cs[:, :, -1:, :] - cs) * dtr              # (b,z,c,h)
    xs = xr if nr == 1 else sum(bf16_parts(xr, nr))
    xw = bf16_parts(xs * w[..., None], nw) if split else [xs * w[..., None]]
    Br = Bm.float().reshape(b, nc, chunk, n)
    states = _mix("bzchp,bzcn->bzhpn", xw, bf16_parts(Br, nr) if split
                  else [Br])
    return states, cs


def ssd_state_passing(states, cs_last, init_state=None):
    """Pass 2.  states (b,nc,h,p,n), cs_last (b,nc,h) → (prev (b,nc,h,p,n):
    the state each chunk starts from; final (b,h,p,n)), fp32."""
    b, nc, h, p, n = states.shape
    carry = torch.zeros((b, h, p, n), dtype=torch.float32,
                        device=states.device) \
        if init_state is None else init_state.float()
    decay = torch.exp(cs_last)
    prev = []
    for z in range(nc):
        prev.append(carry)
        carry = carry * decay[:, z, :, None, None] + states[:, z]
    return torch.stack(prev, dim=1), carry


def ssd_chunk_output(x, dt, Bm, Cm, prev, cs, *, chunk: int,
                     split: bool = False):
    """Pass 3.  y_i = sum_{j<=i} (C_i·B_j) exp(cs_i - cs_j) dt_j x_j
    + exp(cs_i) C_i·prevᵀ, chunk by chunk → y (b,l,h,p) fp32."""
    b, l, h, p = x.shape
    n, nc = Bm.shape[-1], l // chunk
    nr, nw = _parts_of(x.dtype, split)
    raw = lambda t: bf16_parts(t, nr) if split else [t]
    xr = x.float().reshape(b, nc, chunk, h, p)
    dtr = dt.float().reshape(b, nc, chunk, h)
    Br = Bm.float().reshape(b, nc, chunk, n)
    Cr = Cm.float().reshape(b, nc, chunk, n)
    G = _mix("bzin,bzjn->bzij", raw(Cr), raw(Br))           # (b,z,c,c)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]      # (b,z,i,j,h)
    W = torch.where(mask[None, None, :, :, None],
                    G[..., None] * torch.exp(diff) * dtr[:, :, None, :, :],
                    torch.zeros((), device=x.device))
    Wp = bf16_parts(W, nw) if split else [W]
    y_diag = _mix("bzijh,bzjhp->bzihp", Wp, raw(xr))
    prevp = bf16_parts(prev, nw) if split else [prev]
    y_off = _mix("bzin,bzhpn->bzihp", raw(Cr), prevp) \
        * torch.exp(cs)[..., None]
    return (y_diag + y_off).reshape(b, l, h, p)


def ssd_scan_passes(x, dt, A, Bm, Cm, *, chunk: int, init_state=None,
                    split: bool = False):
    """The kernel's passes in plain ops: the same function as ``ssd_scan``
    (same arguments, padding and outputs).  With ``split`` each product
    takes the kernel's bf16 parts (see the module's note)."""
    b, l, h, p = x.shape
    c = min(chunk, l)
    pad = (-l) % c
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    states, cs = ssd_chunk_states(x, dt, A, Bm, chunk=c, split=split)
    prev, final = ssd_state_passing(states, cs[:, :, -1, :], init_state)
    y = ssd_chunk_output(x, dt, Bm, Cm, prev, cs, chunk=c, split=split)
    return y[:, :l].to(x.dtype), final
