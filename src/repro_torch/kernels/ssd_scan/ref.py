"""Plain PyTorch version of the SSD chunk scan: the chunked SSD of the JAX
package's ``models/ssm.py`` (``_segsum``, ``ssd_scan``), written out.

It lives here rather than in ``models/ssm.py`` because ``models/ssm.py``
calls ``ops.ssd``, which imports this module; ``models/ssm.py`` re-exports
it as ``ssd_scan``.  As in the JAX function, ``C·Bᵀ`` is formed in the
inputs' dtype and widened afterwards (the CUDA kernel, like the Pallas one,
widens first), and everything after it runs in fp32.
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
