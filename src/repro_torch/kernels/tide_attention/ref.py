"""Plain PyTorch version of tide_attention: gather the arena through the
table, mask, softmax in fp32, cast to ``q.dtype``.

It follows the JAX package's ``tide_attention/ref.py`` with one exception:
a row with no live position (``seq_len == 0``, or every position below
``first_live`` or outside the window) returns 0, where the JAX oracle
takes a softmax over a row of -1e30 scores and returns the mean of every V
row.  The CUDA kernel (``kernel.py``) returns 0 there too.
"""
from __future__ import annotations

import torch


def live_mask(seq_lens: torch.Tensor, first_live: torch.Tensor, n_pos: int,
              window: int = 0) -> torch.Tensor:
    """(B, n_pos) bool: position p is live iff first_live ≤ p < seq_len and,
    with a window, p > seq_len - 1 - window."""
    pos = torch.arange(n_pos, device=seq_lens.device)[None, :]
    lens = seq_lens[:, None].long()
    mask = (pos < lens) & (pos >= first_live[:, None].long())
    if window > 0:
        mask &= pos > lens - 1 - window
    return mask


def tide_attention_ref(q, arena_k, arena_v, table, seq_lens, first_live,
                       *, window: int = 0, scale=None):
    """q (B,H,dk); arena_k (B,NB,blk,KH,dk); arena_v (B,NB,blk,KH,dv);
    table (B,NB) i32; seq_lens/first_live (B,) i32 → (B,H,dv) in q's dtype."""
    B, H, dk = q.shape
    _, NB, blk, KH, _ = arena_k.shape
    dv = arena_v.shape[-1]
    G = H // KH
    scale = dk ** -0.5 if scale is None else scale

    bidx = torch.arange(B, device=q.device)[:, None]
    tbl = table.long()
    k = arena_k[bidx, tbl].reshape(B, NB * blk, KH, dk).float()
    v = arena_v[bidx, tbl].reshape(B, NB * blk, KH, dv).float()
    qg = q.reshape(B, KH, G, dk).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k) * scale
    mask = live_mask(seq_lens, first_live, NB * blk, window)[:, None, None, :]
    p = torch.softmax(s.masked_fill(~mask, -1e30), dim=-1)
    p = p * mask                        # an empty row attends to nothing
    o = torch.einsum("bkgs,bskd->bkgd", p, v)
    return o.reshape(B, H, dv).to(q.dtype)
