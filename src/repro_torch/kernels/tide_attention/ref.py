"""Plain PyTorch version of tide_attention: gather the arena through the
table, mask, softmax in fp32, cast to ``q.dtype``.

It follows the JAX package's ``tide_attention/ref.py`` with one exception:
a row with no live position (``seq_len == 0``, or every position below
``first_live`` or outside the window) returns 0, where the JAX oracle
takes a softmax over a row of -1e30 scores and returns the mean of every V
row.  The CUDA kernel (``kernel.py``) returns 0 there too.

``tide_attention_split_ref`` computes the same function the way the kernel
does: S slices of R-position tiles of each row's live range, each with its
own (m, l, acc), then the merge.  Only the tests use it.
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


def split_bounds(seq_lens: torch.Tensor, first_live: torch.Tensor,
                 n_pos: int, window: int, S: int, R: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, S) first and end positions of each slice, as the kernel cuts
    them: the live range [lo, hi) in tiles of R aligned to R, slice s taking
    tiles [t0 + s n // S, t0 + (s + 1) n // S).  A slice may reach outside
    [lo, hi) at its edge tiles, whose dead positions the mask drops."""
    lens = seq_lens.long()
    lo = first_live.long().clamp(min=0)
    if window > 0:
        lo = torch.maximum(lo, lens - window)
    hi = lens.clamp(max=n_pos)
    t0 = lo // R
    n = torch.where(lo < hi, -(-hi // R) - t0, torch.zeros_like(lo))
    s = torch.arange(S + 1, device=lens.device)
    edges = (t0[:, None] + s[None] * n[:, None] // S) * R
    return edges[:, :-1], edges[:, 1:]


def tide_attention_split_ref(q, arena_k, arena_v, table, seq_lens,
                             first_live, *, window: int = 0, scale=None,
                             S: int, R: int):
    """``tide_attention_ref`` computed as S slices of R-position tiles, each
    with its running maximum m, sum l and unnormalised accumulator, merged
    by rescaling to the common maximum; a slice with no live position has
    m = -inf and l = 0 and weighs nothing, and a row whose slices all have
    l = 0 gives 0.  In fp32, cast to ``q.dtype``."""
    B, H, dk = q.shape
    _, NB, blk, KH, _ = arena_k.shape
    dv = arena_v.shape[-1]
    G = H // KH
    n_pos = NB * blk
    scale = dk ** -0.5 if scale is None else scale

    bidx = torch.arange(B, device=q.device)[:, None]
    tbl = table.long()
    k = arena_k[bidx, tbl].reshape(B, n_pos, KH, dk).float()
    v = arena_v[bidx, tbl].reshape(B, n_pos, KH, dv).float()
    qg = q.reshape(B, KH, G, dk).float()
    sc = torch.einsum("bkgd,bskd->bkgs", qg, k) * scale
    live = live_mask(seq_lens, first_live, n_pos, window)      # (B, P)
    first, end = split_bounds(seq_lens, first_live, n_pos, window, S, R)
    pos = torch.arange(n_pos, device=q.device)
    in_slice = (pos >= first[..., None]) & (pos < end[..., None])  # (B,S,P)
    mask = (live[:, None] & in_slice)[:, :, None, None]       # (B,S,1,1,P)
    neg = torch.tensor(float("-inf"), device=q.device)
    s_sl = torch.where(mask, sc[:, None], neg)                 # (B,S,KH,G,P)
    m = s_sl.amax(-1)                                          # (B,S,KH,G)
    m_use = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(mask, torch.exp(s_sl - m_use[..., None]),
                    torch.zeros_like(s_sl))
    l = p.sum(-1)
    acc = torch.einsum("bnkgs,bskd->bnkgd", p, v)              # (B,S,KH,G,dv)

    has = l > 0
    top = torch.where(has, m, neg).amax(1, keepdim=True)       # (B,1,KH,G)
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    w = torch.where(has, torch.exp(m_use - top), torch.zeros_like(m))
    den = (w * l).sum(1)                                       # (B,KH,G)
    num = (w[..., None] * acc).sum(1)                          # (B,KH,G,dv)
    o = torch.where(den[..., None] > 0, num / den.clamp(min=1e-30)[..., None],
                    torch.zeros_like(num))
    return o.reshape(B, H, dv).to(q.dtype)
