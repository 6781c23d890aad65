"""Mixture-of-Experts with GShard-style capacity dispatch (qwen2-moe,
deepseek-v3), the JAX package's ``models/moe.py``.

Tokens are processed in groups of ``group_size``; within each group every
token routes to its top-k experts subject to a per-expert capacity
C = ceil(S·k·cf / E), rounded up to a multiple of 4.  A token's position in
an expert's buffer is the count of earlier tokens of its group routed
there; a token past C is dropped for that expert.  Dispatch and combine
are products against the one-hot dispatch tensor (G, g, E, C), so every
expert computes over its C slots whether they hold a token or not, as in
the JAX package.  Shared experts run densely for every token.

Routing runs in fp32 (the router is an fp32 leaf); the experts' products
run at the activation dtype.  The JAX package's ``dispatch_axes`` pins a
TPU mesh layout and has no meaning on one card: it is accepted and
ignored.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .base import MoEConfig
from .layers import init_linear


def moe_capacity(cfg: MoEConfig) -> int:
    c = math.ceil(cfg.group_size * cfg.top_k * cfg.capacity_factor
                  / cfg.n_experts)
    return max(4, ((c + 3) // 4) * 4)


def init_moe(gen: torch.Generator, d_model: int, cfg: MoEConfig, dtype, *,
             n: tuple = ()) -> dict:
    """Router (always fp32), routed experts (E, d, ff) and, where the config
    has them, the shared experts as one MLP of width n_shared·ff; stacked
    over ``n`` (layers)."""
    ff, E = cfg.expert_d_ff, cfg.n_experts
    p = {"router": init_linear(gen, d_model, E, torch.float32, n=n),
         "we_gate": init_linear(gen, d_model, ff, dtype, n=(*n, E)),
         "we_up": init_linear(gen, d_model, ff, dtype, n=(*n, E)),
         "we_down": init_linear(gen, ff, d_model, dtype, n=(*n, E))}
    if cfg.n_shared:
        sff = (cfg.shared_d_ff or ff) * cfg.n_shared
        p["ws_gate"] = init_linear(gen, d_model, sff, dtype, n=n)
        p["ws_up"] = init_linear(gen, d_model, sff, dtype, n=n)
        p["ws_down"] = init_linear(gen, sff, d_model, dtype, n=n)
    return p


def group_tokens(x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """x (B,S,d) → (G, g, d) with g = min(group_size, B·S).  Raises
    ``ValueError`` where B·S is above the group size and not a multiple of
    it: the JAX package's reshape fails there too, and neither pads."""
    B, S, d = x.shape
    T = B * S
    g = min(cfg.group_size, T)
    if T % g:
        raise ValueError(f"{T} tokens do not split into MoE groups of {g} "
                         f"(group_size {cfg.group_size})")
    return x.reshape(T // g, g, d)


def moe_route(router: torch.Tensor, xg: torch.Tensor, cfg: MoEConfig):
    """Routing of grouped tokens xg (G,g,d) → (dispatch (G,g,E,C) 0/1,
    gates (G,g,E), probs (G,g,E), aux), all fp32.  ``gates`` is zero
    wherever a token does not reach an expert, capacity drops included."""
    E, k, C = cfg.n_experts, cfg.top_k, moe_capacity(cfg)
    logits = xg.float() @ router.float()                       # (G,g,E)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(probs, k, dim=-1)                  # (G,g,k)
    if cfg.router_norm_topk:
        topv = topv / (topv.sum(-1, keepdim=True) + 1e-9)
    # Per-(token, expert) membership and position-in-expert-buffer.
    onehot = F.one_hot(topi, E).float()                        # (G,g,k,E)
    member = onehot.sum(2)                                     # (G,g,E)
    pos = torch.cumsum(member, dim=1) - member                 # pos before me
    keep = member * (pos < C)                                  # capacity drop
    slots = torch.arange(C, device=xg.device, dtype=pos.dtype)
    dispatch = keep[..., None] * (pos[..., None] == slots).float()
    gates = (onehot * topv[..., None]).sum(2) * keep           # (G,g,E)
    # Load-balancing auxiliary loss (Switch-style).
    density = member.mean(1)                                   # (G,E)
    density_proxy = probs.mean(1)
    aux = (density * density_proxy).mean() * (E * E)
    return dispatch, gates, probs, aux


def moe_block(params: dict, x: torch.Tensor, cfg: MoEConfig,
              dispatch_axes=None) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,d) → (y (B,S,d), aux_loss scalar fp32)."""
    B, S, d = x.shape
    xg = group_tokens(x, cfg)
    dispatch, gates, _, aux = moe_route(params["router"], xg, cfg)
    dt = x.dtype
    expert_in = torch.einsum("gsec,gsd->gecd", dispatch.to(dt), xg)
    h = F.silu(torch.einsum("gecd,edf->gecf", expert_in,
                            params["we_gate"].to(dt))) \
        * torch.einsum("gecd,edf->gecf", expert_in, params["we_up"].to(dt))
    expert_out = torch.einsum("gecf,efd->gecd", h,
                              params["we_down"].to(dt))        # (G,E,C,d)
    combine = (dispatch * gates[..., None]).to(dt)
    y = torch.einsum("gsec,gecd->gsd", combine, expert_out)
    if "ws_gate" in params:                                    # shared experts
        sh = F.silu(xg @ params["ws_gate"].to(dt)) \
            * (xg @ params["ws_up"].to(dt))
        y = y + sh @ params["ws_down"].to(dt)
    return y.reshape(B, S, d), aux.float()
