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
run at the activation dtype.  ``dispatch_axes = (group_axis, expert_axis)``
pins the expert-parallel layout of the (G,E,C,d) buffers, as in the JAX
package: on DTensors they are redistributed to it (``_wsc``), on plain
tensors nothing changes.
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


def _wsc(x, spec):
    """The reference's sharding constraint: a DTensor is redistributed to
    ``spec``; a plain tensor is returned as it is."""
    from repro_torch.distributed.sharding import constrain
    return constrain(x, tuple(spec))


def _experts(expert_in, we_gate, we_up, we_down):
    """Every expert's SwiGLU over its slots: expert_in (G,E,C,d) →
    (G,E,C,d) in expert_in's dtype."""
    dt = expert_in.dtype
    h = F.silu(torch.einsum("gecd,edf->gecf", expert_in, we_gate.to(dt))) \
        * torch.einsum("gecd,edf->gecf", expert_in, we_up.to(dt))
    return torch.einsum("gecf,efd->gecd", h, we_down.to(dt))


def moe_block(params: dict, x: torch.Tensor, cfg: MoEConfig,
              dispatch_axes=None) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,d) → (y (B,S,d), aux_loss scalar fp32).

    ``dispatch_axes = (group_axis, expert_axis)``: groups shard over the
    data axis, experts over the model axis (the canonical MoE all-to-all)."""
    from repro_torch.distributed.sharding import (experts_as_weight,
                                                  grad_rows_viewable,
                                                  rows_on_shards,
                                                  rows_viewable)
    B, S, d = x.shape
    xg = grad_rows_viewable(group_tokens(x, cfg), B)
    dispatch, gates, _, aux = moe_route(params["router"], xg, cfg)
    dt = x.dtype
    expert_in = torch.einsum("gsec,gsd->gecd", dispatch.to(dt), xg)
    if dispatch_axes is not None:
        ga, ea = dispatch_axes
        expert_in = _wsc(expert_in, (ga, ea, None, None))
    expert_in = experts_as_weight(expert_in, params["we_gate"])
    expert_out = rows_on_shards(_experts, expert_in, params["we_gate"],
                                params["we_up"], params["we_down"])
    expert_out = experts_as_weight(expert_out, params["we_down"])
    if dispatch_axes is not None:
        expert_out = _wsc(expert_out, (dispatch_axes[0], dispatch_axes[1],
                                       None, None))
    combine = (dispatch * gates[..., None]).to(dt)
    y = torch.einsum("gsec,gecd->gsd", combine, expert_out)
    if "ws_gate" in params:                                    # shared experts
        sh = F.silu(xg @ params["ws_gate"].to(dt)) \
            * (xg @ params["ws_up"].to(dt))
        y = y + sh @ params["ws_down"].to(dt)
    return rows_viewable(y, B).reshape(B, S, d), aux.float()
