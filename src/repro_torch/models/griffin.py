"""RecurrentGemma / Griffin blocks (arXiv:2402.19427).

The JAX package's ``models/griffin.py``, leaf for leaf.  Layer pattern
(rec, rec, attn): two RG-LRU recurrent blocks per local-MQA attention block.
The RG-LRU is a gated linear recurrence
    h_t = a_t ⊙ h_{t-1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t),  a_t = a^(c·r_t)
computed over the whole prompt by a log-depth (Hillis–Steele) scan of tensor
ops, where the JAX package calls ``associative_scan``, and by the O(1)
update in decode.  The gates ``w_r``, ``w_i`` and their biases and ``lam``
apply in fp32, as there.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (column_parallel_input,
                                              grad_as_value)

from .base import ModelConfig
from .layers import _gelu, init_linear, linear


def lru_width(cfg: ModelConfig) -> int:
    return cfg.griffin.lru_width or cfg.d_model


def init_recurrent_block(gen: torch.Generator, cfg: ModelConfig, dtype, *,
                         n: tuple = ()) -> dict:
    """One recurrent block's parameters, stacked over ``n``."""
    d, w, g, dev = cfg.d_model, lru_width(cfg), cfg.griffin, gen.device
    conv_w = torch.randn((*n, g.conv_width, w), generator=gen, device=dev)
    f32 = lambda v: torch.full((*n, w), v, dtype=torch.float32, device=dev)
    return {
        "w_gate_in": init_linear(gen, d, w, dtype, n=n),   # GELU branch
        "w_rec_in": init_linear(gen, d, w, dtype, n=n),    # recurrent branch
        "conv_w": (conv_w * 0.1).to(dtype),
        "conv_b": torch.zeros((*n, w), dtype=dtype, device=dev),
        "w_r": init_linear(gen, w, w, dtype, n=n),         # recurrence gate
        "b_r": f32(0.0),
        "w_i": init_linear(gen, w, w, dtype, n=n),         # input gate
        "b_i": f32(0.0),
        "lam": f32(2.0),                                   # Λ (a = σ(Λ))
        "w_out": init_linear(gen, w, d, dtype, n=n),
    }


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along dim 1 with h_{-1} = 0, by doubling:
    after the step of offset k each position holds the composition of the
    (up to) 2k steps ending there.  log2(L) rounds of elementwise ops."""
    L = a.shape[1]
    k = 1
    while k < L:
        a_prev, b_prev = a[:, :-k], b[:, :-k]
        b = torch.cat([b[:, :k], b_prev * a[:, k:] + b[:, k:]], dim=1)
        a = torch.cat([a[:, :k], a_prev * a[:, k:]], dim=1)
        k *= 2
    return b


def _rg_lru(params, x: torch.Tensor, cfg: ModelConfig, state=None):
    """x (B,L,w) → (y, final_state (B,w) fp32)."""
    c = cfg.griffin.c_constant
    x32 = x.float()
    r = torch.sigmoid(x32 @ params["w_r"].float() + params["b_r"])
    i = torch.sigmoid(x32 @ params["w_i"].float() + params["b_i"])
    log_a = -c * r * F.softplus(params["lam"])[None, None, :]
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * x32)
    if x.shape[1] == 1 and state is not None:              # decode: O(1)
        h = a[:, 0] * state.float() + gated[:, 0]
        return h[:, None].to(x.dtype), h
    if state is not None:
        gated = torch.cat([gated[:, :1] + a[:, :1] * state.float()[:, None],
                           gated[:, 1:]], dim=1)
    h = linear_scan(a, gated)
    return h.to(x.dtype), h[:, -1]


def recurrent_block(params: dict, x: torch.Tensor, cfg: ModelConfig,
                    conv_state=None, lru_state=None):
    """Griffin recurrent block.  Returns (y, (new_conv, new_lru))."""
    x = column_parallel_input(x, params["w_rec_in"])
    g = _gelu(linear(x, params["w_gate_in"]))
    u = linear(x, params["w_rec_in"])
    K, L = params["conv_w"].shape[0], u.shape[1]
    if conv_state is None:
        pad = torch.zeros((u.shape[0], K - 1, u.shape[2]), dtype=u.dtype,
                          device=u.device)
    else:
        pad = conv_state.to(u.dtype)
    full = torch.cat([pad, u], dim=1)
    conv = sum(full[:, j:j + L, :] * params["conv_w"][j].to(u.dtype)
               for j in range(K)) + params["conv_b"].to(u.dtype)
    new_conv = full[:, -(K - 1):, :]
    h, new_lru = _rg_lru(params, conv, cfg, lru_state)
    return grad_as_value(linear(g * h, params["w_out"])), \
        (new_conv, new_lru)
