"""Mamba-2 SSD layer (state-space duality, arXiv:2405.21060).

The JAX package's ``models/ssm.py``, leaf for leaf.  Prefill and forward run
the chunked SSD through ``ops.ssd``: kernel E (``csrc/ssd_scan.cu``) on the
card, its plain version (``ssd_scan``, re-exported here) on the CPU.
Training asks for the plain version on every device
(``ssm_block(..., differentiable=True)``): E's outputs carry no gradient,
and the JAX package trains through its plain ``ssd_scan`` too.  Decode
is the O(1) recurrent update in plain tensor ops, as in the JAX package,
which has no kernel there.  Projections stay separate matrices (``in_z``,
``in_x``, ``in_bc``, ``in_dt``), as there.

Dtypes follow the JAX package: ``dt`` is the softplus of an fp32 sum,
``A = -exp(A_log)`` is fp32, ``D`` and the conv weights are cast to the
activation dtype at use, and the SSD state is fp32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan.ops import ssd
from repro_torch.kernels.ssd_scan.ref import ssd_scan

from .base import ModelConfig
from .layers import init_linear, rms_norm


def ssm_dims(cfg: ModelConfig):
    """(d_inner, n_heads, width of the B/C projection)."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return d_inner, d_inner // s.head_dim, 2 * s.d_state


def init_ssm(gen: torch.Generator, cfg: ModelConfig, dtype, *,
             n: tuple = ()) -> dict:
    """One Mamba-2 block's parameters, stacked over ``n`` (layers)."""
    s, d, dev = cfg.ssm, cfg.d_model, gen.device
    d_inner, n_heads, bc_dim = ssm_dims(cfg)

    def conv(width):
        w = torch.randn((*n, s.d_conv, width), generator=gen, device=dev)
        return (w * 0.1).to(dtype)

    zeros = lambda w, dt=dtype: torch.zeros((*n, w), dtype=dt, device=dev)
    ones = lambda w: torch.ones((*n, w), dtype=dtype, device=dev)
    return {
        "in_z": init_linear(gen, d, d_inner, dtype, n=n),
        "in_x": init_linear(gen, d, d_inner, dtype, n=n),
        "in_bc": init_linear(gen, d, bc_dim, dtype, n=n),
        "in_dt": init_linear(gen, d, n_heads, dtype, n=n),
        "conv_x_w": conv(d_inner),
        "conv_x_b": zeros(d_inner),
        "conv_bc_w": conv(bc_dim),
        "conv_bc_b": zeros(bc_dim),
        "A_log": zeros(n_heads, torch.float32),           # A = -exp(A_log)
        "dt_bias": zeros(n_heads, torch.float32),
        "D": ones(n_heads),
        "norm": ones(d_inner),
        "out_proj": init_linear(gen, d_inner, d, dtype, n=n),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv over the sequence, then SiLU.  u (B,L,C);
    w (K,C).  Returns (y (B,L,C), new_state (B,K-1,C))."""
    K, L = w.shape[0], u.shape[1]
    if state is None:
        pad = torch.zeros((u.shape[0], K - 1, u.shape[2]), dtype=u.dtype,
                          device=u.device)
    else:
        pad = state.to(u.dtype)
    full = torch.cat([pad, u], dim=1)
    y = sum(full[:, i:i + L, :] * w[i] for i in range(K))
    return F.silu(y + b), full[:, -(K - 1):, :]


def ssm_block(params: dict, x: torch.Tensor, cfg: ModelConfig,
              conv_x_state=None, conv_bc_state=None, ssm_state=None,
              decode: bool = False, differentiable: bool = False):
    """Full Mamba-2 block.  ``differentiable`` runs the chunked SSD as the
    plain ``ssd_scan``, which autograd differentiates, where ``ops.ssd``
    launches kernel E on the card.
    Returns (y, (new_conv_x, new_conv_bc, new_ssm_state))."""
    s = cfg.ssm
    d_inner, n_heads, _ = ssm_dims(cfg)
    B, L, _ = x.shape
    dt_ = x.dtype
    z = x @ params["in_z"].to(dt_)
    xin = x @ params["in_x"].to(dt_)
    bc = x @ params["in_bc"].to(dt_)
    dt_raw = x @ params["in_dt"].to(dt_)
    xin, new_conv_x = _causal_conv(xin, params["conv_x_w"].to(dt_),
                                   params["conv_x_b"].to(dt_), conv_x_state)
    bc, new_conv_bc = _causal_conv(bc, params["conv_bc_w"].to(dt_),
                                   params["conv_bc_b"].to(dt_), conv_bc_state)
    xs = xin.reshape(B, L, n_heads, s.head_dim)
    Bm = bc[..., :s.d_state]
    Cm = bc[..., s.d_state:]
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])

    if decode:
        # O(1) recurrent update: h' = exp(dt·A) h + dt·B⊗x ; y = C·h
        assert L == 1
        # Broadcasts and a batched product where the JAX package writes
        # einsums: torch.einsum searches a contraction path on the host at
        # every call, which cost more host time than the rest of the layer.
        dA = torch.exp(dt[:, 0] * A[None, :])                # (B,h)
        xdt = xs[:, 0].float() * dt[:, 0, :, None]           # (B,h,p)
        dBx = xdt[..., None] * Bm[:, 0].float()[:, None, None, :]
        h = ssm_state.float() * dA[..., None, None] + dBx    # (B,h,p,n)
        y = (h @ Cm[:, 0].float()[:, None, :, None])[..., 0]
        y = y[:, None].to(dt_)
        new_ssm = h
    else:
        scan = ssd_scan if differentiable else ssd
        y, new_ssm = scan(xs, dt, A, Bm, Cm, chunk=s.chunk_size,
                          init_state=ssm_state)
    y = y + xs * params["D"].to(dt_)[None, None, :, None]
    y = y.reshape(B, L, d_inner)
    y = rms_norm(params["norm"], y * F.silu(z), cfg.norm_eps)
    return (y @ params["out_proj"].to(dt_),
            (new_conv_x, new_conv_bc, new_ssm))
