"""Multi-head Latent Attention (DeepSeek-V3, arXiv:2412.19437), the JAX
package's ``models/mla.py``.

K/V are compressed into a per-token latent c_kv (kv_lora_rank) plus a shared
RoPE key (qk_rope_head_dim).  Prefill expands the latents to heads
(``mla_train``); decode uses the *absorbed* form (``mla_decode``): query
heads are projected into latent space so attention contracts against the
cached latents directly, and the KV-WAL stores only kv_lora_rank + rope
(512 + 64 = 576) dims a token, in two arenas (latent, rope key).

Both are plain products and softmaxes, as in the JAX package, which computes
them outside any kernel; decode does not reach ``tide_attention`` (its
value is the 512-dim latent, above the bf16 kernel's 256 output columns).
"""
from __future__ import annotations

import torch

from .base import ModelConfig
from .layers import apply_rope, attention, init_linear, rms_norm


def init_mla(gen: torch.Generator, cfg: ModelConfig, dtype, *,
             n: tuple = ()) -> dict:
    """One MLA block's weights, stacked over ``n`` (layers)."""
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
    ones = lambda k: torch.ones((*n, k), dtype=dtype, device=gen.device)
    return {
        "wq_a": init_linear(gen, d, m.q_lora_rank, dtype, n=n),
        "q_a_norm": ones(m.q_lora_rank),
        "wq_b": init_linear(gen, m.q_lora_rank, H * qk_hd, dtype, n=n),
        "wkv_a": init_linear(gen, d, m.kv_lora_rank + m.qk_rope_head_dim,
                             dtype, n=n),
        "kv_a_norm": ones(m.kv_lora_rank),
        "wkv_b": init_linear(gen, m.kv_lora_rank,
                             H * (m.qk_nope_head_dim + m.v_head_dim), dtype,
                             n=n),
        "wo": init_linear(gen, H * m.v_head_dim, d, dtype, n=n),
    }


def _scale(cfg: ModelConfig) -> float:
    return (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim) ** -0.5


def _latent(x, w):
    """``x @ w`` into a latent (q's or the KV's), its pending sums done: on
    a mesh that splits ``x``'s hidden dim the product comes out pending a
    sum, and the up-projections that split the heads over the model axis
    then took the heads whole (2.11 all-reduced a batch row's fp32 scores
    over every head); a latent is small, so it is reduced here, as XLA's
    partitioner places the reference's.  A plain tensor is as it was."""
    from repro_torch.distributed.sharding import complete
    return complete(x @ w.to(x.dtype))


def _project_q(params, x, cfg, cos, sin):
    m, H = cfg.mla, cfg.n_heads
    B, S, _ = x.shape
    qa = rms_norm(params["q_a_norm"], _latent(x, params["wq_a"]),
                  cfg.norm_eps)
    q = (qa @ params["wq_b"].to(x.dtype)).reshape(
        B, S, H, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    return q_nope, apply_rope(q_rope, cos, sin)


def compress_kv(params, x, cfg, cos, sin):
    """x → (c_kv (B,S,r), k_rope (B,S,rope)) — the cached latent."""
    m = cfg.mla
    kv = _latent(x, params["wkv_a"])
    c_kv = rms_norm(params["kv_a_norm"], kv[..., :m.kv_lora_rank],
                    cfg.norm_eps)
    k_rope = apply_rope(kv[..., None, m.kv_lora_rank:], cos, sin)
    return c_kv, k_rope[..., 0, :]


def mla_train(params, x, cfg, cos, sin):
    """Full (non-absorbed) path for train/prefill: expand latents to heads.
    → (output (B,S,d), (c_kv, k_rope)) — prefill writes the latter into the
    KV-WAL."""
    m, H = cfg.mla, cfg.n_heads
    B, S, _ = x.shape
    q_nope, q_rope = _project_q(params, x, cfg, cos, sin)
    c_kv, k_rope = compress_kv(params, x, cfg, cos, sin)
    kvb = (c_kv @ params["wkv_b"].to(x.dtype)).reshape(
        B, S, H, m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = kvb[..., :m.qk_nope_head_dim], kvb[..., m.qk_nope_head_dim:]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, m.qk_rope_head_dim)], dim=-1)
    from repro_torch.distributed.sharding import grad_as_value
    o = grad_as_value(attention(q, k, v, causal=True, scale=_scale(cfg),
                                chunk_q=cfg.attn_chunk_q))
    o = o.reshape(B, S, H * m.v_head_dim)
    return grad_as_value(o @ params["wo"].to(x.dtype)), (c_kv, k_rope)


def mla_decode(params, x, cfg, cos, sin, c_cache, rope_cache, kv_len):
    """Absorbed decode: contract queries against cached latents.

    c_cache (B,Skv,r); rope_cache (B,Skv,rope); x (B,1,d); positions at or
    past ``kv_len`` (B,) are masked.  The score is two separate
    contractions (latent and rope), each in fp32 (the JAX package's
    ``preferred_element_type``)."""
    m, H = cfg.mla, cfg.n_heads
    B, S, _ = x.shape
    q_nope, q_rope = _project_q(params, x, cfg, cos, sin)
    # Absorb W_uk into the query: q̃ = q_nope · W_uk → latent space.
    wkv_b = params["wkv_b"].to(x.dtype).reshape(
        m.kv_lora_rank, H, m.qk_nope_head_dim + m.v_head_dim)
    w_uk = wkv_b[..., :m.qk_nope_head_dim]                 # (r,H,nope)
    w_uv = wkv_b[..., m.qk_nope_head_dim:]                 # (r,H,v)
    q_lat = torch.einsum("bshn,rhn->bshr", q_nope, w_uk)   # (B,S,H,r)
    if cfg.decode_q_hd_axis is not None:       # the reference's constraint
        from repro_torch.distributed.sharding import constrain
        ba = cfg.act_batch_axes or ("data",)
        spec = (ba if len(ba) > 1 else ba[0], None, None,
                cfg.decode_q_hd_axis)
        q_lat, q_rope = constrain(q_lat, spec), constrain(q_rope, spec)
    s = (torch.einsum("bshr,btr->bhst", q_lat.float(), c_cache.float())
         + torch.einsum("bshp,btp->bhst", q_rope.float(),
                        rope_cache.float())) * _scale(cfg)
    kv_pos = torch.arange(c_cache.shape[1], device=x.device)
    live = kv_pos[None, :] < kv_len[:, None]               # (B,Skv)
    s = s.masked_fill(~live[:, None, None, :], -1e30)
    p = torch.softmax(s, dim=-1).to(x.dtype)               # (B,H,S,T)
    o_lat = torch.einsum("bhst,btr->bshr", p, c_cache)     # (B,S,H,r)
    o = torch.einsum("bshr,rhv->bshv", o_lat, w_uv)
    o = o.reshape(B, S, H * m.v_head_dim)
    return o @ params["wo"].to(x.dtype)
