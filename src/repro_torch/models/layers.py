"""Core neural layers (functional style: params are plain dicts of tensors).

Conventions, as in the JAX package's ``models/layers.py``:
- activations run in ``cfg.adtype``, reductions/softmax in fp32;
- weights are ``(d_in, d_out)`` and apply as ``x @ w``, cast at use to the
  activation dtype (a no-op where the caller cast them once);
- attention supports GQA (without materializing repeated KV heads),
  qk-norm and query chunking.

Prefill and training attention is the plain einsum/softmax the JAX package
computes outside any kernel, with griffin's sliding window; decode attention
goes through the ``tide_attention`` kernel instead (``models/serve.py``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (attend_on_heads,
                                              column_parallel_input,
                                              grad_as_value, merge_heads,
                                              project_heads, rows_weight,
                                              whole_mean)


def rms_norm(scale: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm over the last dim, in fp32; the mean of squares whole on
    every device of a mesh (``sharding.whole_mean``)."""
    dt = x.dtype
    x32 = x.float()
    y = x32 * torch.rsqrt(whole_mean(x32 * x32) + eps)
    return (y * scale.float()).to(dt)


def init_linear(gen: torch.Generator, d_in: int, d_out: int, dtype, *,
                n: tuple = (), scale: float = 0.02) -> torch.Tensor:
    """Normal(0, scale²) weights of shape n + (d_in, d_out), drawn in fp32
    on the generator's device; ``n`` stacks layers.  The scale multiplies
    in place, so a leaf takes its own size at init and no more."""
    w = torch.randn((*n, d_in, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return w.mul_(scale).to(dtype)


# --------------------------------------------------------------------- RoPE
def _inv_freq(rotary_dim: int, theta: float, device) -> torch.Tensor:
    # numpy float32, exactly as the JAX package builds it, then moved over.
    half = rotary_dim // 2
    inv = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    return torch.from_numpy(np.asarray(inv, np.float32)).to(device)


def rope_angles(positions: torch.Tensor, rotary_dim: int, theta: float):
    """positions (..., S) → cos/sin (..., S, rotary_dim/2) in fp32."""
    inv = _inv_freq(rotary_dim, theta, positions.device)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x (B,S,H,hd) with half-rotation convention; cos/sin (B,S,half), or
    (1,S,half) broadcast over the batch."""
    half = cos.shape[-1]
    x1, x2 = x[..., :half], x[..., half:2 * half]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    r1 = x1 * c - x2 * s
    r2 = x2 * c + x1 * s
    if x.shape[-1] > 2 * half:
        return torch.cat([r1, r2, x[..., 2 * half:]], dim=-1)
    return torch.cat([r1, r2], dim=-1)


def mrope_angles(positions: torch.Tensor, rotary_dim: int, theta: float,
                 sections: tuple):
    """Qwen2-VL M-RoPE: positions (3,B,S) — temporal/height/width streams.
    Frequency slots are partitioned between the three streams."""
    half = rotary_dim // 2
    inv = _inv_freq(rotary_dim, theta, positions.device)
    sel = np.zeros(half, dtype=np.int64)
    start = 0
    for i, sec in enumerate(sections):
        sel[start:start + sec] = i
        start += sec
    pos = positions.float()                                  # (3,B,S)
    pos_sel = pos[torch.from_numpy(sel).to(positions.device)]  # (half,B,S)
    ang = pos_sel.movedim(0, -1) * inv                       # (B,S,half)
    return torch.cos(ang), torch.sin(ang)


def sinusoidal_embedding(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """Whisper-style absolute sinusoidal embedding, computed on the fly.
    The frequencies' exponent is built in numpy as the JAX package builds
    it, then exponentiated in fp32."""
    half = dim // 2
    expo = -np.log(10000.0) * np.arange(half, dtype=np.float32) \
        / max(half - 1, 1)
    inv = torch.exp(torch.from_numpy(np.asarray(expo, np.float32)).to(
        positions.device))
    ang = positions.float()[..., None] * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def linear(x: torch.Tensor, w: torch.Tensor, dtype=None) -> torch.Tensor:
    """``x @ w`` with ``w`` cast to ``dtype`` (``x``'s by default); on
    DTensors ``w`` whole on each mesh dim that splits ``x``'s batch
    (``sharding.rows_weight``)."""
    w = w.to(dtype or x.dtype)
    return x @ rows_weight(x, w)


# ---------------------------------------------------------------- attention
def _attn_scores_block(q, k, v, mask, scale):
    """q (B,Sq,KH,G,hd), k (B,Skv,KH,hd), v (B,Skv,KH,vd), mask (B,Sq,Skv)
    or (1,Sq,Skv).  Scores in fp32 (the JAX package's preferred_element_type),
    weights cast to v's dtype for the second product, as there."""
    s = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float()) * scale
    s = s.masked_fill(~mask[:, None, None, :, :], -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgqs,bskv->bqkgv", p.to(v.dtype), v)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              chunk_q: int = 0, scale: float | None = None) -> torch.Tensor:
    """Prefill multi-query attention, query and key positions from 0.

    q (B,Sq,H,hd); k,v (B,Skv,KH,*).  GQA is computed by grouping query
    heads (no KV repetition).  Returns (B,Sq,H,vd).  With ``window > 0`` a
    query at position i sees keys at positions > i - window (griffin's
    local attention).  ``scale`` defaults to hd^-½ (MLA passes
    (nope + rope)^-½).  The JAX package's offsets and per-sequence
    kv_len/kv_start serve decode, which goes through ``tide_attention``
    here.  DTensors whose heads a mesh dim splits attend on each device's
    batch rows and query heads (``sharding.attend_on_heads``); plain
    tensors take the products below as they are.
    """
    return attend_on_heads(_attention, q, k, v, causal=causal, window=window,
                           chunk_q=chunk_q, scale=scale)


def _attention(q, k, v, *, causal, window, chunk_q, scale):
    """``attention`` on plain tensors."""
    B, Sq, H, hd = q.shape
    KH = k.shape[2]
    G = H // KH
    vd = v.shape[-1]
    scale = hd ** -0.5 if scale is None else scale
    qg = q.reshape(B, Sq, KH, G, hd)
    Skv = k.shape[1]
    dev = q.device
    kv_pos = torch.arange(Skv, device=dev)[None, None, :]      # (1,1,Skv)

    def mask_for(q_positions):
        # q_positions (1, Sq') → mask (1, Sq', Skv), broadcast over the
        # batch: a plain tensor of the batch's size would be whole on every
        # device of a sharded run.
        m = torch.ones((1, 1, Skv), dtype=torch.bool, device=dev)
        if causal:
            m = m & (kv_pos <= q_positions[..., None])
        if window > 0:
            m = m & (kv_pos > q_positions[..., None] - window)
        return m.expand(1, q_positions.shape[-1], Skv)

    if chunk_q and Sq > chunk_q and Sq % chunk_q == 0:
        outs = []
        for i in range(Sq // chunk_q):
            qp = i * chunk_q + torch.arange(chunk_q, device=dev)[None]
            outs.append(_attn_scores_block(
                qg[:, i * chunk_q:(i + 1) * chunk_q], k, v, mask_for(qp),
                scale))
        o = torch.cat(outs, dim=1)
    else:
        q_positions = torch.arange(Sq, device=dev)[None]
        o = _attn_scores_block(qg, k, v, mask_for(q_positions), scale)
    return o.reshape(B, Sq, H, vd)


def qkv_proj(params: dict, x: torch.Tensor, cfg, cos=None, sin=None):
    """x (B,S,d) → q (B,S,H,hd), k and v (B,S,KH,hd): projected, qk-normed
    where the config has it (qwen3), q and k rotated where angles are given.
    Prefill and decode share it; they differ only in how they attend.  On
    DTensors whose query heads split unevenly (not in a decode step), k and
    v come one copy for each of a device's query heads, (B,S,H,hd), for
    the attention (``sharding.project_heads``)."""
    H, KH = cfg.n_heads, cfg.n_kv_heads
    x = column_parallel_input(x, params["wq"])
    q, k, v = (project_heads(linear, x, params[w], n, H, per_query=True)
               for w, n in (("wq", H), ("wk", KH), ("wv", KH)))
    if "q_norm" in params:
        q = rms_norm(params["q_norm"], q, cfg.norm_eps)
        k = rms_norm(params["k_norm"], k, cfg.norm_eps)
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def gqa_block(params: dict, x: torch.Tensor, cfg, *, cos=None, sin=None,
              window: int = 0):
    """Causal (G)QA self-attention: projection, attention, output.  Returns
    (output (B,S,d), the rotated (k, v)) — prefill writes the latter into
    the KV-WAL."""
    (q, k, v), kv = _projections(params, x, cfg, cos, sin)
    o = attention(q, k, v, causal=cfg.causal, window=window,
                  chunk_q=cfg.attn_chunk_q)
    return grad_as_value(merge_heads(linear, o, params["wo"])), kv


def _projections(params: dict, x: torch.Tensor, cfg, cos, sin):
    """(``qkv_proj``'s q, k and v; the k and v (B,S,KH,hd) a prefill
    caches): k and v themselves, or where they came one copy a query head
    (heads split unevenly over a mesh), k and v projected again on their
    own KV heads.  The input placed for the projections is freed on
    return, before the attention."""
    x = column_parallel_input(x, params["wq"])
    q, k, v = qkv_proj(params, x, cfg, cos, sin)
    if k.shape[2] == cfg.n_kv_heads:
        return (q, k, v), (k, v)
    ck, cv = (project_heads(linear, x, params[w], cfg.n_kv_heads,
                            cfg.n_heads) for w in ("wk", "wv"))
    if "k_norm" in params:
        ck = rms_norm(params["k_norm"], ck, cfg.norm_eps)
    if cos is not None:
        ck = apply_rope(ck, cos, sin)
    return (q, k, v), (ck, cv)


def cross_attention(params: dict, x: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, cfg) -> torch.Tensor:
    """Attention of x (B,S,d) over encoder K/V (B,Senc,KH,hd), no mask and
    no rotation (whisper's decoder) → (B,S,d)."""
    x = column_parallel_input(x, params["wq"])
    q = project_heads(linear, x, params["wq"], cfg.n_heads, cfg.n_heads)
    o = attention(q, k, v, causal=False, chunk_q=cfg.attn_chunk_q)
    return grad_as_value(merge_heads(linear, o, params["wo"]))


def cross_kv(params: dict, enc: torch.Tensor, cfg, dtype):
    """Encoder states (B,Senc,encoder_dim) → cross-attention (K, V), each
    (B,Senc,KH,hd) in ``dtype``."""
    enc = column_parallel_input(enc, params["wk"])
    return tuple(project_heads(lambda t, w: linear(t, w, dtype), enc,
                               params[w], cfg.n_kv_heads, cfg.n_heads)
                 for w in ("wk", "wv"))


def init_gqa(gen: torch.Generator, cfg, dtype, *, n: tuple = (),
             cross: bool = False) -> dict:
    """GQA weights, stacked over ``n`` (layers).  With ``cross`` the K/V
    projections read encoder states of ``cfg.encoder_dim`` (whisper)."""
    H, KH, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_model
    d_kv = (cfg.encoder_dim or d) if cross else d
    p = {"wq": init_linear(gen, d, H * hd, dtype, n=n),
         "wk": init_linear(gen, d_kv, KH * hd, dtype, n=n),
         "wv": init_linear(gen, d_kv, KH * hd, dtype, n=n),
         "wo": init_linear(gen, H * hd, d, dtype, n=n)}
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((*n, hd), dtype=dtype, device=gen.device)
        p["k_norm"] = torch.ones((*n, hd), dtype=dtype, device=gen.device)
    return p


# --------------------------------------------------------------------- MLPs
def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation; so does the port.
    return F.gelu(x, approximate="tanh")


def mlp_block(params: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    x = column_parallel_input(x, params["w_up"])
    if act in ("silu", "geglu"):                    # SwiGLU / gated-GELU
        fn = F.silu if act == "silu" else _gelu
        g = fn(linear(x, params["w_gate"]))
        u = linear(x, params["w_up"])
        return grad_as_value(linear(g * u, params["w_down"]))
    h = _gelu(linear(x, params["w_up"]))
    return grad_as_value(linear(h, params["w_down"]))


def init_mlp(gen: torch.Generator, d: int, ff: int, act: str, dtype, *,
             n: tuple = ()) -> dict:
    """MLP weights, stacked over ``n`` (layers)."""
    p = {"w_up": init_linear(gen, d, ff, dtype, n=n),
         "w_down": init_linear(gen, ff, d, dtype, n=n)}
    if act in ("silu", "geglu"):
        p["w_gate"] = init_linear(gen, d, ff, dtype, n=n)
    return p
