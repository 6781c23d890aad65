"""Serving paths of the dense family: prefill and single-token decode over the
Tidehunter KV-WAL.

- ``cache_spec(cfg, batch, max_seq)`` → {name: (shape, dtype)}
- ``init_cache(cfg, batch, max_seq, device)`` → zeroed cache, identity table
- ``prefill(params, cfg, batch_inputs, max_seq)`` → (last-token logits, cache)
- ``decode_step(params, cfg, cache, tokens)`` → (logits, cache)

Decode reads K/V *through* the KV-WAL slot table inside the
``tide_attention`` kernel (``kernels/tide_attention``), with the
per-sequence ``first_live`` epoch watermark masking pruned segments; the
JAX package gathers the arena and runs dense attention there.  Both write
each token's K/V entry once and never move it.  Arena writes happen in
place: the cache returned shares its arenas with the cache passed in.
"""
from __future__ import annotations

import torch

from repro_torch.core import kvwal
from repro_torch.kernels.tide_attention.ops import decode_attention

from .base import ModelConfig
from .layers import gqa_block, mlp_block, qkv_proj, rms_norm
from .transformer import (_angles, embed_tokens, layer, lm_logits,
                          require_dense, with_vision)


# ------------------------------------------------------------- cache shapes
def kv_entry_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    """(kv_heads, k_dim, v_dim) of one KV-WAL slot value, striped across two
    parallel arenas (K and V)."""
    if cfg.mla is not None:
        return 1, cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim
    return cfg.n_kv_heads, cfg.hd, cfg.hd


def cache_spec(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """{name: (shape, dtype)} of the dense family's serving cache."""
    require_dense(cfg)
    kh, kd, vd = kv_entry_dims(cfg)
    mk = lambda d: kvwal.KVWalSpec(
        n_layers=cfg.n_layers, batch=batch, max_seq=max_seq, kv_heads=kh,
        entry_dim=d, block_size=cfg.kv_block, dtype=cfg.dtype)
    ks, vs = mk(kd), mk(vd)
    return {"arena_k": (ks.arena_shape(), cfg.adtype),
            "arena_v": (vs.arena_shape(), cfg.adtype),
            "table": ((batch, ks.n_blocks), torch.int32),
            "seq_lens": ((batch,), torch.int32),
            "first_live": ((batch,), torch.int32)}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device="cpu") -> dict:
    cache = {k: torch.zeros(shape, dtype=dt, device=device)
             for k, (shape, dt) in cache_spec(cfg, batch, max_seq).items()}
    cache["table"] = kvwal.identity_table(*cache["table"].shape, device)
    return cache


# ------------------------------------------------------------------- decode
def _self_attn_decode(cfg: ModelConfig, layer_p, h, arena_k, arena_v, table,
                      seq_lens, first_live, cos, sin, window: int = 0):
    """One decode self-attention through the KV-WAL.  h (B,1,d); the new
    token's K/V entry is appended to the layer arenas in place, then the
    ``tide_attention`` kernel reads every live entry through the table."""
    p = layer_p["attn"]
    q, k, v = qkv_proj(p, h, cfg, cos, sin)
    kvwal.append_token(arena_k, table, seq_lens, k[:, 0])
    kvwal.append_token(arena_v, table, seq_lens, v[:, 0])
    o = decode_attention(q[:, 0].contiguous(), arena_k, arena_v, table,
                         seq_lens + 1, first_live, window=window,
                         scale=cfg.hd ** -0.5)
    return o.reshape(h.shape[0], 1, -1) @ p["wo"].to(h.dtype)


def decode_step(params, cfg: ModelConfig, cache: dict, tokens: torch.Tensor,
                mrope_positions=None) -> tuple[torch.Tensor, dict]:
    """One new token per sequence.  tokens (B,) → logits (B, V)."""
    require_dense(cfg)
    x = embed_tokens(params, cfg, tokens[:, None])
    seq_lens = cache["seq_lens"]
    cos, sin = _angles(cfg, seq_lens[:, None], mrope_positions)
    for i in range(cfg.n_layers):
        layer_p = layer(params["layers"], i)
        h = rms_norm(layer_p["ln1"], x, cfg.norm_eps)
        x = x + _self_attn_decode(
            cfg, layer_p, h, cache["arena_k"][i], cache["arena_v"][i],
            cache["table"], seq_lens, cache["first_live"], cos, sin)
        h = rms_norm(layer_p["ln2"], x, cfg.norm_eps)
        x = x + mlp_block(layer_p["mlp"], h, cfg.act)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return lm_logits(params, cfg, x)[:, 0], dict(cache, seq_lens=seq_lens + 1)


# ------------------------------------------------------------------ prefill
def prefill(params, cfg: ModelConfig, batch: dict, max_seq: int
            ) -> tuple[torch.Tensor, dict]:
    """Run the prompt, writing every position's KV entry into a fresh
    KV-WAL arena (write-once: these bytes never move again)."""
    require_dense(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = with_vision(cfg, embed_tokens(params, cfg, tokens),
                    batch.get("vision_embed"))
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    cache = init_cache(cfg, B, max_seq, x.device)
    cos, sin = _angles(cfg, positions, batch.get("mrope_positions"))
    for i in range(cfg.n_layers):
        layer_p = layer(params["layers"], i)
        h = rms_norm(layer_p["ln1"], x, cfg.norm_eps)
        out, (k, v) = gqa_block(layer_p["attn"], h, cfg, cos=cos, sin=sin)
        kvwal.write_prefill(cache["arena_k"][i], k)
        kvwal.write_prefill(cache["arena_v"][i], v)
        x = x + out
        h = rms_norm(layer_p["ln2"], x, cfg.norm_eps)
        x = x + mlp_block(layer_p["mlp"], h, cfg.act)
    cache["seq_lens"].fill_(S)
    x = rms_norm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    return lm_logits(params, cfg, x)[:, 0], cache
