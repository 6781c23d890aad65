"""Serving paths: prefill and single-token decode over the Tidehunter KV-WAL
(dense, vlm, moe — GQA or MLA — whisper's decoder and griffin's local
attention) and over fixed-size recurrent states (ssm, griffin's recurrent
blocks).

- ``cache_spec(cfg, batch, max_seq)`` → {name: (shape, dtype)}
- ``init_cache(cfg, batch, max_seq, device)`` → zeroed cache, identity table
- ``prefill(params, cfg, batch_inputs, max_seq)`` → (last-token logits, cache)
- ``decode_step(params, cfg, cache, tokens)`` → (logits, cache)

GQA decode reads K/V *through* the KV-WAL slot table inside the
``tide_attention`` kernel (``kernels/tide_attention``), with the
per-sequence ``first_live`` epoch watermark masking pruned segments and, for
griffin, the sliding window; the JAX package gathers the arena and runs
dense attention there.  Both write each token's K/V entry once and never
move it.  MLA's decode keeps the JAX package's form: the latent and rope
arenas are gathered through the table and the absorbed contractions run as
plain products, masked at the sequence length only.  Whisper's
cross-attention K/V are computed once at prefill from the encoder output
and kept in the cache as ``cross_k`` / ``cross_v``.  Griffin's decode
advances ``first_live`` past the blocks that fall wholly behind the
window.  Mamba-2's prefill runs the SSD scan through
kernel E (``kernels/ssd_scan``); its decode is the O(1) recurrent update.
Cache writes happen in place: the cache returned shares its arenas and
recurrent states with the cache passed in.
"""
from __future__ import annotations

import torch

from repro_torch.core import kvwal
from repro_torch.kernels.tide_attention.ops import decode_attention

from .base import ModelConfig
from .griffin import lru_width, recurrent_block
from .layers import (cross_attention, mlp_block, qkv_proj, rms_norm,
                     sinusoidal_embedding)
from .mla import compress_kv, mla_decode
from .ssm import ssm_block, ssm_dims
from .transformer import (_angles, embed_tokens, encode, ffn, griffin_block,
                          griffin_blocks, griffin_layout, layer, lm_logits,
                          require_family, self_attention, whisper_layer,
                          with_vision)


# ------------------------------------------------------------- cache shapes
def kv_entry_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    """(kv_heads, k_dim, v_dim) of one KV-WAL slot value, striped across two
    parallel arenas (K and V)."""
    if cfg.mla is not None:
        return 1, cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim
    return cfg.n_kv_heads, cfg.hd, cfg.hd


def _wal_spec(cfg: ModelConfig, batch: int, max_seq: int,
              n_layers: int) -> dict:
    kh, kd, vd = kv_entry_dims(cfg)
    mk = lambda d: kvwal.KVWalSpec(
        n_layers=n_layers, batch=batch, max_seq=max_seq, kv_heads=kh,
        entry_dim=d, block_size=cfg.kv_block, dtype=cfg.dtype)
    ks, vs = mk(kd), mk(vd)
    return {"arena_k": (ks.arena_shape(), cfg.adtype),
            "arena_v": (vs.arena_shape(), cfg.adtype),
            "table": ((batch, ks.n_blocks), torch.int32),
            "seq_lens": ((batch,), torch.int32),
            "first_live": ((batch,), torch.int32)}


def cache_spec(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """{name: (shape, dtype)} of the serving cache, with the JAX package's
    names and shapes."""
    require_family(cfg)
    dt = cfg.adtype
    if cfg.family == "ssm":
        d_inner, nh, bc_dim = ssm_dims(cfg)
        s, L = cfg.ssm, cfg.n_layers
        return {"conv_x": ((L, batch, s.d_conv - 1, d_inner), dt),
                "conv_bc": ((L, batch, s.d_conv - 1, bc_dim), dt),
                "state": ((L, batch, nh, s.head_dim, s.d_state),
                          torch.float32),
                "seq_lens": ((batch,), torch.int32)}
    if cfg.family == "encdec":
        spec = _wal_spec(cfg, batch, max_seq, cfg.n_layers)
        kh, kd, vd = kv_entry_dims(cfg)
        enc = (cfg.n_layers, batch, cfg.encoder_seq, kh)
        spec["cross_k"] = ((*enc, kd), dt)
        spec["cross_v"] = ((*enc, vd), dt)
        return spec
    if cfg.family != "griffin":
        return _wal_spec(cfg, batch, max_seq, cfg.n_layers)
    g = cfg.griffin
    n_groups, n_tail = griffin_layout(cfg)
    n_rec = sum(1 for k in g.pattern if k == "rec")
    w = lru_width(cfg)
    spec = _wal_spec(cfg, batch, max_seq, n_groups)
    spec["conv"] = ((n_groups, n_rec, batch, g.conv_width - 1, w), dt)
    spec["lru"] = ((n_groups, n_rec, batch, w), torch.float32)
    one = _wal_spec(cfg, batch, max_seq, 1)
    for i in range(n_tail):
        if g.pattern[i % len(g.pattern)] == "rec":
            spec[f"tail{i}_conv"] = ((batch, g.conv_width - 1, w), dt)
            spec[f"tail{i}_lru"] = ((batch, w), torch.float32)
        else:
            for k in ("arena_k", "arena_v"):
                shape, adt = one[k]
                spec[f"tail{i}_{k}"] = (shape[1:], adt)
    return spec


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device="cuda") -> dict:
    cache = {k: torch.zeros(shape, dtype=dt, device=device)
             for k, (shape, dt) in cache_spec(cfg, batch, max_seq).items()}
    if "table" in cache:
        cache["table"] = kvwal.identity_table(*cache["table"].shape, device)
    return cache


# ------------------------------------------------------------------- decode
def _self_attn_decode(cfg: ModelConfig, layer_p, h, arena_k, arena_v, table,
                      seq_lens, first_live, cos, sin, window: int = 0):
    """One decode self-attention through the KV-WAL.  h (B,1,d); the new
    token's K/V entry is appended to the layer arenas in place, then the
    ``tide_attention`` kernel reads every live entry through the table.
    MLA appends (c_kv, k_rope) and attends in the absorbed form over the
    gathered arenas, up to the new length (``first_live`` unread, as in the
    JAX package)."""
    p = layer_p["attn"]
    if cfg.mla is not None:
        c_kv, k_rope = compress_kv(p, h, cfg, cos, sin)
        kvwal.append_token(arena_k, table, seq_lens, c_kv[:, 0, None, :])
        kvwal.append_token(arena_v, table, seq_lens, k_rope[:, 0, None, :])
        return mla_decode(p, h, cfg, cos, sin,
                          kvwal.gather(arena_k, table)[:, :, 0],
                          kvwal.gather(arena_v, table)[:, :, 0],
                          kv_len=seq_lens + 1)
    q, k, v = qkv_proj(p, h, cfg, cos, sin)
    kvwal.append_token(arena_k, table, seq_lens, k[:, 0])
    kvwal.append_token(arena_v, table, seq_lens, v[:, 0])
    q = _maybe_shard_decode_q(cfg, q)
    o = decode_attention(q[:, 0].contiguous(), arena_k, arena_v, table,
                         seq_lens + 1, first_live, window=window,
                         scale=cfg.hd ** -0.5)
    return o.reshape(h.shape[0], 1, -1) @ p["wo"].to(h.dtype)


def _maybe_shard_decode_q(cfg: ModelConfig, q):
    """The reference's decode-q constraint: shard q's head_dim like the
    arena, so the q·k contraction needs a small scores sum and not an
    arena-sized gather.  A DTensor is redistributed to it; a plain tensor
    is returned as it is."""
    if cfg.decode_q_hd_axis is None:
        return q
    from repro_torch.distributed.sharding import constrain
    ba = cfg.act_batch_axes or ("data",)
    return constrain(q, (ba if len(ba) > 1 else ba[0], None, None,
                         cfg.decode_q_hd_axis))


def _griffin_cache(cache: dict, cfg: ModelConfig, gi, i, kind: str):
    """Views of one Griffin block's cache entries, for the block at position
    ``i`` of group ``gi`` (or of the tail, for ``gi`` None): its (K, V)
    arenas for local attention, its (conv, lru) state for recurrence."""
    names = ("arena_k", "arena_v") if kind == "attn" else ("conv", "lru")
    if gi is None:
        return tuple(cache[f"tail{i}_{name}"] for name in names)
    if kind == "attn":
        return tuple(cache[name][gi] for name in names)
    ri = cfg.griffin.pattern[:i].count("rec")
    return tuple(cache[name][gi, ri] for name in names)


def _griffin_decode(params, cfg: ModelConfig, cache: dict, x, cos, sin):
    g = cfg.griffin
    seq_lens, first_live = cache["seq_lens"], cache["first_live"]
    for gi, i, kind, blk in griffin_blocks(params, cfg):
        h = rms_norm(blk["ln1"], x, cfg.norm_eps)
        if kind == "attn":
            ak, av = _griffin_cache(cache, cfg, gi, i, kind)
            out = _self_attn_decode(cfg, blk, h, ak, av, cache["table"],
                                    seq_lens, first_live, cos, sin,
                                    window=g.window)
        else:
            conv, lru = _griffin_cache(cache, cfg, gi, i, kind)
            out, (cs, ls) = recurrent_block(blk["rec"], h, cfg,
                                            conv_state=conv, lru_state=lru)
            conv.copy_(cs)
            lru.copy_(ls)
        x = x + out
        h = rms_norm(blk["ln2"], x, cfg.norm_eps)
        x = x + mlp_block(blk["mlp"], h, cfg.act)
    # Sliding-window epoch pruning: KV-WAL segments (blocks) that fall wholly
    # behind the attention window expire — zero bytes moved (§4.4 adapted).
    blk_size = cfg.kv_block
    min_live = torch.clamp(seq_lens + 1 - g.window, min=0)
    new_live = torch.maximum(first_live,
                             torch.div(min_live, blk_size,
                                       rounding_mode="floor") * blk_size)
    return x, dict(cache, seq_lens=seq_lens + 1,
                   first_live=new_live.to(torch.int32))


def _whisper_decode(params, cfg: ModelConfig, cache: dict, x):
    seq_lens = cache["seq_lens"]
    for i in range(cfg.n_layers):
        layer_p = layer(params["layers"], i)
        h = rms_norm(layer_p["ln1"], x, cfg.norm_eps)
        x = x + _self_attn_decode(cfg, layer_p, h, cache["arena_k"][i],
                                  cache["arena_v"][i], cache["table"],
                                  seq_lens, cache["first_live"], None, None)
        h = rms_norm(layer_p["ln_x"], x, cfg.norm_eps)
        x = x + cross_attention(layer_p["xattn"], h, cache["cross_k"][i],
                                cache["cross_v"][i], cfg)
        h = rms_norm(layer_p["ln2"], x, cfg.norm_eps)
        x = x + mlp_block(layer_p["mlp"], h, cfg.act)
    return x, dict(cache, seq_lens=seq_lens + 1)


def decode_step(params, cfg: ModelConfig, cache: dict, tokens: torch.Tensor,
                mrope_positions=None) -> tuple[torch.Tensor, dict]:
    """One new token per sequence.  tokens (B,) → logits (B, V)."""
    require_family(cfg)
    x = embed_tokens(params, cfg, tokens[:, None])
    seq_lens = cache["seq_lens"]
    if cfg.family == "ssm":
        for i in range(cfg.n_layers):
            layer_p = layer(params["layers"], i)
            h = rms_norm(layer_p["ln1"], x, cfg.norm_eps)
            out, (cx, cbc, st) = ssm_block(
                layer_p["ssm"], h, cfg, conv_x_state=cache["conv_x"][i],
                conv_bc_state=cache["conv_bc"][i],
                ssm_state=cache["state"][i], decode=True)
            cache["conv_x"][i].copy_(cx)
            cache["conv_bc"][i].copy_(cbc)
            cache["state"][i].copy_(st)
            x = x + out
        cache = dict(cache, seq_lens=seq_lens + 1)
    elif cfg.family == "encdec":
        x = x + sinusoidal_embedding(seq_lens[:, None], cfg.d_model).to(
            x.dtype)
        x, cache = _whisper_decode(params, cfg, cache, x)
    else:
        cos, sin = _angles(cfg, seq_lens[:, None], mrope_positions)
        if cfg.family == "griffin":
            x, cache = _griffin_decode(params, cfg, cache, x, cos, sin)
        else:
            for i in range(cfg.n_layers):
                layer_p = layer(params["layers"], i)
                h = rms_norm(layer_p["ln1"], x, cfg.norm_eps)
                x = x + _self_attn_decode(
                    cfg, layer_p, h, cache["arena_k"][i],
                    cache["arena_v"][i], cache["table"], seq_lens,
                    cache["first_live"], cos, sin)
                h = rms_norm(layer_p["ln2"], x, cfg.norm_eps)
                x = x + ffn(cfg, layer_p, h)[0]
            cache = dict(cache, seq_lens=seq_lens + 1)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return lm_logits(params, cfg, x)[:, 0], cache


# ------------------------------------------------------------------ prefill
def _griffin_prefill(params, cfg: ModelConfig, cache: dict, x, cos, sin):
    for gi, i, kind, blk in griffin_blocks(params, cfg):
        x, (a, b) = griffin_block(cfg, blk, x, cos, sin, kind)
        ca, cb = _griffin_cache(cache, cfg, gi, i, kind)
        if kind == "attn":
            kvwal.write_prefill(ca, a)
            kvwal.write_prefill(cb, b)
        else:
            ca.copy_(a)
            cb.copy_(b)
    return x


def prefill(params, cfg: ModelConfig, batch: dict, max_seq: int
            ) -> tuple[torch.Tensor, dict]:
    """Run the prompt, writing every position's KV entry into a fresh
    KV-WAL arena (write-once: these bytes never move again) or leaving each
    recurrent block's final state in the cache."""
    require_family(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = with_vision(cfg, embed_tokens(params, cfg, tokens),
                    batch.get("vision_embed"))
    cache = init_cache(cfg, B, max_seq, x.device)
    if cfg.family == "ssm":
        for i in range(cfg.n_layers):
            layer_p = layer(params["layers"], i)
            h = rms_norm(layer_p["ln1"], x, cfg.norm_eps)
            out, (cx, cbc, st) = ssm_block(layer_p["ssm"], h, cfg)
            cache["conv_x"][i].copy_(cx)
            cache["conv_bc"][i].copy_(cbc)
            cache["state"][i].copy_(st)
            x = x + out
    elif cfg.family == "encdec":
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        x = x + sinusoidal_embedding(positions, cfg.d_model).to(x.dtype)
        enc = encode(params, cfg, batch["frames"])
        for i in range(cfg.n_layers):
            x, (k, v), (ck, cv) = whisper_layer(
                cfg, layer(params["layers"], i), x, enc)
            kvwal.write_prefill(cache["arena_k"][i], k)
            kvwal.write_prefill(cache["arena_v"][i], v)
            cache["cross_k"][i].copy_(ck)
            cache["cross_v"][i].copy_(cv)
    else:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        cos, sin = _angles(cfg, positions, batch.get("mrope_positions"))
        if cfg.family == "griffin":
            x = _griffin_prefill(params, cfg, cache, x, cos, sin)
        else:
            for i in range(cfg.n_layers):
                layer_p = layer(params["layers"], i)
                h = rms_norm(layer_p["ln1"], x, cfg.norm_eps)
                out, (k, v) = self_attention(cfg, layer_p["attn"], h, cos,
                                             sin)
                if cfg.mla is not None:            # (c_kv, k_rope): 1 head
                    k, v = k[:, :, None], v[:, :, None]
                kvwal.write_prefill(cache["arena_k"][i], k)
                kvwal.write_prefill(cache["arena_v"][i], v)
                x = x + out
                h = rms_norm(layer_p["ln2"], x, cfg.norm_eps)
                x = x + ffn(cfg, layer_p, h)[0]
    cache["seq_lens"].fill_(S)
    x = rms_norm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    return lm_logits(params, cfg, x)[:, 0], cache
