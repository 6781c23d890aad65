"""Model assembly: the dense family (llama3, qwen3, phi3) and the vlm
backbone (qwen2-vl: M-RoPE, precomputed patch embeddings).

Parameters keep the JAX package's pytree layout (``models/transformer.py``):
a dict with ``embed``, ``final_norm``, ``lm_head`` (untied) and ``layers``,
whose leaves stack every layer on a leading axis, so ``convert.py`` carries
the JAX package's parameters across leaf for leaf.  A Python loop over the
layers takes the place of ``lax.scan``.

The other families (moe, ssm, griffin, encdec) wait for port slice 3
(ROADMAP A.11) and raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from .base import ModelConfig
from .layers import (gqa_block, init_gqa, init_linear, init_mlp, mlp_block,
                     mrope_angles, rms_norm, rope_angles)

DENSE_FAMILIES = ("dense", "vlm")


def require_dense(cfg: ModelConfig) -> None:
    if cfg.family not in DENSE_FAMILIES or cfg.mla is not None \
            or cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            f"(ROADMAP A.11); the port runs the dense and vlm families")


def layer(stacked: dict, i: int) -> dict:
    """Layer ``i``'s parameters: views into the stacked leaves."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


# =========================================================== initialization
def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random parameters in ``cfg.pdtype`` on the generator's device,
    normal(0, 0.02²) weights and unit norm scales, as the JAX package draws
    them (the numbers differ: torch and JAX generators are different)."""
    require_dense(cfg)
    dtype, dev, L, d = cfg.pdtype, gen.device, cfg.n_layers, cfg.d_model
    ones = lambda *shape: torch.ones(shape, dtype=dtype, device=dev)
    p = {"embed": init_linear(gen, cfg.vocab, d, dtype),
         "final_norm": ones(d)}
    if not cfg.tie_embeddings:
        p["lm_head"] = init_linear(gen, d, cfg.vocab, dtype)
    p["layers"] = {"ln1": ones(L, d), "ln2": ones(L, d),
                   "attn": init_gqa(gen, cfg, dtype, n=(L,)),
                   "mlp": init_mlp(gen, d, cfg.d_ff, cfg.act, dtype, n=(L,))}
    return p


# ============================================================= embeddings
def embed_tokens(params, cfg: ModelConfig, tokens) -> torch.Tensor:
    return params["embed"][tokens.long()].to(cfg.adtype)


def lm_logits(params, cfg: ModelConfig, x) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ params["embed"].to(x.dtype).T
    return x @ params["lm_head"].to(x.dtype)


def _angles(cfg: ModelConfig, positions, mrope_positions=None):
    if cfg.mrope_sections is not None and mrope_positions is not None:
        return mrope_angles(mrope_positions, cfg.hd, cfg.rope_theta,
                            cfg.mrope_sections)
    return rope_angles(positions, cfg.hd, cfg.rope_theta)


def with_vision(cfg: ModelConfig, x, vision_embed):
    """Frontend stub: precomputed patch embeddings replace the first n_vis
    token slots."""
    if cfg.family != "vlm" or vision_embed is None:
        return x
    x = x.clone()
    x[:, :vision_embed.shape[1]] = vision_embed.to(x.dtype)
    return x


# ================================================================ forward
def _dense_layer_fwd(cfg: ModelConfig, layer_p, x, cos, sin):
    h = rms_norm(layer_p["ln1"], x, cfg.norm_eps)
    attn_out, _ = gqa_block(layer_p["attn"], h, cfg, cos=cos, sin=sin)
    x = x + attn_out
    h = rms_norm(layer_p["ln2"], x, cfg.norm_eps)
    return x + mlp_block(layer_p["mlp"], h, cfg.act)


def forward(params, cfg: ModelConfig, tokens, *, vision_embed=None,
            mrope_positions=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward → (logits (B,S,V), aux_loss)."""
    require_dense(cfg)
    B, S = tokens.shape
    x = with_vision(cfg, embed_tokens(params, cfg, tokens), vision_embed)
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    cos, sin = _angles(cfg, positions, mrope_positions)
    for i in range(cfg.n_layers):
        x = _dense_layer_fwd(cfg, layer(params["layers"], i), x, cos, sin)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return lm_logits(params, cfg, x), torch.zeros((), device=x.device)
