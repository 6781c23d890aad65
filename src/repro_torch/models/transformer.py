"""Model assembly: the dense family (llama3, qwen3, phi3), the vlm backbone
(qwen2-vl: M-RoPE, precomputed patch embeddings), the ssm family (mamba2)
and the griffin family (recurrentgemma).

Parameters keep the JAX package's pytree layout (``models/transformer.py``):
a dict with ``embed``, ``final_norm``, ``lm_head`` (untied) and ``layers``
(griffin: ``groups``, whose leaves stack the (rec, rec, attn) groups, and a
``tail`` list of single blocks), whose leaves stack every layer on a leading
axis, so ``convert.py`` carries the JAX package's parameters across leaf for
leaf.  A Python loop over the layers takes the place of ``lax.scan``.

The other families (moe, MLA, encdec) wait (ROADMAP A.11) and raise
``NotImplementedError``.
"""
from __future__ import annotations

import torch

from .base import ModelConfig
from .griffin import init_recurrent_block, recurrent_block
from .layers import (gqa_block, init_gqa, init_linear, init_mlp, mlp_block,
                     mrope_angles, rms_norm, rope_angles)
from .ssm import init_ssm, ssm_block

DENSE_FAMILIES = ("dense", "vlm")
FAMILIES = DENSE_FAMILIES + ("ssm", "griffin")


def require_family(cfg: ModelConfig, families=FAMILIES,
                   what: str = "the port's model stack") -> None:
    """Raise ``NotImplementedError`` unless ``cfg`` is of one of
    ``families`` (and has neither MoE nor MLA layers)."""
    if cfg.family not in families or cfg.mla is not None \
            or cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: {what} runs the {', '.join(families)} families "
            f"without MoE or MLA layers, not this {cfg.family} model "
            f"(ROADMAP A.11)")


def layer(stacked: dict, i: int) -> dict:
    """Layer ``i``'s parameters: views into the stacked leaves."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


# =========================================================== initialization
def _griffin_block_init(gen, cfg: ModelConfig, dtype, kind: str, n=()):
    d = cfg.d_model
    ones = lambda: torch.ones((*n, d), dtype=dtype, device=gen.device)
    p = {"ln1": ones(), "ln2": ones()}
    if kind == "attn":
        p["attn"] = init_gqa(gen, cfg, dtype, n=n)
    else:
        p["rec"] = init_recurrent_block(gen, cfg, dtype, n=n)
    p["mlp"] = init_mlp(gen, d, cfg.d_ff, cfg.act, dtype, n=n)
    return p


def griffin_layout(cfg: ModelConfig) -> tuple[int, int]:
    """(full (rec, rec, attn) groups, tail blocks after them)."""
    period = len(cfg.griffin.pattern)
    return cfg.n_layers // period, cfg.n_layers % period


def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random parameters in ``cfg.pdtype`` on the generator's device,
    normal(0, 0.02²) weights and unit norm scales, as the JAX package draws
    them (the numbers differ: torch and JAX generators are different)."""
    require_family(cfg)
    dtype, dev, L, d = cfg.pdtype, gen.device, cfg.n_layers, cfg.d_model
    ones = lambda *shape: torch.ones(shape, dtype=dtype, device=dev)
    p = {"embed": init_linear(gen, cfg.vocab, d, dtype),
         "final_norm": ones(d)}
    if not cfg.tie_embeddings:
        p["lm_head"] = init_linear(gen, d, cfg.vocab, dtype)
    if cfg.family == "ssm":
        p["layers"] = {"ln1": ones(L, d), "ssm": init_ssm(gen, cfg, dtype,
                                                          n=(L,))}
    elif cfg.family == "griffin":
        pattern = cfg.griffin.pattern
        n_groups, n_tail = griffin_layout(cfg)
        p["groups"] = {f"blk{i}": _griffin_block_init(gen, cfg, dtype, kind,
                                                      n=(n_groups,))
                       for i, kind in enumerate(pattern)}
        p["tail"] = [_griffin_block_init(gen, cfg, dtype,
                                         pattern[i % len(pattern)])
                     for i in range(n_tail)]
    else:
        p["layers"] = {"ln1": ones(L, d), "ln2": ones(L, d),
                       "attn": init_gqa(gen, cfg, dtype, n=(L,)),
                       "mlp": init_mlp(gen, d, cfg.d_ff, cfg.act, dtype,
                                       n=(L,))}
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


def griffin_block(cfg: ModelConfig, blk_p, x, cos, sin, kind):
    """One Griffin block over a whole sequence → (x, what prefill caches:
    the rotated (k, v) of local attention, or the recurrent block's final
    (conv, lru) state)."""
    h = rms_norm(blk_p["ln1"], x, cfg.norm_eps)
    if kind == "attn":
        out, state = gqa_block(blk_p["attn"], h, cfg, cos=cos, sin=sin,
                               window=cfg.griffin.window)
    else:
        out, state = recurrent_block(blk_p["rec"], h, cfg)
    x = x + out
    h = rms_norm(blk_p["ln2"], x, cfg.norm_eps)
    return x + mlp_block(blk_p["mlp"], h, cfg.act), state


def griffin_blocks(params, cfg: ModelConfig):
    """(group index, position in the pattern, kind, block parameters) of
    every block in order: the groups' blocks, then the tail's, whose group
    index is None and whose position is their index in the tail."""
    pattern = cfg.griffin.pattern
    n_groups, _ = griffin_layout(cfg)
    for gi in range(n_groups):
        group = layer(params["groups"], gi)
        for i, kind in enumerate(pattern):
            yield gi, i, kind, group[f"blk{i}"]
    for ti, blk in enumerate(params["tail"]):
        yield None, ti, pattern[ti % len(pattern)], blk


def forward(params, cfg: ModelConfig, tokens, *, vision_embed=None,
            mrope_positions=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward → (logits (B,S,V), aux_loss)."""
    require_family(cfg)
    B, S = tokens.shape
    x = with_vision(cfg, embed_tokens(params, cfg, tokens), vision_embed)
    if cfg.family == "ssm":
        for i in range(cfg.n_layers):
            layer_p = layer(params["layers"], i)
            h = rms_norm(layer_p["ln1"], x, cfg.norm_eps)
            x = x + ssm_block(layer_p["ssm"], h, cfg)[0]
    else:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        cos, sin = _angles(cfg, positions, mrope_positions)
        if cfg.family == "griffin":
            for _, _, kind, blk in griffin_blocks(params, cfg):
                x = griffin_block(cfg, blk, x, cos, sin, kind)[0]
        else:
            for i in range(cfg.n_layers):
                x = _dense_layer_fwd(cfg, layer(params["layers"], i), x, cos,
                                     sin)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return lm_logits(params, cfg, x), torch.zeros((), device=x.device)
