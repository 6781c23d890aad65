"""Model assembly for every family of the JAX package's
``models/transformer.py``: dense (llama3, qwen3, phi3), the vlm backbone
(qwen2-vl: M-RoPE, precomputed patch embeddings), moe (qwen2-moe: shared
and routed experts; deepseek-v3: MLA, MoE and the MTP module's
parameters), ssm (mamba2), griffin (recurrentgemma) and encdec (whisper:
an encoder over precomputed frame embeddings, a decoder with
cross-attention).

Parameters keep the JAX package's pytree layout: a dict with ``embed``,
``final_norm``, ``lm_head`` (untied) and ``layers`` (griffin: ``groups``,
whose leaves stack the (rec, rec, attn) groups, and a ``tail`` list of
single blocks; encdec: ``enc_layers`` and ``enc_norm`` too), whose leaves
stack every layer on a leading axis, so ``convert.py`` carries the JAX
package's parameters across leaf for leaf.  A Python loop over the layers
takes the place of ``lax.scan``.  DeepSeek's MTP module (``mtp``) feeds
only the training loss (``train_loss``).

``forward`` and ``encode`` take each stacked leaf apart by one ``unbind``
(``layers``), whose backward is one ``stack``; ``layer(v, i)`` per layer
would make autograd write a zero tensor the size of the whole leaf for each
layer's select.  Serving's decode and prefill (``serve.py``) take one layer
at a time with ``layer``.

Training (``forward(..., train=True)``, which ``train_loss`` calls) differs
from the plain forward in two ways, neither of which changes a value:
- where the JAX package wraps a layer body in ``jax.checkpoint`` under
  ``cfg.remat`` (the dense/moe and ssm layers, a griffin group, the encoder
  and whisper decoder layers), the same body runs under
  ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``;
- the SSM layers take the plain chunked SSD, which autograd differentiates,
  not kernel E, as the JAX package trains through its plain ``ssd_scan``.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .base import ModelConfig
from .griffin import init_recurrent_block, recurrent_block
from .layers import (cross_attention, cross_kv, gqa_block, init_gqa,
                     init_linear, init_mlp, mlp_block, mrope_angles, rms_norm,
                     rope_angles, sinusoidal_embedding)
from .mla import init_mla, mla_train
from .moe import init_moe, moe_block
from .ssm import init_ssm, ssm_block

KV_WAL_FAMILIES = ("dense", "vlm", "moe")    # a cache of KV-WAL arenas only
FAMILIES = KV_WAL_FAMILIES + ("ssm", "griffin", "encdec")


def require_family(cfg: ModelConfig, families=FAMILIES,
                   what: str = "the port's model stack") -> None:
    """Raise ``NotImplementedError`` unless ``cfg`` is of one of
    ``families``."""
    if cfg.family not in families:
        raise NotImplementedError(
            f"{cfg.name}: {what} runs the {', '.join(families)} families, "
            f"not this {cfg.family} model")


def layer(stacked: dict, i: int) -> dict:
    """Layer ``i``'s parameters: views into the stacked leaves."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def layers(stacked: dict, n: int) -> list[dict]:
    """All ``n`` layers' parameters, each stacked leaf taken apart by one
    ``unbind``: its backward is one ``stack`` of the layers' gradients."""
    cols = {k: layers(v, n) if isinstance(v, dict) else v.unbind(0)
            for k, v in stacked.items()}
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


def _grads_split(tree: dict) -> dict:
    """``tree`` (nested dicts) with every leaf passed through
    ``sharding.grad_split_as``, an expert weight's with its hidden dim to
    scatter on (``EXPERT_GRAD_SCATTER``)."""
    from repro_torch.distributed.sharding import (EXPERT_GRAD_SCATTER,
                                                  grad_split_as)
    return {k: _grads_split(v) if isinstance(v, dict)
            else grad_split_as(v, EXPERT_GRAD_SCATTER.get(k))
            for k, v in tree.items()}


def _body(cfg: ModelConfig, train: bool, fn, *args):
    """``fn(*args)``, recomputed in the backward pass when training under
    ``cfg.remat`` (the JAX package's ``jax.checkpoint(body)``).  The
    layer's parameters (a dict among ``args``) have their gradients split
    as they are where they are DTensors (``sharding.grad_split_as``; ROADMAP
    C.18), the MoE's expert weights' also scattered over the mesh dims that
    leave them whole (C.19), on views made here: a view made with the
    layer's ``unbind`` comes before every layer's ops, and autograd runs its
    backward after every layer's, each layer's gradient whole until then."""
    args = tuple(_grads_split(a) if isinstance(a, dict) else a
                 for a in args)
    if train and cfg.remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


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


def _attn_ffn_init(gen, cfg: ModelConfig, dtype, n=()):
    """A decoder layer of the KV-WAL families: MLA or GQA, then MoE or an
    MLP, stacked over ``n``."""
    d = cfg.d_model
    ones = lambda: torch.ones((*n, d), dtype=dtype, device=gen.device)
    p = {"ln1": ones(), "ln2": ones()}
    p["attn"] = init_mla(gen, cfg, dtype, n=n) if cfg.mla is not None \
        else init_gqa(gen, cfg, dtype, n=n)
    if cfg.moe is not None:
        p["moe"] = init_moe(gen, d, cfg.moe, dtype, n=n)
    else:
        p["mlp"] = init_mlp(gen, d, cfg.d_ff, cfg.act, dtype, n=n)
    return p


def _mtp_init(gen, cfg: ModelConfig, dtype) -> dict:
    """DeepSeek's MTP module: a projection of (hidden, next embedding) and
    one extra dense layer, whose MLP is as wide as a shared expert."""
    d, dev = cfg.d_model, gen.device
    ones = lambda: torch.ones((d,), dtype=dtype, device=dev)
    ff = (cfg.moe.shared_d_ff or cfg.moe.expert_d_ff) if cfg.moe \
        else cfg.d_ff
    return {"proj": init_linear(gen, 2 * d, d, dtype),
            "ln": ones(),
            "layer": {"ln1": ones(),
                      "attn": init_mla(gen, cfg, dtype) if cfg.mla is not None
                      else init_gqa(gen, cfg, dtype),
                      "ln2": ones(),
                      "mlp": init_mlp(gen, d, ff, cfg.act, dtype)}}


def _encdec_init(gen, cfg: ModelConfig, dtype) -> dict:
    d, dev = cfg.d_model, gen.device
    ones = lambda *n: torch.ones((*n, d), dtype=dtype, device=dev)
    E, L = cfg.n_encoder_layers, cfg.n_layers
    p = {"enc_layers": {"ln1": ones(E), "attn": init_gqa(gen, cfg, dtype,
                                                         n=(E,)),
                        "ln2": ones(E), "mlp": init_mlp(gen, d, cfg.d_ff,
                                                        cfg.act, dtype,
                                                        n=(E,))},
         "enc_norm": ones(),
         "layers": {"ln1": ones(L), "attn": init_gqa(gen, cfg, dtype, n=(L,)),
                    "ln_x": ones(L),
                    "xattn": init_gqa(gen, cfg, dtype, n=(L,), cross=True),
                    "ln2": ones(L), "mlp": init_mlp(gen, d, cfg.d_ff,
                                                    cfg.act, dtype, n=(L,))}}
    if cfg.encoder_dim and cfg.encoder_dim != d:
        p["frontend_proj"] = init_linear(gen, cfg.encoder_dim, d, dtype)
    return p


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
    elif cfg.family == "encdec":
        p.update(_encdec_init(gen, cfg, dtype))
    else:
        p["layers"] = _attn_ffn_init(gen, cfg, dtype, n=(L,))
        if cfg.mtp_depth:
            p["mtp"] = _mtp_init(gen, cfg, dtype)
    return p


def param_count_exact(cfg: ModelConfig) -> int:
    """Exact parameter count without allocation: ``init_params`` under
    ``FakeTensorMode`` (fake tensors carry shapes and no storage), as the
    JAX package's ``jax.eval_shape``; it works for the 671B config.  Backs
    MODEL_FLOPS in the roofline."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.core.tree import leaves
    with FakeTensorMode():
        params = init_params(cfg, torch.Generator())
    return sum(t.numel() for t in leaves(params))


# ============================================================= embeddings
def embed_tokens(params, cfg: ModelConfig, tokens) -> torch.Tensor:
    """The tokens' rows of the embedding table in ``cfg.adtype``; on a mesh
    that splits the table's vocab, each device's slice looked up
    (``sharding.embed_on_shards``)."""
    from repro_torch.distributed.sharding import embed_on_shards
    return embed_on_shards(params["embed"], tokens.long(), cfg.adtype)


def lm_logits(params, cfg: ModelConfig, x) -> torch.Tensor:
    from repro_torch.distributed.sharding import vocab_parallel_input
    if cfg.tie_embeddings:
        w = params["embed"]
        return vocab_parallel_input(x, w, 0) @ w.to(x.dtype).T
    w = params["lm_head"]
    return vocab_parallel_input(x, w, 1) @ w.to(x.dtype)


def _angles(cfg: ModelConfig, positions, mrope_positions=None):
    if cfg.family == "encdec":
        return None, None
    if cfg.mrope_sections is not None and mrope_positions is not None:
        return mrope_angles(mrope_positions, cfg.hd, cfg.rope_theta,
                            cfg.mrope_sections)
    rotary = cfg.hd if cfg.mla is None else cfg.mla.qk_rope_head_dim
    return rope_angles(positions, rotary, cfg.rope_theta)


def with_vision(cfg: ModelConfig, x, vision_embed):
    """Frontend stub: precomputed patch embeddings replace the first n_vis
    token slots."""
    if cfg.family != "vlm" or vision_embed is None:
        return x
    x = x.clone()
    x[:, :vision_embed.shape[1]] = vision_embed.to(x.dtype)
    return x


# ================================================================ forward
def maybe_shard_activations(cfg: ModelConfig, x):
    """The reference's optional sharding constraint on (B,S,d) activations:
    batch over ``cfg.act_batch_axes``, sequence over ``cfg.act_seq_axis``
    (Megatron-style sequence parallelism: the remat'd per-layer residual
    shards over the model axis too).  A DTensor is redistributed to that
    spec's placements; a plain tensor is returned as it is, as the
    reference is silently a no-op outside a mesh."""
    if cfg.act_batch_axes is None and cfg.act_seq_axis is None:
        return x
    from repro_torch.distributed.sharding import constrain
    ba = cfg.act_batch_axes
    return constrain(x, (ba if ba and len(ba) > 1 else (ba[0] if ba else None),
                         cfg.act_seq_axis, None))


def self_attention(cfg: ModelConfig, attn_p, h, cos, sin):
    """Prefill self-attention of a KV-WAL layer → (output, the entries the
    KV-WAL keeps: rotated (k, v) for GQA, (c_kv, k_rope) for MLA)."""
    if cfg.mla is not None:
        return mla_train(attn_p, h, cfg, cos, sin)
    return gqa_block(attn_p, h, cfg, cos=cos, sin=sin)


def ffn(cfg: ModelConfig, layer_p, h):
    """The layer's feed-forward: MoE or an MLP → (output, the MoE's aux
    loss or None)."""
    if cfg.moe is not None:
        return moe_block(layer_p["moe"], h, cfg.moe,
                         dispatch_axes=cfg.moe_dispatch_axes)
    return mlp_block(layer_p["mlp"], h, cfg.act), None


def _dense_layer_fwd(cfg: ModelConfig, layer_p, x, cos, sin):
    x = maybe_shard_activations(cfg, x)
    h = rms_norm(layer_p["ln1"], x, cfg.norm_eps)
    attn_out, _ = self_attention(cfg, layer_p["attn"], h, cos, sin)
    x = x + attn_out
    h = rms_norm(layer_p["ln2"], x, cfg.norm_eps)
    out, aux = ffn(cfg, layer_p, h)
    return x + out, aux


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


def _encoder_layer(cfg: ModelConfig, layer_p, x):
    x = maybe_shard_activations(cfg, x)
    h = rms_norm(layer_p["ln1"], x, cfg.norm_eps)
    x = x + gqa_block(layer_p["attn"], h, cfg)[0]
    h = rms_norm(layer_p["ln2"], x, cfg.norm_eps)
    return x + mlp_block(layer_p["mlp"], h, cfg.act)


def encode(params, cfg: ModelConfig, frames, train: bool = False
           ) -> torch.Tensor:
    """Whisper encoder over precomputed frame embeddings (frontend stub).
    Its self-attention is causal, as the JAX package's is (``cfg.causal``)."""
    x = frames.to(cfg.adtype)
    if "frontend_proj" in params:
        x = x @ params["frontend_proj"].to(x.dtype)
    # Positions are one row, broadcast over the batch: a row a sequence
    # would be whole over the batch on every device of a mesh.
    pos = torch.arange(x.shape[1], device=x.device)[None]
    x = x + sinusoidal_embedding(pos, cfg.d_model).to(x.dtype)
    for layer_p in layers(params["enc_layers"], cfg.n_encoder_layers):
        x = _body(cfg, train, _encoder_layer, cfg, layer_p, x)
    return rms_norm(params["enc_norm"], x, cfg.norm_eps)


def whisper_layer(cfg: ModelConfig, layer_p, x, enc):
    """One decoder layer over a whole sequence: causal self-attention,
    cross-attention over ``enc``, MLP → (x, self (k, v), cross (k, v))."""
    h = rms_norm(layer_p["ln1"], x, cfg.norm_eps)
    out, kv = gqa_block(layer_p["attn"], h, cfg)
    x = x + out
    h = rms_norm(layer_p["ln_x"], x, cfg.norm_eps)
    ck, cv = cross_kv(layer_p["xattn"], enc, cfg, h.dtype)
    x = x + cross_attention(layer_p["xattn"], h, ck, cv, cfg)
    h = rms_norm(layer_p["ln2"], x, cfg.norm_eps)
    return x + mlp_block(layer_p["mlp"], h, cfg.act), kv, (ck, cv)


def _griffin_group(cfg: ModelConfig, group_p, x, cos, sin):
    for i, kind in enumerate(cfg.griffin.pattern):
        x = griffin_block(cfg, group_p[f"blk{i}"],
                          maybe_shard_activations(cfg, x), cos, sin, kind)[0]
    return x


def _ssm_layer(cfg: ModelConfig, layer_p, x, differentiable: bool):
    x = maybe_shard_activations(cfg, x)
    h = rms_norm(layer_p["ln1"], x, cfg.norm_eps)
    return x + ssm_block(layer_p["ssm"], h, cfg,
                         differentiable=differentiable)[0]


def forward(params, cfg: ModelConfig, tokens, *, vision_embed=None,
            mrope_positions=None, frames=None, train: bool = False
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward → (logits (B,S,V), aux_loss).  ``train`` takes
    the training route (module docstring): the same values, a graph that
    autograd can differentiate through every layer."""
    require_family(cfg)
    S = tokens.shape[1]
    x = with_vision(cfg, embed_tokens(params, cfg, tokens), vision_embed)
    aux = torch.zeros((), device=x.device)
    if cfg.family == "encdec":
        enc = encode(params, cfg, frames, train)
        pos = torch.arange(S, device=x.device)[None]
        x = x + sinusoidal_embedding(pos, cfg.d_model).to(x.dtype)
        for layer_p in layers(params["layers"], cfg.n_layers):
            x = _body(cfg, train, lambda p, xc: whisper_layer(
                cfg, p, maybe_shard_activations(cfg, xc), enc)[0],
                layer_p, x)
    elif cfg.family == "ssm":
        for layer_p in layers(params["layers"], cfg.n_layers):
            x = _body(cfg, train, _ssm_layer, cfg, layer_p, x, train)
    else:
        positions = torch.arange(S, device=x.device)[None]   # (1, S)
        cos, sin = _angles(cfg, positions, mrope_positions)
        if cfg.family == "griffin":
            pattern = cfg.griffin.pattern
            n_groups, _ = griffin_layout(cfg)
            for group_p in layers(params["groups"], n_groups):
                x = _body(cfg, train, _griffin_group, cfg, group_p, x, cos,
                          sin)
            for ti, blk in enumerate(params["tail"]):
                x = griffin_block(cfg, blk, maybe_shard_activations(cfg, x),
                                  cos, sin,
                                  pattern[ti % len(pattern)])[0]
        else:
            for layer_p in layers(params["layers"], cfg.n_layers):
                x, a = _body(cfg, train, _dense_layer_fwd, cfg, layer_p, x,
                             cos, sin)
                if a is not None:
                    aux = aux + a
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return lm_logits(params, cfg, x), aux


# ==================================================================== loss
def train_loss(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Cross-entropy in fp32, plus 0.3 x the MTP loss for a moe config with
    ``mtp_depth``, plus 0.01 x the MoE auxiliary loss."""
    logits, aux = forward(
        params, cfg, batch["tokens"],
        vision_embed=batch.get("vision_embed"),
        mrope_positions=batch.get("mrope_positions"),
        frames=batch.get("frames"), train=True)
    loss = _xent(logits, batch["labels"], cfg)
    if cfg.mtp_depth and cfg.family == "moe":
        loss = loss + 0.3 * _mtp_loss(params, cfg, batch)
    return loss + 0.01 * aux


def _xent(logits, labels, cfg) -> torch.Tensor:
    """Mean of ``-log_softmax(logits)[label]`` in fp32: the reference's ops.
    Logits split or pending a sum over a mesh (a DTensor not replicated on
    every mesh dim) take ``_xent_vocab_parallel``, which computes the same
    values in another order."""
    from torch.distributed.tensor import DTensor
    if isinstance(logits, DTensor) and not all(
            p.is_replicate() for p in logits.placements):
        return _xent_vocab_parallel(logits, labels)
    lp = torch.log_softmax(logits.float(), dim=-1)
    ll = lp.gather(-1, labels.long()[..., None])[..., 0]
    return -ll.mean()


def _xent_vocab_parallel(logits, labels) -> torch.Tensor:
    """``_xent`` as reductions over the vocab dim and elementwise ops, which
    DTensor shards over logits split along their vocab dim: each device
    reduces its slice, and only per-token scalars are all-reduced, as XLA
    partitions the reference's log-softmax.  The label's log-probability
    is picked by a mask over the vocab ids: a gather's gradient would be
    replicated whole on every device."""
    from repro_torch.distributed.sharding import complete, follow
    x = complete(logits.float())
    z = x - x.detach().amax(-1, keepdim=True)
    lse = complete(z.exp().sum(-1)).log()
    ids = torch.arange(z.shape[-1], device=z.device)
    hit = follow(labels[..., None].expand(z.shape), z) == ids
    return (lse - complete(torch.where(hit, z, 0.0).sum(-1))).mean()


def _roll_left(x) -> torch.Tensor:
    """``torch.roll(x, -1, dims=1)`` as a slice and a concatenation, the
    same values through ops DTensor shards in every torch the port runs on
    (it has no rule for ``roll`` in some)."""
    return torch.cat([x[:, 1:], x[:, :1]], dim=1)


def _mtp_loss(params, cfg: ModelConfig, batch) -> torch.Tensor:
    """DeepSeek-style multi-token prediction: predict t+2 from a fused
    representation of (hidden_t, embed(token_{t+1})) through one extra
    layer; the hidden state is the embedding, as in the JAX package."""
    from repro_torch.distributed.sharding import grad_as_value
    tokens, labels = batch["tokens"], batch["labels"]
    S = tokens.shape[1]
    x = maybe_shard_activations(cfg, embed_tokens(params, cfg, tokens))
    nxt = _roll_left(x)
    h = grad_as_value(torch.cat([x, nxt], dim=-1)
                      @ params["mtp"]["proj"].to(x.dtype))
    h = maybe_shard_activations(cfg, h)
    pos = torch.arange(S, device=x.device)[None]
    cos, sin = _angles(cfg, pos)
    lp = params["mtp"]["layer"]
    out, _ = self_attention(cfg, lp["attn"],
                            rms_norm(lp["ln1"], h, cfg.norm_eps), cos, sin)
    h = maybe_shard_activations(cfg, h + out)
    h = h + mlp_block(lp["mlp"], rms_norm(lp["ln2"], h, cfg.norm_eps),
                      cfg.act)
    h = rms_norm(params["mtp"]["ln"], maybe_shard_activations(cfg, h),
                 cfg.norm_eps)
    return _xent(lm_logits(params, cfg, h), _roll_left(labels),
                 cfg)
