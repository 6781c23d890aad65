"""Unified model configuration covering every assigned architecture family.

Plain data, as in the JAX package's ``models/base.py``; ``adtype`` and
``pdtype`` name torch dtypes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0                 # shared (always-on) experts
    expert_d_ff: int = 0              # per-expert FFN width
    shared_d_ff: int = 0              # shared-expert FFN width
    capacity_factor: float = 1.25
    group_size: int = 1024            # GShard dispatch group size (tokens)
    router_norm_topk: bool = True     # normalize weights over the top-k
    impl: str = "gshard"              # "gshard" | "scatter"


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 Multi-head Latent Attention dims (arXiv:2412.19437)."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SsmConfig:
    """Mamba-2 SSD (arXiv:2405.21060)."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256


@dataclass(frozen=True)
class GriffinConfig:
    """RecurrentGemma / Griffin (arXiv:2402.19427)."""
    lru_width: Optional[int] = None   # defaults to d_model
    window: int = 2048                # local-attention window
    pattern: tuple = ("rec", "rec", "attn")
    conv_width: int = 4
    c_constant: float = 8.0


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense|moe|ssm|griffin|encdec|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                 # 0 → d_model // n_heads
    # attention details
    qk_norm: bool = False             # qwen3
    rope_theta: float = 10_000.0
    mrope_sections: Optional[tuple] = None  # qwen2-vl M-RoPE (t, h, w)
    causal: bool = True
    # families
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SsmConfig] = None
    griffin: Optional[GriffinConfig] = None
    # encoder-decoder (whisper)
    n_encoder_layers: int = 0
    encoder_seq: int = 0              # precomputed frame embeddings (stub)
    encoder_dim: int = 0
    # misc
    act: str = "silu"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    mtp_depth: int = 0                # deepseek multi-token prediction heads
    # KV-WAL
    kv_block: int = 128               # KV-WAL segment (block) size in slots
    # activation sharding constraints of the JAX package's TPU mesh; kept
    # so that every config module carries over as data
    act_batch_axes: Optional[tuple] = None
    act_seq_axis: Optional[str] = None
    decode_q_hd_axis: Optional[str] = None
    moe_dispatch_axes: Optional[tuple] = None
    # numerics
    dtype: str = "bfloat16"           # activation dtype
    param_dtype: str = "float32"
    remat: bool = True                # activation checkpointing over layers
    attn_chunk_q: int = 0             # query-chunked attention (0 = full)
    logit_chunk: int = 0              # chunked loss/logits (0 = full)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def adtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6·N·D)."""
        d, v, L = self.d_model, self.vocab, self.n_layers
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            s = self.ssm
            d_in = s.expand * d
            nheads = d_in // s.head_dim
            per = (d * (2 * d_in + 2 * s.d_state + nheads)   # in_proj
                   + s.d_conv * (d_in + 2 * s.d_state)        # conv
                   + nheads                                    # A, dt bias
                   + d_in * d + d)                             # out_proj + norm
            return emb + L * per
        if self.family == "griffin":
            g = self.griffin
            w = g.lru_width or d
            per_rec = d * 2 * w + w * d + g.conv_width * w + 2 * w * w // 1 \
                + 2 * w + d * 3 * self.d_ff // 1
            per_attn = self._attn_params() + d * 3 * self.d_ff
            n_attn = sum(1 for i in range(L)
                         if g.pattern[i % len(g.pattern)] == "attn")
            return emb + n_attn * per_attn + (L - n_attn) * per_rec
        per_layer = self._attn_params() + self._ffn_params()
        enc = 0
        if self.n_encoder_layers:
            enc = self.n_encoder_layers * (self._attn_params()
                                           + d * 2 * self.d_ff)
            per_layer += self._attn_params()   # cross attention
        return emb + L * per_layer + enc

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.hd
        if self.mla is not None:
            m = self.mla
            qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
            return (d * m.q_lora_rank + m.q_lora_rank * self.n_heads * qk_hd
                    + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    + m.kv_lora_rank * self.n_heads *
                    (m.qk_nope_head_dim + m.v_head_dim)
                    + self.n_heads * m.v_head_dim * d)
        return d * hd * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * hd * d

    def _ffn_params(self) -> int:
        d = self.d_model
        if self.moe is not None:
            m = self.moe
            routed = m.n_experts * 3 * d * m.expert_d_ff
            shared = m.n_shared * 3 * d * (m.shared_d_ff or m.expert_d_ff)
            router = d * m.n_experts
            return routed + shared + router
        mult = 3 if self.act == "silu" else 2   # SwiGLU vs GELU
        return mult * d * self.d_ff

    def active_param_count(self) -> int:
        """Activated params per token (MoE: 6·N_active·D)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        d = self.d_model
        full_ffn = self._ffn_params()
        active_ffn = (m.top_k + m.n_shared) * 3 * d * m.expert_d_ff \
            + d * m.n_experts
        return self.param_count() - self.n_layers * (full_ffn - active_ffn)
