"""Architecture registry and assigned input shapes.

The JAX package's ``input_specs`` (dry-run stand-ins) is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.models.base import ModelConfig

from . import (deepseek_v3_671b, llama3_8b, mamba2_1_3b, phi3_medium_14b,
               phi3_mini_3_8b, qwen2_moe_a2_7b, qwen2_vl_72b,
               qwen3_0_6b, recurrentgemma_9b, whisper_large_v3)

_MODULES = {
    "qwen2-vl-72b": qwen2_vl_72b,
    "llama3-8b": llama3_8b,
    "qwen3-0.6b": qwen3_0_6b,
    "phi3-medium-14b": phi3_medium_14b,
    "phi3-mini-3.8b": phi3_mini_3_8b,
    "recurrentgemma-9b": recurrentgemma_9b,
    "mamba2-1.3b": mamba2_1_3b,
    "qwen2-moe-a2.7b": qwen2_moe_a2_7b,
    "deepseek-v3-671b": deepseek_v3_671b,
    "whisper-large-v3": whisper_large_v3,
}

ARCH_IDS = list(_MODULES)

# Sub-quadratic families run long_500k; pure full-attention archs skip it.
SUBQUADRATIC = {"recurrentgemma-9b", "mamba2-1.3b"}


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    mod = _MODULES[arch]
    return mod.SMOKE if smoke else mod.FULL


def runnable(arch: str, shape: str) -> tuple[bool, str]:
    """Whether this (arch × shape) cell runs; reason string when skipped."""
    if shape == "long_500k" and arch not in SUBQUADRATIC:
        return False, "SKIP(full-attn: O(S) KV for 500k decode is out of " \
                      "scope per assignment; sub-quadratic archs only)"
    return True, ""
