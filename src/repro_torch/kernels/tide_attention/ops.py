"""Host-facing entry for tide_attention.

``decode_attention`` picks by the tensors' device: CUDA tensors launch the
kernel (``kernel.py``, which raises on what it cannot take), CPU tensors
take the plain version (``ref.py``), any other device raises.
"""
from __future__ import annotations

import torch

from ..build import on_card
from .kernel import tide_attention
from .ref import tide_attention_ref


def decode_attention(q: torch.Tensor, arena_k: torch.Tensor,
                     arena_v: torch.Tensor, table: torch.Tensor,
                     seq_lens: torch.Tensor, first_live: torch.Tensor, *,
                     window: int = 0, scale: float | None = None
                     ) -> torch.Tensor:
    """Decode attention through the KV-WAL: q (B,H,dk), arenas
    (B,NB,blk,KH,d), table (B,NB) int32, seq_lens/first_live (B,) int32
    → (B,H,dv) in q's dtype."""
    fn = tide_attention if on_card(q, "tide_attention") else tide_attention_ref
    return fn(q, arena_k, arena_v, table, seq_lens, first_live,
              window=window, scale=scale)
