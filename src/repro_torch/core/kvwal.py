"""Device KV-WAL: Tidehunter's value-arena architecture in device memory.

The serving KV cache is an **append-once arena** of fixed-size blocks with a
slot table as the index — the Large Table analogue.  Values (per-token KV
entries per kv-head) are written exactly once at an allocated (block,
offset) slot and never relocated:

- ``append_token``   — the atomic-allocation write path (§3.1): slot =
  table[seq_len // block]; offset = seq_len % block.  Vectorized over the
  batch (one decode step = one batch of concurrent writers).
- ``gather``         — the read path (§3.2) as a plain copy through the
  table; the decode step reads through the table inside the
  ``tide_attention`` kernel instead and never materializes this copy.
- ``first_live``     — the epoch-pruning watermark (§4.4): whole blocks
  (segments) expire as requests finish or windows slide; no KV byte is ever
  copied.  The host engine recycles expired blocks at segment granularity.

Layout and table are the JAX package's (``repro/core/kvwal.py``): arenas
``(L, B, n_blocks, block, KH, D)``, an identity table at start.  Where the
JAX package returns a new array (``.at[].set``, ``dynamic_update_slice``),
the port writes into the arena in place and returns it.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class KVWalSpec:
    n_layers: int
    batch: int
    max_seq: int
    kv_heads: int
    entry_dim: int              # per-stripe entry dims (head_dim)
    block_size: int = 128       # slots per block
    dtype: str = "bfloat16"

    @property
    def n_blocks(self) -> int:
        return (self.max_seq + self.block_size - 1) // self.block_size

    def arena_shape(self) -> tuple:
        return (self.n_layers, self.batch, self.n_blocks, self.block_size,
                self.kv_heads, self.entry_dim)


def identity_table(batch: int, n_blocks: int, device) -> torch.Tensor:
    """(batch, n_blocks) int32 slot table mapping every logical block to the
    physical block of the same number (blocks allocated append-only)."""
    return torch.arange(n_blocks, dtype=torch.int32, device=device).repeat(
        batch, 1)


def init_cache(spec: KVWalSpec, device="cuda") -> dict:
    """Fresh arena + identity table."""
    return {
        "arena": torch.zeros(spec.arena_shape(), dtype=getattr(torch, spec.dtype),
                             device=device),
        "table": identity_table(spec.batch, spec.n_blocks, device),
        "seq_lens": torch.zeros((spec.batch,), dtype=torch.int32,
                                device=device),
        "first_live": torch.zeros((spec.batch,), dtype=torch.int32,
                                  device=device),
    }


def cache_specs(spec: KVWalSpec) -> dict:
    """Meta-tensor stand-ins of ``init_cache(spec)`` for the dry run (no
    allocation)."""
    meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")
    return {
        "arena": meta(spec.arena_shape(), getattr(torch, spec.dtype)),
        "table": meta((spec.batch, spec.n_blocks), torch.int32),
        "seq_lens": meta((spec.batch,), torch.int32),
        "first_live": meta((spec.batch,), torch.int32),
    }


def append_token(arena_l: torch.Tensor, table: torch.Tensor,
                 seq_lens: torch.Tensor, entry: torch.Tensor) -> torch.Tensor:
    """Write one new token's entry per sequence into layer-arena ``arena_l``,
    in place, and return it.

    arena_l (B, n_blocks, block, KH, D); entry (B, KH, D).  The (block,
    offset) slot is derived from the monotonic per-sequence length counter —
    the atomic allocation of §3.1, vectorized.  A length at or past the
    arena's end reads the last table entry, as the JAX package's clamped
    gather does."""
    n_blocks, block = arena_l.shape[1], arena_l.shape[2]
    b_idx = torch.arange(arena_l.shape[0], device=arena_l.device)
    lens = seq_lens.long()
    logical = (lens // block).clamp(max=n_blocks - 1)
    phys = table[b_idx, logical].long()
    arena_l[b_idx, phys, lens % block] = entry.to(arena_l.dtype)
    return arena_l


def write_prefill(arena_l: torch.Tensor, entries: torch.Tensor) -> torch.Tensor:
    """Bulk write a freshly prefilled sequence (identity table), in place.

    entries (B, S, KH, D) with S ≤ n_blocks·block; the rest of the last
    block written is zeroed, as in the JAX package."""
    B, S, KH, D = entries.shape
    block = arena_l.shape[2]
    nb = -(-S // block)
    if nb > arena_l.shape[1]:
        raise ValueError(f"{S} entries do not fit {arena_l.shape[1]} blocks "
                         f"of {block}")
    chunk = arena_l[:, :nb].view(B, nb * block, KH, D)
    chunk[:, :S] = entries.to(arena_l.dtype)
    chunk[:, S:] = 0
    return arena_l


def gather(arena_l: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Read path as a copy: arena → (B, n_blocks·block, KH, D) through the
    table."""
    B, nb, blk, KH, D = arena_l.shape
    b_idx = torch.arange(B, device=arena_l.device)[:, None]
    return arena_l[b_idx, table.long()].reshape(B, nb * blk, KH, D)


def _block_of(cache: dict) -> int:
    for k in ("arena_k", "arena_v", "arena"):
        if k in cache:
            return cache[k].shape[3]
    raise KeyError("no arena leaf in cache")


def prune_below(cache: dict, min_live_positions: torch.Tensor) -> dict:
    """Epoch pruning: advance the per-sequence watermark to a block boundary.
    Blocks wholly below it are dead and recyclable — zero bytes moved."""
    block = _block_of(cache)
    aligned = (min_live_positions.to(torch.int32) // block) * block
    return dict(cache, first_live=torch.maximum(cache["first_live"], aligned))


def free_blocks(cache: dict) -> torch.Tensor:
    """Per-sequence count of expired (recyclable) blocks — the host engine
    uses this to recycle segments."""
    return cache["first_live"] // _block_of(cache)
