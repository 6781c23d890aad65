"""Data pipeline: deterministic synthetic token shards + a content-addressed
sample store backed by the Tidehunter engine.

The dedup store is the paper's content-addressable workload (§1: "keys lack
locality by design"): samples are keyed by blake2b of their token bytes, so
re-ingesting a shard writes nothing new, and epoch-expired shards are
reclaimed at WAL-segment granularity.

The JAX package's ``data/pipeline.py`` over the port's ``TideDB``: the
batches are the same numpy bits, and the store takes a ``device`` as
``DbConfig`` does (``"cuda"`` by default; it raises without a card).
"""
from __future__ import annotations

import hashlib
from typing import Optional

import numpy as np

from repro_torch.core.tidestore import DbConfig, KeyspaceConfig, TideDB
from repro_torch.core.tidestore.wal import WalConfig


def synthetic_batch(step: int, batch: int, seq: int, vocab: int,
                    seed: int = 0) -> dict:
    """Deterministic per-step batch (restart-safe: same step ⇒ same data)."""
    rng = np.random.default_rng(np.uint64(seed * 1_000_003 + step))
    tokens = rng.integers(0, vocab, (batch, seq + 1), dtype=np.int32)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


class ContentAddressedStore:
    """Dedup sample store: put-if-absent by content hash."""

    def __init__(self, path: str, background: bool = True,
                 device: str = "cuda"):
        cfg = DbConfig(
            keyspaces=[KeyspaceConfig("samples", n_cells=128,
                                      dirty_flush_threshold=1024)],
            wal=WalConfig(segment_size=16 * 1024 * 1024,
                          background=background),
            index_wal=WalConfig(segment_size=8 * 1024 * 1024,
                                background=background),
            background_snapshots=background,
            device=device,
        )
        self.db = TideDB(path, cfg)
        self.dedup_hits = 0
        self.inserted = 0

    @staticmethod
    def key_of(sample: bytes) -> bytes:
        return hashlib.blake2b(sample, digest_size=32).digest()

    def put(self, sample: bytes, epoch: int = 0) -> bytes:
        key = self.key_of(sample)
        if self.db.exists(key, keyspace="samples"):
            self.dedup_hits += 1          # bloom+index, no value fetched
            return key
        self.db.put(key, sample, keyspace="samples", epoch=epoch)
        self.inserted += 1
        return key

    def get(self, key: bytes) -> Optional[bytes]:
        return self.db.get(key, keyspace="samples")

    def ingest_tokens(self, tokens: np.ndarray, epoch: int = 0) -> list[bytes]:
        return [self.put(np.ascontiguousarray(row).tobytes(), epoch)
                for row in tokens]

    def expire_epochs_below(self, epoch: int) -> int:
        return self.db.prune_epochs_below(epoch)

    def close(self) -> None:
        self.db.close()
