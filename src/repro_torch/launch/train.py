"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Wires a registry config (full or smoke), synthetic batches, tidestore
checkpointing and the restartable loop, with random weights from a seeded
``torch.Generator``.  Runs on the card by default; ``--device cpu`` runs on
the host (with ``--smoke``, the architecture's small configuration).
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.models.base import ModelConfig
from repro_torch.training.loop import LoopConfig, run
from repro_torch.training.optimizer import AdamWConfig


def make_batch_fn(cfg: ModelConfig, batch: int, seq: int, device):
    """step → that step's synthetic batch on ``device``, with the vlm's
    patch embeddings and M-RoPE positions and the encdec's frames (zeros:
    the frontends are stubs)."""
    def batch_fn(step: int) -> dict:
        b = synthetic_batch(step, batch, seq, cfg.vocab)
        out = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
        if cfg.family == "vlm":
            out["vision_embed"] = torch.zeros((batch, 4, cfg.d_model),
                                              dtype=cfg.adtype, device=device)
            pos = torch.arange(seq, dtype=torch.int32, device=device)
            out["mrope_positions"] = pos.expand(3, batch, seq)
        if cfg.family == "encdec":
            out["frames"] = torch.zeros(
                (batch, cfg.encoder_seq, cfg.encoder_dim), dtype=cfg.adtype,
                device=device)
        return out
    return batch_fn


def launcher_opt(lr: float, steps: int) -> AdamWConfig:
    """The launcher's optimizer: ``lr`` after a warmup of a fifth of the
    run (at most 20 steps)."""
    return AdamWConfig(lr=lr, warmup_steps=min(20, steps // 5 + 1))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch-train"))
    ap.add_argument("--checkpoint-every", type=int, default=25)
    args = ap.parse_args()

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card: pass --device cpu to train on the "
                         "host")
    cfg = get_config(args.arch, smoke=args.smoke)
    summary = run(cfg, launcher_opt(args.lr, args.steps),
                  LoopConfig(total_steps=args.steps,
                             checkpoint_every=args.checkpoint_every),
                  make_batch_fn(cfg, args.batch, args.seq, args.device),
                  args.ckpt_dir, device=args.device)
    peak = (f", peak device memory {torch.cuda.max_memory_allocated()} B"
            if args.device == "cuda" else "")
    first = summary["losses"][0] if summary["losses"] else float("nan")
    print(f"[train] {args.arch}: loss {first:.4f} → "
          f"{summary['final_loss']:.4f} over {args.steps} steps "
          f"(resumed_from={summary['resumed_from']}){peak}")


if __name__ == "__main__":
    main()
