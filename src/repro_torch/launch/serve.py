"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Runs the continuous-batching engine over the Tidehunter KV-WAL with a
synthetic request stream and random weights from a seeded
``torch.Generator``; reports throughput and segment-recycling stats.  Runs
on the card by default; ``--device cpu`` runs the kernels' plain versions,
and ``--smoke`` takes the architecture's small configuration.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.models import transformer as T
from repro_torch.serving.engine import ServingEngine


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    args = ap.parse_args()

    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.family not in T.KV_WAL_FAMILIES:
        raise SystemExit(f"{args.arch}: the port's serving engine serves the "
                         f"KV-WAL families ({', '.join(T.KV_WAL_FAMILIES)}), "
                         f"not {cfg.family}")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card: pass --device cpu to serve on the "
                         "host")
    gen = torch.Generator(device=args.device)
    gen.manual_seed(0)
    engine = ServingEngine(cfg, T.init_params(cfg, gen),
                           batch_slots=args.slots, max_seq=args.max_seq,
                           device=args.device)
    rng = np.random.default_rng(0)
    reqs = [engine.submit(rng.integers(0, cfg.vocab, 1 + i % 5),
                          max_new_tokens=args.max_new_tokens)
            for i in range(args.requests)]
    t0 = time.time()
    while engine.queue or engine.active:
        engine.step()
    dt = time.time() - t0
    toks = sum(len(r.out_tokens) for r in reqs)
    peak = (f", peak device memory {torch.cuda.max_memory_allocated()} B"
            if args.device == "cuda" else "")
    print(f"[serve] {args.arch} on {args.device}: {len(reqs)} requests, "
          f"{toks} tokens, {toks / dt:.1f} tok/s, segments recycled="
          f"{engine.segments_recycled}{peak}")


if __name__ == "__main__":
    main()
