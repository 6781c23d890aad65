"""Phase 11 or 12 of ``chip_smoke.py`` for several checkouts in turns, each
in a process of its own, on the card: phase 11 serves Whisper-large-v3
(8 x 1500 frames, a 4-token prompt, 32 decode steps: ``whisper_phase``),
phase 12 trains Qwen3-0.6B (8 x 2048 tokens a step: ``train_phase``).

    python scripts/phase_turns.py [--phase 11|12] TREE [TREE ...]

Each TREE is the root of a checkout (``chip_smoke.py`` and ``src/``); give
a parent and its change as ``PARENT CHANGE CHANGE PARENT`` to compare them
on one card in one call.  A turn prints one line ``PHASE<n> {json}``: the
tree and its times (phase 11: encoder and prefill ms, decode ms a step,
tokens/s; phase 12: the median ms a step, tokens/s) and the peak device
bytes (``torch.cuda.max_memory_allocated``); phase 12's work directory is
a temporary one under the tree's ``build/``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

TURN = {11: r"""
import json, sys
sys.path.insert(0, ".")
import chip_smoke
from repro_torch.kernels import build
build.build_all()                    # not inside the phase's timed steps
r = chip_smoke.whisper_phase(0)
print("PHASE11 " + json.dumps({k: r[k] for k in (
    "encoder_and_prefill_ms", "decode_ms_per_step", "tokens_per_s",
    "peak_bytes")}))
""", 12: r"""
import json, sys, tempfile
sys.path.insert(0, ".")
import chip_smoke
with tempfile.TemporaryDirectory(dir="build") as wd:
    r = chip_smoke.train_phase(0, wd)
print("PHASE12 " + json.dumps({k: r[k] for k in
                               ("ms_per_step", "tokens_per_s", "peak_bytes")}))
"""}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", type=int, choices=sorted(TURN), default=12)
    ap.add_argument("trees", nargs="+")
    args = ap.parse_args()
    tag = f"PHASE{args.phase} "
    for tree in args.trees:
        tree = os.path.abspath(tree)
        os.makedirs(os.path.join(tree, "build"), exist_ok=True)
        env = {**os.environ, "PYTHONPATH": os.path.join(tree, "src")}
        out = subprocess.run([sys.executable, "-c", TURN[args.phase]],
                             cwd=tree, env=env, capture_output=True, text=True)
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith(tag)]
        if out.returncode or not lines:
            sys.exit(f"{tree}: exit {out.returncode}\n{out.stderr[-3000:]}")
        rec = json.loads(lines[-1][len(tag):])
        print(tag + json.dumps({"tree": tree, **rec}), flush=True)


if __name__ == "__main__":
    main()
