"""Phase 12 of ``chip_smoke.py`` (Qwen3-0.6B training, 8 x 2048 tokens a
step: ``train_phase``) for several checkouts in turns, each in a process
of its own, on the card.

    python scripts/phase12_turns.py TREE [TREE ...]

Each TREE is the root of a checkout (``chip_smoke.py`` and ``src/``); give
a parent and its change as ``PARENT CHANGE CHANGE PARENT`` to compare them
on one card in one call.  A turn prints one line ``PHASE12 {json}``: the
tree, the median ms a step, tokens/s and the peak device bytes
(``torch.cuda.max_memory_allocated``); the work directory is a temporary
one under the tree's ``build/``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

TURN = r"""
import json, sys, tempfile
sys.path.insert(0, ".")
import chip_smoke
with tempfile.TemporaryDirectory(dir="build") as wd:
    r = chip_smoke.train_phase(0, wd)
print("PHASE12 " + json.dumps({k: r[k] for k in
                               ("ms_per_step", "tokens_per_s", "peak_bytes")}))
"""


def main() -> None:
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    for tree in sys.argv[1:]:
        tree = os.path.abspath(tree)
        os.makedirs(os.path.join(tree, "build"), exist_ok=True)
        env = {**os.environ, "PYTHONPATH": os.path.join(tree, "src")}
        out = subprocess.run([sys.executable, "-c", TURN], cwd=tree, env=env,
                             capture_output=True, text=True)
        lines = [ln for ln in out.stdout.splitlines()
                 if ln.startswith("PHASE12 ")]
        if out.returncode or not lines:
            sys.exit(f"{tree}: exit {out.returncode}\n{out.stderr[-3000:]}")
        rec = json.loads(lines[-1][len("PHASE12 "):])
        print("PHASE12 " + json.dumps({"tree": tree, **rec}), flush=True)


if __name__ == "__main__":
    main()
