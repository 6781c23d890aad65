"""The dry run's whole matrix (every arch x shape x mesh), one process a
cell, several at once, then one table of the records.

    PYTHONPATH=src python scripts/dryrun_matrix.py [--jobs 8]
        [--src src] [--out experiments/dryrun_matrix] [--ref REF.json ...]
        [--against OTHER_OUT]

Each cell runs ``python -m repro_torch.launch.dryrun --arch A --shape S
--mesh M --out <out>/<A>_<S>_<M>.json`` with ``--src`` first on its
``PYTHONPATH`` (another checkout's ``src`` measures that tree: a parent
and its change in one run).  A cell that exists already is not run again.
The table gives, a device, the peak on the reference's terms, the
footprint and the collective bytes of each cell, its status where it is
not ``ok``, and any op run replicated; the last line counts the cells by
status (``ok``, SKIP, FAIL).  Each ``--ref`` is a record of the JAX
package's dry run (``python -m repro.launch.dryrun ... --out REF.json``):
a cell it holds gets the reference's peak and collectives a device beside
the port's, and the port's over them.  ``--against`` names another
matrix's ``--out`` (a parent's run): each cell both hold gets its peak,
footprint and collectives over that run's, and the last lines list the
cells where one of them is more than 5% above it.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ARCHS = ["qwen2-vl-72b", "llama3-8b", "qwen3-0.6b", "phi3-medium-14b",
         "phi3-mini-3.8b", "recurrentgemma-9b", "mamba2-1.3b",
         "qwen2-moe-a2.7b", "deepseek-v3-671b", "whisper-large-v3"]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
MESHES = ["single", "multi"]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--out", default="experiments/dryrun_matrix")
    ap.add_argument("--timeout", type=float, default=3000.0)
    ap.add_argument("--ref", action="append", default=[])
    ap.add_argument("--against", default=None)
    args = ap.parse_args()
    ref = {(r["arch"], r["shape"], r["mesh"]): r["roofline"]
           for path in args.ref for r in json.load(open(path))
           if r.get("status") == "ok"}
    os.makedirs(args.out, exist_ok=True)
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "",
           "PYTHONPATH": os.pathsep.join(
               [os.path.abspath(args.src)]
               + [p for p in os.environ.get("PYTHONPATH", "").split(
                   os.pathsep) if p])}
    todo = [(a, s, m) for a in ARCHS for s in SHAPES for m in MESHES
            if not os.path.exists(os.path.join(args.out, f"{a}_{s}_{m}.json"))]
    running, t0 = {}, time.time()
    while todo or running:
        while todo and len(running) < args.jobs:
            a, s, m = todo.pop(0)
            path = os.path.join(args.out, f"{a}_{s}_{m}")
            with open(path + ".log", "w") as log:
                running[(a, s, m)] = subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.dryrun",
                     "--arch", a, "--shape", s, "--mesh", m,
                     "--out", path + ".json.part"],
                    stdout=log, stderr=subprocess.STDOUT, env=env)
        for key, proc in list(running.items()):
            if proc.poll() is None and time.time() - t0 < args.timeout:
                continue
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            path = os.path.join(args.out, "_".join(key))
            if os.path.exists(path + ".json.part"):
                os.replace(path + ".json.part", path + ".json")
            del running[key]
        time.sleep(1.0)
    counts, rows, above = {}, [], []
    for a in ARCHS:
        for s in SHAPES:
            for m in MESHES:
                path = os.path.join(args.out, f"{a}_{s}_{m}.json")
                recs = json.load(open(path)) if os.path.exists(path) else \
                    [{"status": "FAIL: no record"}]
                r = recs[-1]
                base = _terms(os.path.join(args.against, f"{a}_{s}_{m}.json")
                              ) if args.against else None
                status = r["status"]
                kind = "ok" if status == "ok" else status.split("(")[0][:4]
                counts[kind] = counts.get(kind, 0) + 1
                if status != "ok":
                    rows.append(f"{a} x {s} x {m}: {status[:60]}")
                    continue
                mem = r["memory"]
                peak, coll = mem["peak_reference_terms"], \
                    r["roofline"]["collective_bytes"]
                rf = ref.get((a, s, r["mesh"]))
                over = [x / b for x, b in zip(
                    (peak, mem["footprint_bytes"], coll), base)] \
                    if base else None
                if over and max(over) > 1.05:
                    above.append(f"{a} x {s} x {m}: " + " / ".join(
                        f"{x:.3f}x" for x in over))
                rows.append(
                    f"{a} x {s} x {m}: {peak:.4e} / "
                    f"{mem['footprint_bytes']:.4e} / {coll:.4e}"
                    + (f" replicated {r['replicated_calls']}"
                       if r["replicated_calls"] else "")
                    + (f" | ref {rf['peak_memory_per_device']:.4e} / "
                       f"{rf['collective_bytes']:.4e}: "
                       f"{peak / rf['peak_memory_per_device']:.2f}x / "
                       f"{coll / rf['collective_bytes']:.2f}x" if rf else "")
                    + (" | against " + " / ".join(f"{x:.3f}x" for x in over)
                       if over else ""))
    print("\n".join(rows))
    if args.against:
        print(f"above {args.against} by more than 5%: {len(above)}")
        print("\n".join(above))
    print(f"cells: {counts} in {time.time() - t0:.0f} s")


def _terms(path: str):
    """(peak on the reference's terms, footprint, collectives) of the ok
    record at ``path``, or None."""
    if not os.path.exists(path):
        return None
    r = json.load(open(path))[-1]
    if r.get("status") != "ok":
        return None
    return (r["memory"]["peak_reference_terms"],
            r["memory"]["footprint_bytes"],
            r["roofline"]["collective_bytes"])


if __name__ == "__main__":
    main()
