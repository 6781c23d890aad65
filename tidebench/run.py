"""Run one cell of the benchmark once, on the card, and print its result.

    python3 -m tidebench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell's entry in ``BENCHMARK.json`` names
its configuration (``tidebench/configs/<config>.json``); its traffic is
``tidebench/workloads/<cell>.json``, whose ``driver`` names the module in
``tidebench/drivers/`` that runs it; each metric is read by
``tidebench/metrics/<metric>.py``.  With ``--trace 0`` the line carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, read
from a profiled window.

Standard output holds one line, a JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, and with ``--trace 1`` ``breakdown``,
then ``checks``: each number compared with its limit).  Standard error
carries the diagnostics (calls, rounds, counters, with ``--trace 1`` the
kernels' dispatches a round) and, last, each number compared and its limit.  The
run prints no result and exits non-zero without a CUDA card, with fewer
cards than the cell asks for, without the program (``src/repro_torch``), or
if JAX, the JAX package or its benchmarks were loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def prepare(root: Path) -> None:
    """Fixed build and kernel-cache directories inside the checkout, and
    the program's source on the import path."""
    cache = root / "build" / "tidebench"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(cache / "repro_torch")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def load_cell(root: Path, name: str) -> tuple[dict, dict, dict]:
    """(configuration, traffic, the cell's entry) of the cell ``name``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / conf["file"]).read_text())
    workload = json.loads(
        (root / "tidebench" / "workloads" / f"{name}.json").read_text())
    return config, workload, cell


def metrics_of(root: Path, name: str, trace: bool) -> list[dict]:
    """The metric entries ``BENCHMARK.json`` gives the cell: its end-to-end
    metrics, or with tracing its per-layer ones."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind]
            if "workloads" not in m or name in m["workloads"]]


def read_metric(root: Path, name: str, out: dict, cell: str):
    """The value ``tidebench/metrics/<name>.py`` reads from the run, or
    None where it finds nothing to read."""
    path = root / "tidebench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"tidebench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(out, cell)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def result_of(root: Path, name: str, workload: dict, out: dict,
              device: dict, trace: bool) -> dict:
    """The result line of a run of the cell ``name``: its metrics, read by
    their readers from what the driver returned, and the verdict, each
    number compared against the workload's limit for it."""
    metrics = {}
    for m in metrics_of(root, name, trace):
        value = read_metric(root, m["name"], out, name)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {k: {"value": n, "limit": workload["limits"][k]}
              for k, n in out["checks"].items()}
    correct = bool(checks) and out["failed"] == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    return {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device,
            "checks": checks}


def _cpu_model() -> str | None:
    """The host CPU's model name, for the diagnostics: runs on different
    hosts are compared only with it in view."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return None


def _fail(code: int, msg: str) -> int:
    print(f"tidebench: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    prepare(ROOT)
    config, workload, cell = load_cell(ROOT, args.workload)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        return _fail(3, f"the cell needs {cell['chips']} CUDA card(s); "
                        f"{torch.cuda.device_count()} available")
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        return _fail(4, f"the program is missing: {e}")
    driver = importlib.import_module(f"tidebench.drivers.{workload['driver']}")
    out = driver.run(config, workload, args.seed, args.seconds,
                     trace=bool(args.trace), t_start=T_START)

    rec = out["recorder"]
    ends = out.get("round_ends") or []
    print(json.dumps({
        "workload": args.workload, "seed": args.seed, "rounds": out["rounds"],
        "host_s_by_call": {k: sum(v) for k, v in out["spans"].items()},
        "round_s": [round(b - a, 4) for a, b in zip([0.0] + ends, ends)],
        "cpu": _cpu_model(), "copy_threads": out["copy_threads"],
        "counters": {k: v for k, v in out["counters"].items() if v}}),
        file=sys.stderr, flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": out["memory_peak_bytes"]}
    breakdown = None
    if args.trace:
        from .trace import DeviceTrace
        with tempfile.TemporaryDirectory(prefix="tidebench-trace-") as tmp:
            rec.export(os.path.join(tmp, "trace.json"))
            dt = DeviceTrace.load(os.path.join(tmp, "trace.json"))
        out["trace"] = dt
        device["busy_s"] = dt.busy_s()
        device["window_s"] = ((dt.window[1] - dt.window[0]) / 1e6
                              if dt.window else rec.window_s)
        out["device_window_s"] = device["window_s"]
        breakdown = {"device_ops": dt.device_ops(), "idle_gaps": dt.idle_gaps()}
        rounds = max(out["rounds"], 1)
        print(json.dumps({
            "workload": args.workload, "rounds": out["rounds"],
            "dispatches_per_round": {k: v / rounds
                                     for k, v in out["dispatches"].items()},
            "cells": out["cells"],
            "host_s_by_span": dt.host_s_by_span()}),
            file=sys.stderr, flush=True)

    result = result_of(ROOT, args.workload, workload, out, device,
                       bool(args.trace))
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = result.pop("checks")
    # Last, once the trace is read and every metric reader has run: any of
    # them could have loaded what the port must not load.
    bad = forbidden_modules()
    if bad:
        return _fail(5, f"modules loaded that the port must not load: {bad}")
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
