"""Tiny versions of the benchmark's cells, for tests on the CPU: the same
round programs at a 64th of the batch sizes, a few rounds long.

Besides the cells of ``BENCHMARK.json``, two programs that no cell runs yet
keep the store driver's other steps under test (puts in the window, a reopen
check after it, epochs and ``prune_step``), so that a later cell can use
them by a traffic file alone."""
from __future__ import annotations

import json
from pathlib import Path

from tidebench.run import load_cell

ROOT = Path(__file__).resolve().parents[2]
CELLS = ("tide-1k.read",)

_WRITE = {
    "driver": "store", "keyspace": "kv",
    "preload": {"keys": 2048, "batch": 256, "then": "reopen"},
    "round": [{"op": "put", "n": 64},
              {"op": "exists", "n": 512, "present_share": 0.5,
               "from": "all", "every": 2}],
    "reopen_check": {"present": 512, "absent": 256},
    "space_sample_s": 0.001,
    "limits": {"wrong_exists": 0, "wrong_values": 0, "lost_after_reopen": 0},
}
_INGEST = {
    "driver": "store", "keyspace": "kv",
    "preload": {"keys": 2048, "batch": 256, "then": "flush"},
    "round": [{"op": "exists", "n": 256, "present_share": 0.5,
               "from": "retained"},
              {"op": "put", "n": 64},
              {"op": "prune"}],
    "reopen_check": {"present": 512, "absent": 256},
    "limits": {"wrong_exists": 0, "wrong_values": 0, "lost_after_reopen": 0},
}
PROGRAMS = {"test.write": _WRITE, "test.ingest": _INGEST}


def tiny_cell(name: str) -> tuple[dict, dict]:
    if name in PROGRAMS:
        config, _, _ = load_cell(ROOT, CELLS[0])
        config = json.loads(json.dumps(config))
        workload = json.loads(json.dumps(PROGRAMS[name]))
        if name == "test.ingest":
            config["epoch_keys"] = 1024
            config["store"].update(
                mem_budget_entries=256,
                prune={"retain_epochs": 2, "space_amp_trigger": 3.0,
                       "min_reclaim_bytes": 1 << 20, "reclaim_fraction": 0.25,
                       "batch_records": 256})
        return config, workload
    config, workload, _ = load_cell(ROOT, name)
    config = json.loads(json.dumps(config))
    workload = json.loads(json.dumps(workload))
    if workload.get("preload"):
        workload["preload"].update(keys=2048, batch=256)
    for step in workload["round"]:
        if "n" in step:
            step["n"] = max(64, step["n"] // 64)
        if "every" in step:
            step["every"] = 2
    if workload.get("reopen_check"):
        workload["reopen_check"] = {"present": 512, "absent": 256}
    return config, workload
