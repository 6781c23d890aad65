"""The measuring command refuses to run where it cannot measure, and never
falls back to the CPU."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from tidebench.tests.tiny import ROOT, tiny_cell


def _run(cwd, pre="", pythonpath=None):
    code = pre + ("import runpy, sys\n"
                  "sys.argv = ['tidebench.run', '--workload', 'tide-1k.read',"
                  " '--seed', '1', '--seconds', '1', '--trace', '0']\n"
                  "runpy.run_module('tidebench.run', run_name='__main__')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    if pythonpath:
        env["PYTHONPATH"] = pythonpath
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _no_result(res):
    return not any(line.startswith("{")
                   for line in res.stdout.strip().splitlines())


def test_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the refusal needs none")
    res = _run(ROOT)
    assert res.returncode != 0 and _no_result(res)
    assert "CUDA card" in res.stderr


def test_refuses_without_the_program(tmp_path):
    """A checkout that holds only BENCHMARK.json and the benchmark's own
    files: no result, a non-zero exit (a card is stood in for)."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "tidebench", tmp_path / "tidebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pre = ("import torch\n"
           "torch.cuda.is_available = lambda: True\n"
           "torch.cuda.device_count = lambda: 1\n")
    res = _run(tmp_path, pre)
    assert res.returncode != 0 and _no_result(res)
    assert "program is missing" in res.stderr


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tide-1k.read", "test.ingest"])
def test_tiny_cell_on_the_card(card, name):
    """The cell's loop with the kernels on the card, at a tiny size: every
    answer right."""
    from tidebench.drivers.store import run
    config, workload = tiny_cell(name)
    out = run(config, workload, 5, 30.0, device="cuda", max_rounds=3)
    assert all(v == 0 for v in out["checks"].values()), out["checks"]
    assert json.dumps(out["dispatches"])


_FAKE_RUN = (
    "import torch\n"
    "torch.cuda.is_available = lambda: True\n"
    "torch.cuda.device_count = lambda: 1\n"
    "torch.cuda.get_device_name = lambda i=0: 'stand-in'\n"
    "import tidebench.drivers.store as store\n"
    "def fake(config, workload, seed, seconds, **kw):\n"
    "    return {'recorder': None, 'rounds': 1, 'round_ends': [1.0],\n"
    "            'spans': {}, 'copy_threads': 1, 'counters': {},\n"
    "            'memory_peak_bytes': 1, 'attempted': 2, 'failed': 0,\n"
    "            'gets': 1, 'get_s': 1.0, 'exists': 1, 'exists_s': 1.0,\n"
    "            'setup_s': 1.0, 'checks': {'wrong_exists': 0,\n"
    "                                       'wrong_values': 0}}\n"
    "store.run = fake\n")


@pytest.mark.parametrize("loads_jax", [True, False])
def test_a_reader_that_loads_jax_leaves_no_result(tmp_path, loads_jax):
    """The look for JAX modules comes after every metric reader has run: a
    reader that loads a module named ``jax`` costs the run its result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "tidebench", tmp_path / "tidebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    reader = tmp_path / "tidebench" / "metrics" / "setup_s.py"
    reader.write_text(
        ("import sys, types\n"
         "sys.modules.setdefault('jax', types.ModuleType('jax'))\n"
         if loads_jax else "") +
        "def read(run, cell):\n    return run['setup_s']\n")
    res = _run(tmp_path, _FAKE_RUN, pythonpath=str(ROOT / "src"))
    if loads_jax:
        assert res.returncode != 0 and _no_result(res), res.stdout[-2000:]
        assert "jax" in res.stderr
    else:
        assert res.returncode == 0, res.stderr[-3000:]
        last = json.loads(res.stdout.strip().splitlines()[-1])
        assert last["correct"] and "setup_s" in last["metrics"]
