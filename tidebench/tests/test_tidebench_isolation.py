"""Nothing the benchmark runs imports JAX, the JAX package (``repro``) or
its benchmarks (``benchmarks``): top-level module names compared whole, since
the port's name (``repro_torch``) begins with the JAX package's."""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

from tidebench.tests.tiny import CELLS, PROGRAMS, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _imported_tops(path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "tidebench").rglob("*.py"))
    assert len(files) > 15
    for path in files:
        assert not _imported_tops(path) & FORBIDDEN, path


def test_a_tiny_run_of_each_cell_loads_no_jax_module():
    code = (
        "import json, sys\n"
        "from tidebench.drivers.store import run\n"
        "from tidebench.tests.tiny import tiny_cell\n"
        f"for name in {list(CELLS) + list(PROGRAMS)!r}:\n"
        "    config, workload = tiny_cell(name)\n"
        "    out = run(config, workload, 3, 30.0, device='cpu', max_rounds=2)\n"
        "    assert out['rounds'] == 2\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    tops = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in tops
    assert not tops & FORBIDDEN, tops & FORBIDDEN
