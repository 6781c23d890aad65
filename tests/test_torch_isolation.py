"""The port stands alone: it imports neither JAX nor the JAX package, and
its engine refuses to run without a card unless the caller asks for the
CPU."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch.core.tidestore as port

PKG = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        parts = path.relative_to(PKG.parent).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def test_imports_neither_jax_nor_repro():
    mods = list(_modules())
    assert "repro_torch.core.tidestore.db" in mods
    assert "repro_torch.kernels.bloom_check.kernel" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(sys.modules), bad)\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(PKG.parent)})
    assert res.returncode == 0, res.stdout + res.stderr


def test_default_device_needs_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port.DbConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        port.TideDB(str(tmp_path / "db"), port.DbConfig())
    assert not (tmp_path / "db").exists()        # refused before any I/O
    with port.TideDB(str(tmp_path / "cpu"), port.DbConfig(device="cpu")) as db:
        db.put(b"k" * 32, b"v")
        assert db.get(b"k" * 32) == b"v"
