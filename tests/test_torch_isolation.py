"""The port stands alone: it imports neither JAX nor the JAX package, and
its engines refuse to run without a card unless the caller asks for the
CPU."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch.core.tidestore as port
from repro_torch.configs.registry import get_config
from repro_torch.models import transformer
from repro_torch.serving.engine import ServingEngine

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
    assert "repro_torch.kernels.tide_attention.kernel" in mods
    assert "repro_torch.kernels.ssd_scan.kernel" in mods
    assert "repro_torch.models.ssm" in mods
    assert "repro_torch.models.griffin" in mods
    assert "repro_torch.models.serve" in mods
    assert "repro_torch.models.moe" in mods
    assert "repro_torch.models.mla" in mods
    assert "repro_torch.serving.engine" in mods
    for mod in ("core.tidestore.shard", "core.tidestore.repair",
                "core.tidestore.simulate", "serving.admission",
                "serving.kv_server", "training.optimizer", "training.step",
                "training.loop", "training.straggler", "core.checkpoint",
                "core.tree", "data.pipeline", "launch.train",
                "distributed.sharding", "distributed.compression",
                "distributed.pipeline", "launch.mesh", "launch.dryrun",
                "roofline.hw", "roofline.op_cost", "roofline.analysis"):
        assert f"repro_torch.{mod}" in mods, mod
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


def test_kv_server_needs_neither_torch_nor_the_model_stack():
    """The storage server imports the host engine only: PyTorch loads when
    a store first checks its device or launches a kernel."""
    code = (
        "import sys\n"
        "from repro_torch.serving.kv_server import KvBatchServer\n"
        "from repro_torch.core.tidestore import ShardedTideDB\n"
        "bad = sorted(m for m in sys.modules if m == 'torch' or "
        "m.startswith('repro_torch.models'))\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(PKG.parent)})
    assert res.returncode == 0, res.stdout + res.stderr


def test_sharded_exports_match_the_reference():
    """The port's storage package exports the reference's names."""
    import repro.core.tidestore as ref
    assert sorted(port.__all__) == sorted(ref.__all__)
    assert all(hasattr(port, name) for name in port.__all__)


def test_default_device_needs_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port.DbConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        port.TideDB(str(tmp_path / "db"), port.DbConfig())
    assert not (tmp_path / "db").exists()        # refused before any I/O
    with port.TideDB(str(tmp_path / "cpu"), port.DbConfig(device="cpu")) as db:
        db.put(b"k" * 32, b"v")
        assert db.get(b"k" * 32) == b"v"


def test_serving_engine_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("llama3-8b", smoke=True)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cfg, params)
    engine = ServingEngine(cfg, params, device="cpu", max_seq=16)
    engine.submit([1, 2, 3], max_new_tokens=2)
    assert [len(r.out_tokens) for r in engine.run_until_drained()] == [2]
