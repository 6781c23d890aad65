"""The port's public helpers default to the card, as ``DbConfig`` and
``ServingEngine`` do: without a card, a call that names no device raises
instead of handing back CPU tensors.  The CPU tests name ``device="cpu"``.
"""
import inspect

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core import kvwal
from repro_torch.models import convert, serve

SPEC = kvwal.KVWalSpec(n_layers=1, batch=2, max_seq=16, kv_heads=1,
                       entry_dim=4, block_size=8, dtype="float32")
HELPERS = {
    "serve.init_cache": (serve.init_cache, lambda **kw: serve.init_cache(
        get_config("llama3-8b", smoke=True), 1, 16, **kw)),
    "kvwal.init_cache": (kvwal.init_cache,
                         lambda **kw: kvwal.init_cache(SPEC, **kw)),
    "params_from_numpy": (convert.params_from_numpy,
                          lambda **kw: convert.params_from_numpy(
                              {"w": np.ones((2, 3), np.float32),
                               "tail": [np.zeros(4, np.float32)]}, **kw)),
    "cache_from_numpy": (convert.cache_from_numpy,
                         lambda **kw: convert.cache_from_numpy(
                             {"pos": np.arange(3, dtype=np.int32)}, **kw)),
}


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("name", list(HELPERS))
def test_helper_defaults_to_the_card(name):
    fn, call = HELPERS[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert {t.device.type for t in _leaves(call(device="cpu"))} == {"cpu"}
    if torch.cuda.is_available():
        assert {t.device.type for t in _leaves(call())} == {"cuda"}
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            call()


def test_training_defaults_need_a_card(tmp_path, monkeypatch):
    """The checkpoint manager, the training loop and the sample store
    default to the card and refuse to start without one, before any I/O."""
    from repro_torch.core.checkpoint import CheckpointManager
    from repro_torch.data.pipeline import ContentAddressedStore
    from repro_torch.training.loop import LoopConfig, run
    from repro_torch.training.optimizer import AdamWConfig
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (CheckpointManager, ContentAddressedStore, run):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        CheckpointManager(str(tmp_path / "ckpt"))
    with pytest.raises(RuntimeError, match="CUDA"):
        ContentAddressedStore(str(tmp_path / "samples"))
    with pytest.raises(RuntimeError, match="CUDA"):
        run(get_config("llama3-8b", smoke=True), AdamWConfig(),
            LoopConfig(total_steps=1), lambda step: {}, str(tmp_path / "run"))
    assert not any(tmp_path.iterdir())
    CheckpointManager(str(tmp_path / "cpu"), device="cpu").close()


def test_host_mesh_needs_a_card(monkeypatch):
    """``make_host_mesh`` builds on the card unless ``device="cpu"`` is
    passed; without a card it refuses before touching a process group."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert inspect.signature(make_host_mesh).parameters["device"].default \
        == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        make_host_mesh()
    with pytest.raises(RuntimeError, match="live process group"):
        make_host_mesh(device="cpu")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            make_host_mesh()
        mesh = make_host_mesh(device="cpu")
        assert mesh.device_type == "cpu" and tuple(mesh.shape) == (1, 1)
        assert mesh.mesh_dim_names == ("data", "model")
    finally:
        dist.destroy_process_group()
