"""Restore onto placements: the mirror of
``tests/test_training.py::TestCheckpointRestart::
test_elastic_restore_with_shardings``, on a (1, 1) ("data", "model") mesh
over a gloo group of one rank, and the same through the training loop's
``shardings``."""
import torch
import torch.distributed as dist
import pytest

from repro_torch.configs.registry import get_config
from repro_torch.core.checkpoint import CheckpointManager
from repro_torch.core.tree import leaves, leaves_with_path, path_str, tree_map
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as T
from repro_torch.training.loop import LoopConfig, run
from repro_torch.training.optimizer import AdamWConfig

CFG = get_config("llama3-8b", smoke=True)


@pytest.fixture
def mesh():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield make_host_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def _bytes(t) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def test_elastic_restore_with_shardings(mesh, tmpdir):
    """Restart on a different topology: restore with explicit shardings
    (topology-agnostic checkpoint values)."""
    from torch.distributed.tensor import DTensor
    params = T.init_params(CFG, torch.Generator().manual_seed(2))
    ckpt = CheckpointManager(str(tmpdir), device="cpu")
    ckpt.save(3, params)
    assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == {"data": 1,
                                                          "model": 1}
    shardings = sharding.named(sharding.param_specs(params, mesh), mesh)
    like = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), params)
    restored, step = ckpt.restore(like, shardings=shardings)
    plain, _ = ckpt.restore(like)
    assert step == 3
    leaf = leaves(restored)[0]
    assert isinstance(leaf, DTensor)
    assert dict(zip(leaf.device_mesh.mesh_dim_names,
                    leaf.device_mesh.shape)) == {"data": 1, "model": 1}
    want = {path_str(p): t for p, t in leaves_with_path(plain)}
    for p, t in leaves_with_path(restored):
        assert _bytes(t.full_tensor()) == _bytes(want[path_str(p)])
        assert _bytes(want[path_str(p)]) == _bytes(
            {path_str(q): u for q, u in leaves_with_path(params)}[
                path_str(p)])
    ckpt.close()


def test_loop_resumes_onto_shardings(mesh, tmpdir):
    opt = AdamWConfig(lr=1e-3, warmup_steps=1)
    batch = lambda step: {
        "tokens": torch.arange(32, dtype=torch.int32).reshape(2, 16)
        % CFG.vocab,
        "labels": torch.arange(1, 33, dtype=torch.int32).reshape(2, 16)
        % CFG.vocab}
    run(CFG, opt, LoopConfig(total_steps=2, checkpoint_every=1), batch,
        str(tmpdir), log_fn=lambda s: None, device="cpu")
    params = T.init_params(CFG, torch.Generator().manual_seed(0))
    from repro_torch.training.optimizer import adamw_init
    state = {"params": params, "opt": adamw_init(params, opt)}
    pspec = sharding.param_specs(params, mesh)
    specs = {"params": pspec, "opt": sharding.opt_specs(state["opt"], pspec)}
    seen = []
    out = run(CFG, opt, LoopConfig(total_steps=3, checkpoint_every=1),
              batch, str(tmpdir), shardings=sharding.named(specs, mesh),
              step_fn=lambda p, o, b: seen.append(
                  type(leaves(p)[0]).__name__) or (p, o, {"loss":
                                                          torch.zeros(())}),
              log_fn=lambda s: None, device="cpu")
    assert out["resumed_from"] == 1 and seen == ["DTensor"]
    # The loop saved step 2 from the DTensor state: it restores whole.
    ckpt = CheckpointManager(str(tmpdir), device="cpu")
    got, step = ckpt.restore(state)
    ckpt.close()
    assert step == 2 and all(type(t) is torch.Tensor for t in leaves(got))
