"""The dry run on a fake process group: every family's SMOKE train, prefill
and decode cell traced on a (2, 2) ("data", "model") mesh in ``tp`` mode,
its FLOPs per device times the chips equal to ``op_cost``'s global count;
one production cell (qwen3-0.6b, train_4k, 16 x 16) against the JAX
package's FLOPs; and the sharding hooks on DTensors and plain tensors."""
import dataclasses
import logging

import pytest
import torch

from repro.configs.registry import SHAPES as JAX_SHAPES
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import input_specs as jax_input_specs
from repro.roofline.jaxpr_cost import jaxpr_cost
from repro.training import step as jax_step
from repro.training.optimizer import AdamWConfig as JaxAdamWConfig
from repro_torch.configs.registry import ShapeSpec, get_config, input_specs
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import init_fake_process_group
from repro_torch.roofline.op_cost import op_cost
from repro_torch.training import step as step_mod
from repro_torch.training.optimizer import AdamWConfig

FAMILIES = ["qwen3-0.6b", "qwen2-vl-72b", "qwen2-moe-a2.7b",
            "deepseek-v3-671b", "mamba2-1.3b", "recurrentgemma-9b",
            "whisper-large-v3"]


@pytest.fixture(scope="module")
def mesh():
    """A (2, 2) mesh over a fake process group of 4 ranks in this process,
    torn down after the module."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    init_fake_process_group(4)
    try:
        yield init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _global_flops(arch: str, shape: ShapeSpec) -> float:
    """``op_cost`` of the cell's step, with the cell's config rules."""
    cfg = get_config(arch, smoke=True)
    if shape.kind != "train":
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    if shape.kind == "prefill":
        cfg = dataclasses.replace(cfg, attn_chunk_q=1024)
    opt = dryrun._opt_for(arch)
    params, opt_state = step_mod.abstract_train_state(cfg, opt)
    specs = input_specs(cfg, shape)
    step, args = dryrun._step_and_args(cfg, shape, opt, params, opt_state,
                                       specs)
    return op_cost(step, *args).flops


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_smoke_cell_lowers_on_a_fake_mesh(mesh, arch, kind):
    shape = ShapeSpec(f"{kind}_smoke", 64, 4, kind)
    entry = dryrun.lower_cell(arch, shape, False, mesh=mesh, smoke=True)
    rf = entry["roofline"]
    assert entry["status"] == "ok" and entry["mesh"] == "2x2"
    assert rf["chips"] == 4 and rf["shape"] == f"{kind}_smoke"
    assert rf["flops_per_device"] * 4 == _global_flops(arch, shape)
    assert rf["model_flops"] > 0 and rf["bytes_per_device"] > 0
    # Sharded weights are gathered: every cell runs collectives.
    assert rf["collective_bytes"] > 0
    assert rf["collective_bytes"] == sum(rf["collectives"]["bytes"].values())
    mem = entry["memory"]
    assert rf["peak_memory_per_device"] == mem["argument_bytes"] + \
        mem["peak_live_bytes"] and mem["peak_live_bytes"] > 0
    assert rf["bottleneck"] in ("compute", "memory", "collective")
    assert set(entry["replicated_calls"]) <= dryrun.REPLICABLE


# ------------------------------------------------------------------ hooks
def _dt(mesh, shape, spec=()):
    return sharding.place(torch.empty(shape, device="meta"),
                          sharding.NamedSharding(mesh, spec))


def test_maybe_shard_activations(mesh):
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.models.transformer import maybe_shard_activations
    cfg = dataclasses.replace(get_config("qwen3-0.6b", smoke=True),
                              act_batch_axes=("data",), act_seq_axis="model")
    x = torch.zeros(4, 8, 16)
    assert maybe_shard_activations(cfg, x) is x
    d = _dt(mesh, (4, 8, 16))
    assert tuple(maybe_shard_activations(cfg, d).placements) == (Shard(0),
                                                                 Shard(1))
    both = dataclasses.replace(cfg, act_batch_axes=("data", "model"),
                               act_seq_axis=None)
    assert tuple(maybe_shard_activations(both, d).placements) == (Shard(0),
                                                                  Shard(0))
    off = get_config("qwen3-0.6b", smoke=True)
    assert maybe_shard_activations(off, d) is d
    assert tuple(d.placements) == (Replicate(), Replicate())


def test_moe_dispatch_axes(mesh):
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models import moe
    x = torch.zeros(4, 6, 8, 2)
    assert moe._wsc(x, ("data", "model", None, None)) is x
    d = _dt(mesh, (4, 6, 8, 2))
    assert tuple(moe._wsc(d, ("data", "model", None, None)).placements) == \
        (Shard(0), Shard(1))
    # moe_block on DTensors pins the (G,E,C,d) buffers to dispatch_axes.
    cfg = get_config("qwen2-moe-a2.7b", smoke=True)
    params, _ = step_mod.abstract_train_state(cfg, AdamWConfig())
    layer = {k: _dt(mesh, v.shape[1:]) for k, v in
             params["layers"]["moe"].items()}
    seen = []
    real = sharding.constrain
    try:
        sharding.constrain = lambda t, spec: seen.append(spec) or real(t, spec)
        with implicit_replication():
            y, aux = moe.moe_block(layer, _dt(mesh, (4, 32, cfg.d_model),
                                              ("data",)),
                                   cfg.moe, dispatch_axes=("data", "model"))
    finally:
        sharding.constrain = real
    assert seen == [("data", "model", None, None)] * 2
    assert tuple(y.shape) == (4, 32, cfg.d_model)


def test_maybe_shard_decode_q(mesh):
    from torch.distributed.tensor import Shard
    from repro_torch.models.serve import _maybe_shard_decode_q
    cfg = dataclasses.replace(get_config("llama3-8b", smoke=True),
                              decode_q_hd_axis="model")
    q = torch.zeros(4, 1, 4, 16)
    assert _maybe_shard_decode_q(cfg, q) is q
    d = _dt(mesh, (4, 1, 4, 16))
    assert tuple(_maybe_shard_decode_q(cfg, d).placements) == (Shard(0),
                                                               Shard(3))
    off = get_config("llama3-8b", smoke=True)
    assert _maybe_shard_decode_q(off, d) is d



def test_a_call_dtensor_cannot_shard_runs_replicated(mesh):
    """A view that splits a sharded dim its shard count does not divide
    (6 over 2 ranks into 3 x 2) runs again on replicated inputs: counted,
    and its gathers recorded."""
    x = _dt(mesh, (8, 6), ("data", "model"))
    trace, replicated = dryrun._sharded_run(lambda a: a.view(8, 3, 2) * 2,
                                            [x])
    assert replicated == {"view": 1}
    assert trace.stats.count_by_kind["all-gather"] >= 1
    assert trace.peak_live_bytes >= 8 * 6 * 4


def test_an_op_dtensor_cannot_shard_fails_the_trace(mesh):
    """An op with no DTensor rule and not named in ``REPLICABLE`` is not
    run replicated: it raises, and ``lower_cell`` records the cell as
    FAIL."""
    x = _dt(mesh, (8, 6), ("data", "model"))
    assert "unfold" not in dryrun.REPLICABLE
    with pytest.raises(NotImplementedError):
        dryrun._sharded_run(lambda a: a.unfold(0, 2, 1), [x])


def test_cache_writes_run_on_local_shards(mesh):
    """The KV-WAL's append (``index_put_``) into a DTensor arena split over
    its batch rows and kv heads writes each device's shard and moves no
    bytes; a copy into a plain (replicated) cache gathers its source."""
    from repro_torch.core import kvwal
    arena = _dt(mesh, (4, 3, 8, 2, 16), ("data", None, None, "model"))
    entry = _dt(mesh, (4, 2, 16), ("data", "model"))
    table = torch.zeros(4, 3, dtype=torch.int32, device="meta")
    lens = torch.zeros(4, dtype=torch.int32, device="meta")
    trace, replicated = dryrun._sharded_run(
        lambda a, e: kvwal.append_token(a, table, lens, e), [arena, entry])
    assert replicated == {} and trace.stats.total_bytes == 0
    assert tuple(arena.to_local().shape) == (2, 3, 8, 1, 16)
    plain = torch.empty(4, 2, 16, device="meta")
    trace, _ = dryrun._sharded_run(lambda e: plain.copy_(e), [entry])
    assert trace.stats.count_by_kind["all-gather"] >= 1
    with pytest.raises(NotImplementedError):       # a block dim sharded
        dryrun._write_local(
            torch.ops.aten.index_put_.default,
            (_dt(mesh, (4, 6, 8, 2, 16), (None, "data")),
             [torch.zeros(4, dtype=torch.long, device="meta")] * 3,
             torch.empty(4, 2, 16, device="meta")), {})

# Last: it replaces the fake group of the fixture by one of 256 ranks.
def test_production_cell_equals_the_reference_flops():
    """qwen3-0.6b × train_4k on the fake 16 x 16 mesh of 256 ranks: ok, and
    its global FLOPs (remat on) equal ``jaxpr_cost``'s of the JAX step."""
    import torch.distributed as dist
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    try:
        entry = dryrun.lower_cell("qwen3-0.6b", "train_4k", False)
    finally:
        dist.destroy_process_group()
    rf = entry["roofline"]
    assert entry["status"] == "ok" and entry["mesh"] == "16x16"
    assert rf["chips"] == 256 == dryrun.chips_of(False)
    jcfg = jax_get_config("qwen3-0.6b")
    jp, jo = jax_step.abstract_train_state(jcfg, JaxAdamWConfig())
    want = jaxpr_cost(jax_step.make_train_step(jcfg, JaxAdamWConfig()), jp,
                      jo, jax_input_specs(jcfg, JAX_SHAPES["train_4k"]))
    assert rf["flops_per_device"] * 256 == want.flops
    assert rf["model_flops"] == 6 * 596_049_920 * 4096 * 256
    assert rf["collective_bytes"] > 0
