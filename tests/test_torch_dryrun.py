"""The dry run on a fake process group: every family's SMOKE train, prefill
and decode cell traced on a (2, 2) ("data", "model") mesh in ``tp`` mode,
its FLOPs per device times the chips equal to ``op_cost``'s global count;
one production cell (qwen3-0.6b, train_4k, 16 x 16) against the JAX
package's FLOPs and its peak bytes a device; the dry run's ``flip`` rule
against this torch's own; and the sharding hooks on DTensors and plain
tensors."""
import dataclasses
import json
import logging
import math
import os
import subprocess
import sys

import pytest
import torch

from repro.configs.registry import SHAPES as JAX_SHAPES
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import input_specs as jax_input_specs
from repro.roofline.jaxpr_cost import jaxpr_cost
from repro.training import step as jax_step
from repro.training.optimizer import AdamWConfig as JaxAdamWConfig
from repro_torch.configs.registry import ShapeSpec, get_config, input_specs
from repro_torch.core.tree import leaves
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
    (6 over 2 ranks into 3 x 2), on a batch of 6 rows that the whole mesh
    cannot split further (so the dry run's view rule has no dim to move
    the shard to), runs again with that dim gathered over the model axis,
    its batch dim still split over "data": counted, and its gathers
    recorded (a device's (3, 6) fp32 rows)."""
    x = _dt(mesh, (6, 6), ("data", "model"))
    trace, replicated, gathered = dryrun._sharded_run(
        lambda a: a.view(6, 3, 2) * 2, [x])
    assert replicated == {"view": 1} and gathered == {"view": 3 * 6 * 4}
    assert trace.stats.count_by_kind["all-gather"] >= 1
    assert trace.peak_live_bytes >= 3 * 6 * 4


def test_a_call_no_partial_replication_shards_runs_whole(mesh):
    """A dim split over both mesh axes (12 over 4 ranks) viewed as 3 x 4:
    gathering the model axis leaves it split 2 ways, which 3 does not
    divide, so every device runs the whole view; both gathers count."""
    x = _dt(mesh, (8, 12), (None, ("data", "model")))
    trace, replicated, gathered = dryrun._sharded_run(
        lambda a: a.view(8, 3, 4) * 2, [x])
    assert replicated == {"view": 1}
    assert gathered == {"view": 8 * 6 * 4 + 8 * 12 * 4}
    assert trace.stats.count_by_kind["all-gather"] >= 2


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
    trace, replicated, _ = dryrun._sharded_run(
        lambda a, e: kvwal.append_token(a, table, lens, e), [arena, entry])
    assert replicated == {} and trace.stats.total_bytes == 0
    assert tuple(arena.to_local().shape) == (2, 3, 8, 1, 16)
    plain = torch.empty(4, 2, 16, device="meta")
    trace, _, _ = dryrun._sharded_run(lambda e: plain.copy_(e), [entry])
    assert trace.stats.count_by_kind["all-gather"] >= 1
    with pytest.raises(NotImplementedError):       # a block dim sharded
        dryrun._write_local(
            torch.ops.aten.index_put_.default,
            (_dt(mesh, (4, 6, 8, 2, 16), (None, "data")),
             [torch.zeros(4, dtype=torch.long, device="meta")] * 3,
             torch.empty(4, 2, 16, device="meta")), {})

# ------------------------------------------------------------ flip rule
# The SSD's flips (the backward of its cumsums): the shapes and placements
# the mamba2-1.3b SMOKE train cell gives them on the (2, 2) mesh, and the
# dims they flip.
_SSD_FLIPS = [((4, 8, 8, 8), (-1,)), ((4, 8, 8, 8), (2,)),
              ((4, 8, 8, 8), (-1, 2))]
_FLIP_PLACEMENTS = [("S0", "S0"), ("S0", "R"), ("R", "S0"), ("R", "R"),
                    ("S0", "S1"), ("P", "S0")]


def _placement(tag):
    from torch.distributed.tensor import Partial, Replicate, Shard
    return {"R": Replicate(), "P": Partial()}.get(tag) or Shard(int(tag[1:]))


def _flip_schema(mesh, shape, dims, tags, strategy: bool):
    from torch.distributed.tensor._dtensor_spec import DTensorSpec, TensorMeta
    from torch.distributed.tensor._op_schema import (OpSchema, OpSpec,
                                                     OpStrategy)
    meta = TensorMeta(torch.Size(shape), torch.empty(shape).stride(),
                      torch.float32)
    spec = DTensorSpec(mesh, tuple(_placement(t) for t in tags),
                       tensor_meta=meta)
    arg = OpStrategy([OpSpec(spec)]) if strategy else spec
    return OpSchema(torch.ops.aten.flip.default, (arg, list(dims)), {})


@pytest.mark.parametrize("tags", _FLIP_PLACEMENTS)
@pytest.mark.parametrize("shape,dims", _SSD_FLIPS)
def test_flip_rule_gives_the_native_rules_placements(mesh, shape, dims,
                                                      tags):
    """The dry run's ``flip`` strategy, called directly, places the output
    as this torch's own rule does for the SSD's flips (their flipped dims
    are never split), keeping each input placement."""
    from torch.distributed.tensor import DTensor
    prop = DTensor._op_dispatcher.sharding_propagator
    ours = dryrun._flip_strategy(_flip_schema(mesh, shape, dims, tags, True))
    (choice,) = ours.strategies
    native = prop.propagate_op_sharding(
        _flip_schema(mesh, shape, dims, tags, False))
    assert tuple(choice.output_spec.placements) == \
        tuple(native.output_spec.placements)
    assert tuple(choice.input_specs[0].placements) == \
        tuple(_placement(t) for t in tags)


def test_flip_rule_replicates_a_flipped_split_dim(mesh):
    """Along a flipped dim that is split, the rule gathers it first."""
    from torch.distributed.tensor import Replicate, Shard
    ours = dryrun._flip_strategy(_flip_schema(mesh, (4, 8, 8, 8), (2,),
                                              ("S0", "S2"), True))
    (choice,) = ours.strategies
    assert tuple(choice.output_spec.placements) == (Shard(0), Replicate())
    assert choice.redistribute_cost[0][0] > 0


def test_mamba2_cell_runs_on_the_dry_runs_flip_rule(mesh, monkeypatch):
    """As on a torch whose DTensor has no ``flip`` rule: with this torch's
    own rule taken out, the dry run registers its rule, and mamba2-1.3b's
    SMOKE train cell (its cumsums' backward flips) traces ``ok`` through
    it, with no op run replicated."""
    from torch.distributed.tensor import DTensor
    prop = DTensor._op_dispatcher.sharding_propagator
    flip = torch.ops.aten.flip.default
    calls = []
    real = dryrun._flip_strategy
    monkeypatch.setattr(dryrun, "_flip_strategy",
                        lambda s: calls.append(s) or real(s))
    def clear_caches():                # Python's and the C++ fast path's
        prop.propagate_op_sharding.cache.cache_clear()
        getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
                lambda: None)()

    saved = {t: getattr(prop, t).pop(flip) for t in (
        "op_single_dim_strategy_funcs", "op_strategy_funcs",
        "op_to_rules", "op_to_schema_info",
        "op_to_schema_info_for_single_dim_strategy")
        if flip in getattr(prop, t, {})}
    clear_caches()
    try:
        assert dryrun._ensure_flip_rule() and not dryrun._ensure_flip_rule()
        entry = dryrun.lower_cell("mamba2-1.3b",
                                  ShapeSpec("train_smoke", 64, 4, "train"),
                                  False, mesh=mesh, smoke=True)
    finally:
        for t in ("op_strategy_funcs", "op_to_schema_info"):
            getattr(prop, t).pop(flip, None)
        for t, v in saved.items():
            getattr(prop, t)[flip] = v
        clear_caches()
    assert calls
    assert entry["status"] == "ok" and entry["replicated_calls"] == {}


# ------------------------------------------------------------ view rule
# The attention's head views on a ("data", "model") mesh of 2 x 16, as the
# production cell (qwen3-0.6b: 16 query heads, 8 KV heads of 128) gives
# them on a torch whose matrix rules split the projections' heads over the
# model axis: k's 8 packed heads (8 do not divide 16), q's 16 heads
# regrouped as 8 x 2 KV groups, and q's 16 heads unpacked (they divide).
_HEAD_VIEWS = [((32, 2, 1024), (32, 2, 8, 128), False),
               ((32, 2, 16, 128), (32, 2, 8, 2, 128), False),
               ((32, 2, 2048), (32, 2, 16, 128), True)]


def _wide_mesh():
    """A 2 x 16 mesh for strategies alone (no group behind it)."""
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh("cpu", torch.arange(32).view(2, 16),
                      mesh_dim_names=("data", "model"), _init_backend=False)


def _view_schema(mesh, shape, placements, target):
    from torch.distributed.tensor._dtensor_spec import DTensorSpec, TensorMeta
    from torch.distributed.tensor._op_schema import (OpSchema, OpSpec,
                                                     OpStrategy)
    meta = TensorMeta(torch.Size(shape),
                      torch.empty(shape, device="meta").stride(),
                      torch.float32)
    spec = DTensorSpec(mesh, tuple(placements), tensor_meta=meta)
    return OpSchema(torch.ops.aten.view.default,
                    (OpStrategy([OpSpec(spec)]), list(target)), {})


def _local(t, placements, coord, mesh_shape):
    """Device ``coord``'s shard of ``t`` under plain ``Shard`` and
    ``Replicate`` placements, mesh dims in order (DTensor's even chunks)."""
    from torch.distributed.tensor import Replicate, Shard
    for p, c, n in zip(placements, coord, mesh_shape):
        if isinstance(p, Shard):
            assert type(p) is Shard and t.shape[p.dim] % n == 0
            t = t.chunk(n, dim=p.dim)[c]
        else:
            assert isinstance(p, Replicate)
    return t


@pytest.mark.parametrize("shape,target,divides", _HEAD_VIEWS)
def test_view_rule_gives_the_native_rules_placements(mesh, shape, target,
                                                     divides):
    """The dry run's view strategy, called directly on a ``Shard(-1)`` over
    the 16-wide model axis: where this torch's own rule places the view
    (the heads divide the axis) it gives the same input and output
    placements at no cost; where that rule refuses it too (this torch
    places no split of 8 heads over 16 devices), the shard moves to the
    batch dim, and the output is this torch's own rule's for that input.
    Either way every device's output shard is its input shard viewed."""
    import itertools

    from torch.distributed.tensor import Shard
    own = dryrun._native_view(torch.ops.aten.view.default)
    wide = _wide_mesh()
    given = (Shard(0), Shard(2))
    (choice,) = dryrun._view_strategy(
        _view_schema(wide, shape, given, target)).strategies
    moved = tuple(choice.input_specs[0].placements)
    out = tuple(choice.output_spec.placements)
    if divides:
        (native,) = own(_view_schema(wide, shape, given,
                                     target)).strategies
        assert moved == given and choice.redistribute_cost == [[0.0]]
    else:
        with pytest.raises(RuntimeError):
            own(_view_schema(wide, shape, given, target))
        (native,) = own(_view_schema(wide, shape, moved,
                                     target)).strategies
        assert moved == (Shard(0), Shard(0))
        assert choice.redistribute_cost[0][0] > 0
    assert out == tuple(native.output_spec.placements)
    whole = torch.arange(math.prod(shape), dtype=torch.int32)
    for coord in itertools.product(*map(range, wide.shape)):
        mine = _local(whole.view(shape), moved, coord, wide.shape)
        want = _local(whole.view(target), out, coord, wide.shape)
        assert torch.equal(mine.reshape(want.shape), want), coord


def test_view_rule_moves_a_shard_only_onto_a_split_dim(mesh):
    """A batch of 4 over the 2-wide data axis leaves 2 rows a device, which
    16 does not divide: the rule does not move the model axis's shard onto
    the sequence (no mesh dim splits it), and the refusal stands, so the
    dry run gathers the view."""
    from torch.distributed.tensor import Shard
    with pytest.raises(RuntimeError):
        dryrun._view_strategy(_view_schema(
            _wide_mesh(), (4, 32, 1024), (Shard(0), Shard(2)),
            (4, 32, 8, 128)))


def test_kv_head_view_runs_on_the_dry_runs_view_rule(mesh):
    """This torch's own view rule refuses to split 3 KV heads packed in a
    dim split over the 2-wide model axis (DTensor alone would run the view
    replicated).  The dry run registers its own rule once, on every torch,
    and a projection to those heads viewed as heads runs with nothing
    replicated: its output split over both axes on the batch dim, one
    collective moving the shard there."""
    from torch.distributed.tensor import Shard
    view = torch.ops.aten.view.default
    with pytest.raises(RuntimeError):
        dryrun._native_view(view)(_view_schema(
            mesh, (8, 4, 6), (Shard(0), Shard(2)), (8, 4, 3, 2)))
    x = _dt(mesh, (8, 4, 4), ("data",))
    w = _dt(mesh, (4, 6), (None, "model"))
    outs = []

    def step(a, b):
        outs.append((a @ b).view(8, 4, 3, 2))
        return outs[-1] * 2

    dryrun._ensure_view_rule()
    assert not dryrun._ensure_view_rule()
    trace, replicated, _ = dryrun._sharded_run(step, [x, w])
    assert replicated == {}
    assert sum(trace.stats.count_by_kind.values()) >= 1
    assert tuple(outs[-1].placements) == (Shard(0), Shard(0))
    assert tuple(outs[-1].to_local().shape) == (2, 4, 3, 2)


# Last: they replace the fake group of the fixture by one of 256 ranks.
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


def test_production_cell_peak_near_the_reference(monkeypatch):
    """qwen3-0.6b × train_4k on the fake 16 x 16 mesh: its peak bytes a
    device within 4x of the JAX package's ``lower_cell`` for the same cell
    (XLA's buffer assignment; run in a process of its own, which the
    reference's forced 512 host devices need), where the log-softmax over
    the whole vocabulary had held 102x; and no collective moves logits or
    their gradient: the only collective result that holds the whole vocab
    dim is the embedding table, gathered for the lookup."""
    import torch.distributed as dist
    from repro_torch.roofline import analysis
    from repro_torch.roofline.analysis import _KINDS
    shapes = []

    class Recording(analysis.ShardedTrace):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is not NotImplemented and func.namespace in (
                    "_c10d_functional", "c10d_functional") and \
                    func._overloadpacket.__name__ in _KINDS:
                shapes.extend(tuple(o.shape) for o in leaves([out]))
            return out

    monkeypatch.setattr(dryrun.roofline, "ShardedTrace", Recording)
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    try:
        entry = dryrun.lower_cell("qwen3-0.6b", "train_4k", False)
    finally:
        dist.destroy_process_group()
    code = ("import json\n"
            "from repro.launch.dryrun import lower_cell\n"
            "e = lower_cell('qwen3-0.6b', 'train_4k', False)\n"
            "print('REF ' + json.dumps(e['roofline']))\n")
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": src,
                              "JAX_PLATFORMS": "cpu"})
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("REF ")]
    assert res.returncode == 0 and lines, res.stderr[-2000:]
    want = json.loads(lines[-1][4:])["peak_memory_per_device"]
    got = entry["roofline"]["peak_memory_per_device"]
    assert want / 4 <= got <= 4 * want, (got, want)
    vocab, d_model = 151936, 1024
    assert shapes and all(s == (vocab, d_model) for s in shapes
                          if vocab in s), [s for s in shapes if vocab in s]
