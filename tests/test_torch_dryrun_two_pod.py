"""The dry run on a fake (2, 2, 2) ("pod", "data", "model") mesh of 8 ranks,
the two-pod production mesh's axes at a size the CPU traces in seconds: the
batch stays split over pod and data through the embedding's gather (on this
torch's own rule, and where DTensor refuses the gather, as 2.11's does, and
the dry run reruns it replicated), through the gradient of the loss's mean,
and into the attention and the SSD; the head views shard with nothing
replicated, on this torch's rules and with 2.11's refusal of the gather
stood in for."""
import logging

import pytest
import torch

from repro_torch.configs.registry import ShapeSpec
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import init_fake_process_group
from repro_torch.models import layers, ssm


@pytest.fixture(scope="module")
def mesh():
    """A (2, 2, 2) mesh over a fake process group of 8 ranks in this
    process, torn down after the module."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    init_fake_process_group(8)
    try:
        yield init_device_mesh("cpu", (2, 2, 2),
                               mesh_dim_names=("pod", "data", "model"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _dt(mesh, shape, spec=(), dtype=torch.float32):
    return sharding.place(torch.empty(shape, dtype=dtype, device="meta"),
                          sharding.NamedSharding(mesh, spec))


def _shard(d):
    from torch.distributed.tensor import Shard
    return Shard(d)


@pytest.fixture(params=["own", "2.11"])
def gather_rule(request, monkeypatch):
    """``own``: this torch's DTensor rules.  ``2.11``: the same, but DTensor
    refuses a gather whose index tensor is split twice on one dim, as
    2.11's does (the embedding's token ids split over pod and data), so the
    dry run runs it again replicated (``_DTensorGaps``)."""
    if request.param == "2.11":
        from torch.distributed.tensor import DTensor, Shard

        class Refusing(dryrun.roofline.ShardedTrace):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if func is torch.ops.aten.index.Tensor:
                    for i in args[1]:
                        dims = [p.dim for p in getattr(i, "placements", ())
                                if isinstance(p, Shard)]
                        if isinstance(i, DTensor) and \
                                len(dims) != len(set(dims)):
                            raise RuntimeError("2.11: index split twice")
                return super().__torch_dispatch__(func, types, args, kwargs)

        monkeypatch.setattr(dryrun.roofline, "ShardedTrace", Refusing)
    return request.param


def _refused(op, *args) -> bool:
    """Whether this torch's DTensor refuses ``op(*args)``, found by running
    it (2.11's has no rule for a gather whose ids are split twice on one
    dim, nor for some flattens of a split dim)."""
    try:
        op(*args)
    except (RuntimeError, ValueError, NotImplementedError, AssertionError):
        return True
    return False


def test_gather_keeps_the_batch_split(mesh, gather_rule):
    """The embedding's gather: a vocab table split over the model axis and
    token ids split over pod and data give rows split over pod and data.
    Where DTensor refuses the gather (the ``2.11`` stand-in, or this
    torch's own rule where it refuses, as 2.11's does), it runs again on
    ids gathered over data and is counted, and its output is split over
    data again (a slice of each device's rows: no collective beyond the
    ids' gather)."""
    table = _dt(mesh, (256, 64), ("model",))
    ids = _dt(mesh, (8, 16), (("pod", "data"),), torch.int64)
    refused = gather_rule == "2.11" or _refused(lambda t, i: t[i], table,
                                                ids)
    outs = []
    trace, replicated, gathered = dryrun._sharded_run(
        lambda t, i: outs.append(t[i]) or outs[-1] * 2, [table, ids])
    rows = outs[-1]
    assert tuple(rows.shape) == (8, 16, 64)
    assert tuple(rows.placements[:2]) == (_shard(0), _shard(0))
    assert tuple(rows.to_local().shape[:2]) == (2, 16)
    if refused:
        assert replicated == {"index": 1} and gathered["index"] > 0
    else:
        assert replicated == {}


def test_loss_gradient_keeps_the_batch_split(mesh):
    """The gradient of a mean over a batch split over pod and data comes
    back split as the batch was (DTensor places the expanded scalar
    replicated), so the rows of the gradient over a wide last dim are a
    device's own: the trace holds no copy of half the batch."""
    x = _dt(mesh, (8, 16, 96), (("pod", "data"),)).requires_grad_()

    def step(a):
        loss = (a * 2).sum(-1).mean()
        return torch.autograd.grad(loss, a)[0]

    grads = []
    trace, replicated, _ = dryrun._sharded_run(
        lambda a: grads.append(step(a)), [x])
    (g,) = grads
    assert replicated == {}
    assert tuple(g.placements[:2]) == (_shard(0), _shard(0))
    half_batch = 4 * 16 * 96 * 4
    assert trace.peak_live_bytes < half_batch, trace.peak_live_bytes


# One layer of each SMOKE config; qwen3-0.6b with 1 KV head of 2 query
# heads, so that its KV-head view splits a dim the 2-wide model axis does
# not divide (8 KV heads over the 16-wide axis in production).
_CUTS = {"qwen3-0.6b": {"n_layers": 1, "n_heads": 2, "n_kv_heads": 1},
         "mamba2-1.3b": {"n_layers": 1}}


@pytest.mark.parametrize("arch", sorted(_CUTS))
def test_smoke_step_keeps_the_batch_split(mesh, gather_rule, arch,
                                          monkeypatch):
    """A one-layer SMOKE train step of 8 x 32 tokens: ``ok``, no view or
    ``_unsafe_view`` run replicated, and the activations that enter the
    attention (q) or the SSD (x) split on the batch over pod and data.
    The embedding looks each device's vocab slice up on its own rows
    (``sharding.embed_on_shards``): no gather runs again replicated, with
    2.11's refusal stood in for or not."""
    seen = []

    def watch(fn):
        def inner(x, *a, **kw):
            if hasattr(x, "placements"):     # not ``op_cost``'s fake run
                seen.append(tuple(x.placements))
            return fn(x, *a, **kw)
        return inner

    monkeypatch.setattr(layers, "attention", watch(layers.attention))
    # The SSD enters its hook (``sharding.scan_on_heads``) with x second.
    scan = ssm.scan_on_heads
    monkeypatch.setattr(ssm, "scan_on_heads", lambda fn, x, *a, **kw:
                        watch(lambda x: scan(fn, x, *a, **kw))(x))
    entry = dryrun.lower_cell(arch, ShapeSpec("train_smoke", 32, 8, "train"),
                              True, dict(_CUTS[arch]), mesh=mesh, smoke=True)
    assert entry["status"] == "ok" and entry["mesh"] == "2x2x2"
    assert not {"view", "_unsafe_view"} & set(entry["replicated_calls"])
    assert set(entry["replicated_calls"]) <= dryrun.REPLICABLE
    assert "index" not in entry["replicated_calls"]
    assert seen and all(p[:2] == (_shard(0), _shard(0)) for p in seen), seen


def test_view_rule_takes_no_strided_placement(mesh):
    """A flatten of (batch, heads) with the heads split over the model
    axis, which this torch places as ``_StridedShard`` (2.13) or refuses
    (2.11): the dry run's view rule moves the heads' shard onto the batch
    instead, and places the flattened dim as a plain ``Shard`` on every
    mesh dim."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._op_schema import (OpSchema, OpSpec,
                                                     OpStrategy)
    x = _dt(mesh, (8, 2, 16, 4), (("pod", "data"), "model"))
    view = torch.ops.aten.view.default
    spec = DTensorSpec(mesh, tuple(x.placements),
                       tensor_meta=x._spec.tensor_meta)
    schema = OpSchema(view, (OpStrategy([OpSpec(spec)]), [16, 16, 4]), {})
    native = dryrun._native_view(view)
    assert _refused(native, schema) or dryrun._strided(native(schema))
    (choice,) = dryrun._view_strategy(schema).strategies
    assert tuple(choice.output_spec.placements) == (_shard(0),) * 3
    assert tuple(choice.input_specs[0].placements) == (_shard(0),) * 3
    outs = []
    _, replicated, _ = dryrun._sharded_run(
        lambda a: outs.append(a.view(16, 16, 4)) or outs[-1] * 2, [x])
    assert replicated == {} and isinstance(outs[-1], DTensor)
    assert tuple(outs[-1].placements) == (_shard(0),) * 3
