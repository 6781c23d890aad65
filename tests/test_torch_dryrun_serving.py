"""The dry run's serving cells on a fake (2, 2) ("data", "model") mesh, the
SMOKE configs at one layer where that is enough: the prefill writes into a
cache placed as the reference's ``out_shardings`` place it
(``sharding.cache_specs_tree``), made before the trace and counted among
the arguments, not whole on every device; the attention's mask stays one
row of the batch; a decode reads the arena where it lies (no gather of
it), split by KV heads or by the entry dim; the RG-LRU's gate bias meets
its product's pending sum on 2.11, whose refusal is stood in for here;
and a refused op leaves the step's tensors to be freed when the step
drops them."""
import dataclasses
import gc
import logging
import math

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.registry import ShapeSpec, get_config
from repro_torch.core import kvwal
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import init_fake_process_group
from repro_torch.models import griffin, layers, serve

B, SEQ = 4, 64
PREFILL = ShapeSpec("prefill_smoke", SEQ, B, "prefill")
DECODE = ShapeSpec("decode_smoke", SEQ, B, "decode")
# One layer where that is enough; griffin keeps its SMOKE depth (two
# recurrent blocks and a local attention block, and a tail).
CUTS = {"qwen3-0.6b": {"n_layers": 2}, "mamba2-1.3b": {"n_layers": 1},
        "recurrentgemma-9b": {}, "whisper-large-v3": {"n_layers": 1}}


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


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def _whole_cache_bytes(arch: str) -> int:
    cfg = dataclasses.replace(get_config(arch, smoke=True), **CUTS[arch])
    max_seq = PREFILL.seq_len + 256       # the prefill cells' (as the JAX's)
    return sum(_nbytes(*rec) for rec in serve.cache_spec(
        cfg, B, max_seq).values())


@pytest.mark.parametrize("arch", sorted(CUTS))
def test_prefill_cache_is_placed(mesh, arch, monkeypatch):
    """The prefill returns its cache as DTensors placed by
    ``cache_specs_tree`` (the KV arenas, the ssm's states, griffin's
    arenas and recurrent states, whisper's cross K/V), and the cell counts
    their local shards among its arguments as ``cache_bytes``."""
    got = []

    def prefill(*args, **kw):
        out = real(*args, **kw)
        got.append(out[1])
        return out

    real = serve.prefill
    monkeypatch.setattr(serve, "prefill", prefill)
    entry = dryrun.lower_cell(arch, PREFILL, False, dict(CUTS[arch]),
                              mesh=mesh, smoke=True)
    assert entry["status"] == "ok"
    assert set(entry["replicated_calls"]) <= dryrun.REPLICABLE
    from torch.distributed.tensor import DTensor
    cache = got[-1]                       # the sharded run's, after op_cost's
    specs = sharding.cache_specs_tree(cache, mesh)
    assert all(isinstance(t, DTensor) for t in cache.values())
    for name, t in cache.items():
        assert tuple(t.placements) == sharding.placements(specs[name], mesh), \
            name
    assert any(not p.is_replicate() for t in cache.values()
               for p in t.placements)
    local = sum(t.to_local().numel() * t.element_size()
                for t in cache.values())
    mem = entry["memory"]
    assert mem["cache_bytes"] == local
    assert local < _whole_cache_bytes(arch)
    assert mem["argument_bytes"] > mem["cache_bytes"] > 0


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "whisper-large-v3"])
def test_prefill_peak_is_below_the_whole_cache(mesh, arch):
    """A KV-WAL prefill's live bytes stay below the whole cache's: a cache
    made inside the step is whole on every device, and was counted so."""
    entry = dryrun.lower_cell(arch, PREFILL, False, dict(CUTS[arch]),
                              mesh=mesh, smoke=True)
    assert entry["memory"]["peak_live_bytes"] < _whole_cache_bytes(arch)


class _PlainOps(TorchDispatchMode):
    """The shapes of the tensors that ops on plain tensors only give, seen
    from the top of the mode stack (the ops DTensor runs on local shards
    stay below it), and their dtypes, each into the list ``into`` names.
    Collectives are left out: a redistribution's gather stacks the devices'
    shards on its first dim, which is no batch."""

    def __init__(self):
        super().__init__()
        self.shapes = []
        self.into = self.shapes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        out = func(*args, **(kwargs or {}))
        if not any(issubclass(t, DTensor) for t in types) and \
                not func.namespace.endswith("c10d_functional"):
            self.into += [(tuple(o.shape), o.dtype) for o in (
                out if isinstance(out, (list, tuple)) else (out,))
                if isinstance(o, torch.Tensor)]
        return out


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "recurrentgemma-9b",
                                  "whisper-large-v3"])
def test_attention_makes_no_plain_tensor_of_the_batch(mesh, arch,
                                                      monkeypatch):
    """Inside the prefill's attention (causal, windowed, and whisper's
    encoder and cross attention), every tensor made from plain tensors
    alone has one row where the batch has B: a plain tensor is whole on
    every device.  Where the products run on each device's shards
    (``sharding.attend_on_heads``), they take plain local tensors of the
    device's rows (B / 2 or B / 4 here, as the mesh splits the batch), and
    the mask they make (the one boolean tensor of three dims) has one
    row."""
    seen, local, rows, calls, modes = [], [], [], [], []

    def attention(q, *args, **kw):
        if not hasattr(q, "placements"):          # ``op_cost``'s fake run
            return real(q, *args, **kw)
        calls.append(1)
        with _PlainOps() as mode:
            modes.append(mode)
            out = real(q, *args, **kw)
        seen.extend(mode.shapes)
        return out

    def products(q, *args, **kw):
        if not modes or hasattr(q, "placements"):
            return real_products(q, *args, **kw)
        rows.append(q.shape[0])                   # a device's shards
        modes[-1].into = local
        try:
            return real_products(q, *args, **kw)
        finally:
            modes[-1].into = modes[-1].shapes

    real, real_products = layers.attention, layers._attention
    monkeypatch.setattr(layers, "attention", attention)
    monkeypatch.setattr(layers, "_attention", products)
    entry = dryrun.lower_cell(arch, PREFILL, False, dict(CUTS[arch]),
                              mesh=mesh, smoke=True)
    assert entry["status"] == "ok" and calls and (seen or local)
    assert not [s for s, _ in seen if len(s) > 1 and s[0] == B], seen
    assert all(r < B and B % r == 0 for r in rows), rows
    masks = [s for s, dt in local if dt == torch.bool and len(s) == 3]
    assert not rows or (masks and all(s[0] == 1 for s in masks)), local


# Decodes whose arena the model axis splits by KV heads (phi3-mini's and
# qwen2-moe's shape: 4 KV heads on a 2-wide axis here, 32 and 16 on 16 in
# production), and by the entry dim (one KV head: llama3-8b's 8 heads on
# 16, and MLA's latent arena).
DECODES = {"phi3-mini-3.8b": {}, "qwen2-moe-a2.7b": {},
           "llama3-8b": {"n_kv_heads": 1}, "deepseek-v3-671b": {}}


@pytest.mark.parametrize("arch", sorted(DECODES))
def test_decode_reads_the_arena_where_it_lies(mesh, arch, monkeypatch):
    """A decode reads its arena, split over the batch and the KV heads or
    the entry dim, where it lies: while it attends through the table
    (``decode_attention``; MLA's ``kvwal.gather``), no all-gather of a
    tensor of the arena's rank (rows, blocks, slots, heads, entry), and
    no op run replicated."""
    reading, gathered = [False], []

    class Trace(dryrun.roofline.ShardedTrace):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is not NotImplemented and reading[0] and \
                    func._overloadpacket.__name__ == "all_gather_into_tensor":
                gathered.append(tuple(out.shape))
            return out

    def read(fn):
        def inner(*args, **kw):
            reading[0] = True
            try:
                return fn(*args, **kw)
            finally:
                reading[0] = False
        return inner

    monkeypatch.setattr(dryrun.roofline, "ShardedTrace", Trace)
    monkeypatch.setattr(serve, "decode_attention",
                        read(serve.decode_attention))
    monkeypatch.setattr(kvwal, "gather", read(kvwal.gather))
    entry = dryrun.lower_cell(arch, DECODE, False,
                              {"n_layers": 1, **DECODES[arch]}, mesh=mesh,
                              smoke=True)
    assert entry["status"] == "ok"
    assert not {"index", "index_put"} & set(entry["replicated_calls"])
    assert not [s for s in gathered if len(s) >= 5], gathered


def _pending_meets_split(args) -> bool:
    """Whether an operand pends a sum on a mesh dim that another operand
    splits."""
    from torch.distributed.tensor import DTensor, Shard
    ts = [a for a in args if isinstance(a, DTensor)]
    return any(p.is_partial() and type(t.placements[i]) is Shard
               for a in ts for t in ts if t is not a
               for i, p in enumerate(a.placements))


def _stand_in_211(monkeypatch) -> list:
    """2.11's DTensor, stood in for (→ a list that grows by one at each
    refusal): the RG-LRU's gate products come out
    pending a sum over the model axis (each gate weight moved onto its
    contraction dim, as 2.11 places them), and an add of a pending sum and
    a term split on that mesh dim is refused ("redistribute from S(0) to
    P(sum) not supported yet": 2.11 moves the term to a pending sum)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    in_lru, refused = [False], []

    class Refusing(dryrun.roofline.ShardedTrace):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.add.Tensor and \
                    _pending_meets_split(args):
                refused.append(1)
                raise RuntimeError(
                    "redistribute from S(0) to P(sum) not supported yet")
            if in_lru[0] and func is torch.ops.aten.mm.default and \
                    isinstance(args[1], DTensor):
                x, w = args
                m = x.device_mesh.ndim - 1
                return func(
                    x.redistribute(x.device_mesh,
                                   tuple(x.placements[:m]) + (Shard(1),)),
                    w.redistribute(w.device_mesh,
                                   (Replicate(),) * m + (Shard(0),)))
            return super().__torch_dispatch__(func, types, args, kwargs)

    def rg_lru(*args, **kw):
        in_lru[0] = True
        try:
            return real(*args, **kw)
        finally:
            in_lru[0] = False

    real = griffin._rg_lru
    monkeypatch.setattr(griffin, "_rg_lru", rg_lru)
    monkeypatch.setattr(dryrun.roofline, "ShardedTrace", Refusing)
    return refused


@pytest.fixture
def torch_211(monkeypatch):
    return _stand_in_211(monkeypatch)


def test_pending_sum_meets_a_split_bias(mesh, monkeypatch):
    """A product pending a sum over the model axis plus a bias split over
    it: with 2.11's refusal the dry run reduce-scatters the product onto
    the bias's dim, as this torch's own rule does: the same placements
    and the same collective bytes, and nothing run replicated."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    def run():
        prod = DTensor.from_local(
            torch.empty(2, 8, 16, device="meta"), mesh,
            [Shard(0), Partial()], run_check=False,
            shape=torch.Size((4, 8, 16)), stride=(128, 16, 1))
        bias = DTensor.from_local(
            torch.empty(8, device="meta"), mesh, [Replicate(), Shard(0)],
            run_check=False, shape=torch.Size((16,)), stride=(1,))
        outs = []
        trace, replicated, _ = dryrun._sharded_run(
            lambda p, b: outs.append(p + b), [prod, bias])
        return tuple(outs[0].placements), replicated, trace.stats.bytes_by_kind

    own = run()
    refused = _stand_in_211(monkeypatch)
    stood_in = run()
    assert refused == [1]
    assert stood_in == own
    assert own[0] == (Shard(0), Shard(2)) and own[1] == {}
    assert own[2] == {"reduce-scatter": 2 * 8 * 8 * 4}     # the result


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_recurrentgemma_cells_on_2_11(mesh, torch_211, kind):
    """recurrentgemma-9b's SMOKE train and prefill cells end ``ok`` where
    2.11 refuses the RG-LRU's bias add (each of its gates, in every
    recurrent block), with no op run replicated outside ``REPLICABLE``."""
    entry = dryrun.lower_cell("recurrentgemma-9b",
                              ShapeSpec(f"{kind}_smoke", SEQ, B, kind),
                              False, mesh=mesh, smoke=True)
    assert entry["status"] == "ok"
    assert len(torch_211) >= 2 * 2              # two gates, two blocks
    assert set(entry["replicated_calls"]) <= dryrun.REPLICABLE


def test_refused_view_leaves_the_steps_tensors_free(mesh):
    """A view DTensor refuses (6 rows over 2 ranks split 3 x 2, no dim to
    move the shard to), run again replicated, leaves no reference cycle
    that holds the step's tensors: the refusal's exception held the
    dispatch frames and, through them, the step's intermediate tensors
    until the cycle collector ran, so the trace's peak moved with the
    collector's timing.  With the collector off, the step's intermediate
    is freed as soon as the step lets it go."""
    import weakref
    x = sharding.place(torch.empty((6, 6), device="meta"),
                       sharding.NamedSharding(mesh, ("data", "model")))
    refs = []

    def step(a):
        b = a * 2
        refs.append(weakref.ref(b))
        return b.view(6, 3, 2).sum()

    gc.collect()
    gc.disable()
    try:
        _, replicated, _ = dryrun._sharded_run(step, [x])
        assert replicated == {"view": 1}
        assert refs[0]() is None
    finally:
        gc.enable()
