"""The MoE experts in the dry run's sharded trace (ROADMAP C.19): the
experts' products on each device's groups and experts, and the expert
weights' gradients scattered over the data axes, a layer at a time, through
AdamW.

- SMOKE train cells on ``test_torch_dryrun_peak.py``'s fake (2, 2)
  ("data", "model") mesh: deepseek-v3-671b and qwen2-moe-a2.7b (4 experts
  split over the model axis) and qwen2-moe at 3 experts (whole on every
  device, as its 60 on a 16-wide axis) run no ``view`` or ``_unsafe_view``
  replicated; every expert leaf's gradient that reaches ``adamw_update``
  is split over the data axis on its hidden dim (and over the experts
  where the weight is), no gradient stack or its padded ``cat`` holds a
  layer's expert weight whole over the data axis, and the new expert
  leaves come back placed as the old.
- On 4 gloo ranks, a (2, 2) mesh: the experts on DTensors (split and
  whole experts) against the plain ``moe._experts`` (outputs, input and
  weight gradients at fp32 within rtol/atol 2e-5, the weights' gradients
  scattered on their hidden dim), and AdamW of such gradients against the
  plain update (bit for bit where the global norm does not clip; within
  rtol 1e-6 where it does, the norm summed in another order).
- The trace: a storage counted with a wrapper that outlives it keeps its
  address, so that every fresh output is counted (one record a cell).
- The plain route: plain tensors take the parent's products and update,
  bit for bit."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.distributed.tensor import Shard

from repro_torch.configs.registry import get_config
from repro_torch.core.tree import leaves_with_path, path_str
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun
from repro_torch.models import moe
from repro_torch.roofline import analysis
from repro_torch.training import optimizer
from test_torch_dryrun_peak import TRAIN, mesh  # noqa: F401 (a fixture)
from test_torch_dryrun_heads import SRC

# SMOKE cells, "arch/E" at E experts: qwen2-moe at 3, which the 2-wide
# model axis does not divide.
CELLS = ["deepseek-v3-671b", "qwen2-moe-a2.7b", "qwen2-moe-a2.7b/3"]
HIDDEN = {"we_gate": 2, "we_up": 2, "we_down": 3}   # of (L, E, ·, ·)


def _cell(device_mesh, name, monkeypatch):
    """The SMOKE train cell ``name`` with AdamW a layer at a time → (its
    record, the config, the gradients and the old and new parameters
    ``adamw_update`` saw, the (op, shape, dtype) of every allocation the
    trace counted)."""
    arch, _, cut = name.partition("/")
    cfg = get_config(arch, smoke=True)
    over = {"moe": dataclasses.replace(cfg.moe, n_experts=int(cut))} \
        if cut else {}
    cfg = dataclasses.replace(cfg, **over)
    seen, allocs = {}, []

    class Trace(analysis.ShardedTrace):
        def __init__(self):
            super().__init__()
            allocs.append(self.allocs)

    real = optimizer.adamw_update

    def update(params, grads, state, opt):
        out = real(params, grads, state, opt)
        seen.update(grads=grads, old=params, new=out[0])
        return out

    monkeypatch.setattr(dryrun.roofline, "ShardedTrace", Trace)
    monkeypatch.setattr("repro_torch.training.step.adamw_update", update)
    # One layer's expert leaf a slice, as the production leaves are sliced.
    monkeypatch.setattr(optimizer, "SLICE_BYTES", 4096)
    entry = dryrun.lower_cell(arch, TRAIN, False, over, mesh=device_mesh,
                              smoke=True)
    return entry, cfg, seen, list(allocs[-1].values())


def _experts(tree) -> dict:
    return {path_str(p).rsplit("/", 1)[-1]: t
            for p, t in leaves_with_path(tree)
            if "moe/we_" in path_str(p) and not path_str(p).startswith("mtp")}


@pytest.mark.parametrize("name", CELLS)
def test_experts_replicate_no_view(mesh, monkeypatch, name):  # noqa: F811
    """No ``view`` or ``_unsafe_view`` runs replicated: the experts'
    products run on each device's groups and experts (the parent flattened
    the split groups and experts of a (G, E, C, d) product, ``{"view":
    2}`` in both 4-expert cells)."""
    entry, *_ = _cell(mesh, name, monkeypatch)
    assert entry["status"] == "ok"
    assert not {"view", "_unsafe_view"} & set(entry["replicated_calls"]), \
        entry["replicated_calls"]
    assert set(entry["replicated_calls"]) <= dryrun.REPLICABLE


@pytest.mark.parametrize("name", CELLS)
def test_expert_gradients_split_before_adamw(mesh, monkeypatch,  # noqa: F811
                                             name):
    """Every expert leaf's gradient that reaches ``adamw_update`` is split
    over the data axis on its hidden dim, and over the model axis as its
    weight is; no fp32 allocation but the new leaves (``new_empty``) has
    the local shape of a stack of the layers' expert gradients whole over
    the data axis (the parent's ``stack``), padded or not; the new expert
    leaves are placed as the old."""
    entry, cfg, seen, allocs = _cell(mesh, name, monkeypatch)
    assert entry["status"] == "ok"
    grads, old, new = (_experts(seen[k]) for k in ("grads", "old", "new"))
    assert sorted(grads) == ["we_down", "we_gate", "we_up"]
    E, d, ff = cfg.moe.n_experts, cfg.d_model, cfg.moe.expert_d_ff
    split = E % 2 == 0
    for leaf, g in grads.items():
        want = [Shard(HIDDEN[leaf]), Shard(1) if split else
                Shard(HIDDEN[leaf])]
        assert list(g.placements) == want, (leaf, g.placements)
        assert tuple(new[leaf].placements) == tuple(old[leaf].placements)
    e = E // 2 if split else E
    whole = {(e, d, ff), (e, ff, d)}
    stacks = [a for a in allocs if a[2] == "float32" and len(a[1]) == 4
              and a[1][0] >= cfg.n_layers and tuple(a[1][1:]) in whole
              and a[0] != "new_empty"]
    assert not stacks, stacks


def test_trace_counts_an_output_at_a_dead_storages_address():
    """A storage counted with a wrapper (a collective's result) that dies
    while the wrapper lives keeps its address: fresh outputs made after it
    are each counted.  Keyed by address alone, one of them took the dead
    storage's address and joined the wrapper's handle uncounted, and a
    train cell's footprint moved between runs of one tree."""
    trace = analysis.ShardedTrace()
    held = torch.empty(4, device="meta")
    wrap = torch.empty(4, device="meta")
    trace._count(wrap, "_wrap_tensor_autograd", held)
    del held
    fresh = [torch.empty(4, device="meta") for _ in range(64)]
    for t in fresh:
        trace._count(t, "empty")
    assert trace.live_bytes == trace.peak_without(set()) == 16 * 65
    del wrap, fresh, t
    assert trace.live_bytes == 0


# ------------------------------------------------------ on 4 gloo ranks
_GLOO_BODY = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.distributed import sharding
from repro_torch.models import moe
from repro_torch.training import optimizer
from repro_torch.training.optimizer import AdamWConfig
rank, store = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                        world_size=4)
TOL = dict(rtol=2e-5, atol=2e-5)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
rng = np.random.default_rng(0)
new = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
R = Replicate()

# The experts: x (G, E, C, d) split on its groups over "data" and, where
# the weights split the experts over "model", on its experts.  Each weight
# passes the layer's hook (``grad_split_as``), its gradient scattered on
# its hidden dim over the mesh dims that leave it whole.
for E, split in ((4, True), (3, False)):
    G, C, d, ff = 4, 6, 8, 12
    x = new(G, E, C, d)
    ws = [new(E, d, ff) * 0.3, new(E, d, ff) * 0.3, new(E, ff, d) * 0.3]
    out_w = new(G, E, C, d)
    p_in = [t.clone().requires_grad_() for t in [x] + ws]
    p_out = moe._experts(*p_in)
    p_grads = torch.autograd.grad((p_out * out_w).sum(), p_in)
    w_pl = [R, Shard(0)] if split else [R, R]
    x_pl = [Shard(0), Shard(1)] if split else [Shard(0), R]
    d_in = [distribute_tensor(t.detach().clone(), mesh, pl).requires_grad_()
            for t, pl in zip([x] + ws, [x_pl] + [w_pl] * 3)]
    with implicit_replication():
        hooked = [sharding.grad_split_as(w, s) for w, s in
                  zip(d_in[1:], (-2, -2, -1))]
        d_out = sharding.rows_on_shards(moe._experts, d_in[0], *hooked)
        # Whole experts: the groups split over both mesh dims.
        assert list(d_out.placements) == (x_pl if split else
                                          [Shard(0), Shard(0)]), E
        d_grads = torch.autograd.grad(
            (d_out * distribute_tensor(out_w, mesh, [R, R])).sum(), d_in)
    torch.testing.assert_close(d_out.full_tensor(), p_out.detach(), **TOL)
    for i, (g, p) in enumerate(zip(d_grads, p_grads)):
        if i:                              # the hidden dim: 1, 1, 2
            h = 2 if i == 3 else 1
            want = [Shard(h), Shard(0)] if split else [Shard(h), Shard(h)]
            assert list(g.placements) == want, (E, i, g.placements)
        torch.testing.assert_close(g.full_tensor(), p, **TOL)

# AdamW: stacked expert leaves (L, E, d, ff) whole over "data", their
# gradients scattered there on the hidden dim; m and v in bf16 and fp32.
L, E, d, ff = 3, 4, 8, 12
optimizer.SLICE_BYTES = 4 * (E // 2) * d * ff      # a layer a slice
for scale, mdt, exact in ((1e-3, "float32", True), (1.0, "float32", False),
                          (1e-3, "bfloat16", True)):
    cfg = AdamWConfig(lr=1e-2, warmup_steps=4, moment_dtype=mdt)
    mt = getattr(torch, mdt)
    params = {"a": new(L, E, d, ff), "b": new(L, E, ff, d)}
    grads = {k: new(*p.shape) * scale for k, p in params.items()}
    m = {k: (0.1 * new(*p.shape)).to(mt) for k, p in params.items()}
    v = {k: (0.01 * new(*p.shape) ** 2).to(mt) for k, p in params.items()}
    state = {"m": m, "v": v, "step": torch.tensor(2, dtype=torch.int32)}
    want = optimizer.adamw_update(params, grads, state, cfg)
    p_pl = [R, Shard(1)]
    g_pl = {"a": [Shard(2), Shard(1)], "b": [Shard(3), Shard(1)]}
    dp = lambda t: distribute_tensor(t, mesh, p_pl)
    got = optimizer.adamw_update(
        {k: dp(t) for k, t in params.items()},
        {k: distribute_tensor(t, mesh, g_pl[k]) for k, t in grads.items()},
        {"m": {k: dp(t) for k, t in m.items()},
         "v": {k: dp(t) for k, t in v.items()},
         "step": distribute_tensor(state["step"], mesh, [R, R])}, cfg)
    assert (want[2] < 1) == exact, want[2]
    for g_tree, w_tree in ((got[0], want[0]), (got[1]["m"], want[1]["m"]),
                           (got[1]["v"], want[1]["v"])):
        for k in params:
            assert list(g_tree[k].placements) == p_pl, g_tree[k].placements
            full = g_tree[k].full_tensor()
            if exact:
                assert torch.equal(full, w_tree[k]), (k, mdt)
            else:
                torch.testing.assert_close(full, w_tree[k], rtol=1e-6,
                                           atol=1e-7)
dist.barrier()
dist.destroy_process_group()
print("RANK_OK", flush=True)
import os
os._exit(0)
"""


def test_experts_and_adamw_on_dtensors_match_the_plain_ones(tmp_path):
    """On 4 gloo ranks, a (2, 2) mesh: the experts on each device's groups
    and experts (4 experts split over the model axis; 3, whole) against
    the plain products, outputs and every input's gradient at fp32 within
    rtol/atol 2e-5, the weights' gradients scattered on their hidden dim;
    AdamW of such gradients against the plain update of the whole
    tensors, the new leaves placed as the parameters."""
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _GLOO_BODY, str(r), str(tmp_path / "store")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in range(4)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and "RANK_OK" in log, f"rank {r}:\n{log}"


# ------------------------------------------------------- the plain route
def test_plain_tensors_take_the_parents_experts_and_update():
    """Plain tensors: ``rows_on_shards`` gives the parent's expert
    products, ``grad_split_as`` the tensor itself, and ``adamw_update``
    with a gradient of a stacked expert leaf the parent's update, bit for
    bit."""
    rng = np.random.default_rng(7)
    new = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    x = new(3, 4, 5, 8)
    wg, wu, wd = new(4, 8, 6), new(4, 8, 6), new(4, 6, 8)
    h = F.silu(torch.einsum("gecd,edf->gecf", x, wg)) \
        * torch.einsum("gecd,edf->gecf", x, wu)
    want = torch.einsum("gecf,efd->gecd", h, wd)
    assert torch.equal(sharding.rows_on_shards(moe._experts, x, wg, wu, wd),
                       want)
    w = wg.clone().requires_grad_()
    assert sharding.grad_split_as(w, -2) is w
    p, g = new(3, 4, 8, 6), new(3, 4, 8, 6)
    assert optimizer._gathered(g, p) is g
    cfg = optimizer.AdamWConfig(lr=1e-2, warmup_steps=4)
    state = {"m": {"w": 0.1 * new(3, 4, 8, 6)},
             "v": {"w": 0.01 * new(3, 4, 8, 6) ** 2},
             "step": torch.tensor(1, dtype=torch.int32)}
    got = optimizer.adamw_update({"w": p}, {"w": g}, state, cfg)
    # The parent's update, written out: one fp32 pass over the leaf.
    step = state["step"] + 1
    gnorm = torch.sqrt(torch.sum(g ** 2))
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = cfg.lr * torch.clamp(step.float() / cfg.warmup_steps, max=1.0)
    g32 = g * clip
    m32 = cfg.b1 * state["m"]["w"] + (1 - cfg.b1) * g32
    v32 = cfg.b2 * state["v"]["w"] + (1 - cfg.b2) * g32 * g32
    upd = (m32 / (1 - torch.pow(cfg.b1, step.float()))) / (torch.sqrt(
        v32 / (1 - torch.pow(cfg.b2, step.float()))) + cfg.eps)
    upd = upd + cfg.weight_decay * p
    assert torch.equal(got[0]["w"], p - lr * upd)
    assert torch.equal(got[1]["m"]["w"], m32)
    assert torch.equal(got[1]["v"]["w"], v32)
