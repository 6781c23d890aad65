"""The attention's and the SSD's heads kept split in the dry run's sharded
trace (ROADMAP C.12), and qwen2-vl-72b's MLP gradients kept split (C.18).

- SMOKE prefill and train cells on a fake (2, 4) ("data", "model") mesh,
  whose 4-wide model axis splits 4 query heads but not qwen3's and
  qwen2-vl's 2 KV heads, nor recurrentgemma's one (8 on 16 and 1 on 16 in
  production): no ``view`` or ``_unsafe_view`` runs replicated, and no
  fp32 tensor of the trace holds every head of a chunk's scores (nor, in
  mamba2, every head of a chunk's (c, c) decays).
- On 4 gloo ranks: ``sharding.attend_on_heads`` and ``scan_on_heads`` on
  DTensors against the plain attention and SSD (causal, windowed, cross,
  MLA's shapes; G of 1, 2 and KH = 1), outputs and input gradients at
  fp32 within rtol/atol 2e-5, and the GQA, MLA and SSM blocks whole.
- The plain route: the hooks hand plain tensors to the products as they
  are, bit for bit.
- C.18: qwen2-vl-72b's SMOKE train cell on the (2, 4) mesh at 8 rows, its
  MLP gradients split over the model axis as their weights are."""
import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.configs.registry import ShapeSpec, get_config
from repro_torch.core.tree import leaves_with_path, path_str
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import init_fake_process_group
from repro_torch.models import layers
from repro_torch.roofline import analysis

SRC = Path(__file__).resolve().parents[1] / "src"
B, SEQ, CHUNK = 4, 64, 16
ARCHS = ["qwen3-0.6b", "phi3-mini-3.8b", "recurrentgemma-9b",
         "deepseek-v3-671b", "mamba2-1.3b"]


@pytest.fixture(scope="module")
def mesh():
    """A (2, 4) mesh over a fake process group of 8 ranks in this process,
    torn down after the module."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    init_fake_process_group(8)
    try:
        yield init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _traced_cell(mesh, arch, kind, monkeypatch, batch=B):
    """The SMOKE cell of ``kind`` (``batch`` x 64 tokens, query chunks of
    16) → (its record, the (shape, dtype) of every local tensor the trace
    saw an op make)."""
    made = []

    class Trace(analysis.ShardedTrace):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is not NotImplemented:
                made.extend((tuple(o.shape), o.dtype) for o in (
                    out if isinstance(out, (list, tuple)) else (out,))
                    if isinstance(o, torch.Tensor)
                    and not isinstance(o, FakeTensor))
            return out

    monkeypatch.setattr(dryrun.roofline, "ShardedTrace", Trace)
    entry = dryrun.lower_cell(arch, ShapeSpec(f"{kind}_smoke", SEQ, batch, kind),
                              False, {"attn_chunk_q": CHUNK}, mesh=mesh,
                              smoke=True)
    return entry, made


def _every_head(shape, dtype, cfg) -> bool:
    """Whether a tensor of ``shape`` is fp32 with a chunk's scores (last two
    dims (CHUNK, SEQ)) or, for an SSM, a chunk's (c, c) decays, for every
    head at once."""
    if dtype != torch.float32 or len(shape) < 4:
        return False
    if cfg.ssm is not None:
        c = cfg.ssm.chunk_size
        h = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
        return len(shape) == 5 and shape[-2:] == (c, c) and shape[2] == h
    heads = int(np.prod(shape[1:-2]))
    return shape[-2:] == (CHUNK, SEQ) and heads == cfg.n_heads


@pytest.mark.parametrize("kind", ["prefill", "train"])
@pytest.mark.parametrize("arch", ARCHS)
def test_heads_stay_split(mesh, monkeypatch, arch, kind):
    """No view runs replicated, and no fp32 tensor of the trace (nor of the
    record's largest at the peak) holds every head of a chunk's scores or
    decays: each device computes its own query heads."""
    entry, made = _traced_cell(mesh, arch, kind, monkeypatch)
    cfg = get_config(arch, smoke=True)
    assert entry["status"] == "ok"
    assert not {"view", "_unsafe_view"} & set(entry["replicated_calls"]), \
        entry["replicated_calls"]
    assert set(entry["replicated_calls"]) <= dryrun.REPLICABLE
    whole = [s for s, dt in made if _every_head(s, dt, cfg)]
    assert not whole, whole[:5]
    # The products ran: a chunk's scores (or decays) for some heads.
    part = [s for s, dt in made if dt == torch.float32 and len(s) >= 4 and (
        s[-2:] == (CHUNK, SEQ) if cfg.ssm is None else
        s[-2:] == (cfg.ssm.chunk_size,) * 2)]
    assert part
    holders = entry["memory"]["peak_holders"]
    assert not [h for h in holders
                if _every_head(tuple(h[1]), getattr(torch, h[2]), cfg)]


# ------------------------------------------------------ on 4 gloo ranks
_GLOO_BODY = r"""
import dataclasses, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs.registry import get_config
from repro_torch.core.tree import leaves, unflatten
from repro_torch.distributed import sharding
from repro_torch.kernels.ssd_scan.ref import ssd_scan
from repro_torch.models import layers, mla, ssm, transformer
rank, store = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                        world_size=4)
TOL = dict(rtol=2e-5, atol=2e-5)
meshes = {"2x2": init_device_mesh("cpu", (2, 2),
                                  mesh_dim_names=("data", "model")),
          "1x4": init_device_mesh("cpu", (1, 4),
                                  mesh_dim_names=("data", "model"))}
rng = np.random.default_rng(0)
new = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))


def run(fn, plain, placed, mesh, n_out=1):
    # fn on plain tensors and on DTensors placed as ``placed`` (a list of
    # placements or None for a plain input): outputs and the gradients of
    # a random projection of them, against each other.
    p_in = [t.clone().requires_grad_() for t in plain]
    p_out = fn(*p_in)
    p_out = p_out if isinstance(p_out, tuple) else (p_out,)
    p_out = p_out[:n_out]
    w = [new(*o.shape) for o in p_out]
    p_grads = torch.autograd.grad(sum((o * v).sum() for o, v in
                                      zip(p_out, w)), p_in, allow_unused=True)
    d_in = [distribute_tensor(t.detach().clone(), mesh, pl).requires_grad_()
            for t, pl in zip(plain, placed)]
    with implicit_replication():        # the rotary angles stay plain
        d_out = fn(*d_in)
        d_out = d_out if isinstance(d_out, tuple) else (d_out,)
        d_out = d_out[:n_out]
        assert all(isinstance(o, DTensor) for o in d_out)
        d_w = [distribute_tensor(v, mesh, [Replicate()] * mesh.ndim)
               for v in w]
        d_grads = torch.autograd.grad(sum((o * v).sum() for o, v in zip(
            d_out, d_w)), d_in, allow_unused=True)
    for o, p in zip(d_out, p_out):
        torch.testing.assert_close(o.full_tensor(), p.detach(), **TOL)
    assert [g is None for g in d_grads] == [p is None for p in p_grads]
    for g, p in zip(d_grads, p_grads):
        if p is not None:
            torch.testing.assert_close(g.full_tensor(), p, **TOL)
    return d_out


def placed_as(pl, mesh):
    return [[{"B": Shard(0), "S": Shard(1), "H": Shard(2), "R": Replicate(),
              "L": Shard(2)}[c] for c in p] for p in pl]


S0, S2 = Shard(0), Shard(2)
# (name, mesh, H, KH, hd, vd, Sq, Skv, kw, k's placements)
ATTN = [
    ("causal G=1", "2x2", 4, 4, 8, 8, 12, 12, dict(chunk_q=4), "BH"),
    ("causal G=2 on KH < model", "1x4", 4, 2, 8, 8, 12, 12,
     dict(chunk_q=4), "BS"),
    ("causal KH=1", "1x4", 4, 1, 8, 8, 12, 12, {}, "BR"),
    ("windowed KH=1", "2x2", 4, 1, 8, 8, 16, 16,
     dict(window=5, chunk_q=8), "BS"),
    ("cross", "2x2", 4, 4, 8, 8, 6, 10, dict(causal=False), "BH"),
    ("MLA shapes", "1x4", 8, 8, 12, 8, 8, 8,
     dict(scale=12 ** -0.5, chunk_q=4), "BH"),
]
for name, mname, H, KH, hd, vd, Sq, Skv, kw, kpl in ATTN:
    mesh = meshes[mname]
    q, k, v = new(2, Sq, H, hd), new(2, Skv, KH, hd), new(2, Skv, KH, vd)
    fn = lambda q, k, v: layers.attention(q, k, v, **kw)
    qpl, kvpl = placed_as(["BH", kpl], mesh)
    out = run(fn, [q, k, v], [qpl, kvpl, kvpl], mesh)
    rows = S0 if mesh.size(0) > 1 else Replicate()     # a 1-wide axis: whole
    assert tuple(out[0].placements) == (rows, S2), (name, out[0].placements)

# The SSD: heads split, B and C shared by every head.
mesh = meshes["2x2"]
b, l, h, p, n = 2, 12, 4, 3, 5
x, dt, Bm, Cm = new(b, l, h, p), new(b, l, h).abs(), new(b, l, n), new(b, l, n)
A, st = -new(h).abs(), new(b, h, p, n)
for init in (None, st):
    fn = (lambda x, dt, A, Bm, Cm, s=None: sharding.scan_on_heads(
        ssd_scan, x, dt, A, Bm, Cm, chunk=4, init_state=s))
    args = [x, dt, A, Bm, Cm] + ([init] if init is not None else [])
    pls = [[S0, S2], [S0, S2], [Replicate(), Shard(0)], [S0, Replicate()],
           [S0, Replicate()]] + ([[S0, Shard(1)]] if init is not None
                                 else [])
    y, last = run(fn, args, pls, mesh, n_out=2)
    assert tuple(y.placements) == (S0, S2)
    assert tuple(last.placements) == (S0, Shard(1))


def block(arch, fn, **over):
    # A SMOKE block's parameters placed by the reference's rules, its input
    # split on the batch: the block's output and every gradient against
    # the plain block's.
    mesh = meshes["1x4"] if over.pop("wide", False) else meshes["2x2"]
    cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(1))
    lp = transformer.layer(params["layers"] if "layers" in params else
                           params["groups"]["blk2"], 0)
    flat = [t.float() for t in leaves(lp)]
    specs = sharding.param_specs(lp, mesh)
    pls = [sharding.placements(s, mesh) for s in leaves(
        specs, is_leaf=sharding.is_spec)]
    x = new(4, 16, cfg.d_model)
    run(lambda x, *ws: fn(cfg, unflatten(lp, list(ws)), x),
        [x] + flat, [[S0, Replicate()]] + list(pls), mesh)


pos = torch.arange(16)[None]
def angles(cfg, rot):
    return layers.rope_angles(pos, rot, cfg.rope_theta)
block("qwen3-0.6b", lambda cfg, p, x: layers.gqa_block(
    p["attn"], x, cfg, cos=angles(cfg, cfg.hd)[0],
    sin=angles(cfg, cfg.hd)[1])[0], n_heads=4, n_kv_heads=2, wide=True)
block("recurrentgemma-9b", lambda cfg, p, x: layers.gqa_block(
    p["attn"], x, cfg, cos=angles(cfg, cfg.hd)[0],
    sin=angles(cfg, cfg.hd)[1], window=5)[0])
block("deepseek-v3-671b", lambda cfg, p, x: mla.mla_train(
    p["attn"], x, cfg, *angles(cfg, cfg.mla.qk_rope_head_dim))[0])
block("mamba2-1.3b", lambda cfg, p, x: ssm.ssm_block(
    p["ssm"], x, cfg, differentiable=True)[0])
block("qwen3-0.6b", lambda cfg, p, x: layers.mlp_block(p["mlp"], x, cfg.act))
dist.barrier()
dist.destroy_process_group()
print("RANK_OK", flush=True)
import os
os._exit(0)
"""


def test_heads_on_dtensors_match_the_plain_products(tmp_path):
    """On 4 gloo ranks, the attention (causal, windowed, cross, MLA's
    shapes; G of 1, 2 and KH = 1, k split on its heads, its sequence or
    not at all) and the SSD (with and without an initial state) on
    DTensors, and the GQA, MLA, SSM and MLP blocks with the reference's
    placements: outputs and every input's gradient equal to the plain
    versions' at fp32 within rtol/atol 2e-5."""
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _GLOO_BODY, str(r), str(tmp_path / "store")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in range(4)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and "RANK_OK" in log, f"rank {r}:\n{log}"


# ------------------------------------------------------- the plain route
def test_plain_tensors_take_the_products_as_they_are():
    """On plain tensors the hooks call the products on their own inputs
    and return what they return: ``attention`` equals ``_attention`` bit
    for bit, and ``split_heads`` is the plain reshape."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 8, 4, 8), (2, 8, 2, 8), (2, 8, 2, 8)))
    seen = []

    def attend(*a, **kw):
        seen.append(a)
        return layers._attention(*a, **kw)

    kw = dict(causal=True, window=3, chunk_q=4, scale=None)
    out = sharding.attend_on_heads(attend, q, k, v, **kw)
    assert all(x is y for x, y in zip(seen[0], (q, k, v)))
    assert torch.equal(out, layers._attention(q, k, v, **kw))
    assert torch.equal(layers.attention(q, k, v, causal=True, window=3,
                                        chunk_q=4),
                       layers._attention(q, k, v, **kw))
    t = q.reshape(2, 8, 32)
    assert torch.equal(sharding.split_heads(t, 4, 4), q)
    for hook in (sharding.column_parallel_input, sharding.follow):
        assert hook(t, t) is t
    assert sharding.grad_as_value(t) is t


# ----------------------------------------------------------------- C.18
def test_qwen2_vl_mlp_gradients_keep_their_split(mesh, monkeypatch):
    """qwen2-vl-72b's SMOKE train cell at 8 x 64 tokens, whose batch the
    mesh splits over data and model as the 256-row train batch splits over
    16 x 16 (at 4 rows the parent's MLP gradients were split already):
    every MLP gradient (the stacked ``w_gate``, ``w_up``, ``w_down``)
    comes to the optimizer split over the model axis on the dim its
    weight's spec splits, and no op makes an fp32 tensor of a stacked MLP
    leaf's whole shape.  The parent gave each pending a sum over the model
    axis, and the optimizer all-reduced it whole on every device."""
    from repro_torch.training import optimizer
    from torch.distributed.tensor import Shard
    grads = []
    real_update = optimizer.adamw_update

    def update(params, g, state, opt):
        grads.append(g)
        return real_update(params, g, state, opt)

    monkeypatch.setattr("repro_torch.training.step.adamw_update", update)
    entry, made = _traced_cell(mesh, "qwen2-vl-72b", "train", monkeypatch,
                               batch=8)
    assert entry["status"] == "ok"
    cfg = get_config("qwen2-vl-72b", smoke=True)
    L, d, ff = cfg.n_layers, cfg.d_model, cfg.d_ff
    mlp = {path_str(p): g for p, g in leaves_with_path(grads[-1])
           if "/mlp/" in path_str(p)}
    assert sorted(mlp) == ["layers/mlp/w_down", "layers/mlp/w_gate",
                           "layers/mlp/w_up"]
    for path, g in mlp.items():
        want = Shard(1) if path.endswith("w_down") else Shard(2)
        assert g.placements[1] == want, (path, g.placements)
    whole = [s for s, dt in made if dt == torch.float32
             and s in ((L, d, ff), (L, ff, d))]
    assert not whole, whole[:5]
