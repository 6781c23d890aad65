"""Attention heads that the model axis does not divide, split unevenly in
the dry run's sharded trace, and the embedding looked up on each device's
rows where its table is whole (ROADMAP C.12).

- SMOKE prefill and train cells on the fake (2, 4) ("data", "model") mesh
  of ``test_torch_dryrun_heads.py``: phi3-medium-14b's SMOKE config (5
  heads on 4: gcd 1) and whisper-large-v3's at 10 heads and 10 KV heads
  of 16 (gcd 2), as 40 and 20 heads meet a 16-wide model axis in
  production.  No ``view`` or ``_unsafe_view`` runs replicated, no fp32
  tensor holds every head of a chunk's scores, and the scores come in
  ceil(heads / 4) heads a device.
- On 6 gloo ranks (a 3-wide model axis is the narrowest that a group of
  4 query heads a KV head does not divide): the attention alone, the
  GQA block (causal; G = 1 and G = 4; non-causal, as an encoder), the
  cross-attention with its K/V projection, and the embedding's lookup in
  a whole table, on DTensors against the plain versions: outputs and
  every input's gradient at fp32 within rtol/atol 2e-5.
- mamba2-1.3b's SMOKE cells with a vocab the model axis does not divide
  on a fake (2, 2, 2) ("pod", "data", "model") mesh: the embedding's
  gather and its backward run on each device's ids, none replicated.
- The plain route: the hooks give plain tensors the products they gave
  before, bit for bit."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import Shard

from repro_torch.configs.registry import ShapeSpec, get_config
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun
from repro_torch.models import layers
from repro_torch.roofline import analysis
from test_torch_dryrun_heads import (  # noqa: F401 (mesh: a fixture)
    CHUNK, SEQ, SRC, _every_head, mesh)

B = 4
# arch → the SMOKE config's overrides: whisper at 10 heads of 16 (gcd 2
# with the 4-wide axis), phi3-medium as it is (5 heads).
HEADS = {"phi3-medium-14b": {},
         "whisper-large-v3": {"n_heads": 10, "n_kv_heads": 10,
                              "head_dim": 16}}


def _traced(device_mesh, arch, kind, monkeypatch, over, refuse=False):
    """The SMOKE cell of ``kind`` (4 x 64 tokens, query chunks of 16) with
    the config's overrides ``over`` → (its record, the config, the
    (op, shape, dtype) of every local tensor an op made).  With ``refuse``
    DTensor refuses a gather whose index is split twice on one dim, as
    torch 2.11's does (``test_torch_dryrun_two_pod.py``'s stand-in)."""
    made = []

    class Trace(analysis.ShardedTrace):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if refuse and func is torch.ops.aten.index.Tensor:
                for i in args[1]:
                    dims = [p.dim for p in getattr(i, "placements", ())
                            if isinstance(p, Shard)]
                    if len(dims) != len(set(dims)):
                        raise RuntimeError("2.11: index split twice")
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is not NotImplemented:
                made.extend((func._overloadpacket.__name__, tuple(o.shape),
                             o.dtype) for o in (
                    out if isinstance(out, (list, tuple)) else (out,))
                    if isinstance(o, torch.Tensor)
                    and not isinstance(o, FakeTensor))
            return out

    monkeypatch.setattr(dryrun.roofline, "ShardedTrace", Trace)
    over = {"attn_chunk_q": CHUNK, **over}
    entry = dryrun.lower_cell(arch, ShapeSpec(f"{kind}_smoke", SEQ, B, kind),
                              False, over, mesh=device_mesh, smoke=True)
    cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    return entry, cfg, made


@pytest.mark.parametrize("kind", ["prefill", "train"])
@pytest.mark.parametrize("arch", sorted(HEADS))
def test_uneven_heads_stay_split(mesh, monkeypatch, arch, kind):  # noqa: F811
    """No view runs replicated; no fp32 tensor of the trace, nor of the
    record's largest at the peak, holds every head of a chunk's scores;
    and the scores come ceil(heads / 4) heads to a device."""
    entry, cfg, made = _traced(mesh, arch, kind, monkeypatch, HEADS[arch])
    assert entry["status"] == "ok"
    assert not {"view", "_unsafe_view"} & set(entry["replicated_calls"]), \
        entry["replicated_calls"]
    assert set(entry["replicated_calls"]) <= dryrun.REPLICABLE
    whole = [s for _, s, dt in made if _every_head(s, dt, cfg)]
    assert not whole, whole[:5]
    per = -(-cfg.n_heads // 4)
    part = {int(np.prod(s[1:-2])) for _, s, dt in made
            if dt == torch.float32
            and len(s) >= 4 and s[-2:] == (CHUNK, SEQ)}
    assert part == {per}, part
    holders = entry["memory"]["peak_holders"]
    assert not [h for h in holders
                if _every_head(tuple(h[1]), getattr(torch, h[2]), cfg)]


@pytest.mark.parametrize("rule", ["own", "2.11"])
@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_whole_table_looks_up_each_devices_ids(mesh, monkeypatch,  # noqa: F811
                                               kind, rule):
    """mamba2-1.3b's SMOKE cell at a vocab of 251, which the 2-wide model
    axis does not divide (its 50280 on 16 in production), on a (2, 2, 2)
    mesh, the batch split over pod and data: the table is whole on every
    device, and neither its gather nor the gather's backward runs
    replicated (2.11's DTensor has no rule for ids split over two mesh
    dims on one dim, and the parent reran that gather on ids gathered over
    data, 16 rows of a prefill's embeddings on each device): on this
    torch's rules, and with 2.11's refusal stood in for."""
    from torch.distributed.device_mesh import init_device_mesh
    pods = init_device_mesh("cpu", (2, 2, 2),
                            mesh_dim_names=("pod", "data", "model"))
    entry, cfg, made = _traced(pods, "mamba2-1.3b", kind, monkeypatch,
                               {"vocab": 251}, refuse=rule == "2.11")
    assert entry["status"] == "ok"
    assert not {"index", "index_put", "view", "_unsafe_view"} & set(
        entry["replicated_calls"]), entry["replicated_calls"]
    # Each device's embeddings: its one row of the batch, never more.
    rows = [s for op, s, _ in made if op == "index"
            and s[1:] == (SEQ, cfg.d_model)]
    assert rows and {s[0] for s in rows} == {1}, rows[:5]


# ------------------------------------------------------ on 6 gloo ranks
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
from repro_torch.models import layers, transformer
rank, store = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                        world_size=6)
TOL = dict(rtol=2e-5, atol=2e-5)
meshes = {name: init_device_mesh("cpu", shape,
                                 mesh_dim_names=("data", "model"))
          for name, shape in (("2x3", (2, 3)), ("3x2", (3, 2)),
                              ("1x6", (1, 6)))}
rng = np.random.default_rng(0)
new = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
S0, R = Shard(0), Replicate()


def run(fn, plain, placed, mesh):
    # fn on plain tensors and on DTensors placed as ``placed``: outputs and
    # the gradients of a random projection of them, against each other.
    p_in = [t.clone().requires_grad_(t.is_floating_point()) for t in plain]
    p_out = fn(*p_in)
    w = new(*p_out.shape)
    grads_of = [t for t in p_in if t.requires_grad]
    p_grads = torch.autograd.grad((p_out * w).sum(), grads_of,
                                  allow_unused=True)
    d_in = [distribute_tensor(t.detach().clone(), mesh, pl).requires_grad_(
        t.is_floating_point()) for t, pl in zip(plain, placed)]
    with implicit_replication():        # the rotary angles stay plain
        d_out = fn(*d_in)
        assert isinstance(d_out, DTensor)
        d_w = distribute_tensor(w, mesh, [R] * mesh.ndim)
        d_grads = torch.autograd.grad((d_out * d_w).sum(),
                                      [t for t in d_in if t.requires_grad],
                                      allow_unused=True)
    torch.testing.assert_close(d_out.full_tensor(), p_out.detach(), **TOL)
    assert [g is None for g in d_grads] == [p is None for p in p_grads]
    for g, p in zip(d_grads, p_grads):
        if p is not None:
            torch.testing.assert_close(g.full_tensor(), p, **TOL)
    return d_out


# The attention alone: q split on its batch and, unevenly, on its heads.
# (name, mesh, H, KH, Sq, Skv, kw)
ATTN = [("causal G=1", "2x3", 5, 5, 12, 12, dict(chunk_q=4)),
        ("causal G=4", "2x3", 8, 2, 12, 12, dict(chunk_q=4)),
        ("cross G=1", "1x6", 9, 9, 6, 10, dict(causal=False)),
        ("non-causal G=1", "3x2", 5, 5, 16, 16, dict(causal=False))]
for name, mname, H, KH, Sq, Skv, kw in ATTN:
    mesh = meshes[mname]
    b = mesh.size(0) * 2
    q, k, v = new(b, Sq, H, 8), new(b, Skv, KH, 8), new(b, Skv, KH, 8)
    fn = lambda q, k, v: layers.attention(q, k, v, **kw)
    pl = [[S0, Shard(2)], [S0, R], [S0, R]]
    out = run(fn, [q, k, v], pl, mesh)
    assert H % mesh.size(1) and tuple(out.placements)[1] == Shard(2), \
        (name, out.placements)


def params_of(arch, mesh, **over):
    # A SMOKE layer's parameters placed by the reference's rules.
    cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(1))
    lp = transformer.layer(params["layers"], 0)
    specs = sharding.param_specs(lp, mesh)
    return cfg, lp, [t.float() for t in leaves(lp)], [
        sharding.placements(s, mesh)
        for s in leaves(specs, is_leaf=sharding.is_spec)]


# Each block below takes the uneven route: ``_uneven`` finds a split.
cuts, uneven = [], sharding._uneven
sharding._uneven = lambda *a: cuts.append(uneven(*a)) or cuts[-1]


def block(arch, mname, fn, n_in=1, **over):
    # fn(cfg, layer params, *inputs) on a SMOKE layer against the plain
    # layer: inputs of a row a data slice (too few to split over the
    # model axis too) x 12 tokens, split on their batch.
    cuts.clear()
    mesh = meshes[mname]
    cfg, lp, flat, pls = params_of(arch, mesh, **over)
    b = mesh.size(0)
    xs = [new(b, 12, cfg.d_model if i == 0 else cfg.encoder_dim or
              cfg.d_model) for i in range(n_in)]
    run(lambda *a: fn(cfg, unflatten(lp, list(a[n_in:])), *a[:n_in]),
        xs + flat, [[S0, R]] * n_in + list(pls), mesh)
    assert any(cuts), (arch, over)


pos = torch.arange(12)[None]
def gqa(cfg, p, x):
    cos, sin = layers.rope_angles(pos, cfg.hd, cfg.rope_theta)
    return layers.gqa_block(p["attn"], x, cfg, cos=cos, sin=sin)[0]
# head_dim 12: the projections' columns split over the model axis, 1.67
# and 2.5 heads a device, as whisper's 1.25 on 16.
block("phi3-medium-14b", "2x3", gqa, head_dim=12)                   # G=1
block("phi3-medium-14b", "2x3", gqa, n_heads=8, n_kv_heads=2,
      head_dim=12)                                                   # G=4
block("whisper-large-v3", "3x2", lambda cfg, p, x: layers.gqa_block(
    p["attn"], x, cfg)[0], n_heads=5, n_kv_heads=5, head_dim=12,
    causal=False)                                        # the encoder's
for heads, kv in ((5, 5), (4, 1)):                       # G=1, G=4
    block("whisper-large-v3", "2x3", lambda cfg, p, x, enc:
          layers.cross_attention(p["xattn"], x, *layers.cross_kv(
              p["xattn"], enc, cfg, x.dtype), cfg), n_in=2,
          n_heads=heads, n_kv_heads=kv, head_dim=12)

# The embedding in a whole table (a vocab the model axis does not divide),
# ids split on their batch over both mesh dims.
mesh = meshes["2x3"]
table = new(250, 12)
ids = torch.from_numpy(rng.integers(0, 250, (6, 12)))
emb = run(lambda t, i: sharding.embed_on_shards(t, i, torch.float32),
          [table, ids], [[R, R], [S0, S0]], mesh)
assert tuple(emb.placements) == (S0, S0)
dist.barrier()
dist.destroy_process_group()
print("RANK_OK", flush=True)
import os
os._exit(0)
"""


def test_uneven_heads_on_dtensors_match_the_plain_products(tmp_path):
    """On 6 gloo ranks, over model axes of 2, 3 and 6 that the heads do
    not divide: the attention (causal with G = 1 and 4, cross, non-causal),
    the GQA block (causal, G = 1 and 4, rotated; non-causal, whisper's
    encoder), the cross-attention with its K/V projection (G = 1 and 4),
    and the embedding in a whole table, on DTensors: outputs and every
    input's gradient equal to the plain versions' at fp32 within
    rtol/atol 2e-5."""
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _GLOO_BODY, str(r), str(tmp_path / "store")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in range(6)]
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
def test_plain_tensors_take_the_parents_products():
    """On plain tensors the new hooks give what the parent computed, bit
    for bit: ``project_heads`` the projection viewed as heads,
    ``merge_heads`` the flattened output's projection, ``embed_on_shards``
    the table's rows, and the GQA and cross-attention blocks the parent's
    projections, attention and output product."""
    rng = np.random.default_rng(5)
    new = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    x, w = new(2, 8, 32), new(32, 48)
    assert torch.equal(sharding.project_heads(layers.linear, x, w, 4, 4),
                       (x @ w).reshape(2, 8, 4, 12))
    o, wo = new(2, 8, 4, 12), new(48, 32)
    assert torch.equal(sharding.merge_heads(layers.linear, o, wo),
                       o.reshape(2, 8, 48) @ wo)
    table, ids = new(50, 8), torch.from_numpy(rng.integers(0, 50, (2, 8)))
    assert torch.equal(sharding.embed_on_shards(table, ids, torch.bfloat16),
                       table[ids].to(torch.bfloat16))

    from repro_torch.models import transformer
    cfg = get_config("phi3-medium-14b", smoke=True)
    lp = transformer.layer(transformer.init_params(
        cfg, torch.Generator().manual_seed(2))["layers"], 0)["attn"]
    h = new(2, 8, cfg.d_model)
    cos, sin = layers.rope_angles(torch.arange(8)[None], cfg.hd,
                                  cfg.rope_theta)
    q, k, v = ((h @ lp[w]).reshape(2, 8, -1, cfg.hd)
               for w in ("wq", "wk", "wv"))
    q, k = layers.apply_rope(q, cos, sin), layers.apply_rope(k, cos, sin)
    kw = dict(window=0, chunk_q=cfg.attn_chunk_q, scale=None)
    o = layers._attention(q, k, v, causal=cfg.causal, **kw)
    out, (k2, v2) = layers.gqa_block(lp, h, cfg, cos=cos, sin=sin)
    assert torch.equal(out, o.reshape(2, 8, -1) @ lp["wo"])
    assert torch.equal(k2, k) and torch.equal(v2, v)
    enc = new(2, 6, cfg.d_model)
    ck, cv = layers.cross_kv(lp, enc, cfg, torch.float32)
    assert torch.equal(ck, (enc @ lp["wk"]).reshape(2, 6, -1, cfg.hd))
    o = layers._attention((h @ lp["wq"]).reshape(2, 8, -1, cfg.hd), ck, cv,
                          causal=False, **kw)
    assert torch.equal(layers.cross_attention(lp, h, ck, cv, cfg),
                       o.reshape(2, 8, -1) @ lp["wo"])
