"""The port's scale-out paths on 4 gloo ranks, each a process of its own
(the JAX package's tests force 4 host devices in a subprocess instead):
a spec's placements distributed and gathered back, ``compressed_psum``,
the GPipe pipeline against the sequential loop of both packages, one
sharded SMOKE train step of qwen3-0.6b in ``tp`` and ``fsdp`` mode against
the unsharded step, the error-feedback compressor in that step, and a
data-parallel step through ``compressed_psum``."""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

SRC = Path(__file__).resolve().parents[1] / "src"

_PRE = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                        world_size=world)
"""
# Every rank waits for the others before the group goes, and leaves without
# the interpreter's teardown: gloo's transport threads can abort a process
# that exits while a peer still drains its sockets.
_POST = r"""
dist.barrier()
dist.destroy_process_group()
print("RANK_OK", flush=True)
import os
os._exit(0)
"""


def run_ranks(body: str, tmp_path, world: int = 4, timeout: int = 300):
    """Run ``body`` on ``world`` gloo ranks, one process each (``rank``,
    ``world`` and ``out``, a directory for results, are defined) and fail
    unless every rank ends cleanly."""
    store = tmp_path / "store"
    out = tmp_path / "out"
    out.mkdir()
    code = _PRE + body + _POST
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(world), str(store),
         str(out)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and "RANK_OK" in log, f"rank {r}:\n{log}"
    return out


def test_placements_distribute_and_gather(tmp_path):
    """Each rank holds the reference's block of a spec (the first axis of a
    split dim outermost), and ``full_tensor`` gives the tensor back."""
    run_ranks(r"""
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import make_host_mesh
mesh = make_host_mesh(model_parallel=2, device="cpu")
assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (2, 2)
x = torch.randn(8, 12, 6, generator=torch.Generator().manual_seed(0))
for spec in [(), ("data",), (None, "model"), ("data", None, "model"),
             (("data", "model"),), (None, ("data", "model"))]:
    d = sharding.place(x, sharding.NamedSharding(mesh, spec))
    assert tuple(d.placements) == sharding.placements(spec, mesh), spec
    assert torch.equal(d.full_tensor(), x), spec
    want = x
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else entry
        idx, n = 0, 1
        for a in axes:
            k = mesh.size(mesh.mesh_dim_names.index(a))
            idx, n = idx * k + mesh.get_local_rank(a), n * k
        want = want.chunk(n, dim=i)[idx]
    assert torch.equal(d.to_local(), want), spec
""", tmp_path)


def test_compressed_psum_over_four_ranks(tmp_path):
    """Every rank gets the int32 sum of the ranks' int8 values times the
    largest scale, bit for bit, in the leaf's dtype."""
    run_ranks(r"""
from repro_torch.distributed.compression import (compressed_psum,
                                                 quantize_int8)
def grads(r):
    g = np.random.default_rng(r).standard_normal((2, 64)) * (r + 1)
    return {"w": torch.from_numpy(g.astype(np.float32)),
            "b": [torch.from_numpy(g[0, :5].astype(np.float32)).to(
                torch.bfloat16)]}
got = compressed_psum(grads(rank))
for path in (("w",), ("b", 0)):
    leaf = lambda t: t[path[0]] if len(path) == 1 else t[path[0]][path[1]]
    qs = [quantize_int8(leaf(grads(r))) for r in range(world)]
    qsum = sum(q.to(torch.int32) for q, _ in qs)
    smax = max(float(s) for _, s in qs)
    want = (qsum.float() * torch.tensor(smax)).to(leaf(got).dtype)
    assert leaf(got).dtype == leaf(grads(rank)).dtype
    assert torch.equal(leaf(got), want), path
""", tmp_path)


def test_gpipe_matches_sequential(tmp_path):
    """L=8, B=8, D=16, 4 microbatches over 4 stages: every rank's output
    equals the port's sequential loop and the JAX package's, at 1e-5."""
    L, B, D = 8, 8, 16
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((L, D, D)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((L, D)) * 0.1).astype(np.float32)
    x = rng.standard_normal((B, D)).astype(np.float32)
    np.savez(tmp_path / "inputs.npz", w=w, b=b, x=x)
    out = run_ranks(rf"""
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.distributed.pipeline import pipeline_forward
inp = np.load({str(tmp_path / "inputs.npz")!r})
params = {{"w": torch.from_numpy(inp["w"]), "b": torch.from_numpy(inp["b"])}}
x = torch.from_numpy(inp["x"])
layer_fn = lambda p, h: torch.tanh(h @ p["w"] + p["b"])
ref = x
for i in range({L}):
    ref = layer_fn({{"w": params["w"][i], "b": params["b"][i]}}, ref)
mesh = init_device_mesh("cpu", ({4},), mesh_dim_names=("stage",))
got = pipeline_forward(layer_fn, params, x, mesh=mesh, stage_axis="stage",
                       n_microbatches=4)
np.save(f"{{out}}/pipe{{rank}}.npy", got.numpy())
np.save(f"{{out}}/seq{{rank}}.npy", ref.numpy())
""", tmp_path)
    want = jnp.asarray(x)
    for i in range(L):
        want = jnp.tanh(want @ jnp.asarray(w[i]) + jnp.asarray(b[i]))
    for r in range(4):
        np.testing.assert_allclose(np.load(out / f"pipe{r}.npy"),
                                   np.load(out / f"seq{r}.npy"),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np.load(out / f"pipe{r}.npy"),
                                   np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["tp", "fsdp"])
def test_sharded_train_step_matches_plain(mode, tmp_path):
    """One SMOKE train step of qwen3-0.6b with its state distributed by
    ``param_specs`` on a (2, 2) ("data", "model") mesh and its batch by
    ``input_specs_tree`` (activations held to the batch axes by
    ``maybe_shard_activations``) against the unsharded step: the loss at
    rtol = atol = 1e-5, each gradient leaf at rtol 1e-5 and atol 1e-5 x the
    leaf's largest |grad|, and the updated parameters at rtol = atol = 1e-5
    against the unsharded AdamW update of those gradients.  (AdamW's first
    step moves an entry by lr·g/(|g| + eps): a gradient within rounding of
    zero, 5e-9 in this run, moves by up to 2e-5 when its rounding changes,
    so the update is held on the sharded run's own gradients, as the card
    check holds the card's.)"""
    run_ranks(rf"""
import dataclasses
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs.registry import get_config
from repro_torch.core.tree import leaves_with_path, path_str, tree_map
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import make_batch_fn
from repro_torch.models import transformer as T
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update)
from repro_torch.training.step import make_train_step
mode = {mode!r}
mesh = make_host_mesh(model_parallel=2, device="cpu")
cfg = dataclasses.replace(
    get_config("qwen3-0.6b", smoke=True),
    act_batch_axes=("data", "model") if mode == "fsdp" else ("data",))
opt = AdamWConfig(lr=1e-3, warmup_steps=1)
params = T.init_params(cfg, torch.Generator().manual_seed(0))
batch = make_batch_fn(cfg, 4, 16, "cpu")(0)
grads = {{}}
def keep(name):
    return lambda g: grads.setdefault(name, g)
_, _, want_m = make_train_step(cfg, opt, compress_grads=keep("plain"))(
    params, adamw_init(params, opt), batch)

pspec = sharding.param_specs(params, mesh, mode=mode)
assert any(s for _, s in leaves_with_path(pspec, is_leaf=sharding.is_spec))
state = adamw_init(params, opt)
d_params = sharding.distribute(params, pspec, mesh)
d_state = sharding.distribute(state, sharding.opt_specs(state, pspec), mesh)
d_batch = sharding.distribute(
    batch, sharding.input_specs_tree(batch, mesh, mode=mode), mesh)
with implicit_replication():
    got_p, _, got_m = make_train_step(cfg, opt, compress_grads=keep("sharded"))(
        d_params, d_state, d_batch)
loss = got_m["loss"].full_tensor()
assert torch.allclose(loss, want_m["loss"], rtol=1e-5, atol=1e-5), \
    (float(loss), float(want_m["loss"]))
flat = lambda tree: {{path_str(p): t for p, t in leaves_with_path(tree)}}
g_sharded = tree_map(lambda t: t.full_tensor(), grads["sharded"])
g_plain = flat(grads["plain"])
for path, g in flat(g_sharded).items():
    w = g_plain[path]
    assert torch.allclose(g, w, rtol=1e-5, atol=1e-5 * float(w.abs().max())), \
        (path, float((g - w).abs().max()))
want = flat(adamw_update(params, g_sharded, adamw_init(params, opt), opt)[0])
for path, t in flat(got_p).items():
    full = t.full_tensor()
    assert torch.allclose(full, want[path], rtol=1e-5, atol=1e-5), \
        (path, float((full - want[path]).abs().max()))
""", tmp_path)


@pytest.mark.parametrize("mode", ["tp", "fsdp"])
def test_sharded_step_compresses_its_reduced_gradients(mode, tmp_path):
    """The error-feedback compressor as the ``compress_grads`` of a sharded
    SMOKE train step of qwen3-0.6b (state placed by ``param_specs`` on a
    (2, 2) mesh): its output, gathered, equals the compressor's on the
    gathered gradients bit for bit; its residual equals theirs within 1e-6
    of the leaf's largest |gradient| (DTensor keeps a replicated leaf's
    residual as a pending sum, which rounds in another order); and
    ``compressed_psum`` refuses the DTensor gradients, which stand for the
    global gradient."""
    run_ranks(rf"""
import dataclasses
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs.registry import get_config
from repro_torch.core.tree import leaves, tree_map
from repro_torch.distributed import sharding
from repro_torch.distributed.compression import (
    compressed_psum, make_error_feedback_compressor)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import make_batch_fn
from repro_torch.models import transformer as T
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.step import make_train_step
mode = {mode!r}
mesh = make_host_mesh(model_parallel=2, device="cpu")
cfg = dataclasses.replace(
    get_config("qwen3-0.6b", smoke=True),
    act_batch_axes=("data", "model") if mode == "fsdp" else ("data",))
opt = AdamWConfig(lr=1e-3, warmup_steps=1)
params = T.init_params(cfg, torch.Generator().manual_seed(0))
pspec = sharding.param_specs(params, mesh, mode=mode)
state = adamw_init(params, opt)
d_params = sharding.distribute(params, pspec, mesh)
d_state = sharding.distribute(state, sharding.opt_specs(state, pspec), mesh)
batch = make_batch_fn(cfg, 4, 16, "cpu")(0)
d_batch = sharding.distribute(
    batch, sharding.input_specs_tree(batch, mesh, mode=mode), mesh)
compress, init = make_error_feedback_compressor()
whole = lambda tree: tree_map(lambda t: t.full_tensor(), tree)
def hook(g):
    try:
        compressed_psum(g)
        raise AssertionError("compressed_psum took DTensor gradients")
    except TypeError:
        pass
    out, res = compress(g, init(g))
    full = whole(g)
    want, want_res = compress(full, init(full))
    for a, b in zip(leaves(whole(out)), leaves(want), strict=True):
        assert torch.equal(a, b)
    for a, b, w in zip(leaves(whole(res)), leaves(want_res), leaves(full),
                       strict=True):
        assert torch.allclose(a, b, rtol=0, atol=1e-6 * float(w.abs().max()))
    return out
with implicit_replication():
    _, _, m = make_train_step(cfg, opt, compress_grads=hook)(
        d_params, d_state, d_batch)
assert torch.isfinite(m["loss"].full_tensor())
""", tmp_path)


def test_data_parallel_step_with_compressed_psum(tmp_path):
    """The reference's data-parallel use of ``compressed_psum``: each of 4
    ranks runs the plain SMOKE train step on its quarter of the batch, with
    the error-feedback compressor and then ``compressed_psum`` over the
    group as ``compress_grads``.  The gradients the step applies are the
    int32 sum of every rank's int8 values times the largest scale, bit for
    bit, and every rank ends with the same parameters."""
    run_ranks(r"""
from repro_torch.configs.registry import get_config
from repro_torch.core.tree import leaves
from repro_torch.distributed.compression import (
    compressed_psum, make_error_feedback_compressor, quantize_int8)
from repro_torch.launch.train import make_batch_fn
from repro_torch.models import transformer as T
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.step import make_train_step
cfg = get_config("qwen3-0.6b", smoke=True)
opt = AdamWConfig(lr=1e-3, warmup_steps=1)
params = T.init_params(cfg, torch.Generator().manual_seed(0))
batch = {k: v[2 * rank:2 * rank + 2]
         for k, v in make_batch_fn(cfg, 8, 16, "cpu")(0).items()}
compress, init = make_error_feedback_compressor()
seen = {}
def hook(g):
    mine, _ = compress(g, init(g))
    seen["mine"], seen["sum"] = mine, compressed_psum(mine)
    return seen["sum"]
new, _, _ = make_train_step(cfg, opt, compress_grads=hook)(
    params, adamw_init(params, opt), batch)
def gathered(t):
    parts = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(parts, t.contiguous())
    return parts
for mine, got in zip(leaves(seen["mine"]), leaves(seen["sum"]), strict=True):
    qs = [quantize_int8(p) for p in gathered(mine)]
    qsum = sum(q.to(torch.int32) for q, _ in qs)
    smax = max(float(s) for _, s in qs)
    assert torch.equal(got, (qsum.float() * torch.tensor(smax)).to(got.dtype))
for t in leaves(new):
    assert all(torch.equal(p, t) for p in gathered(t))
""", tmp_path)
