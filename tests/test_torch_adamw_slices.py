"""AdamW a slice of leading rows at a time (``optimizer.SLICE_BYTES``): the
new parameters and moments bit-equal to the whole-leaf update for leaves of
one to four dims whose leading dim the slice does not divide, in fp32 and
bf16, the inputs left as they were; the sliced update against the JAX
package's AdamW; and the sliced update of DTensor leaves on two gloo ranks
(a stack split on a later dim with a gradient pending a sum, replicated,
split on the rows) against the plain update of the whole tensors."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import optimizer as jax_opt
from repro_torch.core.tree import leaves, leaves_with_path, path_str
from repro_torch.models.convert import params_from_numpy
from repro_torch.training import optimizer
from repro_torch.training.optimizer import AdamWConfig

SRC = Path(__file__).resolve().parents[1] / "src"
SHAPES = {"vec": (7,), "mat": (11, 5), "cube": (9, 3, 4),
          "stack": (13, 2, 3, 5), "scalar": ()}


def _tree(rng, scale=1.0, dtype=torch.float32):
    return {k: (scale * torch.from_numpy(rng.standard_normal(s).astype(
        np.float32))).to(dtype) for k, s in SHAPES.items()}


def _state(rng, params, mdt):
    return {"m": {k: (0.1 * torch.from_numpy(rng.standard_normal(
                 tuple(p.shape)).astype(np.float32))).to(mdt)
                  for k, p in params.items()},
            "v": {k: (0.01 * torch.from_numpy(rng.standard_normal(
                 tuple(p.shape)).astype(np.float32)) ** 2).to(mdt)
                  for k, p in params.items()},
            "step": torch.tensor(2, dtype=torch.int32)}


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


@pytest.mark.parametrize("slice_bytes", [24, 60, 100])
@pytest.mark.parametrize("pdt,mdt", [("float32", "float32"),
                                     ("float32", "bfloat16"),
                                     ("bfloat16", "bfloat16")])
def test_sliced_update_is_bit_equal(monkeypatch, slice_bytes, pdt, mdt):
    """With slices of a row or a few (a leaf's leading dim not a multiple
    of them), every new parameter, m and v equal to the whole-leaf update
    bit for bit, the gradient norm too, and the inputs unchanged."""
    rng = np.random.default_rng(slice_bytes)
    params = _tree(rng, dtype=getattr(torch, pdt))
    grads = _tree(rng, 40.0, getattr(torch, pdt))
    state = _state(rng, params, getattr(torch, mdt))
    cfg = AdamWConfig(lr=1e-2, warmup_steps=4, moment_dtype=mdt)
    before = _clone({"p": params, "g": grads, "s": state})
    want = optimizer.adamw_update(params, grads, state, cfg)
    rows = {k: optimizer._rows_per_slice(p) for k, p in params.items()}
    assert rows["scalar"] == 1
    monkeypatch.setattr(optimizer, "SLICE_BYTES", slice_bytes)
    sliced = {k: r for k, p in params.items() if p.dim()
              for r in [optimizer._rows_per_slice(p)] if r < p.shape[0]}
    assert len(sliced) >= 3 and any(
        params[k].shape[0] % r for k, r in sliced.items()), sliced
    got = optimizer.adamw_update(params, grads, state, cfg)
    assert torch.equal(got[2], want[2])
    assert torch.equal(got[1]["step"], want[1]["step"])
    for g_tree, w_tree in ((got[0], want[0]), (got[1]["m"], want[1]["m"]),
                           (got[1]["v"], want[1]["v"])):
        for (path, g), w in zip(leaves_with_path(g_tree), leaves(w_tree)):
            assert g.dtype == w.dtype and g.shape == w.shape, path_str(path)
            assert torch.equal(g, w), path_str(path)
    for (path, a), b in zip(leaves_with_path({"p": params, "g": grads,
                                              "s": state}), leaves(before)):
        assert torch.equal(a, b), path_str(path)


def test_sliced_update_matches_jax(monkeypatch):
    """The sliced update against the JAX package's AdamW at the whole-leaf
    test's tolerance (bf16 moments, clipping active)."""
    rng = np.random.default_rng(5)
    tree = lambda: {k: rng.standard_normal(s).astype(np.float32)
                    for k, s in SHAPES.items() if s}
    params, grads = tree(), {k: 40.0 * g for k, g in tree().items()}
    cfg = jax_opt.AdamWConfig(lr=1e-2, warmup_steps=4,
                              moment_dtype="bfloat16")
    jstate = jax_opt.adamw_init(jax.tree.map(jnp.asarray, params), cfg)
    jstate = {"m": jax.tree.map(lambda m, g: (0.1 * g).astype(m.dtype),
                                jstate["m"], grads),
              "v": jax.tree.map(lambda v, g: (0.01 * g * g).astype(v.dtype),
                                jstate["v"], grads),
              "step": jnp.int32(2)}
    want_p, want_s, want_n = jax_opt.adamw_update(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, grads),
        jstate, cfg)
    assert float(want_n) > cfg.grad_clip
    monkeypatch.setattr(optimizer, "SLICE_BYTES", 24)
    got_p, got_s, got_n = optimizer.adamw_update(
        params_from_numpy(params, device="cpu"),
        params_from_numpy(grads, device="cpu"),
        params_from_numpy(jax.tree.map(np.asarray, jstate), device="cpu"),
        AdamWConfig(**dataclasses.asdict(cfg)))
    np.testing.assert_allclose(float(got_n), float(want_n), rtol=1e-6)
    for got, want in ((got_p, want_p), (got_s["m"], want_s["m"]),
                      (got_s["v"], want_s["v"])):
        for k, leaf in got.items():
            np.testing.assert_allclose(
                leaf.float().numpy(), np.asarray(want[k], np.float32),
                rtol=1e-6, atol=1e-6, err_msg=k)


_DTENSOR_BODY = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from repro_torch.training import optimizer
from repro_torch.training.optimizer import AdamWConfig
rank, store = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                        world_size=2)
mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("model",))
rng = np.random.default_rng(0)
new = lambda s, k=1.0: torch.from_numpy(
    (k * rng.standard_normal(s)).astype(np.float32))
shapes = {"later": (7, 4, 6), "whole": (5, 3), "rows": (8, 3),
          "flat": (9, 8)}
place = {"later": [Shard(1)], "whole": [Replicate()], "rows": [Shard(0)],
         "flat": [Replicate()]}
params = {k: new(s) for k, s in shapes.items()}
grads = {k: new(s, 40.0) for k, s in shapes.items()}
m = {k: new(s, 0.1) for k, s in shapes.items()}
v = {k: new(s, 0.1) ** 2 for k, s in shapes.items()}
state = {"m": m, "v": v, "step": torch.tensor(2, dtype=torch.int32)}
cfg = AdamWConfig(lr=1e-2, warmup_steps=4)
want = optimizer.adamw_update(params, grads, state, cfg)
d = lambda t, k: distribute_tensor(t, mesh, place[k])
dgrads = {k: d(g, k) for k, g in grads.items()}
# The "later" gradient pending a sum: each rank holds half of it.
dgrads["later"] = DTensor.from_local(grads["later"] / 2, mesh, [Partial()],
                                     run_check=False)
dstate = {"m": {k: d(t, k) for k, t in m.items()},
          "v": {k: d(t, k) for k, t in v.items()},
          "step": distribute_tensor(state["step"], mesh, [Replicate()])}
optimizer.SLICE_BYTES = 4 * 4 * 6 * 2           # two rows of "later"
assert optimizer._rows_per_slice(params["later"]) == 2
assert optimizer._rows_per_slice(dstate["m"]["later"]) == 1
assert optimizer._rows_per_slice(dstate["m"]["rows"]) == 8
assert optimizer._rows_per_slice(params["flat"]) == 6
assert optimizer._rows_per_slice(dstate["m"]["flat"]) == 9
got = optimizer.adamw_update({k: d(p, k) for k, p in params.items()},
                             dgrads, dstate, cfg)
for g_tree, w_tree in ((got[0], want[0]), (got[1]["m"], want[1]["m"]),
                       (got[1]["v"], want[1]["v"])):
    for k in shapes:
        full = g_tree[k].full_tensor()
        assert full.shape == w_tree[k].shape, k
        torch.testing.assert_close(full, w_tree[k], rtol=1e-6, atol=1e-7)
dist.barrier()
dist.destroy_process_group()
print("RANK_OK", flush=True)
import os
os._exit(0)
"""


def test_sliced_update_of_dtensors(tmp_path):
    """On two gloo ranks, DTensor leaves updated a layer at a time (a
    stacked leaf split on a later dim, its gradient pending a sum) or whole
    (a leaf split on its rows, two-dim leaves) give the plain update of the
    whole tensors."""
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _DTENSOR_BODY, str(r),
         str(tmp_path / "store")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and "RANK_OK" in log, f"rank {r}:\n{log}"
