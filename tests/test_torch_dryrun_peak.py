"""The dry run's peak on the reference's terms (ROADMAP C.16), DeepSeek-V3's
expert gradients kept split (C.17) and the positions one row of the batch
(C.12), on a fake (2, 2) ("data", "model") mesh.

- A toy step that donates an argument: ``peak_reference_terms`` is the
  footprint less the donated argument's bytes and the bytes of the fresh
  output that replaces it, to the byte (a fresh output, a view of one, and
  the argument written in place and returned).
- SMOKE train cells: the reference's terms never above the footprint, the
  train state donated, and the record's largest holders within the peak.
- deepseek-v3's SMOKE train cell (4 experts over a model axis of 2): no
  collective result and no tensor of the step holds ``we_down``'s whole
  expert dim, and its gradient keeps ``Shard`` on that dim.
- The rotary angles and whisper's sinusoids held at batch 1 in SMOKE train
  cells; ``train_loss`` and its gradients bit-equal to positions expanded
  to the whole batch."""
import dataclasses
import logging

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.registry import ShapeSpec, get_config
from repro_torch.core.tree import leaves, leaves_with_path, path_str
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import init_fake_process_group
from repro_torch.models import transformer as T
from repro_torch.roofline import analysis
from repro_torch.roofline.analysis import _KINDS
from repro_torch.training import optimizer

B, SEQ = 4, 64
TRAIN = ShapeSpec("train_smoke", SEQ, B, "train")


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


def _dt(mesh, shape):
    """A meta DTensor of ``shape``, its first dim split over "data"."""
    return sharding.place(torch.empty(shape, device="meta"),
                          sharding.NamedSharding(mesh, ("data",)))


def _fresh(x, y):
    t = x * 2
    return (t + y,)


def _view_of_fresh(x, y):
    t = x * 2
    return ((t + y).t(),)


def _in_place(x, y):
    t = y * 2
    return (x.add_(t),)


# step → (its fresh local allocations' high-water mark, the bytes of the
# fresh output that replaces the donated argument), for (8, 6) fp32
# arguments split over "data": a local shard is (4, 6), 96 B.
TOY = {"fresh": (_fresh, 192, 96), "view": (_view_of_fresh, 192, 96),
       "in_place": (_in_place, 96, 0)}


@pytest.mark.parametrize("case", sorted(TOY))
def test_toy_step_accounting_is_exact(mesh, case):
    """x donated, y kept: the reference's terms leave out x and the fresh
    output that replaces it, and nothing else, to the byte."""
    step, peak_live, out_bytes = TOY[case]
    x, y = _dt(mesh, (8, 6)), _dt(mesh, (8, 6))
    x_bytes = 4 * 6 * 4
    _, replicated, _, mem = dryrun.traced_memory(step, [x, y], {0: 0})
    assert replicated == {}
    assert mem["argument_bytes"] == 2 * x_bytes
    assert mem["donated_bytes"] == x_bytes
    assert mem["peak_live_bytes"] == peak_live
    assert mem["footprint_bytes"] == 2 * x_bytes + peak_live
    assert mem["peak_reference_terms"] == \
        mem["footprint_bytes"] - x_bytes - out_bytes
    # What is live at that peak: the step's temporary, never its output.
    assert mem["peak_holders"] == [["mul", [4, 6], "float32", 96, 1]]


def test_trace_replays_its_own_peak(mesh):
    """The allocation log replays ``peak_live_bytes`` with nothing left
    out, and a collective's wrapper counts no bytes of its own."""
    from torch.distributed.tensor import Replicate
    x = _dt(mesh, (8, 6))
    trace, _, _ = dryrun._sharded_run(
        lambda a: (a.redistribute(mesh, [Replicate(), Replicate()]) * 2,),
        [x], {0: 0})
    assert trace.peak_without(set()) == trace.peak_live_bytes
    # The gathered (8, 6) and the product: 192 + 192, the wrapper nothing.
    assert trace.peak_live_bytes == 384
    assert trace.stats.bytes_by_kind == {"all-gather": 192}
    assert len(trace.replacing) == 1


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2-moe-a2.7b",
                                  "deepseek-v3-671b", "mamba2-1.3b",
                                  "whisper-large-v3"])
def test_smoke_train_cell_on_the_reference_terms(mesh, arch):
    """The reference's terms never above the footprint; the train state
    (parameters and optimizer state) is what is donated, the batch is not;
    the largest holders at the peak fit in it."""
    entry = dryrun.lower_cell(arch, TRAIN, False, mesh=mesh, smoke=True)
    mem, rf = entry["memory"], entry["roofline"]
    assert entry["status"] == "ok"
    assert rf["peak_memory_per_device"] == mem["peak_reference_terms"]
    assert 0 < mem["peak_reference_terms"] <= mem["footprint_bytes"]
    assert 0 < mem["donated_bytes"] < mem["argument_bytes"]
    holders = mem["peak_holders"]
    assert holders and sum(n * k for *_, n, k in holders) <= \
        mem["peak_reference_terms"] - (mem["argument_bytes"]
                                       - mem["donated_bytes"])


class _Seen(TorchDispatchMode):
    """Each DTensor op's outputs (shape, placements), seen from the top of
    the mode stack."""

    def __init__(self):
        super().__init__()
        self.outputs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        out = func(*args, **(kwargs or {}))
        self.outputs += [(func._overloadpacket.__name__, tuple(o.shape),
                          tuple(o.placements)) for o in leaves([out])
                         if isinstance(o, DTensor)]
        return out


def test_deepseek_we_down_gradient_keeps_the_expert_split(mesh, monkeypatch):
    """deepseek-v3's SMOKE train cell, 4 experts split over the model axis:
    the parent all-reduced ``we_down``'s gradient whole over the experts.
    No collective result and no DTensor of the step of ``we_down``'s
    (experts, ff, d) shape holds the whole expert dim where the model
    axis could split it, and every expert leaf's gradient keeps ``Shard``
    on its expert dim over the model axis."""
    from torch.distributed.tensor import Shard
    cfg = get_config("deepseek-v3-671b", smoke=True)
    tail = (cfg.moe.n_experts, cfg.moe.expert_d_ff, cfg.d_model)
    results, seen, grads = [], _Seen(), []

    class Trace(analysis.ShardedTrace):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is not NotImplemented and func._overloadpacket.__name__ \
                    in _KINDS and func.namespace.endswith("c10d_functional"):
                results.extend(tuple(o.shape) for o in leaves([out])
                               if not isinstance(o, FakeTensor))
            return out

    real_run, real_update = dryrun._sharded_run, optimizer.adamw_update

    def sharded_run(step, args, replaced=()):
        def seen_step(*a):
            with seen:                  # on top of the trace's modes
                return step(*a)
        return real_run(seen_step, args, replaced)

    def update(params, g, state, opt):
        grads.append(g)
        return real_update(params, g, state, opt)

    monkeypatch.setattr(dryrun.roofline, "ShardedTrace", Trace)
    monkeypatch.setattr(dryrun, "_sharded_run", sharded_run)
    monkeypatch.setattr("repro_torch.training.step.adamw_update", update)
    entry = dryrun.lower_cell("deepseek-v3-671b", TRAIN, False, mesh=mesh,
                              smoke=True)
    assert entry["status"] == "ok"
    assert results and not [s for s in results if s[-3:] == tail]
    whole = [(op, shape, pl) for op, shape, pl in seen.outputs
             if shape[-3:] == tail and Shard(len(shape) - 3) != pl[1]]
    assert not whole, whole[:5]
    moe = {path_str(p): g for p, g in leaves_with_path(grads[-1])
           if "moe/we_" in path_str(p)}
    assert sorted(moe) == ["layers/moe/we_down", "layers/moe/we_gate",
                           "layers/moe/we_up"]
    for path, g in moe.items():
        assert g.placements[1] == Shard(1), (path, g.placements)
    assert not [h for h in entry["memory"]["peak_holders"]
                if tuple(h[1][-3:]) == tail]


@pytest.mark.parametrize("arch,ops", [("qwen3-0.6b", ("cos", "sin")),
                                      ("deepseek-v3-671b", ("cos", "sin")),
                                      ("whisper-large-v3", ("cos", "sin"))])
def test_positions_are_one_row_of_the_batch(mesh, monkeypatch, arch, ops):
    """The rotary angles (the MTP's too) and whisper's encoder and decoder
    sinusoids are made at batch 1 in a SMOKE train cell: no device holds
    them whole over the batch (4 rows; 2 a device on this mesh)."""
    made = []

    class Trace(analysis.ShardedTrace):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is not NotImplemented and \
                    func._overloadpacket.__name__ in ops and \
                    not isinstance(out, FakeTensor):
                made.append(tuple(out.shape))
            return out

    monkeypatch.setattr(dryrun.roofline, "ShardedTrace", Trace)
    entry = dryrun.lower_cell(arch, TRAIN, False, mesh=mesh, smoke=True)
    assert entry["status"] == "ok"
    assert made and all(s[0] == 1 for s in made if len(s) == 3), made


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (B, SEQ + 1)))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.encoder_seq, cfg.encoder_dim)).astype(np.float32))
    return batch


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v3-671b",
                                  "recurrentgemma-9b", "whisper-large-v3"])
def test_positions_at_batch_one_change_no_bit(monkeypatch, arch):
    """``train_loss`` and every gradient with the positions one row equal,
    bit for bit, to those with the positions expanded to the whole batch
    (the angles and sinusoids computed per row, as before)."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), remat=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    batch = _batch(cfg)

    def loss_and_grads():
        flat = [p.detach().requires_grad_() for p in leaves(params)]
        from repro_torch.core.tree import unflatten
        loss = T.train_loss(unflatten(params, flat), cfg, batch)
        return loss, torch.autograd.grad(loss, flat, allow_unused=True)

    loss, grads = loss_and_grads()
    rows = lambda f: (lambda pos, *a: f(pos.expand(B, pos.shape[-1]), *a))
    monkeypatch.setattr(T, "rope_angles", rows(T.rope_angles))
    monkeypatch.setattr(T, "sinusoidal_embedding",
                        rows(T.sinusoidal_embedding))
    want, want_grads = loss_and_grads()
    assert torch.equal(loss, want)
    for g, w in zip(grads, want_grads):
        assert (g is None and w is None) or torch.equal(g, w)
