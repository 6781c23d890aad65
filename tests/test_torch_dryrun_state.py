"""The train step's new state placed as its specs in the dry run (ROADMAP
C.20), and the trace's count of a storage that a view holds (C.21), on
``test_torch_dryrun_peak.py``'s fake (2, 2) ("data", "model") mesh.

- Every runnable SMOKE train cell: the new parameters, m and v that
  ``adamw_update`` returns are placed exactly as ``sharding.param_specs``
  and ``opt_specs`` place the old ones (the reference's ``out_shardings``),
  so that the dry run moves none of them after the step
  (``memory.outputs_placed`` empty); the new state holds the donated
  bytes, and the footprint at least the old state and the new one.
- Toy steps: an update whose gradient is split where its parameter is
  whole gathers the gradient (once, its bytes) and returns whole leaves;
  a step that returns a leaf split where its argument is whole has it
  placed as the argument, the move counted by the trace and listed.
- The trace: a storage stays counted while a view that keeps no reference
  to its base holds it (one made below autograd's view tracking, and the
  ``detach`` through which autograd saves a DTensor output).
- Plain tensors: ``adamw_update`` gives the parent's bits."""
import logging

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs.registry import ARCH_IDS, get_config, runnable
from repro_torch.core.tree import leaves, leaves_with_path, path_str
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun
from repro_torch.roofline import analysis
from repro_torch.training import optimizer
from repro_torch.training.step import abstract_train_state
from test_torch_dryrun_peak import TRAIN, _dt, mesh  # noqa: F401 (a fixture)

ARCHS = [a for a in ARCH_IDS if runnable(a, "train_4k")[0]]
_CELLS: dict = {}


def _cell(device_mesh, arch: str) -> tuple:
    """The SMOKE train cell of ``arch``, run once a module → (its record,
    the old and new state ``adamw_update`` saw and returned, the state's
    placements by ``param_specs`` / ``opt_specs``)."""
    if arch in _CELLS:
        return _CELLS[arch]
    seen = {}
    real = optimizer.adamw_update

    def update(params, grads, state, opt):
        out = real(params, grads, state, opt)
        seen.update(old=(params, state), new=out[:2])
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("repro_torch.training.step.adamw_update", update)
        entry = dryrun.lower_cell(arch, TRAIN, False, mesh=device_mesh,
                                  smoke=True)
    params, opt_state = abstract_train_state(get_config(arch, smoke=True),
                                             dryrun._opt_for(arch))
    pspec = sharding.param_specs(params, device_mesh)
    specs = (pspec, sharding.opt_specs(opt_state, pspec))
    want = [sharding.placements(s, device_mesh)
            for s in leaves(list(specs), is_leaf=sharding.is_spec)]
    _CELLS[arch] = entry, seen, want
    return _CELLS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_new_state_placed_as_its_specs(mesh, arch):  # noqa: F811
    """(a) Every new parameter, m and v (and the step) comes out of the
    update placed as its spec, as the old one is; the dry run moves no
    leaf of the outputs that replace the state."""
    entry, seen, want = _cell(mesh, arch)
    assert entry["status"] == "ok"
    old, new = (list(leaves_with_path(list(seen[k]))) for k in ("old",
                                                                "new"))
    assert [p for p, _ in old] == [p for p, _ in new]
    assert [tuple(t.placements) for _, t in old] == want
    wrong = [(path_str(p), t.placements, w) for (p, t), w in zip(new, want)
             if tuple(t.placements) != w]
    assert not wrong, wrong[:6]
    assert entry["memory"]["outputs_placed"] == []


def _local_bytes(tree) -> int:
    return sum(t.to_local().numel() * t.element_size() for t in leaves(tree))


@pytest.mark.parametrize("arch", ARCHS)
def test_footprint_holds_the_old_state_and_the_new(mesh, arch):  # noqa: F811
    """(b) The new state's shards hold the donated bytes (the old state's,
    as its specs place it), and the footprint is at least the arguments
    and the new state."""
    entry, seen, _ = _cell(mesh, arch)
    mem = entry["memory"]
    assert _local_bytes(list(seen["new"])) == mem["donated_bytes"]
    assert mem["footprint_bytes"] >= \
        mem["argument_bytes"] + mem["donated_bytes"]


# ------------------------------------------------------------ toy steps
def _whole(device_mesh, shape=(8, 6)):
    """A meta DTensor of ``shape``, whole on every mesh dim."""
    return sharding.place(torch.empty(shape, device="meta"),
                          sharding.NamedSharding(device_mesh, ()))


def _replacing_bytes(trace) -> int:
    """The bytes of the allocations the replacing outputs hold."""
    return sum(n for h, n in trace.log if h in trace.replacing and n > 0)


def test_update_gathers_a_split_gradient_once(mesh):  # noqa: F811
    """(c) AdamW of a (8, 6) fp32 leaf whole on the mesh whose gradient is
    split over "data": the trace counts one all-gather of the gradient (192
    B), the scalar all-reduce of its norm and nothing else; the new leaf,
    m and v are whole (192 B each, the step 4 B), none moved after the
    step, and the footprint holds both states."""
    params, grads = {"w": _whole(mesh)}, {"w": _dt(mesh, (8, 6))}
    state = {"m": {"w": _whole(mesh)}, "v": {"w": _whole(mesh)},
             "step": sharding.place(torch.empty((), dtype=torch.int32,
                                                device="meta"),
                                    sharding.NamedSharding(mesh, ()))}
    cfg = optimizer.AdamWConfig()
    trace, replicated, _, mem = dryrun.traced_memory(
        lambda p, s, g: optimizer.adamw_update(p, g, s, cfg)[:2],
        [params, state, grads], {0: 0, 1: 1})
    assert replicated == {}
    assert trace.stats.bytes_by_kind == {"all-gather": 192, "all-reduce": 4}
    assert trace.stats.count_by_kind == {"all-gather": 1, "all-reduce": 1}
    assert mem["outputs_placed"] == []
    assert mem["donated_bytes"] == 3 * 192 + 4
    assert _replacing_bytes(trace) == mem["donated_bytes"]
    assert mem["footprint_bytes"] >= \
        mem["argument_bytes"] + mem["donated_bytes"]


def test_misplaced_output_is_placed_as_its_argument(mesh):  # noqa: F811
    """(c) A step that returns its (8, 6) argument, whole on the mesh,
    less a term split over "data", returns a leaf split as the term: the
    dry run places it whole, as its argument, inside the trace, which
    counts the all-gather (192 B) and the whole leaf; the record names the
    leaf, both placements and the bytes moved."""
    p, g = _whole(mesh), _dt(mesh, (8, 6))
    trace, _, _, mem = dryrun.traced_memory(lambda a, b: (a - b,), [p, g],
                                            {0: 0})
    assert trace.stats.bytes_by_kind == {"all-gather": 192}
    assert mem["outputs_placed"] == [
        ["0", str((Shard(0), Replicate())), str((Replicate(), Replicate())),
         192]]
    assert _replacing_bytes(trace) == 192


# ------------------------------------------------------------ the trace
def test_view_below_autograd_keeps_its_storage_counted():
    """A view made below autograd's view tracking keeps no reference to
    its base: with the base gone, the storage it holds stays counted until
    the view goes (it was counted as freed under the view)."""
    trace = analysis.ShardedTrace()
    with trace:
        t = torch.empty(16, device="meta")
        with torch._C._AutoDispatchBelowADInplaceOrView():
            v = t.view(4, 4)
        assert v._base is None
        del t
        assert trace.live_bytes == 64
        del v
    assert trace.live_bytes == 0
    assert trace.peak_live_bytes == 64


def test_saved_output_stays_counted_until_the_backward(mesh):  # noqa: F811
    """Autograd saves ``exp``'s output for its backward through a
    ``detach`` of the DTensor, a view below it: with the output's tensor
    gone, its shard (96 B) stays counted until the backward has run and
    the graph is freed."""
    from torch.distributed.tensor.experimental import implicit_replication
    x = _dt(mesh, (8, 6)).requires_grad_()
    trace = analysis.ShardedTrace()
    with implicit_replication(), trace:
        y = torch.exp(x)
        loss = y.sum()
        del y
        assert trace.live_bytes == 96 + 4
        g, = torch.autograd.grad(loss, x)
        del loss
    assert trace.live_bytes == 96          # the gradient's shard
    del g
    assert trace.live_bytes == 0


# ------------------------------------------------------- the plain route
def test_plain_update_keeps_the_parents_bits(monkeypatch):
    """(d) Plain tensors: leaves of one to four dims, a few updated a
    slice of rows at a time, fp32 and bf16 moments: every new parameter,
    m and v is the parent's update bit for bit (written out: one fp32
    pass over each leaf), and ``_gathered`` is the gradient itself."""
    rng = np.random.default_rng(30)
    new = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    shapes = {"vec": (7,), "mat": (11, 5), "cube": (9, 3, 4),
              "stack": (5, 2, 3, 4)}
    monkeypatch.setattr(optimizer, "SLICE_BYTES", 100)
    for mdt in (torch.float32, torch.bfloat16):
        cfg = optimizer.AdamWConfig(lr=1e-2, warmup_steps=4,
                                    moment_dtype=str(mdt)[6:])
        params = {k: new(*s) for k, s in shapes.items()}
        grads = {k: 1e-3 * new(*s) for k, s in shapes.items()}
        state = {"m": {k: (0.1 * new(*s)).to(mdt)
                       for k, s in shapes.items()},
                 "v": {k: (0.01 * new(*s) ** 2).to(mdt)
                       for k, s in shapes.items()},
                 "step": torch.tensor(1, dtype=torch.int32)}
        for k in shapes:
            assert optimizer._gathered(grads[k], params[k]) is grads[k]
        got_p, got_s, gnorm = optimizer.adamw_update(params, grads, state,
                                                     cfg)
        step = state["step"] + 1
        want_norm = torch.sqrt(sum(torch.sum(g.float() ** 2)
                                   for g in leaves(grads)))
        assert torch.equal(gnorm, want_norm)
        clip = torch.clamp(cfg.grad_clip / (want_norm + 1e-9), max=1.0)
        lr = cfg.lr * torch.clamp(step.float() / cfg.warmup_steps, max=1.0)
        bc1 = 1 - torch.pow(cfg.b1, step.float())
        bc2 = 1 - torch.pow(cfg.b2, step.float())
        for k, p in params.items():
            g32 = grads[k].float() * clip
            m32 = cfg.b1 * state["m"][k].float() + (1 - cfg.b1) * g32
            v32 = cfg.b2 * state["v"][k].float() + (1 - cfg.b2) * g32 * g32
            upd = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
            if p.dim() >= 2:
                upd = upd + cfg.weight_decay * p.float()
            assert torch.equal(got_p[k], (p.float() - lr * upd).to(p.dtype))
            assert torch.equal(got_s["m"][k], m32.to(mdt))
            assert torch.equal(got_s["v"][k], v32.to(mdt))
        assert torch.equal(got_s["step"], step)
