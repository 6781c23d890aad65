"""Multi-pod dry run: every architecture's train, prefill and decode step,
sharded over the production meshes, with its roofline — the JAX package's
``launch/dryrun.py`` on ``torch.distributed``.

    python -m repro_torch.launch.dryrun [--arch A] [--shape S]
        [--mesh single|multi|both] [--sharding-mode tp|fsdp]
        [--override key=value] [--out experiments/dryrun_torch.json]

The reference lowers each cell on 512 placeholder XLA devices.  Here one
process makes the live process group a fake one of 256 or 512 ranks
(``mesh.init_fake_process_group``: its collectives move nothing) and builds
the production ``DeviceMesh`` over it.  Each cell then:

1. builds its inputs (``input_specs``) and train state
   (``abstract_train_state``) as meta tensors, and its specs by
   ``param_specs`` / ``input_specs_tree`` in ``tp`` or ``fsdp`` mode;
2. counts the step's global FLOPs and bytes under ``op_cost`` (fake
   tensors, nothing allocated) and divides them by the chip count, as the
   reference divides ``jaxpr_cost``'s;
3. places the state and inputs on the mesh as DTensors whose local shards
   are meta tensors (rank 0's side; DTensor's sharding propagation
   materializes small index tensors, which ``FakeTensorMode`` would fake,
   so this trace runs on the meta device instead) and runs the step under
   ``ShardedTrace``, which reads the collectives DTensor issues (count and
   result bytes by kind) and the local bytes that ops allocate.  Where
   DTensor cannot shard an op, a view or an index named in ``REPLICABLE``
   runs again on replicated inputs (the record counts those ops:
   ``replicated_calls``), an in-place cache write runs on the local
   shards, and any other op fails the cell.

Peak memory per device is the local shard bytes of the step's arguments
plus the high-water mark of the bytes allocated and not yet freed during
the sharded run (activations saved for the backward included).  It stands
in for the reference's ``memory_analysis`` (arguments + temporaries −
aliases); the sharded run does not donate its arguments, so an updated
state counts beside the old one.

Each (arch × shape × mesh) cell is recorded, skipped ones (``runnable``)
with their reason and failed ones as ``FAIL: <reason>``.  The output
defaults to ``experiments/dryrun_torch.json`` so that it never overwrites
the reference's artifact.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import math
import os
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.registry import (ARCH_IDS, SHAPES, ShapeSpec,
                                          get_config, input_specs, runnable)
from repro_torch.core.tree import leaves, unflatten
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import (init_fake_process_group,
                                     make_production_mesh, production_shape)
from repro_torch.roofline import analysis as roofline
from repro_torch.roofline.op_cost import op_cost
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.step import (abstract_train_state,
                                       make_decode_step, make_prefill_step,
                                       make_train_step)

# Memory-constrained giants drop to bf16 optimizer moments.
_BF16_MOMENTS = {"deepseek-v3-671b", "qwen2-vl-72b"}


def chips_of(multi_pod: bool) -> int:
    return 512 if multi_pod else 256


def _opt_for(arch: str) -> AdamWConfig:
    return AdamWConfig(
        moment_dtype="bfloat16" if arch in _BF16_MOMENTS else "float32")


def _mesh_name(mesh) -> str:
    return "x".join(str(s) for s in mesh.shape)


def _step_and_args(cfg, shape: ShapeSpec, opt, params, opt_state, specs):
    """(step, positional args) of the cell's step."""
    if shape.kind == "train":
        return make_train_step(cfg, opt), [params, opt_state, specs]
    if shape.kind == "prefill":
        return make_prefill_step(cfg, max_seq=shape.seq_len + 256), \
            [params, specs]
    args = [params, specs["cache"], specs["tokens"]]
    if "mrope_positions" in specs:
        args.append(specs["mrope_positions"])
    return make_decode_step(cfg), args


# Ops DTensor may fail to shard (which of them, differs between torch
# versions), rerun on replicated inputs: a view or reshape that splits or
# merges a sharded dim (a head dim over the model axis), and an index
# whose index tensor is sharded twice on one dim (the embedding's gather
# and its backward).  Any other op DTensor cannot shard fails the cell.
REPLICABLE = frozenset({"view", "_unsafe_view", "index", "index_put"})
# In-place cache writes run on each device's shards (``_write_local``).
LOCAL_WRITES = frozenset({"copy_", "index_put_"})


class _DTensorGaps(TorchDispatchMode):
    """Where DTensor cannot shard an op of the step (forward or backward):
    an op named in ``REPLICABLE`` runs again on the whole inputs on every
    device, its outputs replicated (the gathers that costs are counted, and
    ``replicated`` counts the ops by name); a write named in
    ``LOCAL_WRITES`` (the KV-WAL's appends and prefill writes, a recurrent
    state or cross K/V into its cache slot) runs on the local shards.
    Any other op fails.  Entered after ``ShardedTrace``, so that it sees
    each op first and the trace sees what DTensor then runs."""

    def __init__(self):
        super().__init__()
        self.replicated: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor, Replicate
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        name = func._overloadpacket.__name__
        if name in LOCAL_WRITES and not isinstance(args[0], DTensor) and \
                any(issubclass(t, DTensor) for t in types):
            # DTensor would gather the operands and then refuse the write.
            return _write_local(func, args, kwargs)
        try:
            return func(*args, **kwargs)
        except (RuntimeError, ValueError, NotImplementedError,
                AssertionError):
            if not any(issubclass(t, DTensor) for t in types) or \
                    name not in REPLICABLE | LOCAL_WRITES:
                raise
        if name in LOCAL_WRITES:
            return _write_local(func, args, kwargs)
        flat = leaves([list(args), kwargs])
        mesh = next(t.device_mesh for t in flat if isinstance(t, DTensor))
        whole = [Replicate()] * mesh.ndim
        local = [t.redistribute(mesh, whole).to_local().contiguous()
                 if isinstance(t, DTensor) else t for t in flat]
        a, kw = unflatten([list(args), kwargs], local)
        self.replicated[name] = self.replicated.get(name, 0) + 1
        out = func(*a, **kw)          # every device computes the whole op
        return unflatten(out, [DTensor.from_local(o, mesh, whole,
                                                  run_check=False)
                               if isinstance(o, torch.Tensor) else o
                               for o in leaves(out)])


def _write_local(func, args, kwargs):
    """``copy_(dst, src)`` or ``index_put_(dst, indices, values)`` on each
    device's shards: every operand is split as ``dst`` is along the dims it
    writes, and the write runs on the local tensors.  A plain ``dst`` (a
    cache the step made itself) is replicated: it takes whole operands.
    ``dst`` may be split along an indexed dim only if it is its first and
    one index a row runs along it (the KV-WAL's batch rows); the dry run's
    shards are meta tensors, so no row index is translated to local rows,
    and a write of real data is refused."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    dst, rest = args[0], list(args[1:])
    if not isinstance(dst, DTensor):
        return func(*unflatten(args, [
            t.full_tensor() if isinstance(t, DTensor) else t
            for t in leaves(list(args))]), **kwargs)
    if dst.to_local().device.type != "meta":
        raise NotImplementedError(f"{func}: a local write of real data")
    mesh, n = dst.device_mesh, dst.dim()

    def split(t, dim_of):
        """``t`` split as ``dst`` along the dims ``dim_of`` maps (dst dim →
        t dim), replicated along the others → its local tensor."""
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        want = [Shard(dim_of[p.dim]) if isinstance(p, Shard)
                and dim_of.get(p.dim, -1) >= 0 else Replicate()
                for p in dst.placements]
        return t.redistribute(mesh, want).to_local()

    if func._overloadpacket.__name__ == "copy_":
        src = rest[0]                         # broadcasts from the right
        local = [split(src, {d: src.dim() - n + d for d in range(n)})]
    else:
        indices, values = rest[0], rest[1]
        k = len(indices)
        dim_of = {d: values.dim() - n + d for d in range(k, n)}
        rows = {}
        for p in dst.placements:
            if isinstance(p, Shard) and p.dim < k:
                i = indices[p.dim]
                if p.dim != 0 or i is None or i.dim() != 1 or \
                        values.dim() != 1 + n - k or \
                        i.shape[0] != dst.shape[0]:
                    raise NotImplementedError(
                        f"{func}: dim {p.dim} is sharded and indexed")
                dim_of[p.dim] = rows[p.dim] = 0
        local = [[None if i is None else split(i, rows) for i in indices],
                 split(values, dim_of)] + rest[2:]
    func(dst.to_local(), *local, **kwargs)
    return dst


def _sharded_run(step, args):
    """Run ``step`` on DTensor arguments under ``ShardedTrace``; plain
    tensors the step makes itself count as replicated → (the trace, the
    ops run again on replicated inputs)."""
    from torch.distributed.tensor.experimental import implicit_replication
    trace, gaps = roofline.ShardedTrace(), _DTensorGaps()
    with implicit_replication(), trace, gaps:
        out = step(*args)
    del out
    return trace, gaps.replicated


def lower_cell(arch: str, shape_name, multi_pod: bool,
               overrides: dict | None = None, sharding_mode: str = "tp", *,
               mesh=None, smoke: bool = False) -> dict:
    """Trace one (arch × shape × mesh) cell → its record.  ``shape_name``
    names one of ``SHAPES`` or is a ``ShapeSpec``; ``mesh`` (a
    ``DeviceMesh`` over a live group) replaces the production mesh, and
    ``smoke`` takes the SMOKE config: the tests' small cells."""
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    cfg = get_config(arch, smoke=smoke)
    if shape.kind != "train":
        # Serving uses bf16 weights.
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    if shape.kind == "prefill" or (shape.kind == "train"
                                   and shape.seq_len > 8192):
        cfg = dataclasses.replace(cfg, attn_chunk_q=1024)
    for k, v in (overrides or {}).items():
        if isinstance(v, list):
            v = tuple(v)
        cfg = dataclasses.replace(cfg, **{k: v})

    if mesh is None:
        init_fake_process_group(chips_of(multi_pod))
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    chips = math.prod(mesh.shape)
    specs = input_specs(cfg, shape)
    in_specs = sharding.input_specs_tree(specs, mesh, mode=sharding_mode)
    opt = _opt_for(arch)
    params_abs, opt_abs = abstract_train_state(cfg, opt)
    pspec = sharding.param_specs(params_abs, mesh, mode=sharding_mode)

    t0 = time.time()
    step, args = _step_and_args(cfg, shape, opt, params_abs, opt_abs, specs)
    cost = op_cost(step, *args)
    t_cost = time.time() - t0

    t0 = time.time()
    d_params = sharding.distribute(params_abs, pspec, mesh)
    d_inputs = sharding.distribute(specs, in_specs, mesh)
    d_opt = sharding.distribute(
        opt_abs, sharding.opt_specs(opt_abs, pspec), mesh) \
        if shape.kind == "train" else None
    _, d_args = _step_and_args(cfg, shape, opt, d_params, d_opt, d_inputs)
    arg_bytes = sum(t.to_local().numel() * t.element_size()
                    for t in leaves(d_args))
    trace, replicated = _sharded_run(step, d_args)
    t_trace = time.time() - t0
    coll = trace.stats

    n_tokens = shape.seq_len * shape.global_batch \
        if shape.kind != "decode" else shape.global_batch
    mf = roofline.model_flops(cfg, n_tokens, shape.kind)
    mesh_name = _mesh_name(mesh)
    rf = roofline.Roofline(
        arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
        flops_per_device=cost.flops / chips,
        bytes_per_device=cost.bytes / chips,
        collective_bytes=float(coll.total_bytes),
        peak_memory_per_device=float(arg_bytes + trace.peak_live_bytes),
        model_flops=mf,
        collectives={"bytes": coll.bytes_by_kind,
                     "count": coll.count_by_kind})
    return {
        "arch": arch, "shape": shape.name, "mesh": mesh_name,
        "status": "ok", "sharding_mode": sharding_mode,
        "cost_s": round(t_cost, 1), "trace_s": round(t_trace, 1),
        "memory": {"argument_bytes": arg_bytes,
                   "peak_live_bytes": trace.peak_live_bytes},
        "replicated_calls": replicated,
        "global_cost": {"flops": cost.flops, "bytes": cost.bytes},
        "roofline": rf.to_dict(),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description="Multi-pod dry run")
    ap.add_argument("--arch", default=None, choices=ARCH_IDS + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch.json")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg overrides as key=value (perf experiments)")
    ap.add_argument("--sharding-mode", default="tp", choices=["tp", "fsdp"])
    args = ap.parse_args()
    # DTensor warns on every multi-step redistribution; the counts say it.
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)

    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v

    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    def record(entry):
        results[:] = [r for r in results
                      if not (r["arch"] == entry["arch"]
                              and r["shape"] == entry["shape"]
                              and r["mesh"] == entry["mesh"])]
        results.append(entry)
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)

    for arch in archs:
        for shape_name in shapes:
            ok, reason = runnable(arch, shape_name)
            for multi in meshes:
                mesh_name = "x".join(map(str, production_shape(multi)[0]))
                tag = f"{arch} × {shape_name} × {mesh_name}"
                if not ok:
                    print(f"[dryrun] {tag}: {reason}")
                    record({"arch": arch, "shape": shape_name,
                            "mesh": mesh_name, "status": reason})
                    continue
                try:
                    t0 = time.time()
                    entry = lower_cell(arch, shape_name, multi, overrides,
                                       sharding_mode=args.sharding_mode)
                    rf = entry["roofline"]
                    print(f"[dryrun] {tag}: OK in {time.time()-t0:.0f}s — "
                          f"flops/dev={rf['flops_per_device']:.3e} "
                          f"coll={rf['collective_bytes']:.3e}B "
                          f"bottleneck={rf['bottleneck']} "
                          f"mem/dev={rf['peak_memory_per_device']/2**30:.2f}"
                          f"GiB")
                    record(entry)
                except Exception as e:
                    traceback.print_exc()
                    print(f"[dryrun] {tag}: FAIL {e}")
                    record({"arch": arch, "shape": shape_name,
                            "mesh": mesh_name, "status": f"FAIL: {e}"})
    n_ok = sum(1 for r in results if r.get("status") == "ok")
    print(f"[dryrun] {n_ok}/{len(results)} cells OK → {args.out}")


if __name__ == "__main__":
    main()
