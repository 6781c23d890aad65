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
   runs again on inputs replicated over as few mesh dims as it needs (the
   record counts those ops, ``replicated_calls``, and the bytes they
   gathered, ``replicated_bytes``), an in-place cache write runs on the
   local shards, and any other op fails the cell.  A torch whose DTensor
   has no rule for ``aten.flip`` gets the dry run's (``_flip_strategy``),
   and every torch gets the dry run's view rule (``_view_strategy``: a
   head split its own rule refuses, or places as ``_StridedShard``, moves
   onto the batch, split further, instead of running replicated).

The batch stays split over every data axis, as the inputs place it (pod
and data on the 2 x 16 x 16 mesh).  Two places dropped that split, and
the dry run repairs each where it happens, not in the specs or the
models: a gather the torch refuses (2.11's DTensor has no rule for the
embedding's token ids split over two mesh dims on one dim) ran again on
ids gathered over data, and came back whole over data, so every
activation after it was too; ``_split_again`` splits a rerun op's output
again where its inputs were split (a slice of each device's copy, no
bytes moved), and the op still counts in ``replicated_calls``.  The
gradient of the loss's mean, a scalar that DTensor expands replicated,
met the split batch one mesh dim at a time and held half the batch's
logits' gradient on each device; ``_DTensorGaps`` places that expand as
the mean's input was.  The view rule takes no ``_StridedShard``, so that
2.11 and 2.13 trace the same placements, and because every such
placement sends 2.13's redistribution costs to its graph planner (a
two-pod cell took 950 s; now 30-90 s).

The serving cells keep the reference's placements.  A prefill writes into
a cache made before the trace as DTensors placed by
``sharding.cache_specs_tree`` (``_placed_cache``), as the reference's
``out_shardings`` place it, and passed to the step: made inside the step,
a global-size tensor was whole on every device.  A decode reads the
KV-WAL arena where it lies: a read through the table runs on each
device's rows (``_index_local``), an in-place append on each device's
shards (``_write_local``), and where the arena splits the KV heads the
attention runs on each device's sequences and heads
(``sharding.attend_on_shards``).  On 2.11 an ``add`` of a product pending
a sum and a term split on the same mesh dim, which DTensor refuses, has
the sum scattered onto the term's dim, as 2.13 places it
(``_meet_pending_sum``: the RG-LRU's gate biases).

Memory a device, ``memory`` in the record (``traced_memory``): the local
shard bytes of the step's arguments (``argument_bytes``) and the
high-water mark of the bytes the sharded run allocates and has not freed
(``peak_live_bytes``: activations saved for the backward included, a
storage counted once whatever tensors hold it, with Python's cycle
collector off so that it does not hang on the collector's timing,
``_drop_frames``).  Their sum is the footprint (``footprint_bytes``): what
a device holds when nothing is donated, the old state beside the new one.
The reference reports XLA's argument + temp - alias, and donates the
train state and a decode's cache (``donate_argnums``); a prefill's cache
is its step's output there, which that sum leaves out.  The peak on the
reference's terms (``peak_reference_terms``, the roofline's
``peak_memory_per_device``) leaves out what those donations alias
(``DONATED``): the donated arguments (``donated_bytes``; a prefill's cache,
``cache_bytes``, is one) and the trace's allocations that the outputs
replacing them hold when the step returns, found by their storage;
``peak_holders`` names the largest allocations live at it.

Each (arch × shape × mesh) cell is recorded, skipped ones (``runnable``)
with their reason and failed ones as ``FAIL: <reason>``.  The output
defaults to ``experiments/dryrun_torch.json`` so that it never overwrites
the reference's artifact.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
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
from repro_torch.models import serve
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


def _prefill_max_seq(shape: ShapeSpec) -> int:
    return shape.seq_len + 256


# The reference donates the train state and a decode's cache
# (``donate_argnums``), and a prefill's cache is its step's output: its
# peak counts none of them.  Kind → {argument index: index of the output
# that replaces it}; a prefill's cache is the last argument, written in
# place and returned.
DONATED = {"train": {0: 0, 1: 1}, "prefill": {-1: 1}, "decode": {1: 1}}


def _step_and_args(cfg, shape: ShapeSpec, opt, params, opt_state, specs,
                   cache=None):
    """(step, positional args) of the cell's step; a prefill's ``cache``,
    where given, is its last argument (the step makes its own without)."""
    if shape.kind == "train":
        return make_train_step(cfg, opt), [params, opt_state, specs]
    if shape.kind == "prefill":
        return make_prefill_step(cfg, max_seq=_prefill_max_seq(shape)), \
            [params, specs] + ([cache] if cache is not None else [])
    args = [params, specs["cache"], specs["tokens"]]
    if "mrope_positions" in specs:
        args.append(specs["mrope_positions"])
    return make_decode_step(cfg), args


# Ops DTensor may fail to shard (which of them, differs between torch
# versions), rerun on inputs replicated over as few mesh dims as DTensor
# needs to shard them: a view or reshape that splits or
# merges a sharded dim (a head dim over the model axis), and an index
# whose index tensor is sharded twice on one dim (the embedding's gather
# and its backward).  Any other op DTensor cannot shard fails the cell.
REPLICABLE = frozenset({"view", "_unsafe_view", "index", "index_put"})
# In-place cache writes run on each device's shards (``_write_local``).
LOCAL_WRITES = frozenset({"copy_", "index_put_"})


class _DTensorGaps(TorchDispatchMode):
    """Where DTensor cannot shard an op of the step (forward or backward):
    an op named in ``REPLICABLE`` runs again with its inputs replicated over
    the innermost mesh dims, one more at a time until DTensor shards it
    (on every mesh dim: each device computes the whole op, its outputs
    replicated).  The gathers that costs are counted; ``replicated``
    counts the ops by name, ``replicated_bytes`` the bytes a device holds
    of the inputs they gathered.  A write named in
    ``LOCAL_WRITES`` (the KV-WAL's appends and prefill writes, a recurrent
    state or cross K/V into its cache slot) runs on the local shards, an
    ``index_put_`` there first; a read through the KV-WAL's table runs on
    each device's rows (``_index_local``); an ``add`` DTensor refuses has
    its pending sums met (``_meet_pending_sum``).  Any other op that
    DTensor refuses fails.  A scalar broadcast back to the shape of a
    whole-tensor reduction (the backward of the loss's mean) is placed as
    that reduction's input was (``_reduced``).  Entered after
    ``ShardedTrace``, so that it sees each op first and the trace sees
    what DTensor then runs."""

    def __init__(self):
        super().__init__()
        self.replicated: dict = {}
        self.replicated_bytes: dict = {}
        # shape -> placements of the last DTensor reduced to a scalar
        self._reduced: dict = {}

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
        if name == "index_put_" and isinstance(args[0], DTensor):
            # 2.11's DTensor writes a copy of the whole destination (a
            # KV-WAL layer's arena) on every device; 2.13 refuses.
            try:
                return _write_local(func, args, kwargs)
            except NotImplementedError as err:
                _drop_frames(err)
        if func is torch.ops.aten.index.Tensor and _row_gather(*args):
            # DTensor would move the source off its batch split to index it.
            return _index_local(*args)
        try:
            out = func(*args, **kwargs)
        except (RuntimeError, ValueError, NotImplementedError,
                AssertionError) as err:
            _drop_frames(err)
            # 2.11 meets a pending sum and a split term by moving the term
            # to a pending sum, which it cannot run (the RG-LRU's biases).
            met = _meet_pending_sum(args) if name == "add" else None
            if met is not None:
                return func(*met, **kwargs)
            if not any(issubclass(t, DTensor) for t in types) or \
                    name not in REPLICABLE | LOCAL_WRITES:
                raise
        else:
            return self._reduced_split(name, args, out)
        if name in LOCAL_WRITES:
            return _write_local(func, args, kwargs)
        flat = given = leaves([list(args), kwargs])
        mesh = next(t.device_mesh for t in flat if isinstance(t, DTensor))
        self.replicated[name] = self.replicated.get(name, 0) + 1
        # Replicate the innermost mesh dims first (the model axis, which
        # splits heads), one more at a time, and let DTensor run the op
        # again; only on every mesh dim replicated does each device compute
        # the whole op itself.
        for n in range(1, mesh.ndim + 1):
            keep = mesh.ndim - n
            moved = [t.redistribute(mesh, tuple(t.placements[:keep])
                                    + (Replicate(),) * n)
                     if isinstance(t, DTensor) and not all(
                         p.is_replicate() for p in t.placements[keep:])
                     else t for t in flat]
            self.replicated_bytes[name] = \
                self.replicated_bytes.get(name, 0) + sum(
                    m.to_local().numel() * m.element_size()
                    for t, m in zip(flat, moved) if m is not t)
            a, kw = unflatten([list(args), kwargs], moved)
            if keep == 0:
                break
            try:
                return _split_again(func(*a, **kw), given)
            except (RuntimeError, ValueError, NotImplementedError,
                    AssertionError) as err:
                _drop_frames(err)
                flat = moved
        whole = [Replicate()] * mesh.ndim
        a, kw = unflatten([list(args), kwargs], [
            t.to_local().contiguous() if isinstance(t, DTensor) else t
            for t in leaves([a, kw])])
        out = func(*a, **kw)          # every device computes the whole op
        return _split_again(unflatten(out, [
            DTensor.from_local(o, mesh, whole, run_check=False)
            if isinstance(o, torch.Tensor) else o for o in leaves(out)]),
            given)

    def _reduced_split(self, name, args, out):
        """``out`` of a reduction to a scalar, recorded; ``out`` of a
        scalar replicated on every mesh dim expanded to a recorded shape,
        placed as that shape's reduced input was.  DTensor places such an
        expand replicated, and the first op that meets the split batch
        then slices each device's copy one mesh dim at a time: the first
        slice holds half the batch (mamba2-1.3b x train_4k x 2 x 16 x 16:
        the loss's gradient over the whole vocabulary, (128, 4096, 50280)
        in fp32)."""
        from torch.distributed.tensor import DTensor
        if name in ("mean", "sum") and isinstance(args[0], DTensor) and \
                isinstance(out, DTensor) and out.dim() == 0:
            self._reduced[tuple(args[0].shape)] = tuple(args[0].placements)
        elif name == "expand" and isinstance(args[0], DTensor) and \
                args[0].numel() == 1 and \
                all(p.is_replicate() for p in args[0].placements):
            want = self._reduced.get(tuple(out.shape))
            if want is not None and not any(p.is_partial() for p in want):
                return out.redistribute(out.device_mesh, want)
        return out


def _drop_frames(err: BaseException) -> None:
    """Clear the finished frames of ``err``'s traceback and of the
    exceptions it chains.  A refused op's exception holds DTensor's
    dispatch frames, and with them the op's local tensors; where it sits
    in a reference cycle (an exception kept in a local of a frame on its
    own traceback), those tensors lived on until Python's cycle collector
    ran, and the trace's peak moved with the collector's timing
    (whisper-large-v3 x train_4k x 2 x 16 x 16: 3.5e10 to 5.5e10 B a
    device; 2.7e12 with the collector off)."""
    seen = set()
    while err is not None and id(err) not in seen:
        seen.add(id(err))
        traceback.clear_frames(err.__traceback__)
        err = err.__cause__ or err.__context__


def _split_again(out, given):
    """The outputs of an op ``_DTensorGaps`` ran on replicated inputs, each
    split again on every mesh dim where it came back replicated but one of
    ``given`` (the op's inputs as they came) split a dim of the same index
    and size, placed as the output is on every outer mesh dim: the batch
    that a gather or a view keeps (the embedding's gather, whose token ids
    are split over pod and data, comes back whole over data on 2.11).
    Replicate to Shard is a slice of each device's copy: no bytes move."""
    from torch.distributed.tensor import DTensor, Shard

    def split(o):
        if not isinstance(o, DTensor):
            return o
        want = list(o.placements)
        for j, p in enumerate(want):
            if not p.is_replicate():
                continue
            for t in given:
                if not isinstance(t, DTensor) or \
                        t.device_mesh != o.device_mesh:
                    continue
                q = t.placements[j]
                if type(q) is Shard and q.dim < o.dim() and \
                        t.shape[q.dim] == o.shape[q.dim] and \
                        tuple(t.placements[:j]) == tuple(want[:j]):
                    want[j] = q
                    break
        if want == list(o.placements):
            return o
        return o.redistribute(o.device_mesh, want)

    return unflatten(out, [split(o) for o in leaves(out)])


def _write_local(func, args, kwargs):
    """``copy_(dst, src)`` or ``index_put_(dst, indices, values)`` on each
    device's shards: every operand is split as ``dst`` is along the dims it
    writes, and the write runs on the local tensors.  A plain ``dst`` (a
    tensor the step made itself; no serving cache since the dry run places
    the prefill's) is replicated: it takes whole operands.
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


def _meet_pending_sum(args):
    """``args`` with each pending sum (``Partial``) on a mesh dim where
    another operand is split completed there: reduced and scattered along
    that operand's dim (aligned from the right, as a broadcast aligns
    them) → the new args, or None where no operand has such a sum.  The
    RG-LRU's gate bias added to its product (``models/griffin.py::
    _rg_lru``): on 2.11 the product comes out pending a sum over the model
    axis, the bias is split over it, and DTensor asks a ``Shard`` →
    ``Partial`` move of the bias that it then refuses; 2.13 reduce-scatters
    the product onto the bias's dim, and so does this."""
    from torch.distributed.tensor import DTensor, Shard
    terms = [a for a in args if isinstance(a, DTensor)]
    out, moved = [], False
    for a in args:
        want = list(a.placements) if isinstance(a, DTensor) else []
        for i, p in enumerate(want):
            for t in terms:
                q = t.placements[i]
                d = q.dim - t.dim() + a.dim() if type(q) is Shard else -1
                if p.is_partial() and t is not a and 0 <= d < a.dim() and \
                        a.shape[d] == t.shape[q.dim]:
                    want[i] = Shard(d)
                    break
        if want != list(getattr(a, "placements", [])):
            a, moved = a.redistribute(a.device_mesh, want), True
        out.append(a)
    return out if moved else None


def _row_gather(src, indices) -> bool:
    """Whether ``src[indices]`` is a read through a per-row table: ``src``
    a DTensor split on its first dim, the first index a plain tensor of
    one entry a row of it (``arange(B)[:, None]``: the KV-WAL's batch rows)
    and every index of the same rank, running along the rows (the table,
    ``(B, n_blocks)``).  The dry run's shards are meta tensors, so the
    rows' values cannot be read: like ``_write_local``, this takes the
    first index to be the rows in their order."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(src, DTensor) or not indices or \
            src.to_local().device.type != "meta" or \
            not any(type(p) is Shard and p.dim == 0 for p in src.placements):
        return False
    rows = indices[0]
    if rows is None or isinstance(rows, DTensor) or \
            rows.shape[0] != src.shape[0] or rows.numel() != src.shape[0]:
        return False
    return all(i is not None and i.dim() == rows.dim() and
               i.shape[0] == src.shape[0] and
               not (i.dtype.is_floating_point or i.dtype == torch.bool) and
               (not isinstance(i, DTensor) or
                all(p.is_replicate() for p in i.placements))
               for i in indices)


def _index_local(src, indices):
    """``src[indices]`` of a ``_row_gather`` on each device's rows: the
    indices split as ``src``'s first dim is (a slice of each device's
    copy), ``src``'s other indexed dims whole, its later dims kept as they
    are split; the output split likewise (its first dim the rows', its
    last the source's unindexed dims).  The KV-WAL's decode reads (the
    plain ``tide_attention``'s and ``kvwal.gather``'s), where DTensor
    would move the arena's split from the batch onto an unindexed dim
    and then gather the whole arena to view its blocks as positions."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh, k = src.device_mesh, len(indices)
    lead = torch.broadcast_shapes(*(i.shape for i in indices))
    src_want, idx_want, out_pl = [], [], []
    for p in src.placements:
        if type(p) is Shard and p.dim == 0:
            src_want.append(p)
            idx_want.append(Shard(0))
            out_pl.append(Shard(0))
        elif type(p) is Shard and p.dim >= k:
            src_want.append(p)
            idx_want.append(Replicate())
            out_pl.append(Shard(p.dim - k + len(lead)))
        else:                        # an indexed dim split, or a pending sum
            src_want.append(Replicate())
            idx_want.append(Replicate())
            out_pl.append(Replicate())
    local_src = src.redistribute(mesh, src_want).to_local()
    local_idx = [
        (i if isinstance(i, DTensor) else DTensor.from_local(
            i, mesh, [Replicate()] * mesh.ndim, run_check=False)
         ).redistribute(mesh, idx_want).to_local() for i in indices]
    out = torch.ops.aten.index.Tensor(local_src, local_idx)
    shape = torch.Size(tuple(lead) + tuple(src.shape[k:]))
    return DTensor.from_local(out, mesh, out_pl, run_check=False,
                              shape=shape,
                              stride=sharding.contiguous_strides(shape))


def _flip_strategy(op_schema):
    """DTensor strategy for ``aten.flip``, for a torch whose propagator has
    none (the backward of ``torch.cumsum`` flips: the plain SSD's scans).
    Each input placement is kept, but a ``Shard`` of a flipped dim, which
    is replicated first: a flip moves rows between shards."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._op_schema import OpSpec, OpStrategy
    from torch.distributed.tensor._ops.utils import (
        generate_redistribute_costs, normalize_dim)
    inp = op_schema.args_schema[0]
    dims = {normalize_dim(d, inp.ndim) for d in op_schema.args_schema[1]}
    out = OpStrategy([])
    for strategy in inp.strategies:
        spec = strategy.output_spec
        want = tuple(Replicate() if isinstance(p, Shard) and p.dim in dims
                     else p for p in spec.placements)
        src = DTensorSpec(spec.mesh, want, tensor_meta=spec.tensor_meta)
        out.strategies.append(OpSpec(
            output_specs=DTensorSpec(spec.mesh, want),
            input_specs=(src,),
            redistribute_cost=[generate_redistribute_costs(inp, src)]))
    return out


def _ensure_flip_rule() -> bool:
    """Register ``_flip_strategy`` if the running torch's DTensor has no
    rule for ``aten.flip`` (2.13 has one; 2.11 has none) → whether it
    registered it."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo
    prop = DTensor._op_dispatcher.sharding_propagator
    flip = torch.ops.aten.flip.default
    if any(flip in getattr(prop, table, {}) for table in (
            "op_strategy_funcs", "op_single_dim_strategy_funcs",
            "op_to_rules")):
        return False
    prop.register_op_strategy(flip, _flip_strategy, RuntimeSchemaInfo(1))
    return True


# The running torch's own strategies for the views, kept when the dry run
# registers ``_view_strategy`` over them.
_NATIVE_VIEW: dict = {}


def _native_view(op):
    """The running torch's DTensor strategy function for ``op``."""
    if op not in _NATIVE_VIEW:
        from torch.distributed.tensor import DTensor
        prop = DTensor._op_dispatcher.sharding_propagator
        _NATIVE_VIEW[op] = prop.op_strategy_funcs[op]
    return _NATIVE_VIEW[op]


def _strided(strategy) -> bool:
    """Whether an ``OpStrategy`` places any output as ``_StridedShard``."""
    from torch.distributed.tensor.placement_types import _StridedShard
    return any(isinstance(p, _StridedShard) for choice in strategy.strategies
               for p in choice.output_spec.placements)


def _view_strategy(op_schema):
    """DTensor strategy for ``aten.view`` / ``_unsafe_view``, where the
    running torch's rule refuses a split or flatten of a dim sharded over
    a mesh dim, or places it as ``_StridedShard``.  Refused: 8 KV heads
    packed in a dim split over a 16-wide model axis, viewed as heads x
    head_dim (2.11 and 2.13 alike).  Strided: a flatten of (batch, heads)
    with the heads split, which 2.11 refuses and 2.13 places as
    ``_StridedShard``; the dry run takes that as refused too, so that its
    placements are the same on both torches, and because any
    ``_StridedShard`` sends 2.13's redistribution costs to its graph
    planner, a graph search in Python for each candidate strategy of each
    op (950 s for qwen3-0.6b x train_4k x 2 x 16 x 16 on 2.13).  Each such mesh dim, innermost first, moves
    its shard to a dim that every outer mesh dim already splits and that
    it divides further: the batch split over the whole mesh, as 2.13's
    rules place the attention (an all-to-all, where running the view
    replicated gathers the dim); the first such dim for which the torch's
    own rule then places the view with no ``_StridedShard``, whose output
    for the moved input it takes.  Where no move is accepted, the refusal
    stands, and ``_DTensorGaps`` runs the view replicated: a batch too
    small to split further (256 rows over 2 x 16 x 16 devices), or one an
    outer mesh dim leaves whole (on 2.11 mamba2-1.3b x train_4k x 2 x 16
    x 16's batch placed ``(S(0), R, S(0))`` met a residual ``(S(0), S(0),
    P)`` in an add, which asked an ``S(0)`` to ``P(sum)`` redistribution
    2.11 cannot run)."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._op_schema import (OpSchema, OpSpec,
                                                     OpStrategy)
    from torch.distributed.tensor._ops.utils import \
        generate_redistribute_costs
    native = _native_view(op_schema.op)
    # The refusal is kept as its message: an exception held in a local of
    # a frame on its own traceback is a cycle that keeps every caller's
    # tensors alive until the cycle collector runs (``_drop_frames``).
    try:
        placed = native(op_schema)
        if not _strided(placed):
            return placed
        refused = f"{op_schema.op}: the dry run places no _StridedShard"
    except (RuntimeError, AssertionError) as e:
        refused = f"{op_schema.op}: {e}"
    inp = op_schema.args_schema[0]
    rest = op_schema.args_schema[1:]

    def rule(spec):
        """The torch's own strategy for ``spec`` alone, or None (refused,
        or placed as ``_StridedShard``)."""
        try:
            got = native(OpSchema(op_schema.op,
                                  (OpStrategy([OpSpec(spec)]),) + rest,
                                  op_schema.kwargs_schema))
        except (RuntimeError, AssertionError):
            return None
        return None if _strided(got) else got

    out = OpStrategy([])
    for strategy in inp.strategies:
        spec = strategy.output_spec
        mesh, shape = spec.mesh, spec.shape

        def spec_of(placements):
            return DTensorSpec(mesh, tuple(placements),
                               tensor_meta=spec.tensor_meta)

        moved, got = list(spec.placements), None
        for i in reversed(range(mesh.ndim)):
            p = moved[i]
            if type(p) is not Shard:
                continue
            fits = [d for d in range(len(shape)) if i and d != p.dim
                    and all(type(q) is Shard and q.dim == d
                            for q in moved[:i])
                    and shape[d] % math.prod(mesh.shape[:i + 1]) == 0]
            trials = [moved[:i] + [Shard(d)] + moved[i + 1:] for d in fits]
            got = next((r for r in map(rule, map(spec_of, trials))
                        if r is not None), None)
            if got is not None:
                break
            if fits:
                moved = trials[0]
        if got is None:
            raise RuntimeError(refused)
        for choice in got.strategies:
            choice.redistribute_cost = [
                generate_redistribute_costs(inp, choice.input_specs[0])]
            out.strategies.append(choice)
    return out


_VIEW_OPS = ("view", "_unsafe_view")


def _ensure_view_rule() -> bool:
    """Register ``_view_strategy`` for ``aten.view`` and ``_unsafe_view``
    over the running torch's own rule (on every torch: it changes only
    what that rule refuses or places as ``_StridedShard``) → whether it
    registered it now."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo
    prop = DTensor._op_dispatcher.sharding_propagator
    ops = [getattr(torch.ops.aten, name).default for name in _VIEW_OPS]
    if prop.op_strategy_funcs.get(ops[0]) is _view_strategy:
        return False
    for op in ops:
        _native_view(op)
        prop.register_op_strategy(op, _view_strategy, RuntimeSchemaInfo(1))
    return True


def _sharded_run(step, args, replaced=()):
    """Run ``step`` on DTensor arguments under ``ShardedTrace``; plain
    tensors the step makes itself count as replicated → (the trace, the
    ops run again on replicated inputs by name: their count, and the bytes
    a device holds of the inputs they gathered).  The trace's ``replacing``
    names the allocations that the step's outputs numbered in ``replaced``
    hold when it returns."""
    from torch.distributed.tensor.experimental import implicit_replication
    _ensure_flip_rule()
    _ensure_view_rule()
    trace, gaps = roofline.ShardedTrace(), _DTensorGaps()
    # The peak counts a tensor until its last reference goes: with the
    # cycle collector off, a tensor held in a reference cycle counts until
    # the run ends, the same on every run, where the collector's timing
    # would free it at some step or other (``_drop_frames``).
    collecting = gc.isenabled()
    gc.disable()
    try:
        with implicit_replication(), trace, gaps:
            out = step(*args)
        trace.replacing = trace.handles_of(leaves([out[i] for i in replaced]))
        del out
    finally:
        if collecting:
            gc.enable()
    return trace, gaps.replicated, gaps.replicated_bytes


def _local_bytes(tree) -> int:
    """The bytes of the local shards of the DTensors in ``tree``."""
    return sum(t.to_local().numel() * t.element_size() for t in leaves(tree))


def traced_memory(step, args, donated: dict) -> tuple:
    """``step`` run on its DTensor ``args`` under the trace
    (``_sharded_run``) → (the trace, the ops run replicated: their counts
    and bytes, the memory record).  ``donated`` maps an argument's index to
    the index of the output that replaces it (``DONATED``).  The record:
    the local bytes of the arguments (``argument_bytes``) and of the
    donated ones (``donated_bytes``), the trace's high-water mark
    (``peak_live_bytes``), ``footprint_bytes`` (the two sums: what a device
    holds with nothing donated), and ``peak_reference_terms``: the
    reference's argument + temp - alias, the arguments but the donated ones
    plus the high-water mark of the trace's allocations but those the
    replacing outputs hold (under donation they share the donated
    buffers), with ``peak_holders``, the largest allocations live at it."""
    arg_bytes = _local_bytes(args)
    donated_bytes = _local_bytes([args[i] for i in donated])
    trace, replicated, replicated_bytes = _sharded_run(
        step, args, tuple(donated.values()))
    kept = trace.replacing
    return trace, replicated, replicated_bytes, {
        "argument_bytes": arg_bytes, "donated_bytes": donated_bytes,
        "peak_live_bytes": trace.peak_live_bytes,
        "footprint_bytes": arg_bytes + trace.peak_live_bytes,
        "peak_reference_terms": arg_bytes - donated_bytes
        + trace.peak_without(kept),
        "peak_holders": trace.holders_at_peak(kept)}


def _placed_cache(cfg, batch: int, max_seq: int, mesh) -> dict:
    """The serving cache of ``serve.cache_spec(cfg, batch, max_seq)`` as
    DTensors placed by ``sharding.cache_specs_tree``, their local shards
    meta tensors; the table a placeholder (the prefill writes through the
    identity table, and reads none)."""
    cache = {k: torch.empty(shape, dtype=dt, device="meta") for k, (shape, dt)
             in serve.cache_spec(cfg, batch, max_seq).items()}
    return sharding.distribute(cache, sharding.cache_specs_tree(cache, mesh),
                               mesh)


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
    # A prefill's cache, placed as the reference's out_shardings place it,
    # made here: a global-size tensor made inside the trace is counted whole.
    d_cache = _placed_cache(cfg, specs["tokens"].shape[0],
                            _prefill_max_seq(shape), mesh) \
        if shape.kind == "prefill" else None
    _, d_args = _step_and_args(cfg, shape, opt, d_params, d_opt, d_inputs,
                               d_cache)
    trace, replicated, replicated_bytes, memory = traced_memory(
        step, d_args, DONATED[shape.kind])
    memory["cache_bytes"] = _local_bytes(d_cache or {})
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
        peak_memory_per_device=float(memory["peak_reference_terms"]),
        model_flops=mf,
        collectives={"bytes": coll.bytes_by_kind,
                     "count": coll.count_by_kind})
    return {
        "arch": arch, "shape": shape.name, "mesh": mesh_name,
        "status": "ok", "sharding_mode": sharding_mode,
        "cost_s": round(t_cost, 1), "trace_s": round(t_trace, 1),
        "memory": memory,
        "replicated_calls": replicated,
        "replicated_bytes": replicated_bytes,
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
                          f"GiB footprint/dev="
                          f"{entry['memory']['footprint_bytes']/2**30:.2f}"
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
