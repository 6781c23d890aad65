"""Logical → physical sharding rules (DP / TP / EP / SP), the JAX package's
``distributed/sharding.py`` with DTensor placements in place of
``NamedSharding``.

Parameters are matched by leaf-path suffix; every rule validates
divisibility against the mesh and falls back to replication when a dim
does not divide (e.g. phi3-medium's 10 KV heads on a 16-way model axis:
we shard head_dim instead — "shard kv_heads if divisible, else head_dim,
else replicate").

A spec is a tuple with one entry per leading tensor dim, as the reference's
``PartitionSpec``: ``None`` (replicated), an axis name, or a tuple of axis
names (the dim split over each, the first outermost).  Leaf paths are the
reference's, "/"-joined with dict keys sorted (``core/tree.py``).  The
rules read only a leaf's ``.shape``; the serving cache's ``(shape, dtype)``
records (``serve.cache_spec``) are read as they are.  ``placements`` turns
a spec into DTensor placements on a ``DeviceMesh``; ``constrain`` is the
reference's ``with_sharding_constraint``.  The same rule tree shards the
optimizer moments (identical shapes).
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core.tree import leaves, leaves_with_path, path_str, unflatten
from repro_torch.launch.mesh import as_abstract, data_axes


def is_spec(x) -> bool:
    return isinstance(x, tuple)


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    shape = as_abstract(mesh).shape
    return math.prod(shape[a] for a in axes)


def _fits(mesh, dim: int, axes) -> bool:
    n = _axis_size(mesh, axes)
    return n > 1 and dim % n == 0


def _shape(leaf) -> tuple:
    """A tensor's shape, or the shape of a ``(shape, dtype)`` record."""
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf[0])


# Each rule: (path regex, [axis-candidates per dim]).  Axis candidates are
# tried right-to-left per dim priority; None = replicate.  "DP" expands to
# the mesh's data axes, "MP" to the model axis.
_PARAM_RULES = [
    # embeddings / heads (vocab-parallel)
    (r"embed$",                 [("MP",), (None,)]),
    (r"lm_head$",               [(None,), ("MP",)]),
    # attention (stacked layer dim first when present)
    (r"(attn|xattn)/w[qkv]$",   [(None,), ("MP",)]),
    (r"(attn|xattn)/wo$",       [("MP",), (None,)]),
    (r"wq_a$",                  [(None,), (None,)]),
    (r"wq_b$",                  [(None,), ("MP",)]),
    (r"wkv_a$",                 [(None,), (None,)]),
    (r"wkv_b$",                 [(None,), ("MP",)]),
    # dense MLP (column-parallel up, row-parallel down)
    (r"mlp/w_(gate|up)$",       [(None,), ("MP",)]),
    (r"mlp/w_down$",            [("MP",), (None,)]),
    # MoE: experts over the model axis (EP)
    (r"moe/we_(gate|up|down)$", [("MP",), (None,), (None,)]),
    (r"moe/router$",            [(None,), (None,)]),
    (r"moe/ws_(gate|up)$",      [(None,), ("MP",)]),
    (r"moe/ws_down$",           [("MP",), (None,)]),
    # mamba2
    (r"ssm/in_(z|x|dt)$",       [(None,), ("MP",)]),
    (r"ssm/in_bc$",             [(None,), (None,)]),
    (r"ssm/conv_x_[wb]$",       [(None,), ("MP",)]),
    (r"ssm/conv_bc_[wb]$",      [(None,), (None,)]),
    (r"ssm/out_proj$",          [("MP",), (None,)]),
    (r"ssm/(A_log|dt_bias|D)$", [("MP",)]),
    (r"ssm/norm$",              [("MP",)]),
    # griffin RG-LRU
    (r"rec/w_(gate_in|rec_in)$", [(None,), ("MP",)]),
    (r"rec/conv_[wb]$",         [(None,), ("MP",)]),
    (r"rec/w_[ri]$",            [(None,), ("MP",)]),
    (r"rec/(b_r|b_i|lam)$",     [("MP",)]),
    (r"rec/w_out$",             [("MP",), (None,)]),
    # MTP
    (r"mtp/proj$",              [(None,), ("MP",)]),
    (r"frontend_proj$",         [(None,), (None,)]),
]


def _spec_for_path(path: str, shape: tuple, mesh) -> tuple:
    for pat, dim_rules in _PARAM_RULES:
        if re.search(pat, path):
            # stacked-layer / stacked-group leading dims are never sharded
            extra = len(shape) - len(dim_rules)
            spec = [None] * extra
            for dim, cands in zip(shape[extra:], dim_rules):
                chosen = None
                for cand in cands:
                    if cand is None:
                        continue
                    axes = ("model",) if cand == "MP" else data_axes(mesh)
                    if _fits(mesh, dim, axes):
                        chosen = axes[0] if len(axes) == 1 else axes
                        break
                spec.append(chosen)
            return tuple(spec)
    return ()                                    # norms, scalars: replicate


def _fsdp_spec_for_path(path: str, shape: tuple, mesh) -> tuple:
    """FSDP / ZeRO-3 sharding: every weight matrix shards one large dim over
    ALL axes ("data"+"model" ⇒ 256-way); its weights are all-gathered
    just-in-time per use and its gradients reduce-scattered.  MoE keeps
    experts on "model" (EP) and shards the expert's output dim over the
    data axes, never the contracting d_model dim (the reference measured
    the gathers of full expert activations that sharding it causes)."""
    all_axes = tuple(as_abstract(mesh).axis_names)
    dp = data_axes(mesh)
    if re.search(r"moe/we_(gate|up|down)$", path):
        spec = [None] * (len(shape) - 3)
        e, a, b = shape[-3:]
        s_e = "model" if _fits(mesh, e, ("model",)) else None
        s_b = (dp if len(dp) > 1 else dp[0]) if _fits(mesh, b, dp) else None
        spec += [s_e, None, s_b]
        return tuple(spec)
    if len(shape) == 0:
        return ()
    # Stacked-layer leading dim stays unsharded.  Prefer the LAST (output)
    # dim: output-dim sharding keeps weight gradients local and
    # reduce-scattered, where a contracting dim gathers full-batch
    # activations.
    lead = 1 if len(shape) >= 3 else 0
    dims = list(range(lead, len(shape)))
    if not dims:
        return ()
    for axes in (all_axes, dp, ("model",)):
        for d in sorted(dims, key=lambda i: -i):
            if _fits(mesh, shape[d], axes):
                spec = [None] * len(shape)
                spec[d] = axes if len(axes) > 1 else axes[0]
                return tuple(spec)
    return ()


def _map_with_path(fn, tree):
    return unflatten(tree, [fn(path_str(p), leaf)
                            for p, leaf in leaves_with_path(tree)])


def param_specs(params_tree, mesh, mode: str = "tp"):
    """Spec tree for a parameter (or shape-record) tree.
    mode: "tp" (Megatron tensor parallel, baseline) | "fsdp" (ZeRO-3)."""
    fn = _fsdp_spec_for_path if mode == "fsdp" else _spec_for_path
    return _map_with_path(lambda p, leaf: fn(p, _shape(leaf), mesh),
                          params_tree)


def opt_specs(opt_tree, param_spec_tree):
    """Optimizer moments shard like their parameters."""
    return {"m": param_spec_tree, "v": param_spec_tree, "step": ()}


# ------------------------------------------------------------- activations
def batch_spec(mesh, shape: tuple, batch_dim: int = 0,
               extra: Optional[dict] = None, mode: str = "tp") -> tuple:
    """Shard dim ``batch_dim`` over the data axes (tp) or ALL axes (fsdp:
    pure-DP compute, every chip gets its own batch slice)."""
    dp = tuple(as_abstract(mesh).axis_names) if mode == "fsdp" \
        else data_axes(mesh)
    spec = [None] * len(shape)
    if _fits(mesh, shape[batch_dim], dp):
        spec[batch_dim] = dp if len(dp) > 1 else dp[0]
    elif mode == "fsdp" and _fits(mesh, shape[batch_dim], data_axes(mesh)):
        d2 = data_axes(mesh)
        spec[batch_dim] = d2 if len(d2) > 1 else d2[0]
    if extra:
        for d, axes in extra.items():
            if _fits(mesh, shape[d], axes):
                spec[d] = axes if isinstance(axes, str) else \
                    (axes if len(axes) > 1 else axes[0])
    return tuple(spec)


def kv_head_axis_dims(kv_heads: int, entry_dim: int, mesh):
    """Shard kv_heads over model if divisible, else the packed entry dim,
    else replicate.  Returns (kv_spec_axis, entry_axis)."""
    if _fits(mesh, kv_heads, ("model",)):
        return "model", None
    if _fits(mesh, entry_dim, ("model",)):
        return None, "model"
    return None, None


def cache_specs_tree(cache_tree, mesh):
    """Specs for a KV-WAL / state cache (by leaf name): tensors, or the
    ``(shape, dtype)`` records of ``serve.cache_spec``."""
    dp = data_axes(mesh)

    def spec(name, sh):
        if ("arena_k" in name or "arena_v" in name) and len(sh) >= 5:
            # (L?, B, nb, blk, KH, dim)
            off = len(sh) - 5                    # tail arenas have no L dim
            s = [None] * len(sh)
            if _fits(mesh, sh[off], dp):
                s[off] = dp if len(dp) > 1 else dp[0]
            kh_ax, ed_ax = kv_head_axis_dims(sh[off + 3], sh[off + 4], mesh)
            s[off + 3] = kh_ax
            s[off + 4] = ed_ax
            return tuple(s)
        if name.endswith(("cross_k", "cross_v")) and len(sh) == 5:
            s = [None, None, None, None, None]
            if _fits(mesh, sh[1], dp):
                s[1] = dp if len(dp) > 1 else dp[0]
            kh_ax, ed_ax = kv_head_axis_dims(sh[3], sh[4], mesh)
            s[3], s[4] = kh_ax, ed_ax
            return tuple(s)
        if name.endswith("state") and len(sh) == 5:   # ssm (L,B,h,p,n)
            s = [None] * 5
            if _fits(mesh, sh[1], dp):
                s[1] = dp if len(dp) > 1 else dp[0]
            if _fits(mesh, sh[2], ("model",)):
                s[2] = "model"
            return tuple(s)
        if ("conv" in name or "lru" in name) and len(sh) >= 3:
            s = [None] * len(sh)
            bdim = len(sh) - 3 if "conv" in name else len(sh) - 2
            if _fits(mesh, sh[bdim], dp):
                s[bdim] = dp if len(dp) > 1 else dp[0]
            if _fits(mesh, sh[-1], ("model",)):
                s[-1] = "model"
            return tuple(s)
        if name.endswith(("seq_lens", "first_live", "table")):
            return ()
        # fallback: shard the most plausible batch dim
        return batch_spec(mesh, sh, 0 if len(sh) <= 2 else 1)

    return {name: spec(name, _shape(leaf)) for name, leaf in cache_tree.items()}


def input_specs_tree(specs: dict, mesh, mode: str = "tp"):
    """Specs for dry-run/step inputs keyed by input name."""
    out = {}
    for k, v in specs.items():
        if k == "cache":
            out[k] = cache_specs_tree(v, mesh)
        elif k == "mrope_positions":
            out[k] = batch_spec(mesh, _shape(v), batch_dim=1, mode=mode)
        else:
            out[k] = batch_spec(mesh, _shape(v), batch_dim=0, mode=mode)
    return out


# ------------------------------------------------------------- placements
def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each mesh
    dim the spec names for tensor dim ``d``, ``Replicate()`` elsewhere.  A
    dim split over several axes names them in mesh order, as the rules
    do (DTensor splits it the first mesh dim outermost, as JAX does)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(as_abstract(mesh).axis_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}, not one of "
                                 f"the mesh's {names}")
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"spec {spec} splits dim {d} over {axes}, not "
                             f"in the mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a ``DeviceMesh``: the reference's ``NamedSharding``."""
    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def named(tree_specs, mesh):
    """A tree of ``NamedSharding`` for a tree of specs."""
    return unflatten(tree_specs, [NamedSharding(mesh, s) for s in
                                  leaves(tree_specs, is_leaf=is_spec)],
                     is_leaf=is_spec)


def place(t: torch.Tensor, sharding: NamedSharding):
    """``t`` as a DTensor on ``sharding``.  A real tensor is distributed
    from rank 0 (each rank keeps its shard); a meta tensor (a shape record)
    becomes a DTensor whose local shard is a meta tensor of the shard's
    shape, with no collective."""
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor
    mesh, pl = sharding.mesh, sharding.placements
    if not t.is_meta:
        return distribute_tensor(t, mesh, pl)
    local = list(t.shape)
    for size, p in zip(mesh.shape, pl):
        if isinstance(p, Shard):
            if local[p.dim] % size:
                raise ValueError(f"dim {p.dim} of {tuple(t.shape)} does not "
                                 f"split {size} ways")
            local[p.dim] //= size
    return DTensor.from_local(
        torch.empty(local, dtype=t.dtype, device="meta"), mesh, pl,
        run_check=False, shape=t.shape, stride=t.stride())


def distribute(tree, specs, mesh):
    """Each leaf of ``tree`` placed by the spec at its path in ``specs``."""
    flat = leaves(specs, is_leaf=is_spec)
    return unflatten(tree, [place(t, NamedSharding(mesh, s))
                            for t, s in zip(leaves(tree), flat, strict=True)])


def constrain(x, spec: tuple):
    """The reference's ``with_sharding_constraint``: a DTensor is
    redistributed to ``spec``'s placements on its own mesh; any other tensor
    is returned as it is (the reference is silently a no-op outside a
    mesh)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return _to(x, placements(spec, x.device_mesh))


def _to(t, want):
    """The DTensor ``t`` redistributed to the placements ``want``, or ``t``
    itself where it has them already."""
    if tuple(t.placements) == tuple(want):
        return t
    return t.redistribute(t.device_mesh, tuple(want))


def attend_on_shards(attend, q, arena_k, arena_v, table, *rows, **kw):
    """``attend(q, arena_k, arena_v, table, *rows, **kw)``, a decode
    attention through the KV-WAL (q (B,H,dk), arenas (B,NB,blk,KH,d), the
    table and ``rows`` one entry a sequence: ``seq_lens``, ``first_live``)
    → (B,H,dv), on each device's shards where the arenas are DTensors split
    on the batch and the KV heads only: each sequence and each KV head's
    group of query heads attends alone, so q is placed as the arenas are
    (its heads where they split the KV heads), the table and rows where
    they split the batch, and the output comes back placed as q.  XLA's
    partitioner keeps the reference's batch and head dims split through
    its dense attention; DTensor flattens the split batch and head dims
    into one batch of products, which it cannot place, and gathers the
    arena (phi3-mini's 32 and qwen2-moe's 16 KV heads on a 16-wide model
    axis).  Plain tensors, and arenas split on another dim (the entry dim,
    where the KV heads do not divide the model axis), go to ``attend`` as
    they are."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    pl = tuple(arena_k.placements) if isinstance(arena_k, DTensor) else ()
    if not pl or tuple(arena_v.placements) != pl or not all(
            p.is_replicate() or (type(p) is Shard and p.dim in (0, 3))
            for p in pl) or all(p.is_replicate() for p in pl):
        return attend(q, arena_k, arena_v, table, *rows, **kw)
    mesh = arena_k.device_mesh
    q_pl = [Shard(0) if p == Shard(0) else Shard(1) if p == Shard(3)
            else Replicate() for p in pl]
    row_pl = [p if p == Shard(0) else Replicate() for p in pl]

    def local(t, want):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return _to(t, want).to_local()

    out = attend(local(q, q_pl), arena_k.to_local(), arena_v.to_local(),
                 *(local(r, row_pl) for r in (table,) + rows), **kw)
    shape = torch.Size((*q.shape[:2], arena_v.shape[-1]))
    return DTensor.from_local(out, mesh, q_pl, run_check=False, shape=shape,
                              stride=contiguous_strides(shape))


def contiguous_strides(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape`` (without making one:
    a tensor made under the dry run's trace counts as allocated)."""
    out, step = [], 1
    for n in reversed(shape):
        out.append(step)
        step *= n
    return tuple(reversed(out))


# ---------------------------------------------------- vocab-parallel loss
# XLA partitions the reference's log-softmax over vocab-sharded logits with
# per-token all-reduces.  DTensor picks each op's placements by the bytes
# its inputs move, not by the bytes its output holds: left alone, the head
# product comes out pending a sum over the whole vocabulary.  These hooks
# steer the head and the loss (``models/transformer.py``); like
# ``constrain``, each returns a plain tensor as it is.
def vocab_parallel_input(x, w, vocab_dim: int):
    """The head's input ``x`` whole on each mesh dim that splits the head
    weight ``w`` along its vocab dim, so that the logits come out split
    there; its other mesh dims keep their placements."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not (isinstance(x, DTensor) and isinstance(w, DTensor)):
        return x
    vdim = vocab_dim % w.dim()
    return _to(x, [Replicate() if isinstance(pw, Shard) and pw.dim == vdim
                   else px for px, pw in zip(x.placements, w.placements)])


def experts_as_weight(x, w, x_dim: int = 1, w_dim: int = 0):
    """``x`` with its expert dim ``x_dim`` split over each mesh dim that
    splits the expert weight ``w`` along its expert dim ``w_dim``, its
    other mesh dims as they were (a plain tensor, or one whose expert dim
    nothing splits, is returned as it is), its gradient placed the same
    (``grad_as_value``).  The MoE's expert inputs and outputs
    (``models/moe.py``): XLA's partitioner propagates the experts' split
    from the weights into the expert products and their cotangents.
    DTensor places each product by the bytes its inputs move: it split the
    expert inputs by their hidden dim in the forward, and the down
    projection's output gradient by groups in the backward, which left
    ``we_down``'s gradient whole on every device, pending a sum (ROADMAP
    C.17)."""
    from torch.distributed.tensor import DTensor, Shard
    if not (isinstance(x, DTensor) and isinstance(w, DTensor)):
        return x
    want = [Shard(x_dim) if type(pw) is Shard and pw.dim == w_dim else px
            for px, pw in zip(x.placements, w.placements)]
    return grad_as_value(_to(x, want))


def grad_as_value(t):
    """``t`` itself, its gradient placed as ``t`` is when the backward
    reaches it (a hook; a plain tensor, or one that needs no gradient, is
    returned as it is): XLA places a cotangent as its primal.  2.11's
    DTensor kept MLA's attention-output gradient pending a sum over the
    model axis through the attention's backward, every head of a batch
    row's fp32 scores on each device (``models/mla.py``)."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor) and t.requires_grad:
        want = tuple(t.placements)
        t.register_hook(lambda g: _to(g, want)
                        if isinstance(g, DTensor) else g)
    return t


def complete(t):
    """``t`` with its pending reductions done: each ``Partial`` mesh dim
    all-reduced to ``Replicate``."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, DTensor):
        return t
    return _to(t, [Replicate() if p.is_partial() else p
                   for p in t.placements])


def follow(t, ref):
    """``t`` placed as ``ref``, a tensor of the same shape, is placed."""
    from torch.distributed.tensor import DTensor
    if not (isinstance(t, DTensor) and isinstance(ref, DTensor)):
        return t
    return _to(t, ref.placements)
