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


def split_heads(t, n: int, heads: int):
    """``t`` (B,S,n*d) viewed as (B,S,n,d), the K, V or Q of a layer of
    ``heads`` query heads.  A DTensor whose last dim is split over mesh
    dims whose sizes do not divide ``n`` but divide ``heads`` (qwen3-0.6b's
    8 KV heads on a 16-wide model axis, recurrentgemma-9b's one) is first
    moved to split its sequence there (an all-to-all): no torch views such
    a split as heads, and a refused view runs replicated in the dry run,
    the K/V whole on every device; ``attend_on_heads`` then splits the
    query heads.  Plain tensors, DTensors whose split ``n`` divides, and
    layers whose query heads the split does not divide (whisper's 20 on
    16: ``project_heads`` splits those unevenly, but in a decode step),
    are viewed as they are."""
    from torch.distributed.tensor import DTensor, Shard
    shape = (*t.shape[:2], n, t.shape[-1] // n)
    if isinstance(t, DTensor):
        mesh, last = t.device_mesh, t.dim() - 1
        on_last = [i for i, p in enumerate(t.placements)
                   if type(p) is Shard and p.dim == last]
        across = math.prod(mesh.size(i) for i in on_last)
        on_seq = math.prod(mesh.size(i) for i, p in enumerate(t.placements)
                           if type(p) is Shard and p.dim == 1)
        if n % across and heads % across == 0 and \
                t.shape[1] % (across * on_seq) == 0:
            t = _to(t, [Shard(1) if i in on_last else p
                        for i, p in enumerate(t.placements)])
    return t.reshape(shape)


def _as_dtensor(t, mesh):
    """``t`` itself if a DTensor, else ``t`` replicated on ``mesh``."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _local_shard(t, want, split):
    """``t`` placed as ``want`` → its local tensor, for a computation that
    each device runs on its own shards, split over the mesh dims where
    ``split`` holds a ``Shard``: on such a mesh dim the gradient of an input
    it leaves replicated is each device's part of a sum (``Partial``)."""
    from torch.distributed.tensor import Partial
    t = _to(t, want)
    return t.to_local(grad_placements=[
        Partial() if p.is_replicate() and not s.is_replicate() else p
        for p, s in zip(want, split)])


def _from_local(local, mesh, placements, shape):
    """The contiguous DTensor of global ``shape`` whose local tensor is
    ``local`` (made contiguous: a product's output may be a permuted view,
    which a later view of the DTensor could not take)."""
    from torch.distributed.tensor import DTensor
    shape = torch.Size(shape)
    return DTensor.from_local(local.contiguous(), mesh, tuple(placements),
                              run_check=False, shape=shape,
                              stride=contiguous_strides(shape))


def _rows_and_heads(ts, head_dim: int, seq: int = 0, heads=None):
    """Placements for a computation that each device runs on its own batch
    rows and heads of the DTensors ``ts`` (the first gives the shape, and
    ``heads``, where given, the number of heads at ``head_dim``): each mesh
    dim that splits the batch (dim 0) of any of them keeps that split
    where the batch divides it, each that splits the heads of any of them
    keeps that split where they divide, and where the sequence ``seq`` is
    no shorter than a mesh dim, each other mesh dim splits the heads
    where they divide further; any left replicates → those placements, or
    None where no mesh dim splits the heads and some mesh dim replicates,
    or nothing is split at all (a mesh of one device): there the products
    stay as they are.  Where no mesh dim splits the heads, the innermost
    mesh dim left replicated splits them unevenly, again if ``seq`` is no
    shorter than it, ceil(heads / n) a device as ``torch.chunk`` cuts them
    (whisper's 20 heads on a 16-wide model axis: 2 heads on 10 devices,
    none on 6).  A decode step's one token moves nothing to split its
    heads further: mamba2-1.3b x long_500k's one sequence keeps its
    state's heads where the cache has them."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor import DTensor
    t, rows, across = ts[0], 1, 1
    mesh, heads = t.device_mesh, heads or t.shape[head_dim]
    want = [None] * mesh.ndim

    def split(i, dim):
        return any(isinstance(u, DTensor) and u.placements[i] == Shard(dim)
                   for u in ts)

    for i in range(mesh.ndim):
        n = mesh.size(i)
        if n == 1:                                 # no split at all
            want[i] = Replicate()
        elif split(i, 0) and t.shape[0] % (rows * n) == 0:
            want[i] = Shard(0)
            rows *= n
        elif split(i, head_dim) and heads % (across * n) == 0:
            want[i] = Shard(head_dim)
            across *= n
    for i in range(mesh.ndim):
        if want[i] is None and seq >= mesh.size(i) and \
                heads % (across * mesh.size(i)) == 0:
            want[i] = Shard(head_dim)
            across *= mesh.size(i)
        elif want[i] is None:
            want[i] = Replicate()
    left = [i for i, p in enumerate(want)
            if p.is_replicate() and mesh.size(i) > 1]
    if across == 1 and left and heads > 1 and seq >= mesh.size(left[-1]):
        want[left[-1]] = Shard(head_dim)
        across, left = mesh.size(left[-1]), left[:-1]
    return None if across == 1 and (rows == 1 or left) else want


def _uneven(want, heads: int, mesh):
    """The mesh dim of ``want`` that splits the heads (dim 2) unevenly, and
    the range of heads it leaves this device → (mesh dim, (h0, h1)), or
    None where no mesh dim does."""
    from torch.distributed.tensor import Shard
    for i, p in enumerate(want or ()):
        if p == Shard(2) and heads % mesh.size(i):
            per = -(-heads // mesh.size(i))        # torch.chunk's cut
            h0 = min(heads, per * mesh.get_coordinate()[i])
            return i, (h0, min(heads, h0 + per))
    return None


def project_heads(proj, x, w, n: int, heads: int, per_query: bool = False):
    """``split_heads(proj(x, w), n, heads)``: a layer's Q (``n`` =
    ``heads``, its query heads) or its K or V (``n`` KV heads), (B,S,n,hd)
    from x (B,S,d) and w (d, n*hd).  Where x is a DTensor whose query
    heads split unevenly over a mesh dim (``_rows_and_heads``: no mesh dim
    divides them; whisper-large-v3's 20 and phi3-medium-14b's 40 on a
    16-wide model axis), each device multiplies its rows of x, whole on
    that mesh dim (``column_parallel_input`` places it so), by the
    columns of w for its own heads (w whole there; the gradients of x and
    w each device's part of a sum), and the output comes back split so: Q
    over its query heads as ``attend_on_heads`` places them, K and V over
    their KV heads, or with ``per_query`` one copy for each of the
    device's query heads, (B,S,heads,hd) placed as Q, for the attention.
    No activation moves, and K/V are never whole on a device; DTensor's
    own heads view of the split hidden dim is refused, and ran replicated
    in the dry run.
    Other tensors → ``split_heads(proj(x, w), n, heads)``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    want = _rows_and_heads([x], 2, x.shape[1], heads) \
        if isinstance(x, DTensor) else None
    cut = _uneven(want, heads, x.device_mesh) if want else None
    if cut is None:
        return split_heads(proj(x, w), n, heads)
    mesh, (i, (h0, h1)) = x.device_mesh, cut
    hd, group = w.shape[-1] // n, heads // n
    if n == heads or per_query:                  # the query heads' own
        lo, hi = h0 // group, -(-h1 // group)
    else:
        _, (lo, hi) = _uneven(want, n, mesh)
    whole = [Replicate()] * mesh.ndim
    x_l = _local_shard(x, [p if p == Shard(0) else Replicate()
                           for p in want], want)
    w_l = _local_shard(_as_dtensor(w, mesh), whole, want)
    y = proj(x_l, w_l[..., lo * hd:hi * hd].contiguous())
    y = y.reshape(*y.shape[:2], hi - lo, hd)
    if per_query and group > 1:
        y = y[:, :, :, None].expand(*y.shape[:3], group, hd).reshape(
            *y.shape[:2], (hi - lo) * group, hd)[:, :, h0 - lo * group:
                                                 h1 - lo * group]
    n_out = heads if per_query else n
    return _from_local(y, mesh, want, (*x.shape[:2], n_out, hd))


def attend_on_heads(attend, q, k, v, **kw):
    """``attend(q, k, v, **kw)``, a prefill or training attention (q
    (B,Sq,H,d); k, v (B,Skv,KH,*) → (B,Sq,H,vd)), on each device's batch
    rows and query heads where q is a DTensor (``_rows_and_heads``: the
    batch split where any of q, k, v splits it and it divides, the heads
    on every other mesh dim where they divide): q, k and v are placed so,
    each device attends with plain tensors, and the output comes back
    placed so.
    Where the split does not divide the KV heads (qwen3-0.6b's 8 on a
    16-wide model axis, recurrentgemma-9b's one), each query head takes its
    own copy of its KV head (head h reads h // G) before k and v move onto
    the heads, from a split of the sequence: a device holds the K/V of its
    own query heads only, never the whole K/V.  XLA's partitioner tiles the
    reference's (KV head, group) dims over the model axis likewise.
    DTensor itself flattens the split batch and head dims into one batch
    of products, which it cannot place (the batch would be split inside
    the flattened dim), and the dry run ran each such view replicated, a
    chunk's fp32 scores for every head on each device.
    Heads that no mesh dim divides (whisper's 20 and phi3-medium-14b's 40
    on a 16-wide model axis) split unevenly over the innermost mesh dim
    left whole, ceil(H / n) a device (``_rows_and_heads``), their K/V
    copied per query head where the KV heads are fewer; the output stays
    split so, and ``merge_heads`` multiplies it by the output projection
    (no torch views an uneven split of heads as the hidden dim).  XLA's
    partitioner tiles whisper's product 4 ways over the heads and
    replicates it over the other 4; DTensor left it whole on every
    device.  Plain tensors go to ``attend`` as they are."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(q, DTensor):
        return attend(q, k, v, **kw)
    want = _rows_and_heads([q, k, v], 2, q.shape[1])
    if want is None:
        return attend(q, k, v, **kw)
    mesh, (B, Sq, H, _) = q.device_mesh, q.shape
    across = math.prod(mesh.size(i) for i, p in enumerate(want)
                       if p == Shard(2))

    def per_query_head(t):
        t = _as_dtensor(t, mesh)
        B, S, n, d = t.shape
        if n == H or n % across == 0:
            return t
        # Split the sequence where the heads will be, so that each device
        # copies 1/across of the expanded K/V, then expand (KH, G) → H.
        # KV heads split unevenly (``project_heads``) move there whatever
        # the sequence's length.
        on_heads = Shard(2) in t.placements
        seq = [Shard(1) if w == Shard(2) and (p.is_replicate() or on_heads)
               else p for p, w in zip(t.placements, want)]
        if on_heads or S % math.prod(mesh.size(i) for i, p in enumerate(seq)
                                     if p == Shard(1)) == 0:
            t = _to(t, seq)
        return t[:, :, :, None].expand(B, S, n, H // n, d).reshape(
            B, S, H, d)

    q, k, v = (_local_shard(t, want, want)
               for t in (q, per_query_head(k), per_query_head(v)))
    # A device that holds none of an uneven split's heads gives an empty
    # output made of its inputs: their gradients' moves run on every device.
    out = attend(q, k, v, **kw) if q.shape[2] else torch.einsum(
        "bqhd,bshd,bshv->bqhv", q, k, v)
    return _from_local(out, mesh, want, (B, Sq, H, v.shape[-1]))


def merge_heads(proj, o, w):
    """``proj(o.reshape(B, S, H * vd), w)``, the output projection of an
    attention's output o (B,S,H,vd) by w (H*vd, d).  Where o is a DTensor
    whose heads a mesh dim splits unevenly (``attend_on_heads``), each
    device multiplies its own heads by their rows of w (w whole on that
    mesh dim, its gradient each device's part of a sum there and on every
    mesh dim that splits o), and the output is pending a sum there, as a
    row-parallel product's is: no torch views such a split as the hidden
    dim, and the view ran replicated in the dry run, every head's output
    on each device.  Other tensors take ``proj`` as they are."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    B, S, H, vd = o.shape
    cut = _uneven(o.placements, H, o.device_mesh) \
        if isinstance(o, DTensor) else None
    if cut is None:
        return proj(o.reshape(B, S, H * vd), w)
    mesh, (_, (h0, h1)) = o.device_mesh, cut
    local = o.to_local()
    w = _local_shard(_as_dtensor(w, mesh), [Replicate()] * mesh.ndim,
                     o.placements)[h0 * vd:h1 * vd].contiguous()
    out = proj(local.reshape(*local.shape[:2], (h1 - h0) * vd), w)
    return _from_local(out, mesh, [Partial() if p == Shard(2) else p
                                   for p in o.placements],
                       (B, S, out.shape[-1]))


def rows_on_shards(fn, x, *ws):
    """``fn(x, *ws)``, the MoE's experts (``moe._experts``: x (G,E,C,d),
    the groups' slots of each expert, and each weight (E,·,·) → (G,E,C,·)),
    on each device's groups and experts where ``x`` is a DTensor: each mesh
    dim that splits every weight's experts (dim 0) splits x's experts (dim
    1) so, and each other mesh dim splits x's groups (dim 0) where they
    divide (a split of another dim moves there), or leaves x whole; each
    device runs ``fn`` with plain tensors on its own groups and experts,
    the output comes back placed so, and a weight's gradient is split as
    the weight on its experts and each device's part of a sum elsewhere
    (``transformer._body`` scatters that sum: ``grad_split_as``).  XLA's
    partitioner keeps the reference's groups and experts split through its
    expert products.  DTensor split the expert inputs on their hidden dim
    where the model axis does not divide the experts (qwen2-moe-a2.7b's 60
    on 16), and flattened the split groups and experts with the slots of
    the products (DeepSeek-V3's 256 on 16): views the dry run ran
    replicated, 9.4e9 B a layer.  Plain tensors, a mesh of one device,
    weights split on another dim, and an ``x`` pending a sum on a mesh
    dim that its groups do not divide (a decode step's one group, its
    tokens summed over the data axes: completed there, every device of
    those axes would run the same products, and deepseek-v3-671b x
    decode_32k x 2 x 16 x 16 moved 30% more bytes) go to ``fn`` as they
    are; a sum over a mesh dim that splits the groups is scattered onto
    them."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return fn(x, *ws)
    mesh, want, w_want, rows, experts = x.device_mesh, [], [], 1, 1
    for i, p in enumerate(x.placements):
        n = mesh.size(i)
        w_pl = {w.placements[i] if isinstance(w, DTensor) else Replicate()
                for w in ws}
        if w_pl == {Shard(0)} and x.shape[1] % (experts * n) == 0:
            want.append(Shard(1))
            w_want.append(Shard(0))
            experts *= n
        elif w_pl != {Replicate()}:
            return fn(x, *ws)
        elif p == Shard(0) or x.shape[0] % (rows * n) == 0:
            want.append(Shard(0))
            w_want.append(Replicate())
            rows *= n
        else:
            want.append(Replicate())
            w_want.append(Replicate())
    if rows * experts == 1 or any(p.is_partial() and q.is_replicate()
                                  for p, q in zip(x.placements, want)):
        return fn(x, *ws)
    out = fn(_to(x, want).to_local(), *(
        _local_shard(_as_dtensor(w, mesh), w_want, want) for w in ws))
    return _from_local(out, mesh, want, (out.shape[0] * rows,
                                         out.shape[1] * experts,
                                         *out.shape[2:]))


def scan_on_heads(scan, x, dt, A, Bm, Cm, *, chunk: int, init_state=None):
    """``scan(x, dt, A, Bm, Cm, chunk=chunk, init_state=init_state)``, the
    chunked SSD (x (b,l,h,p), dt (b,l,h), A (h,), Bm and Cm (b,l,n) shared
    by every head, init_state (b,h,p,n) or None → (y (b,l,h,p),
    final_state (b,h,p,n))), on each device's batch rows and heads where x
    is a DTensor, placed as ``attend_on_heads`` places q: every operand is
    split so (Bm and Cm only on the batch), each device scans with plain
    tensors, and y and the state come back split so.  DTensor flattens
    the split batch, chunk and head dims of the SSD's products into one,
    which it cannot place, and the dry run ran each such view replicated,
    every head's (b, chunk, h, c, c) decays on each device.  Plain tensors,
    and x left whole by ``_rows_and_heads``, go to ``scan`` as they
    are."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return scan(x, dt, A, Bm, Cm, chunk=chunk, init_state=init_state)
    want = _rows_and_heads([x], 2, x.shape[1])
    if want is None:
        return scan(x, dt, A, Bm, Cm, chunk=chunk, init_state=init_state)
    mesh = x.device_mesh

    def local(t, rows, heads):
        """t's local shard, its dims ``rows`` and ``heads`` (or None) split
        as x's batch and heads are."""
        pl = [Shard(rows) if p == Shard(0) and rows is not None else
              Shard(heads) if p == Shard(2) and heads is not None else
              Replicate() for p in want]
        return _local_shard(_as_dtensor(t, mesh), pl, want)

    state = None if init_state is None else local(init_state, 0, 1)
    y, last = scan(local(x, 0, 2), local(dt, 0, 2), local(A, None, 0),
                   local(Bm, 0, None), local(Cm, 0, None), chunk=chunk,
                   init_state=state)
    b, _, h, p = x.shape
    rows_heads = [Shard(1) if q == Shard(2) else q for q in want]
    return (_from_local(y, mesh, want, x.shape),
            _from_local(last, mesh, rows_heads, (b, h, p, last.shape[-1])))


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


def column_parallel_input(x, w):
    """``x`` placed for a column-parallel product ``x @ w`` (the attention's,
    the MLP's, the SSM's and the RG-LRU's input projections): on each mesh
    dim that splits ``w``'s output (last) dim, ``x``'s batch (dim 0) split
    further where it divides, else ``x`` whole there, as XLA's partitioner
    places the reference's; its other mesh dims as they were.  A batch
    split over the model axis
    multiplies each device's rows by the gathered weight (a 256-row train
    batch on 16 x 16; ``rows_weight``); a whole ``x`` gives the product
    split on its output dim, so that its heads stay split (a prefill's 2
    rows a data slice, a two-pod train batch's 8).  DTensor alone places
    a product by the bytes its inputs move: given ``x`` split on its
    hidden dim, it moved the weight onto that split and gave the product
    pending a sum, every head on each device; given ``x`` split on its
    sequence, it kept that split, and the next product's flatten of the
    batch and the split sequence, which it cannot place, ran replicated in
    the dry run.  A plain tensor is returned as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not (isinstance(x, DTensor) and isinstance(w, DTensor)):
        return x
    last, rows, want = w.dim() - 1, 1, []
    for i, (px, pw) in enumerate(zip(x.placements, w.placements)):
        n = x.device_mesh.size(i)
        if px == Shard(0) or (type(pw) is Shard and pw.dim == last
                              and x.shape[0] % (rows * n) == 0):
            want.append(Shard(0))
            rows *= n
        elif type(pw) is Shard and pw.dim == last:
            want.append(Replicate())
        else:
            want.append(px)
    return _to(x, want)


def embed_on_shards(table, ids, dtype):
    """``table[ids].to(dtype)`` (table (V, d), ids integers) where ``ids``
    is a DTensor and ``table`` a DTensor split on its vocab (dim 0) over
    one mesh dim and whole on the others: each device looks the ids up in
    its own slice of the vocab (the others give zeros), its rows split as
    the ids are, and the sum over the vocab's mesh dim is completed (the
    rows whole over the model axis, as the input projections take them;
    scattered over the hidden dim instead, 2.11 placed the attention of
    heads that the axis does not divide with collectives x145); the
    table's gradient comes back split as the table, each device's part of
    a sum elsewhere.  XLA's partitioner masks each device's slice of the
    reference's gather likewise.  DTensor gathered the whole table on every
    device.  A table whole on every mesh dim (a vocab the model axis does
    not divide: mamba2-1.3b's 50280, whisper's 51866 on 16) is looked up on
    each device's own ids where a mesh dim splits them, the output placed
    as the ids, the table's gradient each device's part of a sum over the
    mesh dims that split them, scattered over the innermost.  2.11's
    DTensor has no rule for ids split over two mesh dims on
    one dim (the batch over pod and data): the dry run ran either gather
    again on ids gathered over data, 16 rows of a prefill's embeddings on
    each device.  A plain tensor, and other placements, take
    ``table[ids].to(dtype)`` as it is."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not (isinstance(table, DTensor) and isinstance(ids, DTensor)):
        return table[ids].to(dtype)
    mesh = table.device_mesh
    rows = [Replicate() if p.is_partial() else p for p in ids.placements]
    shape = (*ids.shape, table.shape[1])
    split = [i for i, p in enumerate(rows) if not p.is_replicate()]
    if all(p.is_replicate() for p in table.placements) and split:
        # The table's gradient scattered over its hidden dim on the
        # innermost mesh dim that splits the ids, as DTensor's own gather
        # gives it: left pending a sum there, each of AdamW's uses of it
        # all-reduced the whole table (a tied head's gradient meets it).
        grad_pl = [Partial() if i in split else Replicate()
                   for i in range(mesh.ndim)]
        if table.shape[1] % mesh.size(split[-1]) == 0:
            grad_pl[split[-1]] = Shard(1)
        view = table.view_as(table)
        if view.requires_grad:
            view.register_hook(lambda g: _to(g, grad_pl))
        local = _local_shard(view, table.placements, rows)
        out = local[_to(ids, rows).to_local()]
        return _from_local(out.to(dtype), mesh, rows, shape)
    vocab = [i for i, p in enumerate(table.placements) if p == Shard(0)]
    if len(vocab) != 1 or any(not p.is_replicate() for i, p in
                              enumerate(table.placements) if i != vocab[0]):
        return table[ids].to(dtype)
    (v,) = vocab
    rows[v] = Replicate()
    out_pl = [Partial() if i == v else p for i, p in enumerate(rows)]
    local = _local_shard(table, table.placements, out_pl)
    n = local.shape[0]
    idx = _to(ids, rows).to_local() - mesh.get_coordinate()[v] * n
    hit = (idx >= 0) & (idx < n)
    out = torch.where(hit[..., None], local[idx.clamp(0, n - 1)], 0)
    return complete(_from_local(out.to(dtype), mesh, out_pl, shape))


def rows_weight(x, w):
    """``w`` whole on each mesh dim that splits both ``x``'s batch (dim 0)
    and ``w``: the weight of a product ``x @ w`` that each device runs on
    its own rows (a gather, whose backward reduce-scatters the gradient
    onto ``w``'s split).  DTensor would place such a product by the bytes
    its inputs move, and 2.11 moved ``x`` onto its hidden dim and the
    weight onto its rows instead, and all-reduced the product whole.  A
    plain tensor, or an ``x`` whose batch no mesh dim of ``w``'s split
    splits, gives ``w`` as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not (isinstance(x, DTensor) and isinstance(w, DTensor)):
        return w
    return _to(w, [Replicate() if px == Shard(0) and not pw.is_replicate()
                   else pw for px, pw in zip(x.placements, w.placements)])


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


def rows_viewable(t, rows: int):
    """``t`` (rows first, a hidden dim last) placed so that its rows view
    back as ``rows`` rows: each mesh dim that splits its rows keeps that
    split while ``rows`` divides it, and splits its last dim instead where
    it does not (replicating where that does not divide either); every
    other mesh dim keeps its placement.  A plain tensor is returned as it
    is.  The MoE's combined output (``models/moe.py``): DTensor splits its
    groups over the model axis too, and no torch views that split back as
    (batch, sequence) at a batch of fewer rows than devices (2 rows a data
    slice in a prefill)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(t, DTensor):
        return t
    want, split, across, last = [], 1, 1, t.dim() - 1
    for i, p in enumerate(t.placements):
        n = t.device_mesh.size(i)
        if p != Shard(0):
            want.append(p)
        elif rows % (split * n) == 0:
            want.append(p)
            split *= n
        elif t.shape[last] % (across * n) == 0:
            want.append(Shard(last))
            across *= n
        else:
            want.append(Replicate())
    return _to(t, want)


def grad_rows_viewable(t, rows: int):
    """``t`` itself, its gradient placed by ``rows_viewable`` when the
    backward reaches it (a hook; a plain tensor, or one that needs no
    gradient, is returned as it is): the MoE's grouped tokens, whose
    gradient views back to the batch's."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor) and t.requires_grad:
        t.register_hook(lambda g: rows_viewable(g, rows)
                        if isinstance(g, DTensor) else g)
    return t


def grad_as_value(t):
    """``t`` itself, its gradient placed as ``t`` is when the backward
    reaches it, whole on each mesh dim where ``t`` is a pending sum (a
    hook; a plain tensor, or one that needs no gradient, is returned as it
    is): XLA places a cotangent as its primal.  2.11's DTensor kept MLA's
    attention-output gradient pending a sum over the model axis through
    the attention's backward, every head of a batch row's fp32 scores on
    each device (``models/mla.py``).  The output of a row-parallel product
    (the attention's and the MLP's output projections) is a pending sum
    whose gradient came back split on the sequence, and the backward's
    flatten of the batch and that split, which DTensor cannot place, ran
    replicated in the dry run."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(t, DTensor) and t.requires_grad:
        want = tuple(Replicate() if p.is_partial() else p
                     for p in t.placements)
        t.register_hook(lambda g: _to(g, want)
                        if isinstance(g, DTensor) else g)
    return t


def grad_split_as(t, scatter=None):
    """A view of ``t`` whose gradient is split as ``t`` is on each mesh dim
    that splits ``t`` when the backward reaches it (a pending sum there is
    reduce-scattered), its other mesh dims as the gradient has them (a
    hook; a plain tensor, one that needs no gradient, or one replicated on
    every mesh dim is returned as it is).  A layer's weights, at the start
    of the layer (``transformer._body``): DTensor gave a weight that it
    gathered for a product its gradient pending a sum over the model axis,
    whole on every device, and their stack was all-reduced whole
    (qwen2-vl-72b's MLP gradients, (80, 8192, 29568) in fp32: ROADMAP
    C.18).  The sum over the data axes stays pending, for the optimizer,
    as before; with ``scatter``, a dim of ``t``, each mesh dim that leaves
    ``t`` whole splits the gradient on that dim instead, while it divides
    (a pending sum reduce-scattered there; ``t`` replicated on every mesh
    dim too): the MoE's expert weights (``EXPERT_GRAD_SCATTER``), whose
    fp32 gradients stayed whole on the data axes until the ``unbind``'s
    backward stacked every layer's (DeepSeek-V3's three (61, 16, 7168,
    2048) stacks, 5.7e10 B each; ROADMAP C.19).  AdamW gathers such a
    gradient a slice of rows at a time (``optimizer._gathered``)."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(t, DTensor) or not t.requires_grad or (
            scatter is None and all(p.is_replicate() for p in t.placements)):
        return t
    mine, mesh = tuple(t.placements), t.device_mesh
    dim = None if scatter is None else scatter % t.dim()
    across = math.prod(mesh.size(i) for i, p in enumerate(mine)
                       if type(p) is Shard and p.dim == dim)

    def place(g):
        want, split = [], across
        for i, (p, q) in enumerate(zip(g.placements, mine)):
            if not q.is_replicate():
                want.append(q)
            elif dim is not None and not isinstance(p, Shard) and \
                    mesh.size(i) > 1 and \
                    t.shape[dim] % (split * mesh.size(i)) == 0:
                want.append(Shard(dim))
                split *= mesh.size(i)
            else:
                want.append(p)
        return _to(g, want)

    t = t.view_as(t)
    t.register_hook(lambda g: place(g) if isinstance(g, DTensor) else g)
    return t


# The dim of each MoE expert weight, (E, d, ff) or (E, ff, d), that its
# gradient is scattered on where the weight is whole (``grad_split_as``):
# the model's hidden dim d.
EXPERT_GRAD_SCATTER = {"we_gate": -2, "we_up": -2, "we_down": -1}


def whole_mean(t):
    """``t.mean(-1, keepdim=True)``; on a DTensor whose last dim a mesh
    dim splits, the sum over it with its pending reductions done
    (``complete``), over its size: a norm's statistics whole on every
    device.  Where the last dim
    is split over the model axis, DTensor scattered such a mean over the
    batch there, and the backward then moved each activation gradient it
    met onto that split, and back (DTensor's mean, a ``Partial("avg")``,
    cannot be completed in the backward: hence the sum).  Other tensors
    take the mean as it was."""
    from torch.distributed.tensor import DTensor, Shard
    last = t.dim() - 1
    if not isinstance(t, DTensor) or not any(
            type(p) is Shard and p.dim == last for p in t.placements):
        return t.mean(-1, keepdim=True)
    return complete(t.sum(-1, keepdim=True)) / t.shape[-1]


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
