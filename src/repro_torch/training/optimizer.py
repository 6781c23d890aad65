"""AdamW in plain PyTorch, the JAX package's ``training/optimizer.py``.

Not ``torch.optim.AdamW``, whose rules differ from the reference's: weight
decay here is decoupled and applies to leaves of two or more dimensions
only, the learning rate warms up linearly, gradients are clipped by their
global norm, and the moments are stored in ``moment_dtype`` (bf16 for
memory-constrained configs) while every update runs in fp32.  The state
keeps the reference's layout, ``{"m": tree, "v": tree, "step": int32
scalar}``, so a checkpoint of either package restores in the other.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.tree import leaves, tree_map, unflatten


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"
    warmup_steps: int = 100


def adamw_init(params, cfg: AdamWConfig) -> dict:
    dt = getattr(torch, cfg.moment_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    device = leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in leaves(tree)))


# The largest fp32 copy of a leaf's slice that ``adamw_update`` makes: a leaf
# whose fp32 copy is larger is updated a slice of leading rows at a time.
SLICE_BYTES = 256 << 20


def _rows_per_slice(p, *rest) -> int:
    """Leading rows of ``p`` a slice of the update takes: as many as keep
    the slice's fp32 copy within ``SLICE_BYTES``, at least one; all of
    them for a scalar.  A DTensor (``p`` or one of ``rest``) is measured by
    its local shard and is sliced only where it is a stack of layers' weight
    matrices (three dims or more) whose first dim nothing splits (a slice
    of a split dim would be gathered), a layer at a time: slices of one
    shape are placed alike, and a slice of several layers may come out
    split by them, which the new leaf can take only gathered."""
    from torch.distributed.tensor import DTensor
    if p.dim() == 0 or p.shape[0] == 0:
        return 1
    dts = [t for t in (p, *rest) if isinstance(t, DTensor)]
    if dts and (p.dim() < 3 or any(getattr(q, "dim", None) == 0
                                   for t in dts for q in t.placements)):
        return p.shape[0]
    local = p.to_local() if isinstance(p, DTensor) else p
    rows = max(1, SLICE_BYTES // max(4 * local.numel() // p.shape[0], 1))
    return 1 if dts and rows < p.shape[0] else rows


def _new_rows(part, n: int):
    """An uninitialised tensor of ``n`` leading rows laid out as ``part``,
    the update of a slice of them.  A DTensor keeps ``part``'s placements
    but a split of the rows, which it replicates (a slice's rows are not
    one run of a device's rows)."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.distributed.sharding import contiguous_strides
    if not isinstance(part, DTensor):
        return part.new_empty((n, *part.shape[1:]))
    local = part.to_local()
    pl = [Replicate() if getattr(q, "dim", None) == 0 else q
          for q in part.placements]
    shape = torch.Size((n, *part.shape[1:]))
    return DTensor.from_local(local.new_empty((n, *local.shape[1:])),
                              part.device_mesh, pl, run_check=False,
                              shape=shape,
                              stride=contiguous_strides(shape))


def _write_rows(out, start: int, part) -> None:
    """``out[start:start + len(part)] = part``; a DTensor's on each
    device's shard, ``part`` placed as ``out`` first."""
    from torch.distributed.tensor import DTensor
    if not isinstance(out, DTensor):
        out[start:start + part.shape[0]].copy_(part)
        return
    if tuple(part.placements) != tuple(out.placements):
        part = part.redistribute(out.device_mesh, out.placements)
    out.to_local()[start:start + part.shape[0]].copy_(part.to_local())


def _gathered(g, p):
    """The gradient ``g`` placed as its parameter ``p``: gathered on each
    mesh dim that splits it where ``p`` is whole, summed on each where it
    is pending a sum (an all-reduce, or a reduce-scatter where ``p`` is
    split there, as the reference's gradient psum), cut to ``p``'s split
    where it is whole (no bytes moved); ``g`` itself where it is placed so
    already, or is a plain tensor.  The update's operations are pointwise,
    so the new parameter and both moments then come out placed as ``p``,
    ``m`` and ``v`` are: their specs, as the reference's ``out_shardings``
    pin them (ROADMAP C.20).  Placed by DTensor's rules instead, a new leaf
    kept the gradient's split (a whole-table embedding split on its hidden
    dim, deepseek-v3-671b's ``wq_b`` split over the data axis) or its
    pending sum (``wq_b`` over the pod axis, all-reduced at each use), and
    would be gathered after the update: the parameter's and both moments'
    bytes (8-12 B an element), where this moves the gradient's (4 B).  A
    MoE expert weight's gradient arrives scattered over the data axes
    (``sharding.grad_split_as``, C.19) and is gathered a slice of rows at
    a time, one slice's bytes at a time."""
    from torch.distributed.tensor import DTensor
    if not (isinstance(g, DTensor) and isinstance(p, DTensor)) or \
            tuple(g.placements) == tuple(p.placements):
        return g
    return g.redistribute(g.device_mesh, p.placements)


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: AdamWConfig):
    """Returns (new_params, new_state, grad_norm); the inputs stay as they
    are.  A leaf is updated ``_rows_per_slice`` leading rows at a time and
    each slice written into the new leaf, m and v: the same operations on
    each element as on the whole leaf, so the same bits, without fp32
    temporaries the size of the whole leaf (a stacked expert leaf is
    (layers, experts, d, ff)).  A DTensor gradient is placed as its
    parameter before the update, a sliced leaf's a slice at a time
    (``_gathered``), so that the new leaves come out placed as the old."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0) \
        if cfg.grad_clip > 0 else torch.ones((), device=gnorm.device)
    lr = _schedule(cfg, step)
    bc1 = 1 - torch.pow(cfg.b1, step.float())
    bc2 = 1 - torch.pow(cfg.b2, step.float())
    mdt = getattr(torch, cfg.moment_dtype)

    def upd(p, g, m, v):
        g32 = g.float() * clip
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g32
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g32 * g32
        update = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        if p.dim() >= 2:                      # decoupled weight decay
            update = update + cfg.weight_decay * p.float()
        newp = p.float() - lr * update
        return newp.to(p.dtype), m32.to(mdt), v32.to(mdt)

    def leaf(p, g, m, v):
        n = p.shape[0] if p.dim() else 0
        rows = _rows_per_slice(p, g, m, v)
        if rows >= n:
            return upd(p, _gathered(g, p), m, v)
        out = None
        for a in range(0, n, rows):
            b = min(a + rows, n)
            part = upd(p[a:b], _gathered(g[a:b], p), m[a:b], v[a:b])
            if out is None:
                out = [_new_rows(t, n) for t in part]
            for o, t in zip(out, part):
                _write_rows(o, a, t)
            del part                 # this slice's fp32 copies go first
        return tuple(out)

    out = [leaf(p, g, m, v) for p, g, m, v in
           zip(leaves(params), leaves(grads), leaves(state["m"]),
               leaves(state["v"]))]
    new = [unflatten(params, [o[i] for o in out]) for i in range(3)]
    return new[0], {"m": new[1], "v": new[2], "step": step}, gnorm
