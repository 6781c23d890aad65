"""GPipe-style pipeline parallelism over ``torch.distributed``, the JAX
package's ``distributed/pipeline.py`` (``shard_map`` + ``ppermute`` there,
point-to-point sends here).

Layers are partitioned into S contiguous stages along a mesh axis; a batch
is split into M microbatches that flow through the stages in a T = M+S−1
tick schedule.  Each tick every stage applies its local layer block and
forwards its activation to the next stage (a ring: the last stage's send
is unused) — the classic GPipe bubble of (S−1)/T idle ticks.  The last
stage's outputs reach every rank through a sum of the masked result over
the stage group, as the reference's ``psum`` does.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.core.tree import leaves, unflatten


def _local_layers(stacked_params, stage: int, n_stages: int):
    """This stage's contiguous L/S layers: a DTensor's local shard (dim 0
    split over the stage axis), or a slice of a full tensor."""
    from torch.distributed.tensor import DTensor
    flat = leaves(stacked_params)
    L = flat[0].shape[0]
    if L % n_stages:
        raise ValueError(f"{L} layers do not split into {n_stages} stages")
    per = L // n_stages

    def local(t):
        if isinstance(t, DTensor):
            return t.to_local()
        return t[stage * per:(stage + 1) * per]
    return unflatten(stacked_params, [local(t) for t in flat]), per


def pipeline_forward(layer_fn: Callable, stacked_params, x, *, mesh,
                     stage_axis: str = "model", n_microbatches: int = 4):
    """Run ``x`` through all layers, pipelined over ``stage_axis`` of
    ``mesh`` (a ``DeviceMesh``); every rank of the stage group calls it.

    layer_fn(layer_params, x) → x, applied once per layer.
    stacked_params: tree with leading layer dim L (L % n_stages == 0).
    x: (B, ...) with B % n_microbatches == 0, the same on every rank.
    """
    group = mesh.get_group(stage_axis)
    n_stages = mesh.size(mesh.mesh_dim_names.index(stage_axis))
    stage = mesh.get_local_rank(stage_axis)
    params_local, per = _local_layers(stacked_params, stage, n_stages)
    B = x.shape[0]
    M = n_microbatches
    if B % M:
        raise ValueError(f"batch {B} does not split into {M} microbatches")
    mb = B // M
    nxt_rank = dist.get_global_rank(group, (stage + 1) % n_stages)
    prv_rank = dist.get_global_rank(group, (stage - 1) % n_stages)

    flat = leaves(params_local)

    def local_block(h):                  # this stage's layers in order
        for i in range(per):
            h = layer_fn(unflatten(params_local, [v[i] for v in flat]), h)
        return h

    micro = x.reshape((M, mb) + tuple(x.shape[1:]))
    buf = torch.zeros_like(micro[0])
    out = torch.zeros_like(micro)
    for t in range(M + n_stages - 1):
        if stage == 0:
            h = micro[min(t, M - 1)] * (1.0 if t < M else 0.0)
        else:
            h = buf
        h = local_block(h)
        # forward to the next stage (ring; the last stage's send is unused)
        if n_stages > 1:
            nxt = torch.empty_like(h)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, h.contiguous(), nxt_rank, group),
                dist.P2POp(dist.irecv, nxt, prv_rank, group)])
            for r in reqs:
                r.wait()
            buf = nxt
        else:
            buf = h
        slot = t - (n_stages - 1)
        if stage == n_stages - 1 and slot >= 0:
            out[slot] = h
    # only the last stage holds real outputs; broadcast via masked sum
    result = out.reshape(x.shape)
    if stage != n_stages - 1:
        result = torch.zeros_like(result)
    dist.all_reduce(result, op=dist.ReduceOp.SUM, group=group)
    return result
