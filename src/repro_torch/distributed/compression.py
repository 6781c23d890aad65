"""Gradient compression for the slow all-reduce across pods or nodes, the
JAX package's ``distributed/compression.py``.

int8 quantization with per-tensor scales and error feedback: the gradient
all-reduce moves 4× fewer bytes (fp32 → int8), and the quantization
residual is fed back into the next step so the compression is unbiased over
time (Seide et al. / 1-bit-SGD style error feedback).

The arithmetic is the reference's, in fp32: the scale is max|x| / 127 +
1e-12 and the rounding is half to even (``torch.round``, as ``jnp.round``).
``make_error_feedback_compressor`` feeds ``make_train_step``'s
``compress_grads`` hook, on plain tensors and on DTensors alike (a
DTensor's max is taken over every shard); ``compressed_psum`` is the
reference's quantize → integer psum → dequantize at the max scale, over a
process group where the reference names a ``shard_map`` axis, for a
data-parallel step's per-rank gradients.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.tree import leaves, tree_map, unflatten


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x → (q int8, scale fp32 scalar)."""
    xf = x.float()
    scale = xf.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def make_error_feedback_compressor():
    """Returns (compress(grads, residuals) -> (grads', residuals'),
    init_residuals(grads_like))."""

    def init_residuals(grads):
        return tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                        grads)

    def compress(grads, residuals):
        out, res = [], []
        for g, r in zip(leaves(grads), leaves(residuals), strict=True):
            target = g.float() + r
            deq = dequantize_int8(*quantize_int8(target))
            out.append(deq.to(g.dtype))
            res.append(target - deq)
        return unflatten(grads, out), unflatten(grads, res)

    return compress, init_residuals


def compressed_psum(grads, group=None):
    """int8-quantized sum over ``group`` (a process group; None is the
    default group) of each rank's own gradients: quantize → int32
    ``all_reduce(SUM)`` of the integers, ``all_reduce(MAX)`` of the scales
    → dequantize with the max scale.  The integers carry 4× fewer bytes than
    fp32 would.  The leaves are plain tensors, one rank's partial gradients
    (a data-parallel step on its shard of the batch), as ``shard_map`` hands
    the reference's function each device's block.  A DTensor is refused:
    it stands for the global gradient (DTensor's backward leaves a
    replicated leaf's sum pending, as a ``Partial`` placement, and completes
    it itself on first use), so a second sum would count each shard or
    replica again; apply the error-feedback compressor alone to it."""
    from torch.distributed.tensor import DTensor

    def one(g):
        if isinstance(g, DTensor):
            raise TypeError("compressed_psum sums each rank's own gradients; "
                            "a DTensor gradient stands for the global one")
        q, s = quantize_int8(g)
        qsum = q.to(torch.int32)
        smax = s.reshape(1)
        dist.all_reduce(qsum, op=dist.ReduceOp.SUM, group=group)
        dist.all_reduce(smax, op=dist.ReduceOp.MAX, group=group)
        return (qsum.float() * smax[0]).to(g.dtype)

    return tree_map(one, grads)
