"""Op-level cost model: exact FLOPs and fusion-aware HBM bytes, the
counterpart of the JAX package's ``roofline/jaxpr_cost.py``.

``op_cost`` runs the function under ``FakeTensorMode`` (tensors with a
shape and a dtype and no storage: nothing is allocated, also at 671B) and
a ``TorchDispatchMode`` that sees every aten op the run dispatches, the
backward's included.  Python loops take the place of ``scan``, so every
layer's ops are seen and no trip count is needed.  It counts:

- FLOPs: matrix products exactly (2·batch·M·N·K for ``mm``, ``bmm``,
  ``addmm``, ``baddbmm``, and ``mv``/``dot``; ``matmul``, ``linear`` and
  ``einsum`` reach the dispatcher as these); everything else is negligible
  at LM scale, as in the reference.
- Bytes: the inputs and outputs of the products and of the aten
  counterparts of the reference's materialization ops (gathers and
  indexing, scatters and index writes, concatenation, reductions,
  arg-max/min, cumulative ops, sort/top-k, flip, pad, convolution), plus
  the function's inputs and outputs once (parameters read, results
  written).  Elementwise chains are assumed fused into their producers.
  An estimate of HBM traffic, good to ~2×, for the roofline's memory term.

Under fake tensors the model code takes its plain versions (a fake tensor
is on the CPU), so kernels D and E are never reached; none of the
reference's model code reaches a Pallas kernel either.  Counts are over
the global (unpartitioned) program; the roofline divides by chip count.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.tree import leaves, unflatten

aten = torch.ops.aten


def _packets(*names) -> frozenset:
    return frozenset(getattr(aten, n) for n in names if hasattr(aten, n))


_PRODUCTS = _packets("mm", "bmm", "addmm", "baddbmm", "mv", "dot")
_BYTES_OPS = _packets(
    "gather", "index", "index_select", "embedding", "take",
    "scatter", "scatter_add", "scatter_reduce", "index_put", "index_add",
    "slice_scatter", "select_scatter", "cat", "stack",
    "sum", "mean", "amax", "amin", "max", "min", "prod", "logsumexp",
    "_softmax", "_log_softmax", "argmax", "argmin",
    "cumsum", "cumprod", "cummax", "cummin", "logcumsumexp",
    "sort", "topk", "flip", "constant_pad_nd", "convolution")


def _size_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_size_bytes(v) for v in x)
    return 0


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0

    def __iadd__(self, other):
        self.flops += other.flops
        self.bytes += other.bytes
        return self

    def scaled(self, k: float) -> "Cost":
        return Cost(self.flops * k, self.bytes * k)


def _product_flops(packet, args) -> float:
    if packet in (aten.addmm, aten.baddbmm):
        args = args[1:]                          # (bias, a, b)
    a, b = args[0], args[1]
    if packet is aten.dot:
        return 2.0 * a.shape[0]
    if packet is aten.mv:
        return 2.0 * a.shape[0] * a.shape[1]
    if packet in (aten.bmm, aten.baddbmm):
        return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.cost = Cost()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        packet = func._overloadpacket
        if packet in _PRODUCTS:
            self.cost.flops += _product_flops(packet, args)
        if packet in _PRODUCTS or packet in _BYTES_OPS:
            self.cost.bytes += sum(_size_bytes(a) for a in args) + \
                sum(_size_bytes(v) for v in (kwargs or {}).values()) + \
                _size_bytes(out)
        return out


def _as_fake(tree):
    """The tensors of ``tree`` as fake CPU tensors of the same shape, dtype
    and strides (run inside ``FakeTensorMode``)."""
    def one(x):
        if not isinstance(x, torch.Tensor):
            return x
        return torch.empty_strided(tuple(x.shape), tuple(x.stride()),
                                   dtype=x.dtype, device="cpu")
    return unflatten(tree, [one(x) for x in leaves(tree)])


def op_cost(fn, *args, **kwargs) -> Cost:
    """Run ``fn`` on fake copies of its tensor arguments (any device, meta
    tensors included) and return its global Cost."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fargs, fkwargs = _as_fake(list(args)), _as_fake(dict(kwargs))
        counter = _Counter()
        with counter:
            out = fn(*fargs, **fkwargs)
        cost = counter.cost
        # top-level I/O counts once (params read, outputs written)
        cost.bytes += sum(_size_bytes(x) for x in leaves([fargs, fkwargs]))
        cost.bytes += sum(_size_bytes(x) for x in leaves(out))
    return cost
