"""Roofline terms of a dry-run cell, the JAX package's
``roofline/analysis.py`` over the H100 constants of ``hw.py``.

Three terms per (arch × shape × mesh), all in seconds per step:

    compute    = FLOPs_per_device / PEAK_FLOPS_BF16
    memory     = bytes_per_device / HBM_BW
    collective = collective_bytes_per_device / LINK_BW

FLOPs and bytes are ``op_cost``'s global counts divided by the chip count,
as the reference divides ``jaxpr_cost``'s.  Collective bytes come from the
collectives DTensor issues while the step runs on the sharded state
(``ShardedTrace``): the result bytes of every functional collective a
device runs, by kind.  The port has no HLO, so the reference's
``parse_collectives`` has no counterpart.  DTensor's sharding propagation
is not XLA's partitioner: it picks other collectives for the same specs
(and on a CPU mesh it replaces all-to-all by all-gather), so collective
bytes do not compare between the two packages.  FLOPs and specs do.
"""
from __future__ import annotations

import weakref
from dataclasses import asdict, dataclass, field

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode

from . import hw

# Functional collectives (native and legacy) → the reference's kind names.
_KINDS = {"all_gather_into_tensor": "all-gather",
          "all_gather_into_tensor_coalesced": "all-gather",
          "reduce_scatter_tensor": "reduce-scatter",
          "reduce_scatter_tensor_coalesced": "reduce-scatter",
          "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
          "all_to_all_single": "all-to-all", "broadcast": "broadcast"}


# Ops whose output the dry run's meta tensors give a storage of its own but
# a device's would not: the wrapper that lets autograd reach a collective's
# result holds that result (its meta kernel is ``empty_like``).
_WRAPS = {"_wrap_tensor_autograd"}


def _storage(t):
    """(The address of the storage that holds ``t``, that storage), or
    (None, None)."""
    try:
        s = t.untyped_storage()
    except (RuntimeError, NotImplementedError):
        return None, None
    return s._cdata, s


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return 0


@dataclass
class CollectiveStats:
    bytes_by_kind: dict = field(default_factory=dict)
    count_by_kind: dict = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    def add(self, kind: str, nbytes: int) -> None:
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) + nbytes
        self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + 1


class ShardedTrace(TorchDispatchMode):
    """A dispatch mode over one device's side of a DTensor program: it lets
    DTensor run each op (returning ``NotImplemented`` for DTensor
    arguments, as ``CommDebugMode`` does) and then sees the plain ops on
    local shards that DTensor issues.  It records each functional
    collective's result bytes by kind (``stats``), and the high-water mark
    of the bytes of local tensors that ops allocate while it is on
    (``peak_live_bytes``): an output that aliases no input is counted from
    its op until the last tensor of its storage that an op gave is freed
    (a storage once, whatever tensors hold it: a collective's result and
    the wrapper that lets autograd reach it, a view).  The fake tensors of
    the whole global shape that DTensor's sharding propagation runs each op
    on, to learn its output's shape, are no device's bytes and are not
    counted.

    Each counted storage gets a handle, and ``log`` keeps the run's
    allocations and frees in order (handle, +bytes / -bytes):
    ``handles_of`` names the storages that tensors still alive hold, and
    ``peak_without`` gives the high-water mark with some of them left out
    (the outputs a donated argument's buffer would hold)."""

    def __init__(self):
        super().__init__()
        self.stats = CollectiveStats()
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self.log: list = []
        self.allocs: dict = {}              # handle -> (op, shape, dtype)
        self._handle: dict = {}             # storage key -> handle, live
        # handle -> [bytes, tensors, {key: storage}]
        self._held: dict = {}
        # Handles of the outputs that replace donated arguments (the dry
        # run's ``_sharded_run`` sets them when the step returns), and the
        # leaves of those outputs it moved to their arguments' placements.
        self.replacing: set = set()
        self.outputs_placed: list = []

    def _count(self, o, name: str, holds=None, fresh: bool = True) -> None:
        """Count ``o``, a fresh output of op ``name``, with the storage it
        shares with a counted tensor (``holds``, the tensor it wraps).  A
        handle keeps the storages of its keys until it is freed, so that no
        storage made meanwhile takes a live key's address: keyed by address
        alone, a fresh output at the address of a storage freed under a
        live handle (a collective's result that the wrapper around it
        outlived) joined that handle and went uncounted, and a cell's
        footprint moved with the process's allocation order
        (qwen2-moe-a2.7b x train_4k x 2 x 16 x 16: 3.066e11 to 3.398e11 B
        in three runs of one tree, ``PERF.md`` §6).

        An output that aliases an input (not ``fresh``: a view, a
        ``detach``) joins the handle of a counted storage it holds, and
        counts nothing of its own: a view that keeps no reference to its
        base (one made below autograd's view tracking, or the ``detach``
        through which autograd saves a DTensor output for the backward)
        holds the storage after every tensor counted with it is gone, and
        the storage was counted as freed under it (ROADMAP C.21)."""
        found = dict(_storage(t) for t in (o, holds) if t is not None)
        found.pop(None, None)
        keys = set(found)
        handle = next((self._handle[k] for k in keys if k in self._handle),
                      None)
        if handle is None and not fresh:
            return
        if handle is None:
            n = _nbytes(o)
            handle = len(self.log)
            self.live_bytes += n
            self.log.append((handle, n))
            self.allocs[handle] = (name, tuple(o.shape),
                                   str(o.dtype).removeprefix("torch."))
            self._held[handle] = [n, 0, {}]
        held = self._held[handle]
        held[1] += 1
        held[2].update(found)
        self._handle.update(dict.fromkeys(keys, handle))
        weakref.finalize(o, self._free, handle)

    def _free(self, handle: int) -> None:
        held = self._held[handle]
        held[1] -= 1
        if held[1]:
            return
        self.live_bytes -= held[0]
        self.log.append((handle, -held[0]))
        del self._held[handle]
        for k in held[2]:
            if self._handle.get(k) == handle:
                del self._handle[k]

    def handles_of(self, tensors) -> set:
        """The handles of the live storages that hold ``tensors`` (plain
        tensors or views of them; a DTensor by its local shard); a tensor
        whose storage the trace did not count has none."""
        from torch.distributed.tensor import DTensor
        out = set()
        for t in tensors:
            if isinstance(t, DTensor):
                t = t.to_local()
            key = _storage(t)[0] if isinstance(t, torch.Tensor) else None
            if key in self._handle:
                out.add(self._handle[key])
        return out

    def peak_without(self, handles: set) -> int:
        """The high-water mark of the live bytes, the allocations named by
        ``handles`` left out; ``peak_without(set())`` is
        ``peak_live_bytes``."""
        return self._high_water(handles)[0]

    def holders_at_peak(self, handles: set, top: int = 8) -> list:
        """The allocations live at ``peak_without(handles)``'s mark, by
        (op, shape, dtype), the ``top`` largest in bytes: ``[op, shape,
        dtype, bytes each, count]``."""
        _, at = self._high_water(handles)
        live: dict = {}
        for h, n in self.log[:at + 1]:
            if h in handles:
                continue
            if n > 0:
                live[h] = n
            else:
                live.pop(h, None)
        groups: dict = {}
        for h, n in live.items():
            key = self.allocs[h] + (n,)
            groups[key] = groups.get(key, 0) + 1
        ranked = sorted(groups.items(), key=lambda kv: -kv[0][3] * kv[1])
        return [[op, list(shape), dtype, n, k]
                for (op, shape, dtype, n), k in ranked[:top]]

    def _high_water(self, handles: set) -> tuple:
        """(the high-water mark without ``handles``, the index in ``log``
        of the event that reached it, -1 if none did)."""
        live = peak = 0
        at = -1
        for i, (h, n) in enumerate(self.log):
            if h in handles:
                continue
            live += n
            if live > peak:
                peak, at = live, i
        return peak, at

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **(kwargs or {}))
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        name = func._overloadpacket.__name__
        if func.namespace in ("_c10d_functional", "c10d_functional") \
                and name in _KINDS:
            self.stats.add(_KINDS[name], _nbytes(out))
        fresh = [r.alias_info is None for r in func._schema.returns]
        outs = out if isinstance(out, (list, tuple)) else (out,)
        given = {id(a) for a in args if isinstance(a, torch.Tensor)}
        for o, new in zip(outs, fresh):
            if isinstance(o, torch.Tensor) and id(o) not in given and \
                    not isinstance(o, FakeTensor):
                self._count(o, name, args[0] if name in _WRAPS else None,
                            fresh=new)
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
        return out


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes: float
    peak_memory_per_device: float
    model_flops: float                 # 6·N·D (or 6·N_active·D)
    collectives: dict = field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / hw.PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / hw.HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / hw.LINK_BW

    @property
    def bottleneck(self) -> str:
        ts = {"compute": self.t_compute, "memory": self.t_memory,
              "collective": self.t_collective}
        return max(ts, key=ts.get)

    @property
    def model_flops_ratio(self) -> float:
        """useful FLOPs / counted FLOPs (total across chips)."""
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """MODEL_FLOPS-based MFU bound implied by the dominant term."""
        t_step = max(self.t_compute, self.t_memory, self.t_collective)
        if t_step == 0:
            return 0.0
        return (self.model_flops / self.chips / t_step) / hw.PEAK_FLOPS_BF16

    def to_dict(self) -> dict:
        d = asdict(self)
        d.update(t_compute=self.t_compute, t_memory=self.t_memory,
                 t_collective=self.t_collective, bottleneck=self.bottleneck,
                 model_flops_ratio=self.model_flops_ratio,
                 roofline_fraction=self.roofline_fraction)
        return d


def model_flops(cfg, n_tokens: int, kind: str) -> float:
    """MODEL_FLOPS = 6·N·D for training, 2·N·D for inference forward;
    MoE uses N_active."""
    from repro_torch.models import transformer as T
    n = T.param_count_exact(cfg)
    if cfg.moe is not None:
        m = cfg.moe
        routed_inactive = cfg.n_layers * 3 * cfg.d_model * m.expert_d_ff \
            * (m.n_experts - m.top_k)
        n = n - routed_inactive
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * n_tokens
