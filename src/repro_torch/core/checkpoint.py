"""Fault-tolerant checkpointing on the Tidehunter engine, the JAX package's
``core/checkpoint.py`` over the port's ``TideDB``.

Checkpoints are the framework's hash-keyed, KB-to-MB-value workload — the
paper's exact target.  Each leaf of the train state is cut into chunks of
``chunk_bytes``, and each chunk is one WAL value keyed by
blake2b(tag ‖ step ‖ path ‖ part); a JSON manifest per step names every
leaf's dtype, shape and part count; epoch-based pruning retires old steps
at segment granularity (epoch == training step).

Keys, path strings, chunking, the manifest and retention are the
reference's, so either package restores the other's checkpoints.  Leaves
cross as raw bytes through ``torch.frombuffer``: bf16 leaves too, whose
dtype string stays the reference's ``"bfloat16"`` (numpy has no bf16 of its
own, and the card's machine has no ``ml_dtypes``).
"""
from __future__ import annotations

import hashlib
import json
import threading
import time
from typing import Optional

import torch

from .tidestore import DbConfig, KeyspaceConfig, TideDB
from .tidestore.wal import WalConfig
from .tree import leaves, leaves_with_path, path_str, tree_map, unflatten


def _key(tag: str, step: int, path: str, part: int = 0) -> bytes:
    return hashlib.blake2b(f"{tag}/{step}/{path}/{part}".encode(),
                           digest_size=32).digest()


def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a dtype ("float32", "int32", "bfloat16", ...)."""
    return str(dtype).removeprefix("torch.")


def _to_bytes(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _from_bytes(raw: bytearray, dtype: str, shape) -> torch.Tensor:
    dt = getattr(torch, dtype)
    if not raw:
        return torch.empty(shape, dtype=dt)
    return torch.frombuffer(raw, dtype=torch.uint8).view(dt).reshape(shape)


class CheckpointManager:
    def __init__(self, directory: str, *, keep_last: int = 3,
                 chunk_bytes: int = 8 * 1024 * 1024,
                 background: bool = True, device: str = "cuda"):
        cfg = DbConfig(
            keyspaces=[KeyspaceConfig("ckpt", n_cells=64,
                                      dirty_flush_threshold=256),
                       KeyspaceConfig("meta", n_cells=4)],
            wal=WalConfig(segment_size=64 * 1024 * 1024,
                          background=background),
            index_wal=WalConfig(segment_size=8 * 1024 * 1024,
                                background=background),
            background_snapshots=background,
            cache_bytes=0,
            device=device,
        )
        self.db = TideDB(directory, cfg)
        self.device = torch.device(device)
        self.keep_last = keep_last
        self.chunk_bytes = chunk_bytes
        self._lock = threading.Lock()
        self._async_thread: Optional[threading.Thread] = None

    # ---------------------------------------------------------------- save
    def save(self, step: int, state, wait: bool = True) -> None:
        """Async by default: the device→host copy happens synchronously,
        WAL writes run in a background thread (the paper's
        synchronous/asynchronous split applied to checkpointing)."""
        # A copy even from host tensors: the writer must not see the
        # caller's later in-place updates.  A DTensor is saved whole, as
        # the reference saves a sharded array's global value.
        from torch.distributed.tensor import DTensor
        host_state = tree_map(
            lambda t: (t.full_tensor() if isinstance(t, DTensor) else t)
            .detach().to("cpu", copy=True), state)
        if self._async_thread is not None:
            self._async_thread.join()

        def write():
            self._write_step(step, host_state)

        self._async_thread = threading.Thread(target=write, daemon=True)
        self._async_thread.start()
        if wait:
            self._async_thread.join()

    def _write_step(self, step: int, host_state) -> None:
        with self._lock:
            manifest = []
            for path, leaf in leaves_with_path(host_state):
                pstr = path_str(path)
                raw = _to_bytes(leaf)
                nparts = max(1, (len(raw) + self.chunk_bytes - 1)
                             // self.chunk_bytes)
                for part in range(nparts):
                    chunk = raw[part * self.chunk_bytes:
                                (part + 1) * self.chunk_bytes]
                    self.db.put(_key("ckpt", step, pstr, part), chunk,
                                keyspace="ckpt", epoch=step)
                # A scalar is recorded as shape [1], as the reference's
                # np.ascontiguousarray reports it.
                manifest.append({"path": pstr,
                                 "dtype": _dtype_name(leaf.dtype),
                                 "shape": list(leaf.shape) or [1],
                                 "parts": nparts})
            self.db.put(_key("manifest", step, "", 0),
                        json.dumps({"step": step, "leaves": manifest,
                                    "time": time.time()}).encode(),
                        keyspace="meta", epoch=step)
            self.db.put(_key("latest", 0, "", 0),
                        str(step).encode(), keyspace="meta", epoch=step)
            self.db.flush()
            self._prune(step)

    def _prune(self, newest_step: int) -> None:
        """Epoch pruning (§4.4): whole WAL segments whose steps all fall
        below the retention horizon are dropped — no value is rewritten
        (``stats()["segments_pruned"]`` counts them)."""
        steps = self.list_steps()
        keep = set(sorted(steps)[-self.keep_last:])
        horizon = min(keep) if keep else 0
        self.db.prune_epochs_below(horizon)

    # ---------------------------------------------------------------- load
    def latest_step(self) -> Optional[int]:
        raw = self.db.get(_key("latest", 0, "", 0), keyspace="meta")
        return int(raw) if raw is not None else None

    def list_steps(self) -> list[int]:
        steps = []
        latest = self.latest_step()
        if latest is None:
            return steps
        for s in range(max(0, latest - 100), latest + 1):
            if self.db.exists(_key("manifest", s, "", 0), keyspace="meta"):
                steps.append(s)
        return steps

    def restore(self, like, step: Optional[int] = None, shardings=None):
        """Rebuild the tree ``like`` as tensors on the manager's device →
        (state, step), or (None, None) without a checkpoint.  Each leaf
        takes the manifest's dtype and its template's shape, whose element
        count must be the manifest's (a scalar reads back as a scalar).
        With ``shardings`` (a tree of ``distributed.sharding.NamedSharding``
        of ``like``'s structure) each leaf is placed as a DTensor on its
        mesh and placements: a restart onto another topology.  The stored
        bytes are the same either way."""
        if self._async_thread is not None:
            self._async_thread.join()
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        raw = self.db.get(_key("manifest", step, "", 0), keyspace="meta")
        if raw is None:
            return None, None
        by_path = {m["path"]: m for m in json.loads(raw)["leaves"]}

        def load(path, leaf):
            pstr = path_str(path)
            m = by_path[pstr]
            buf = bytearray()
            for part in range(m["parts"]):
                chunk = self.db.get(_key("ckpt", step, pstr, part),
                                    keyspace="ckpt")
                if chunk is None:
                    raise KeyError(f"missing checkpoint chunk {pstr}/{part}")
                buf += chunk
            t = _from_bytes(buf, m["dtype"], m["shape"])
            if t.numel() != leaf.numel():
                raise ValueError(f"checkpoint leaf {pstr} has shape "
                                 f"{m['shape']}, the template "
                                 f"{tuple(leaf.shape)}")
            return t.reshape(leaf.shape).to(self.device)

        state = unflatten(like, [load(p, leaf) for p, leaf in
                                 leaves_with_path(like)])
        if shardings is not None:
            from repro_torch.distributed.sharding import NamedSharding, place
            state = unflatten(like, [
                place(t, sh) for t, sh in zip(
                    leaves(state),
                    leaves(shardings,
                           is_leaf=lambda x: isinstance(x, NamedSharding)),
                    strict=True)])
        return state, step

    def stats(self) -> dict:
        return self.db.stats()

    def close(self) -> None:
        if self._async_thread is not None:
            self._async_thread.join()
        self.db.close()
