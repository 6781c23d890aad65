"""The store driver: one client drives ``repro_torch``'s ``TideDB`` through a
workload's round program, and the reference judges every answer.

A workload file gives the program (see ``tidebench/README.md``):

- ``preload``: keys written before the window in batches, then ``flush``
  (cells keep their flushed index on disk) or ``reopen`` (flush, close and
  open again, so every cell starts UNLOADED); either way every file of the
  store is written through to its disk before the window opens, so that no
  write-back of the set-up's data lands in it;
- ``round``: steps run in order, again and again until the window closes,
  each ``put`` (``n`` fresh keys in one ``put_many``), ``exists`` or ``get``
  (``n`` keys, ``present_share`` of them drawn from the written keys, from
  ``all`` of them or only the ``retained`` epochs', the rest never written)
  or ``prune`` (one ``prune_step``); a step with ``every: k`` runs in every
  k-th round only;
- ``reopen_check``: after the window, the store is closed and opened again,
  and ``present`` written keys (the last batch among them) and ``absent``
  keys never written are read back;
- ``space_sample_s``: the store directory's disk bytes and the live bytes
  are sampled between calls every so many seconds of the window, and once
  at its end (none: no samples, for a cell that reports no space).

A configuration's ``epoch_keys`` (writes per epoch; none: writes carry no
epoch) and its ``prune.retain_epochs`` say which writes must read back.

The window closes at a call boundary once ``seconds`` have passed.  Answers
are judged once it has closed, each against what the reference held when the
call was made.
"""
from __future__ import annotations

import contextlib
import gc
import shutil
import sys
import tempfile
import time
import traceback

from ..measures import disk_bytes, fsync_tree, wchar
from ..reference import ReferenceStore
from ..trace import Recorder
from ..traffic import Traffic

COUNT_OF = {"get": "gets", "exists": "exists"}


def db_config(config: dict, device: str | None = None):
    """``DbConfig`` from a configuration's ``store`` section: nested
    sections build ``KeyspaceConfig``, ``WalConfig`` and ``PruneOptions``,
    every other key is a field of ``DbConfig``."""
    from repro_torch.core.tidestore import (DbConfig, KeyspaceConfig,
                                            PruneOptions, WalConfig)
    kw = {}
    for key, val in config["store"].items():
        if key == "keyspaces":
            kw[key] = [KeyspaceConfig(**ks) for ks in val]
        elif key in ("wal", "index_wal"):
            kw[key] = WalConfig(**val)
        elif key == "prune":
            kw[key] = PruneOptions(**val)
        else:
            kw[key] = val
    if device is not None:
        kw["device"] = device
    return DbConfig(**kw)


def retain_epochs(config: dict):
    return (config["store"].get("prune") or {}).get("retain_epochs")


def _warm_kernels(device: str) -> None:
    """One call of each batched read kernel on a small input, so that the
    libraries are built and loaded and the device is up before the window.
    Their launches take any size: no shape compiles."""
    import numpy as np
    from repro_torch.kernels.bloom_check.ops import probe_cells_batch
    from repro_torch.kernels.optimistic_lookup.ops import lookup_indices_batch
    q = 64
    h = np.arange(1, q + 1, dtype=np.uint32)
    probe_cells_batch(h, h | 1, np.zeros(q, np.int32),
                      np.full(q, 2048, np.uint32), np.ones(64, np.uint32),
                      k=7, device=device)
    lookup_indices_batch(h, np.arange(0, 4 * q * 8192, 8192, dtype=np.uint32),
                         window=800, device=device)


class _KernelTap:
    """With tracing on: a harness span around each call of the fused Bloom
    probe and of the batched lookup (the names the trace reads), and a copy
    of the inputs each call was given, for the byte counts."""

    def __init__(self, rec: Recorder):
        self.rec = rec
        self.calls: dict[str, list] = {"bloom_probe": [], "lookup": []}
        self._undo = []

    def __enter__(self):
        from repro_torch.kernels.bloom_check import ops as bops
        from repro_torch.kernels.optimistic_lookup import ops as lops
        self._wrap(bops, "probe_cells_batch", "bloom_probe",
                   lambda a, kw: (a[0].copy(), a[1].copy(), a[2].copy(),
                                  a[3].copy(), a[4].copy(), kw.get("k", 7)))
        self._wrap(lops, "lookup_indices_batch", "lookup",
                   lambda a, kw: (a[0].copy(), a[1].copy(),
                                  kw.get("window", 512)))
        return self

    def _wrap(self, module, attr, name, grab):
        orig = getattr(module, attr)
        rec, calls = self.rec, self.calls[name]

        def tapped(*args, **kwargs):
            calls.append(grab(args, kwargs))
            with rec.span("kernel." + name):
                return orig(*args, **kwargs)
        setattr(module, attr, tapped)
        self._undo.append((module, attr, orig))

    def __exit__(self, *exc):
        for module, attr, orig in reversed(self._undo):
            setattr(module, attr, orig)


def _dispatches() -> dict:
    from repro_torch.kernels.bloom_check import ops as bops
    from repro_torch.kernels.optimistic_lookup import ops as lops
    return {"bloom_check_ragged": bops.ragged_dispatch_count,
            "optimistic_lookup_resolve": lops.lookup_dispatch_count}


def _counters(db) -> dict:
    """The engine's counters (``Metrics``); a stand-in store has none."""
    metrics = getattr(db, "metrics", None)
    return metrics.snapshot() if metrics is not None else {}


def _cell_states(db) -> dict:
    out: dict[str, int] = {}
    table = getattr(db, "table", None)
    for _ks, cell in (table.all_cells() if table is not None else ()):
        out[cell.state.name] = out.get(cell.state.name, 0) + 1
    return out


def run(config: dict, workload: dict, seed: int, seconds: float, *,
        trace: bool = False, device: str | None = None, store_factory=None,
        max_rounds: int | None = None, t_start: float | None = None) -> dict:
    """Run one cell once and return what the metric readers read.

    ``store_factory(path)`` opens the store (by default ``TideDB`` under the
    configuration); tests pass a broken one.  ``max_rounds`` ends the window
    early, for tests only."""
    t_start = time.perf_counter() if t_start is None else t_start
    cfg = db_config(config, device)
    if store_factory is None:
        from repro_torch.core.tidestore import TideDB

        def store_factory(path):
            return TideDB(path, cfg)
    kb, vb = config["key_bytes"], config["value_bytes"]
    ks = workload["keyspace"]
    epoch_keys = config.get("epoch_keys", 0)
    traffic = Traffic(seed, kb, vb)
    ref = ReferenceStore(retain_epochs(config), vb)
    bytes_by_epoch: dict[int, int] = {}

    def epoch_now() -> int:
        return 1 + traffic.written.n // epoch_keys if epoch_keys else 0

    def fresh(n):
        epoch = epoch_now()
        if epoch_keys and (traffic.written.n % epoch_keys) + n > epoch_keys:
            raise ValueError("a put batch must not straddle two epochs")
        return traffic.fresh(n, epoch), epoch

    def acknowledge(items, epoch):
        ref.put_many(items, epoch)
        bytes_by_epoch[epoch] = bytes_by_epoch.get(epoch, 0) + \
            len(items) * (kb + vb)

    def live_bytes() -> int:
        floor = ref.epoch_floor()
        return sum(b for e, b in bytes_by_epoch.items()
                   if e == 0 or e >= floor)

    workdir = tempfile.mkdtemp(prefix="tidebench-")
    path = workdir + "/store"
    db = None
    try:
        db = store_factory(path)
        pre = workload.get("preload") or {}
        for lo in range(0, pre.get("keys", 0), pre.get("batch", 4096)):
            items, epoch = fresh(min(pre["batch"], pre["keys"] - lo))
            db.put_many(items, keyspace=ks, epoch=epoch)
            acknowledge(items, epoch)
        if pre.get("then") in ("flush", "reopen"):
            db.flush()
        if pre.get("then") == "reopen":
            db.close()
            db = store_factory(path)
        if cfg.device != "cpu":
            _warm_kernels(cfg.device)
        fsync_tree(path)

        rec = Recorder(trace)
        # The set-up's objects (the reference's records among them) leave
        # the cyclic collector's scans, so that its pauses in the window do
        # not grow with the harness's bookkeeping.
        gc.freeze()
        out = _window(db, workload, seconds, max_rounds, rec, traffic, ref,
                      fresh, acknowledge, live_bytes, path)
        gc.unfreeze()
        out["setup_s"] = rec.window_t0 - t_start
        if cfg.device != "cpu":
            import torch
            out["memory_peak_bytes"] = torch.cuda.max_memory_allocated()

        checks = _judge(out.pop("answers"), ref)
        rc = workload.get("reopen_check")
        if rc:
            db.close()
            db = store_factory(path)
            checks["lost_after_reopen"] = _reopen_check(db, ks, rc, traffic,
                                                        ref, out["last_batch"])
        out["checks"] = checks
        db.close()
        db = None
        return out
    finally:
        if db is not None:
            with contextlib.suppress(Exception):
                db.close()
        shutil.rmtree(workdir, ignore_errors=True)


def _window(db, workload, seconds, max_rounds, rec, traffic, ref, fresh,
            acknowledge, live_bytes, path) -> dict:
    ks = workload["keyspace"]
    steps = workload["round"]
    out = {"rounds": 0, "puts": 0, "put_bytes": 0, "gets": 0, "get_s": 0.0,
           "exists": 0, "exists_s": 0.0, "absent_probed": 0,
           "get_blob_reads": 0, "attempted": 0, "failed": 0,
           "space_samples": [], "answers": [], "last_batch": [],
           "round_ends": []}
    kb_vb = traffic.written.key_bytes + traffic.value_bytes

    def call(name, fn, n_ops):
        out["attempted"] += n_ops
        try:
            with rec.span(name):
                return fn()
        except Exception:           # a failed call counts, the run goes on
            traceback.print_exc(file=sys.stderr)
            out["failed"] += n_ops
            return None

    tap = _KernelTap(rec) if rec.trace else contextlib.nullcontext()
    m0 = _counters(db)
    d0 = _dispatches()
    w0 = wchar()
    cells_before = _cell_states(db)
    with tap, rec.window():
        last_sample = time.perf_counter()
        sample_s = workload.get("space_sample_s")
        done = False
        while not done:
            r = out["rounds"]
            for step in steps:
                if rec.window_elapsed() >= seconds or \
                        (max_rounds is not None and r >= max_rounds):
                    done = True
                    break
                if r % step.get("every", 1) != step.get("every", 1) - 1:
                    continue
                op = step["op"]
                if op == "put":
                    items, epoch = fresh(step["n"])
                    if call("put_many", lambda: db.put_many(
                            items, keyspace=ks, epoch=epoch),
                            len(items)) is not None:
                        acknowledge(items, epoch)
                        out["puts"] += len(items)
                        out["put_bytes"] += len(items) * kb_vb
                        out["last_batch"] = [k for k, _ in items]
                elif op in ("exists", "get"):
                    lo = (traffic.first_index_of_epoch(ref.epoch_floor())
                          if step.get("from") == "retained" else 0)
                    keys = traffic.mixed(step["n"],
                                         step.get("present_share", 1.0), lo)
                    blob0 = _counters(db).get("batched_blob_reads", 0)
                    t0 = time.perf_counter()
                    got = call("multi_" + op, lambda: getattr(
                        db, "multi_" + op)(keys, keyspace=ks), len(keys))
                    dt = time.perf_counter() - t0
                    if got is not None:
                        out[COUNT_OF[op]] += len(keys)
                        out[op + "_s"] += dt
                        if op == "get":
                            out["get_blob_reads"] += _counters(db).get(
                                "batched_blob_reads", 0) - blob0
                        else:
                            out["absent_probed"] += len(keys) - int(round(
                                len(keys) * step.get("present_share", 1.0)))
                        out["answers"].append((op, keys, got,
                                               ref.epoch_floor()))
                elif op == "prune":
                    call("prune_step", db.prune_step, 0)
                else:
                    raise ValueError(f"unknown step {op!r}")
            now = time.perf_counter()
            if not done:
                out["rounds"] += 1
                out["round_ends"].append(now - rec.window_t0)
            if sample_s and now - last_sample >= sample_s:
                with rec.span("space_sample"):
                    out["space_samples"].append((disk_bytes(path),
                                                 live_bytes()))
                last_sample = now
    if sample_s:
        out["space_samples"].append((disk_bytes(path), live_bytes()))
    out["window_s"] = rec.window_s
    w1 = wchar()
    out["wchar"] = None if w0 is None or w1 is None else w1 - w0
    m1 = _counters(db)
    out["counters"] = {k: m1[k] - m0[k] for k in m1}
    d1 = _dispatches()
    out["dispatches"] = {k: d1[k] - d0[k] for k in d1}
    out["cells"] = {"before": cells_before, "after": _cell_states(db)}
    out["copy_threads"] = getattr(getattr(db, "_copy_pool", None), "threads",
                                  None)
    out["spans"] = rec.spans
    out["recorder"] = rec
    if rec.trace:
        out["kernel_calls"] = tap.calls
    return out


def _judge(answers, ref: ReferenceStore) -> dict:
    """Every answer of the window against the reference as it stood when
    the call was made (the floor of retained epochs then)."""
    wrong: dict[str, int] = {}
    for op, keys, got, floor in answers:
        if op == "exists":
            n = ref.wrong_exists(keys, got, floor)
        else:
            n = ref.wrong_values(keys, got, floor)
        name = "wrong_" + ("exists" if op == "exists" else "values")
        wrong[name] = wrong.get(name, 0) + n
    return wrong


def _reopen_check(db, ks, rc, traffic, ref, last_batch) -> int:
    """Acknowledged writes that do not read back byte-exact from the store
    closed and opened again, and never-written keys it claims."""
    lo = traffic.first_index_of_epoch(ref.epoch_floor())
    n = max(0, rc["present"] - len(last_batch))
    present = list(last_batch) + (traffic.present(n, lo) if n else [])
    absent = traffic.never_written(rc["absent"])
    got = db.multi_get(present, keyspace=ks)
    lost = ref.wrong_values(present, got)
    lost += ref.wrong_exists(present + absent,
                             db.multi_exists(present + absent, keyspace=ks))
    return lost
