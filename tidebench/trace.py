"""Spans around the program's calls, and the device trace of a window.

``Recorder.span`` times each call on the host clock, always; with tracing on
it also opens a ``torch.profiler.record_function`` range of the same name,
so that the device trace can say which call launched which operation and
what the host was doing while the device stood idle.  The trace is read from
the profiler's Chrome-format export: device operations are the events of the
``kernel``, ``gpu_memcpy`` and ``gpu_memset`` categories, and an operation
belongs to the span in which the host launched it (its runtime call, joined
by the correlation id).
"""
from __future__ import annotations

import contextlib
import json
import time
from bisect import bisect_right

PREFIX = "tidebench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Recorder:
    def __init__(self, trace: bool = False):
        self.trace = trace
        self.spans: dict[str, list[float]] = {}     # name -> durations (s)
        self.window_s = 0.0
        self.window_t0 = None
        self._prof = None

    @contextlib.contextmanager
    def span(self, name: str):
        rf = None
        if self.trace:
            import torch
            rf = torch.profiler.record_function(PREFIX + name)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.setdefault(name, []).append(time.perf_counter() - t0)
            if rf is not None:
                rf.__exit__(None, None, None)

    def window_elapsed(self) -> float:
        return time.perf_counter() - self.window_t0

    @contextlib.contextmanager
    def window(self):
        """The measured window; under tracing, the profiled one."""
        if self.trace:
            import torch
            from torch.profiler import ProfilerActivity, profile
            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            self._prof.__enter__()
        self.window_t0 = time.perf_counter()
        try:
            with self.span("window"):
                yield self
        finally:
            if self.trace and torch.cuda.is_available():
                torch.cuda.synchronize()
            self.window_s = time.perf_counter() - self.window_t0
            if self._prof is not None:
                self._prof.__exit__(None, None, None)

    def export(self, path: str) -> None:
        self._prof.export_chrome_trace(path)


def _union(intervals) -> list[tuple[float, float]]:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class DeviceTrace:
    """What a Chrome-format profiler trace says of the device (times in
    seconds)."""

    def __init__(self, events: list[dict]):
        xs = [e for e in events if e.get("ph") == "X"]
        self.ops = [e for e in xs if e.get("cat") in DEVICE_CATS]
        launches = {}
        for e in xs:
            corr = (e.get("args") or {}).get("correlation")
            if e.get("cat") in ("cuda_runtime", "cuda_driver") and \
                    corr is not None:
                launches[corr] = e["ts"]
        self.launch_ts = launches
        self.spans = sorted(
            ((e["ts"], e["ts"] + e["dur"], e["name"][len(PREFIX):])
             for e in xs if e.get("cat") == "user_annotation"
             and e.get("name", "").startswith(PREFIX)),
            key=lambda s: s[0])
        win = [s for s in self.spans if s[2] == "window"]
        self.window = (win[0][0], win[0][1]) if win else None
        self._inner = [sp for sp in self.spans if sp[2] != "window"]
        self._inner_starts = [sp[0] for sp in self._inner]

    @classmethod
    def load(cls, path: str) -> "DeviceTrace":
        with open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    def _in_window(self, e) -> bool:
        if self.window is None:
            return True
        return self.window[0] <= e["ts"] <= self.window[1]

    def busy_intervals(self) -> list[tuple[float, float]]:
        return _union((e["ts"], e["ts"] + e["dur"]) for e in self.ops
                      if self._in_window(e))

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def innermost(self, ts: float):
        """The innermost harness span (not the window) the host was in at
        ``ts``, or None."""
        name, best = None, None
        for s, e, nm in self._inner[:bisect_right(self._inner_starts, ts)]:
            if s <= ts <= e and (best is None or s >= best):
                best, name = s, nm
        return name

    def host_timeline(self) -> list[tuple[float, float, str]]:
        """The window cut into (start, end, name) segments, each named by
        the innermost harness span the host was in ("between calls" where
        it was in none)."""
        if self.window is None:
            return []
        bounds = {self.window[0], self.window[1]}
        for s, e, _ in self._inner:
            bounds |= {s, e}
        cuts = sorted(b for b in bounds
                      if self.window[0] <= b <= self.window[1])
        return [(a, b, self.innermost((a + b) / 2) or "between calls")
                for a, b in zip(cuts, cuts[1:])]

    def host_s_by_span(self) -> dict[str, float]:
        """Host seconds of the window by innermost harness span."""
        out: dict[str, float] = {}
        for a, b, name in self.host_timeline():
            out[name] = out.get(name, 0.0) + (b - a) / 1e6
        return out

    def device_ops(self, top: int = 10) -> list[list]:
        by_name: dict[str, float] = {}
        for e in self.ops:
            if self._in_window(e):
                by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
        rows = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return [[name, us / 1e6] for name, us in rows]

    def idle_gaps(self, top: int = 10) -> list[list]:
        """Idle device time inside the window, by what the host was doing
        meanwhile: each gap split over the harness spans it overlaps."""
        if self.window is None:
            return []
        gaps, t = [], self.window[0]
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, min(s, self.window[1])))
            t = max(t, e)
        if t < self.window[1]:
            gaps.append((t, self.window[1]))
        by_name: dict[str, float] = {}
        timeline = self.host_timeline()
        i = 0
        for gs, ge in gaps:
            while i < len(timeline) and timeline[i][1] <= gs:
                i += 1
            j = i
            while j < len(timeline) and timeline[j][0] < ge:
                a, b, name = timeline[j]
                over = min(b, ge) - max(a, gs)
                if over > 0:
                    by_name[name] = by_name.get(name, 0.0) + over
                j += 1
        rows = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return [[name, us / 1e6] for name, us in rows]

    def device_s_by_span(self, cats=("kernel",)) -> dict[str, float]:
        """Device seconds of the operations launched inside each harness
        span, by the span's name (the innermost span)."""
        out: dict[str, float] = {}
        for e in self.ops:
            if e.get("cat") not in cats or not self._in_window(e):
                continue
            ts = self.launch_ts.get((e.get("args") or {}).get("correlation"))
            name = None if ts is None else self.innermost(ts)
            if name is not None:
                out[name] = out.get(name, 0.0) + e["dur"] / 1e6
        return out
