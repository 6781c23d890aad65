"""The statistics and the trace reading, on hand-made samples."""
from __future__ import annotations

import os

import pytest

from tidebench import measures
from tidebench.roofline import HBM_BYTES_PER_S, least_seconds, span_roofline
from tidebench.trace import DeviceTrace


def test_p95_by_nearest_rank():
    assert measures.p95([]) is None
    assert measures.p95([5.0]) == 5.0
    assert measures.p95(range(1, 21)) == 19           # 19 of 20 at or below
    assert measures.p95(list(range(100, 0, -1))) == 95
    assert measures.p95([1] * 95 + [50] * 5) == 1


def test_space_amp_is_the_mean_of_ratios():
    assert measures.space_amp([(300, 100), (200, 100), (120, 0)]) == 2.5
    assert measures.space_amp([]) is None


def test_disk_bytes_counts_allocated_blocks(tmp_path):
    (tmp_path / "a").write_bytes(b"x" * 10000)
    sub = tmp_path / "d"
    sub.mkdir()
    (sub / "b").write_bytes(b"y" * 5000)
    want = sum(os.lstat(p).st_blocks * 512
               for p in (tmp_path / "a", sub / "b"))
    assert measures.disk_bytes(str(tmp_path)) == want >= 15000


def test_write_amp_from_wchar(tmp_path):
    before = measures.wchar()
    if before is None:
        pytest.skip("/proc/self/io is not readable here")
    with open(tmp_path / "f", "wb") as f:
        f.write(b"z" * 100000)
    assert measures.wchar() - before >= 100000
    assert measures.ratio(150000, 100000) == 1.5
    assert measures.ratio(None, 100000) is None


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


TRACE = [
    _ev("user_annotation", "tidebench.window", 0, 1000),
    _ev("user_annotation", "tidebench.multi_exists", 100, 300),
    _ev("user_annotation", "tidebench.kernel.bloom_probe", 150, 100),
    _ev("cuda_runtime", "cudaLaunchKernel", 160, 5, corr=1),
    _ev("kernel", "bloom_ragged_kernel", 200, 10, corr=1),
    _ev("cuda_runtime", "cudaMemcpyAsync", 140, 5, corr=2),
    _ev("gpu_memcpy", "Memcpy HtoD", 145, 20, corr=2),
    _ev("user_annotation", "tidebench.put_many", 500, 400),
    _ev("kernel", "outside_window", 2000, 50, corr=3),
]


def test_trace_busy_gaps_and_spans():
    dt = DeviceTrace(TRACE)
    assert dt.window == (0, 1000)
    assert dt.busy_s() == pytest.approx(30e-6)
    assert dt.device_ops() == [["Memcpy HtoD", 20e-6],
                               ["bloom_ragged_kernel", 10e-6]]
    gaps = dict(dt.idle_gaps())
    assert sum(gaps.values()) == pytest.approx(970e-6)
    assert gaps["put_many"] == pytest.approx(400e-6)
    assert gaps["kernel.bloom_probe"] == pytest.approx(100e-6 - 25e-6)
    assert gaps["multi_exists"] == pytest.approx(200e-6 - 5e-6)
    assert gaps["between calls"] == pytest.approx(300e-6)
    host = dt.host_s_by_span()
    assert host == pytest.approx({"between calls": 300e-6,
                                  "multi_exists": 200e-6,
                                  "kernel.bloom_probe": 100e-6,
                                  "put_many": 400e-6})
    assert dt.device_s_by_span() == {"kernel.bloom_probe": 10e-6}


def test_span_roofline_is_least_time_over_kernel_time():
    import numpy as np
    h = np.array([1, 2, 3, 4], np.uint32)
    bits = np.zeros(64, np.uint32)          # every probe stops at once
    call = (h, h | 1, np.zeros(4, np.int32), np.full(4, 2048, np.uint32),
            bits, 7)
    run = {"trace": DeviceTrace(TRACE), "kernel_calls": {"bloom_probe": [call]}}
    nbytes = 16 * 4 + 4 + 4 * 4              # 4 distinct first words at most
    share = span_roofline(run, "bloom_probe")
    assert 0 < share <= 100 * least_seconds(nbytes, 6 * 7 * 4) / 10e-6
    assert least_seconds(HBM_BYTES_PER_S, 0) == 1.0
    assert span_roofline({"trace": None, "kernel_calls": {}}, "lookup") is None


def test_fsync_tree_counts_every_file(tmp_path):
    (tmp_path / "a").write_bytes(b"x" * 100)
    (tmp_path / "d").mkdir()
    (tmp_path / "d" / "b").write_bytes(b"y")
    assert measures.fsync_tree(str(tmp_path)) == 2
    assert measures.fsync_tree(str(tmp_path / "missing")) == 0
