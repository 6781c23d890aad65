"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, which the kernel wrappers load with
``ctypes``.  The library's file name carries a hash of its source and of the
compiler flags, so an edited source builds anew and an unchanged one loads
what an earlier process built.  ``build_all`` starts one ``nvcc`` per source,
all together, and waits for them.

Libraries go to ``build/repro_torch/`` at the root of the checkout (listed in
``.gitignore``), or to ``$REPRO_TORCH_BUILD_DIR`` when that is set.  Nothing
here runs at import time: the CPU tests import every module of the package on
machines that have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("bloom_check", "optimistic_lookup", "tide_attention", "ssd_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
count_lock = threading.Lock()     # guards every launch and dispatch count


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build from source "
                       "with the CUDA toolkit (set NVCC to its path)")


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"{name}-{digest[:16]}.so"


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every named source that has no library yet, one ``nvcc``
    process each, all started together.  Returns the compiler's output per
    source ("" for one already built); raises if any compile fails."""
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            jobs[name] = None
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out)
    logs, failed = {}, []
    for name, job in jobs.items():
        if job is None:
            logs[name] = ""
            continue
        proc, tmp, out = job
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{logs[name]}")
            continue
        os.replace(tmp, out)           # atomic: a concurrent loader never
                                       # sees a half-written library
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build_all((name,))
            lib = ctypes.CDLL(str(path))
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({lib.error_string(err).decode()})")


def count_launch(counts: dict, *names: str) -> None:
    """Add one to each ``counts[name]``, under one lock: a sharded store's
    threads launch at once, and ``+=`` on a dict entry is a read, an add
    and a store that another thread can interleave and lose."""
    with count_lock:
        for name in names:
            counts[name] += 1


def stream_arg(t) -> ctypes.c_void_p:
    """PyTorch's current stream on the tensor's card, for a launch."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check_tensor(t, name: str, dtype, device, n=None, *, shape=None) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on the card
    ``device`` of shape ``shape`` or, without one, 1-D (with ``n`` entries
    when given): what a kernel takes."""
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name} must lie on the card {device}, "
                         f"not on {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, not {t.dtype}")
    if shape is not None:
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must have shape {tuple(shape)}, not "
                             f"{tuple(t.shape)}")
    elif t.dim() != 1 or (n is not None and t.shape[0] != n):
        raise ValueError(f"{name} must have shape ({n},), not "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def on_card(t, what: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (take the plain version) and for a meta tensor, which holds no data:
    the dry run traces the plain version's shapes on it.  Any other device
    raises."""
    if t.device.type in ("cuda", "cpu", "meta"):
        return t.device.type == "cuda"
    raise ValueError(f"no {what} for tensors on {t.device}")
