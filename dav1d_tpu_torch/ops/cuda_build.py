"""Build and load the port's hand-written CUDA kernels.

Each csrc/<name>.cu has a plain C interface and is compiled by nvcc for
Hopper (sm_90a) into build/dav1d_tpu_torch/lib<name>.so at the repo
root, then loaded with ctypes. A library is rebuilt when its source or
a shared header (csrc/*.cuh) is newer than the .so. A missing nvcc or
a failed build raises: the port never falls back to the plain versions
for CUDA tensors. Also the helpers the wrappers share: tensor checks
and the cutting of a class-sorted job table into kernel blocks.
"""
from __future__ import annotations

import ctypes as ct
import os
import shutil
import subprocess
import threading
import time

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(os.path.dirname(_PKG), "build", "dav1d_tpu_torch")
ARCH = "arch=compute_90a,code=sm_90a"

_LOCK = threading.Lock()
_LIBS = {}
_READY = set()      # (library handle id, CUDA device) set up (per_device)
_COUNT_LOCK = threading.Lock()


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built (put the CUDA toolkit's bin on PATH)")
    return path


def lib_path(name: str) -> str:
    return os.path.join(BUILD, f"lib{name}.so")


def _stale(name: str) -> bool:
    """The library is missing, or older than its source or one of the
    shared headers (csrc/*.cuh)."""
    so = lib_path(name)
    if not os.path.exists(so):
        return True
    srcs = [os.path.join(CSRC, f"{name}.cu")] + \
        [os.path.join(CSRC, f) for f in os.listdir(CSRC)
         if f.endswith(".cuh")]
    return max(os.path.getmtime(s) for s in srcs) > os.path.getmtime(so)


def _command(name: str, out: str) -> list:
    return [nvcc(), "-gencode", ARCH, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", out,
            os.path.join(CSRC, f"{name}.cu")]


def build(names) -> dict:
    """Compile every stale library of `names` with one nvcc process per
    source, all started together. Returns {name: {"seconds", "ptxas"}}
    for the libraries this call built (ptxas: nvcc's -Xptxas -v log)."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return {}
    os.makedirs(BUILD, exist_ok=True)
    procs = []
    for n in todo:
        tmp = f"{lib_path(n)}.{os.getpid()}.tmp"
        procs.append((n, tmp, time.perf_counter(), subprocess.Popen(
            _command(n, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    built = {}
    errors = []
    for n, tmp, t0, p in procs:
        out, err = p.communicate()
        if p.returncode != 0:
            errors.append(f"nvcc {n}.cu failed (exit {p.returncode}):\n"
                          f"{out}{err}")
            continue
        os.replace(tmp, lib_path(n))
        built[n] = {"seconds": time.perf_counter() - t0, "ptxas": err}
    if errors:
        raise RuntimeError("\n".join(errors))
    return built


def check_tensor(t, name, dtype, device, shape=None, ndim=2):
    """Raise unless `t` is a contiguous `dtype` tensor on `device` of
    `shape` (or, with shape None, of `ndim` dimensions): what a kernel
    given t.data_ptr() assumes."""
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} dtype {t.dtype}, expected {dtype}")
    want = f"{ndim}-d" if shape is None else str(tuple(shape))
    if t.dim() != ndim if shape is None else tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)}, expected {want}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def cut_blocks(cls, cap):
    """Block rows [cls, first, count] (int32, (nb, 3)) over a sorted
    class array: each run of one class cut into blocks of at most cap
    jobs (cap: per element, constant over a run), the last one
    ragged. The kernels' block tables start from it."""
    if not len(cls):
        return np.zeros((0, 3), np.int32)
    start = np.flatnonzero(np.concatenate([[True], cls[1:] != cls[:-1]]))
    end = np.append(start[1:], len(cls))
    cap = cap[start]
    nb = -(-(end - start) // cap)
    k = np.arange(nb.sum()) - np.repeat(np.cumsum(nb) - nb, nb)
    first = np.repeat(start, nb) + k * np.repeat(cap, nb)
    count = np.minimum(np.repeat(cap, nb), np.repeat(end, nb) - first)
    return np.stack([np.repeat(cls[start], nb), first, count],
                    axis=1).astype(np.int32)


def load_library(name: str) -> ct.CDLL:
    """The ctypes handle of lib<name>.so, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = _LIBS[name] = ct.CDLL(lib_path(name))
        return lib


def per_device(lib, setup):
    """`lib` after `setup(lib)` (a library's __constant__ tables and
    kernel attributes, which each CUDA device holds for itself) has run
    once on the current CUDA device: a wrapper passes its handle
    through here before each launch."""
    import torch
    key = (id(lib), torch.cuda.current_device())
    if key not in _READY:
        with _LOCK:
            if key not in _READY:
                setup(lib)
                _READY.add(key)
    return lib


def count_launch(counts, name, n=1):
    """Add n to a module's LAUNCHES[name], where its wrapper launched
    its kernel: under a lock, as the Stage-B workers launch at once and
    `+=` on a dict entry is no atomic step."""
    with _COUNT_LOCK:
        counts[name] += n


def launch_stream(device):
    """The handle of `device`'s current stream, on which a wrapper
    launches its kernel. The libraries launch in the current CUDA
    device's context, so this raises unless `device` is that device:
    a caller on another card enters device_guard(device) first."""
    import torch
    current = torch.cuda.current_device()
    if device.index != current:
        raise RuntimeError(
            f"kernel launch for tensors on {device} while cuda:{current} "
            f"is the current device: enter device_guard({device}) first")
    return torch.cuda.current_stream(device).cuda_stream


def device_guard(device):
    """The context in which a wrapper launches on `device`: that CUDA
    device made current (the libraries launch on the current device's
    context), or nothing for a CPU device."""
    import contextlib
    import torch
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
