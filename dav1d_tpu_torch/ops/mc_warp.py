"""The affine warp of inter Stage B on the device: 8x8 tiles over the
native emitter's warp table.

Port of the `warp` segment of dav1d_tpu's ops/mc_fused.py `_mc_program`,
whose math is ops/mc_jobs.py `warp_jobs_fn` (reference src/mc_tmpl.c
warp_affine_8x8_c). Two implementations:

- `warp_plain`: batched torch gathers, used for CPU tensors only;
- the hand-written CUDA kernel csrc/mc_warp.cu, used for every CUDA
  tensor (`warp_cuda`: every plane of a frame in one launch).

Job row (int32, as native/interjobs.cpp writes it):

  WARP [plane, py, px, slot, dy, dx, mx, my, alpha, beta, gamma, delta]

A job writes the 8x8 tile at (py, px) from the 15x15 reference window
at (dy - 3, dx - 3), read with the per-element emu-edge clamp to the
frame's (rh, rw). mx / my already hold the emitter's -4 alpha - 7 beta
and -4 gamma - 4 delta offsets. Horizontal taps: filter row 64 + ((mx +
beta y + alpha x + 512) >> 10) for window row y < 15 and column x < 8,
rounded by 7 - ib; vertical taps: row 64 + ((my + delta y + gamma x +
512) >> 10), rounded by 7 + ib, then clipped. A valid stream's shear
(4|alpha| + 7|beta| and 4|gamma| + 4|delta| below 2^16) keeps the row
in 0..192; both versions clamp it there, as dav1d_tpu's gather does.
Tiles of one call never overlap.
"""
from __future__ import annotations

import ctypes as ct

import numpy as np
import torch

from . import mc
from .cuda_build import count_launch, launch_stream
from .mc_ref import _warp_filter, intermediate_bits

N_ROWS = 193            # rows of dav1d_mc_warp_filter


def filter_rows(jobs):
    """(n, 15, 8) horizontal and (n, 8, 8) vertical filter rows of warp
    jobs (n, 12), before the clamp to 0..192 (int64)."""
    j = jobs.long()
    mx, my, al, be, ga, de = (j[:, k, None, None] for k in range(6, 12))
    ar = torch.arange(15, device=jobs.device)
    y15, y8, x8 = ar[:, None], ar[:8, None], ar[None, :8]
    rh = 64 + ((mx + be * y15 + al * x8 + 512) >> 10)
    rv = 64 + ((my + de * y8 + ga * x8 + 512) >> 10)
    return rh, rv


def warp_plain(refs, jobs, plane, rh, rw, bd, wf):
    """Warp jobs (n, 12) into `plane` in place, plain torch. refs: list
    of (H, W) int32 reference planes; wf: the (193, 8) int32 warp filter
    tensor."""
    if not len(jobs):
        return plane
    REF = torch.stack(list(refs))
    ib = intermediate_bits(bd)
    j = jobs.long()
    patch = mc._window(REF, j[:, 3], j[:, 4], j[:, 5], 15, 3, rh,
                       rw).long()
    fh, fv = (wf[r.clamp(0, N_ROWS - 1)].long() for r in filter_rows(jobs))
    mid = sum(fh[..., t] * patch[:, :, t:t + 8] for t in range(8))
    mid = mc._rnd(mid, 7 - ib)
    out = sum(fv[..., t] * mid[:, t:t + 8] for t in range(8))
    out = torch.clamp(mc._rnd(out, 7 + ib), 0, (1 << bd) - 1)
    eight = torch.full_like(j[:, 1], 8)
    mc._scatter(plane, j[:, 1], j[:, 2], eight, eight, out)
    return plane


def warp_planes_plain(planes, jobs, bd, wf):
    """warp_cuda's contract in plain torch: warp_plain per plane
    on the jobs of its plane index."""
    for pi, (refs, plane, rh, rw) in enumerate(planes):
        warp_plain(refs, jobs[jobs[:, 0] == pi], plane, rh, rw, bd, wf)
    return [p for _, p, _, _ in planes]


_LIB = []


def _set_filter(lib):
    lib.mc_warp_set_filter.restype = ct.c_int
    lib.mc_warp_set_filter.argtypes = [ct.c_void_p]
    wf = np.asarray(_warp_filter())
    if wf.shape != (N_ROWS, 8) or wf.min() < -128 or wf.max() > 127:
        raise ValueError("the warp filter is not a (193, 8) bank of "
                         "int8 taps")
    wf = np.ascontiguousarray(wf, np.int8)
    rc = lib.mc_warp_set_filter(wf.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"mc_warp: filter upload failed: CUDA "
                           f"error {rc}")


def _lib():
    from .cuda_build import load_library, per_device
    if not _LIB:
        lib = load_library("mc_warp")
        lib.mc_warp.restype = ct.c_int
        lib.mc_warp.argtypes = [ct.c_void_p, ct.c_void_p, ct.c_int,
                                ct.c_void_p, ct.c_int, ct.c_int,
                                ct.c_void_p]
        _LIB.append(lib)
    return per_device(_LIB[0], _set_filter)


def warp_cuda(planes, jobs, bd):
    """The warp of a frame's planes in one launch of csrc/mc_warp.cu;
    CUDA tensors only. planes: [(refs, plane, rh, rw)], one per plane
    index of the jobs' column 0 (a job of a plane index past the list,
    or of a slot past its plane's references, traps the kernel).
    Launches on the current stream, does not synchronise."""
    ptrs, dims = mc.plane_args(planes, jobs, 12, bd)
    dev = planes[0][1].device
    rc = _lib().mc_warp(ptrs, dims, len(planes), jobs.data_ptr(),
                        len(jobs), bd,
                        launch_stream(dev))
    if rc != 0:
        raise RuntimeError(f"mc_warp kernel launch failed: CUDA error {rc}")
    count_launch(mc.LAUNCHES, "mc_warp")
    return [p for _, p, _, _ in planes]


def warp_planes(planes, jobs, bd):
    """Warp a frame's jobs into their planes (warp_cuda's
    contract): one launch of the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    plane = planes[0][1]
    if plane.is_cuda:
        return warp_cuda(planes, jobs, bd)
    mc._cpu_only(plane)
    from .device import device_tables
    return warp_planes_plain(planes, jobs, bd,
                             device_tables(plane.device)["mc_warp_filter"])
