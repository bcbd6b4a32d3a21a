"""Overlapped block motion compensation (OBMC) of inter Stage B on the
device: each lap predicts a strip of a block from a neighbour's motion
and blends it into the block's prediction.

Port of the `obmc` segments of dav1d_tpu's ops/mc_fused.py
`_mc_program`, whose math is ops/mc_jobs.py `obmc_jobs_fn` (reference
src/recon_tmpl.c obmc() with mc_tmpl.c put_8tap_c and blend_h_c /
blend_v_c). Two implementations:

- `obmc_plain`: batched torch gathers per lap geometry, used for CPU
  tensors only;
- the hand-written CUDA kernel csrc/mc_obmc.cu, used for every CUDA
  tensor (`obmc_cuda`: every lap of a frame's planes, both directions,
  in one launch).

Job row (int32, as native/interjobs.cpp writes it):

  OBMC [top, plane, ww, hh, lap_h, py, px, slot, dy, dx, amx, amy, ft]

The lap is the clipped 8-tap put of the (lap_h x ww) block at (dy, dx)
(windows clamped to the frame's (rh, rw); the 4-tap filters where ww <=
4 horizontally and lap_h <= 4 vertically; ft in 0..10, never bilinear).
It is blended into the plane at (py, px) as (dst (64 - m) + lap m + 32)
>> 6: a top lap over rows < (hh * 3) >> 2 and columns < ww, m =
obmc_masks[hh + row]; a left lap over rows < hh and columns < (ww * 3) >>
2, m = obmc_masks[ww + col]. Pixels past the plane are not written.
Laps of one direction never overlap; a block's left laps read its
top-left corner after its top laps wrote it, so the top laps of every
plane run before the left laps.

Unlike dav1d_tpu's fused segments, the geometry is the job's own: there
are no static caps. The kernel holds the laps the emitter writes (ww,
hh and lap_h <= 64; a top lap's hh and a left lap's ww <= 32, so a
blended region of at most 24 x 64 or 64 x 24): the host raises on
another before the upload (`check_geometry`, from ops/mc_fused.py), and
the kernel traps on one.
"""
from __future__ import annotations

import ctypes as ct

import numpy as np
import torch

from . import mc
from .cuda_build import count_launch, launch_stream
from .mc_ref import intermediate_bits, obmc_masks

MAX_DIM = 64            # the kernel's largest ww, hh and lap_h
MAX_SHORT = 32          # its largest hh of a top lap, ww of a left lap


def blend_dims(jobs, top):
    """(rows, cols) of the region each lap (n, 13) blends."""
    ww, hh = jobs[:, 2], jobs[:, 3]
    if top:
        return (hh * 3) >> 2, ww
    return hh, (ww * 3) >> 2


def obmc_plain(refs, jobs, plane, rh, rw, bd, fb, om, top):
    """Blend OBMC laps (n, 13) of one direction (top: 1 or 0) into
    `plane` in place, plain torch; one batch per blended (rows, cols).
    refs: list of (H, W) int32 reference planes; fb: the filter bank
    tensor; om: the (64,) int32 OBMC masks."""
    if not len(jobs):
        return plane
    REF = torch.stack(list(refs))
    ib = intermediate_bits(bd)
    H, W = plane.shape
    j = jobs.long()
    oh, ow = blend_dims(j, top)
    for a, b in sorted(set(zip(oh.tolist(), ow.tolist()))):
        if a == 0 or b == 0:
            continue
        s = j[(oh == a) & (ow == b)]
        ww, hh, lap_h, py, px = (s[:, k] for k in (2, 3, 4, 5, 6))
        slot, dy, dx, amx, amy, ft = (s[:, k] for k in range(7, 13))
        fh = fb[(ww <= 4).long(), ft & 3, amx].long()
        fv = fb[(lap_h <= 4).long(), (ft >> 2) & 3, amy].long()
        ar_r = torch.arange(a + 7, device=plane.device)
        ar_c = torch.arange(b + 7, device=plane.device)
        rows = torch.clamp(dy[:, None] - 3 + ar_r, 0, rh - 1)
        cols = torch.clamp(dx[:, None] - 3 + ar_c, 0, rw - 1)
        patch = REF[slot[:, None, None], rows[:, :, None],
                    cols[:, None, :]].long()
        mid = sum(fh[:, i, None, None] * patch[:, :, i:i + b]
                  for i in range(8))
        mid = mc._rnd(mid, 6 - ib)
        lap = sum(fv[:, i, None, None] * mid[:, i:i + a] for i in range(8))
        lap = torch.clamp(mc._rnd(lap, 6 + ib), 0, (1 << bd) - 1)
        ah, aw = ar_r[:a], ar_c[:b]
        if top:
            m = om[hh[:, None] + ah].long()[:, :, None]
        else:
            m = om[ww[:, None] + aw].long()[:, None, :]
        drow = py[:, None] + ah
        dcol = px[:, None] + aw
        ok = (drow < H)[:, :, None] & (dcol < W)[:, None, :]
        idx = (drow[:, :, None] * W + dcol[:, None, :])[ok]
        m = m.expand_as(lap)[ok]
        dst = plane.view(-1)[idx].long()
        out = (dst * (64 - m) + lap[ok] * m + 32) >> 6
        plane.view(-1)[idx] = out.to(plane.dtype)
    return plane


def obmc_planes_plain(planes, jobs, bd, fb, om, top):
    """The laps of one direction over a frame's planes in plain torch:
    obmc_plain per plane on the laps of its plane index (column 1)."""
    for pi, (refs, plane, rh, rw) in enumerate(planes):
        obmc_plain(refs, jobs[jobs[:, 1] == pi], plane, rh, rw, bd, fb, om,
                   top)
    return [p for _, p, _, _ in planes]


def obmc_frame_plain(planes, top, left, bd, fb, om):
    """obmc_cuda's contract in plain torch: obmc_planes_plain of the top
    laps, then of the left laps (either may be None)."""
    for t, jobs in ((1, top), (0, left)):
        if jobs is not None:
            obmc_planes_plain(planes, jobs, bd, fb, om, t)
    return [p for _, p, _, _ in planes]


def check_geometry(jobs, top):
    """Raise unless every lap (n, 13) numpy row is of direction `top`
    and of a geometry the kernel holds: ww, hh and lap_h in 1..64, and a
    blended region of at most 24 x 64 (top: hh <= 32) or 64 x 24 (left:
    ww <= 32), as the emitter writes them."""
    j = np.asarray(jobs)
    if not len(j):
        return
    if (j[:, 0] != top).any():
        raise ValueError(f"OBMC laps of direction {set(j[:, 0])} in a "
                         f"{'top' if top else 'left'} call")
    g = j[:, 2:5]
    short = j[:, 3 if top else 2]
    if g.min() < 1 or g.max() > MAX_DIM or short.max() > MAX_SHORT:
        raise ValueError(f"OBMC lap geometry (ww, hh, lap_h) from "
                         f"{g.min(0).tolist()} to {g.max(0).tolist()}: "
                         f"the kernel holds 1..{MAX_DIM}, and "
                         f"{'hh' if top else 'ww'} <= {MAX_SHORT}")


_LIB = []


def _set_tables(lib):
    lib.mc_obmc_set_tables.restype = ct.c_int
    lib.mc_obmc_set_tables.argtypes = [ct.c_void_p, ct.c_void_p]
    fb = np.ascontiguousarray(mc.filter_banks(), np.int32)
    om = np.ascontiguousarray(obmc_masks(), np.int32)
    if om.shape != (MAX_DIM,):
        raise ValueError(f"OBMC masks of shape {om.shape}")
    rc = lib.mc_obmc_set_tables(fb.ctypes.data, om.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"mc_obmc: table upload failed: CUDA error "
                           f"{rc}")


def _lib():
    from .cuda_build import load_library, per_device
    if not _LIB:
        lib = load_library("mc_obmc")
        lib.mc_obmc.restype = ct.c_int
        lib.mc_obmc.argtypes = [ct.c_void_p, ct.c_void_p, ct.c_int,
                                ct.c_void_p, ct.c_int, ct.c_void_p,
                                ct.c_int, ct.c_int, ct.c_void_p,
                                ct.POINTER(ct.c_int)]
        lib.mc_obmc_blocks_per_sm.restype = ct.c_int
        lib.mc_obmc_grid.restype = ct.c_int
        lib.mc_obmc_grid.argtypes = [ct.c_int, ct.c_int]
        _LIB.append(lib)
    return per_device(_LIB[0], _set_tables)


def obmc_cuda(planes, top, left, bd):
    """Every lap of a frame's planes in one launch of csrc/mc_obmc.cu,
    the top laps before the left laps; CUDA tensors only. planes:
    [(refs, plane, rh, rw)], one per plane index of the laps' column 1;
    top, left: (n, 13) int32 tables of that direction's laps, or None. A
    lap of the other direction, of a plane index or slot past the lists,
    or of a geometry the kernel does not hold traps the kernel. Launches
    on the current stream, does not synchronise."""
    from .cuda_build import check_tensor
    given = [t for t in (top, left) if t is not None]
    if not given:
        raise ValueError("no OBMC laps")
    ptrs, dims = mc.plane_args(planes, given[0], 13, bd)
    dev = planes[0][1].device
    for t in given[1:]:
        check_tensor(t, "jobs", torch.int32, dev, (len(t), 13))
    arg = [(0, 0) if t is None else (t.data_ptr(), len(t))
           for t in (top, left)]
    launched = ct.c_int(0)
    rc = _lib().mc_obmc(ptrs, dims, len(planes), *arg[0], *arg[1], bd,
                        launch_stream(dev),
                        ct.byref(launched))
    if rc != 0:
        raise RuntimeError(f"mc_obmc kernel launch failed: CUDA error {rc}")
    count_launch(mc.LAUNCHES, "mc_obmc", launched.value)
    return [p for _, p, _, _ in planes]


def obmc_planes(planes, top, left, bd):
    """Blend a frame's laps into their planes, the top laps before the
    left laps (obmc_cuda's contract): one launch of the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    plane = planes[0][1]
    if plane.is_cuda:
        return obmc_cuda(planes, top, left, bd)
    mc._cpu_only(plane)
    from .device import device_tables
    tb = device_tables(plane.device)
    return obmc_frame_plain(planes, top, left, bd, tb["mc_filter_banks"],
                            tb["mc_obmc_masks"])
