"""Super-resolution on the device: the horizontal upscale of a frame's
coded-width planes to the output width, after CDEF and before loop
restoration (reference recon_tmpl.c:2053-2086 filter_sbrow_resize,
decode.c:3524-3540 step / x0 setup); the pre-CDEF snapshot that LR
reads is resized as well.

Port of dav1d_tpu's ops/superres.py `_resize_fn` and of the super-res
step of its recon/filters.py. Two implementations of a frame's resize:

- `resize_frame_plain`: per plane, 8 weighted column gathers in plain
  torch (`resize_plane_plain`), used for CPU tensors only;
- the hand-written CUDA kernel csrc/superres.cu, used for every CUDA
  tensor (`resize_frame_cuda`: every plane and source in one launch).

`apply_superres` is the golden host model of the step (dav1d_tpu's, on
numpy planes through mc_ref.resize_plane), which the golden host route
runs (DAV1D_TPU_BACKEND=numpy).

Output column ox reads source columns clip(src_x - 3 .. src_x + 4, 0,
src_w - 1) with the taps of dav1d_resize_filter row `phase`, where
T = mx0 + ox * step, src_x = (T >> 14) - 1 and phase = (T & 0x3fff) >>
8: the closed form of the reference's position recurrence
(`_resize_tables`), exact because mx0 < 2^14. The result is
clip((-acc + 64) >> 7, 0, 2^bd - 1): the bank's taps are negated.
"""
from __future__ import annotations

import ctypes as ct

import numpy as np
import torch

from .cuda_build import count_launch, launch_stream
from .mc_ref import _resize_filter, get_upscale_x0, resize_plane, scale_fac

# kernel launches per name (counted where the CUDA kernel is launched)
LAUNCHES = {"superres": 0}
MAX_JOBS = 6            # (plane, source) pairs of a frame: 3 planes x 2
# csrc/superres.cu's tiles: TILE_W output columns x TILE_ROWS rows, each
# staging at most SPAN source columns from a multiple of 4
TILE_W, TILE_ROWS, SPAN = 128, 32, 140


def _resize_tables(dst_w, src_w, dx, mx0):
    """(dst_w, 8) clamped source column ids + filter taps (reference
    mc_tmpl.c:918-958 resize_c position recurrence)."""
    F = _resize_filter()
    idx = np.zeros((dst_w, 8), np.int32)
    flt = np.zeros((dst_w, 8), np.int32)
    mx = mx0
    src_x = -1
    for ox in range(dst_w):
        flt[ox] = F[mx >> 8]
        idx[ox] = np.clip(np.arange(src_x - 3, src_x + 5), 0, src_w - 1)
        mx += dx
        src_x += mx >> 14
        mx &= 0x3FFF
    return idx, flt


def positions(dst_w, dx, mx0, device="cpu"):
    """(src_x, phase) of every output column, int64 tensors: the closed
    form of _resize_tables' recurrence (T in int64)."""
    T = mx0 + torch.arange(dst_w, dtype=torch.int64, device=device) * dx
    return (T >> 14) - 1, (T & 0x3FFF) >> 8


def resize_plane_plain(src, src_w, h, dst_w, step, mx0, bd):
    """(h, dst_w) int32: rows [:h] of `src` ((>= h, >= src_w) int32)
    resized, term for term as dav1d_tpu's `_resize_fn`."""
    src_x, phase = positions(dst_w, step, mx0, src.device)
    F = torch.from_numpy(_resize_filter()).to(src.device)[phase]
    rows = src[:h].long()
    acc = torch.zeros((h, dst_w), dtype=torch.int64, device=src.device)
    for i in range(8):
        col = (src_x - 3 + i).clamp(0, src_w - 1)
        acc += F[None, :, i] * rows[:, col]
    return torch.clamp((-acc + 64) >> 7, 0, (1 << bd) - 1).to(torch.int32)


def resize_frame_plain(jobs, bd):
    """resize_frame_cuda's contract in plain torch: per job
    resize_plane_plain into [:h, :dst_w] of its destination, zeros
    elsewhere."""
    check_jobs(jobs)
    for src, src_w, h, dst, dst_w, step, mx0 in jobs:
        dst.zero_()
        dst[:h, :dst_w] = resize_plane_plain(src, src_w, h, dst_w, step,
                                             mx0, bd)
    return [j[3] for j in jobs]


def tile_spans(dst_w, step, mx0):
    """The staged source span of each tile column of a job, as
    csrc/superres.cu `tile_of` computes it: int64 arrays (c0, lo, nvec)
    of the tiles' first output column, their first staged source column
    (a multiple of 4, before the clamp to the source) and their count of
    4-column vectors. Output ox of a tile reads the staged columns
    (mx0 + ox * step >> 14) - 4 - lo + [0, 8)."""
    c0 = np.arange(0, dst_w, TILE_W, dtype=np.int64)
    cl = np.minimum(c0 + TILE_W, dst_w) - 1
    lo = ((mx0 + c0 * step) >> 14) - 4
    hi = ((mx0 + cl * step) >> 14) + 3
    lo &= ~3
    return c0, lo, ((hi - lo) >> 2) + 1


def check_jobs(jobs):
    """Raise unless every job (src, src_w, h, dst, dst_w, step, mx0)
    fits its tensors: src (>= h, >= src_w) and dst (>= h, >= dst_w)
    2-D int32 on one device, a step of 1 to 2^14 and 0 <= mx0 < 2^14."""
    if not 1 <= len(jobs) <= MAX_JOBS:
        raise ValueError(f"{len(jobs)} resize jobs, expected 1 to "
                         f"{MAX_JOBS}")
    dev = jobs[0][0].device
    for k, (src, src_w, h, dst, dst_w, step, mx0) in enumerate(jobs):
        for name, t in (("src", src), ("dst", dst)):
            if t.device != dev or t.dtype != torch.int32 or t.dim() != 2:
                raise ValueError(f"job {k}: {name} {t.dtype} "
                                 f"{tuple(t.shape)} on {t.device}")
        if not (0 < src_w <= src.shape[1] and 0 < h <= src.shape[0] and
                h <= dst.shape[0] and 0 < dst_w <= dst.shape[1]):
            raise ValueError(f"job {k}: {h}x{src_w} -> {dst_w} outside "
                             f"{tuple(src.shape)} -> {tuple(dst.shape)}")
        if not (0 < step <= 1 << 14 and 0 <= mx0 < 1 << 14):
            raise ValueError(f"job {k}: step {step}, x0 {mx0}")


_LIB = []


def _set_filter(lib):
    lib.superres_set_filter.restype = ct.c_int
    lib.superres_set_filter.argtypes = [ct.c_void_p]
    bank = np.asarray(_resize_filter())
    if bank.shape != (64, 8) or bank.min() < -128 or bank.max() > 127:
        raise ValueError("the resize filter is not a (64, 8) bank of "
                         "int8 taps")
    bank = np.ascontiguousarray(bank, np.int8)
    rc = lib.superres_set_filter(bank.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"superres: filter upload failed: CUDA "
                           f"error {rc}")


def _lib():
    from .cuda_build import load_library, per_device
    if not _LIB:
        lib = load_library("superres")
        lib.superres_occupancy.restype = ct.c_int
        lib.superres_occupancy.argtypes = [ct.c_void_p, ct.c_void_p]
        lib.superres.restype = ct.c_int
        lib.superres.argtypes = [ct.c_void_p, ct.c_void_p, ct.c_int,
                                 ct.c_int, ct.c_void_p]
        _LIB.append(lib)
    return per_device(_LIB[0], _set_filter)


def resize_frame_cuda(jobs, bd):
    """Resize a frame's planes in one launch of csrc/superres.cu: jobs
    [(src, src_w, h, dst, dst_w, step, mx0)], src and dst contiguous
    int32 CUDA planes (dst not src) with 16-byte aligned rows (a multiple
    of 4 columns; raises otherwise). Each dst gets the resized rows
    [:h] of src in [:h, :dst_w] and zeros in the rest of its shape.
    Launches on the current stream, does not synchronise."""
    check_jobs(jobs)
    dev = jobs[0][0].device
    if dev.type != "cuda":
        raise ValueError("resize_frame_cuda needs CUDA tensors")
    if bd not in (8, 10, 12):
        raise ValueError(f"bitdepth {bd}")
    ptrs, dims = [], []
    for k, (src, src_w, h, dst, dst_w, step, mx0) in enumerate(jobs):
        for name, t in (("src", src), ("dst", dst)):
            if not t.is_contiguous():
                raise ValueError(f"job {k}: {name} must be contiguous")
            # the kernel's 16-byte copies and stores of 4 columns
            if t.shape[1] % 4 or t.data_ptr() % 16:
                raise ValueError(f"job {k}: {name} rows of {t.shape[1]} "
                                 f"columns at {t.data_ptr():#x}: the "
                                 f"kernel needs 16-byte aligned rows")
        if dst.data_ptr() == src.data_ptr():
            raise ValueError(f"job {k}: dst is src")
        ptrs += [src.data_ptr(), dst.data_ptr()]
        dims += [src_w, src.shape[1], h, dst_w, *dst.shape, step, mx0]
    rc = _lib().superres((ct.c_void_p * len(ptrs))(*ptrs),
                         (ct.c_int * len(dims))(*dims), len(jobs), bd,
                         launch_stream(dev))
    if rc != 0:
        raise RuntimeError(f"superres kernel launch failed: CUDA error "
                           f"{rc}")
    count_launch(LAUNCHES, "superres")
    return [j[3] for j in jobs]


def occupancy():
    """(blocks a SM, SMs) of the kernel's persistent grid on the current
    CUDA device."""
    per_sm, sms = ct.c_int(), ct.c_int()
    rc = _lib().superres_occupancy(ct.byref(per_sm), ct.byref(sms))
    if rc != 0:
        raise RuntimeError(f"superres occupancy query failed: CUDA error "
                           f"{rc}")
    return per_sm.value, sms.value


def resize_frame(jobs, bd):
    """Resize a frame's planes (resize_frame_cuda's contract): one
    launch of the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if jobs[0][0].is_cuda:
        return resize_frame_cuda(jobs, bd)
    from .mc import _cpu_only
    _cpu_only(jobs[0][0])
    return resize_frame_plain(jobs, bd)


def frame_geometry(f, layout, ss_hor, ss_ver):
    """Per plane (src_w, h, dst_w, step, mx0) of a super-res frame
    (dav1d_tpu's recon/filters.py): the even-rounded coded width
    (4 * bw) >> ss, the output width, and chroma's step and x0 from the
    rounded chroma widths."""
    fh = f.frame_hdr
    in_w, out_w = fh.width[0], fh.width[1]
    step = [scale_fac(in_w, out_w),
            scale_fac((in_w + ss_hor) >> ss_hor, (out_w + ss_hor) >> ss_hor)]
    x0 = [get_upscale_x0(in_w, out_w, step[0]),
          get_upscale_x0((in_w + ss_hor) >> ss_hor,
                         (out_w + ss_hor) >> ss_hor, step[1])]
    out = []
    for pl in range(3 if layout else 1):
        c = int(bool(pl))
        out.append(((4 * f.bw) >> (ss_hor * c),
                    (fh.height + (ss_ver * c)) >> (ss_ver * c),
                    (out_w + (ss_hor * c)) >> (ss_hor * c), step[c], x0[c]))
    return out


def superres_planes_device(planes, pre_cdef, plan, pic):
    """The super-res step of the filter chain: the post-CDEF planes and,
    when LR runs (pre_cdef not None), the pre-CDEF snapshot resized in
    one resize_frame call into planes of the output Picture's padded
    shape (zero outside the resized area). Returns (the new Picture,
    its planes, the resized snapshot or None)."""
    from ..recon.picture import Picture
    fh = plan.f.frame_hdr
    newpic = Picture(fh.width[1], fh.height, pic.layout, pic.bpc)
    newpic.props = pic.props
    shapes = newpic.plane_shapes()
    geo = frame_geometry(plan.f, pic.layout, pic.ss_hor, pic.ss_ver)
    sources = [planes] + ([pre_cdef] if pre_cdef is not None else [])
    jobs = []
    for srcs in sources:
        for pl, (src_w, h, dst_w, step, mx0) in enumerate(geo):
            dst = torch.empty(shapes[pl], dtype=torch.int32,
                              device=srcs[pl].device)
            jobs.append((srcs[pl], src_w, h, dst, dst_w, step, mx0))
    out = resize_frame(jobs, pic.bpc)
    n = len(geo)
    return newpic, out[:n], (out[n:] if pre_cdef is not None else None)


def apply_superres(pic, pre_cdef, plan):
    """The golden host super-res of a frame (dav1d_tpu's ops/superres.py
    apply_superres): a new output-width Picture with each host plane's
    rows resized by mc_ref.resize_plane, and, when pre_cdef (int32 numpy
    planes) is given, the resized snapshot in int32 planes of the output
    planes' padded shape (zero outside the resized area). Returns (the
    new Picture, the resized snapshot or None)."""
    from ..recon.picture import Picture
    fh = plan.f.frame_hdr
    out = Picture(fh.width[1], fh.height, pic.layout, pic.bpc)
    out_pre = [None] * 3 if pre_cdef is not None else None
    geo = frame_geometry(plan.f, pic.layout, pic.ss_hor, pic.ss_ver)
    for pl, (src_w, h, dst_w, step, mx0) in enumerate(geo):
        res = resize_plane(pic.planes[pl][:h], src_w, h, dst_w, step, mx0,
                           pic.bpc)
        out.planes[pl][:h, :dst_w] = res.astype(out.planes[pl].dtype)
        if pre_cdef is not None:
            # the padded geometry of the planes without super-res (the
            # stripe context may read past the visible area)
            buf = np.zeros(out.planes[pl].shape, np.int32)
            buf[:h, :dst_w] = resize_plane(pre_cdef[pl][:h], src_w, h,
                                           dst_w, step, mx0, pic.bpc)
            out_pre[pl] = buf
    return out, out_pre
