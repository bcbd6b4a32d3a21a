"""Film grain on the device: the out-of-loop grain synthesis of a shown
frame, applied to an output copy (reference src/filmgrain_tmpl.c:169-423
fgy/fguv_32x32xn, fg_apply_tmpl.c); reference pictures stay clean.

Port of dav1d_tpu's ops/fg.py. The grain and scaling LUTs are made on
the host (ops/fg_ref.py: small, inherently serial AR / LFSR
recursions, `_grain_data`) and memoized on the device per parameter
set (`grain_tables`: the three grain LUTs int16, the scaling LUTs
uint8). Each 32-row's LFSR chain of block offsets is drawn on the host
(`_block_offsets`, an (n_rows, n_bx) int32 table, one upload a frame). Two implementations of a frame's grain:

- `film_grain_plain`: whole-plane torch gathers, `fgy_plain` and
  `fguv_plain`, term for term as dav1d_tpu's `_grain_maps_injit` /
  `_fgy_fn` / `_fguv_fn`; used for CPU tensors only;
- the hand-written CUDA kernel csrc/film_grain.cu, used for every CUDA
  tensor (`film_grain_cuda`: luma and both chroma planes in one launch).

Per pixel of a plane's visible area: the grain of its 32x32 block
(32 >> ss on chroma) is LUT[offy + y_in, offx + x_in] with offx = 3 +
(2 >> sx) (3 + (r >> 4)), offy = 3 + (2 >> sy) (3 + (r & 15)) from the
block's offset r; with overlap, the first min(2 >> s, 2) columns (rows)
of a block that has a left (top) neighbour blend in the neighbour's
grain (W_OVERLAP, or W_OVERLAP_SUB on a subsampled axis); the noise is
round2(scaling[v] * grain, scaling_shift), v the source pixel on luma
and on chroma the luma average at its position, combined with the uv
multipliers and offset unless chroma scaling comes from luma; the
result is clipped to the full or restricted range.
"""
from __future__ import annotations

import ctypes as ct
from dataclasses import dataclass

import numpy as np
import torch

from ..utils import timing
from . import fg_ref
from .fg_ref import (FG_BLOCK_SIZE, GRAIN_HEIGHT, GRAIN_WIDTH, _rand,
                     generate_grain_uv, generate_grain_y, generate_scaling)

# kernel launches per name (counted where the CUDA kernel is launched)
LAUNCHES = {"film_grain": 0}
LUT_ROWS = GRAIN_HEIGHT + 1     # the chroma LUTs' rows (luma has one less)
UNIT_W = 128                    # luma columns of a csrc/film_grain.cu unit

_DEVICE_CACHE = {}


def _fgd_key(fgd, bd):
    return (fgd.seed, bd, fgd.grain_scale_shift, fgd.ar_coeff_lag,
            fgd.ar_coeff_shift, tuple(fgd.ar_coeffs_y),
            tuple(tuple(c) for c in fgd.ar_coeffs_uv),
            tuple(fgd.num_uv_points), fgd.chroma_scaling_from_luma,
            fgd.num_y_points,
            tuple(tuple(p) for p in fgd.y_points[:fgd.num_y_points]),
            tuple(tuple(tuple(p) for p in fgd.uv_points[i]
                        [:fgd.num_uv_points[i]]) for i in range(2)),
            fgd.scaling_shift)


def _grain_data(fgd, ss_x, ss_y, bd):
    """Grain + scaling LUTs of a grain-parameter set (memoized on the
    device by grain_tables)."""
    lut_y = generate_grain_y(fgd, bd)
    luts = [lut_y, None, None]
    for uv in range(2):
        if fgd.num_uv_points[uv] or fgd.chroma_scaling_from_luma:
            luts[1 + uv] = generate_grain_uv(fgd, lut_y, uv, ss_x, ss_y,
                                             bd)
    scalings = [None, None, None]
    if fgd.num_y_points or fgd.chroma_scaling_from_luma:
        scalings[0] = generate_scaling(bd, fgd.y_points, fgd.num_y_points)
    for uv in range(2):
        if fgd.num_uv_points[uv]:
            scalings[1 + uv] = generate_scaling(bd, fgd.uv_points[uv],
                                                fgd.num_uv_points[uv])
    return luts, scalings


def _block_offsets(fgd, n_rows, n_bx):
    """Per-(32-row, 32-col-block) grain offsets. Each row draws its own
    8-bit LFSR chain from a row-seeded state (reference
    filmgrain_tmpl.c:183-195); the row above's chain is re-derived
    identically, so off[row-1, bx] is exactly the 'top' offset."""
    off = np.zeros((n_rows, n_bx), np.int32)
    for row in range(n_rows):
        s = fgd.seed
        s ^= ((row * 37 + 178) & 0xFF) << 8
        s ^= (row * 173 + 105) & 0xFF
        state = [s]
        for b in range(n_bx):
            off[row, b] = _rand(state, 8)
    return off


def _w_vecs(bs, sub):
    """Per-in-block-position overlap weight vectors (length bs)."""
    wtab = fg_ref.W_OVERLAP_SUB if sub else fg_ref.W_OVERLAP
    w0 = np.zeros(bs, np.int32)
    w1 = np.zeros(bs, np.int32)
    for i, (a, b_) in enumerate(wtab):
        w0[i] = a
        w1[i] = b_
    return w0, w1


def _rnd2(x, s):
    return (x + ((1 << s) >> 1)) >> s


def _grain(src, lut, off, sx, sy, bd, overlap):
    """The (h, w) grain of a plane (src's shape), blended at the block
    overlaps: _grain_maps_injit and the blend of _fgy_fn / _fguv_fn."""
    h, w = src.shape
    dev = src.device
    bs_y = FG_BLOCK_SIZE >> sy
    bs_x = FG_BLOCK_SIZE >> sx
    n_rows, n_bx = off.shape
    ys = torch.arange(h, device=dev)
    xs = torch.arange(w, device=dev)
    row_of, bx_of = ys // bs_y, xs // bs_x
    y_in, x_in = ys - row_of * bs_y, xs - bx_of * bs_x
    lf = lut.reshape(-1).long()
    lut_w = lut.shape[1]
    offl = off.long()

    def take(dx_blk, dy_blk):
        r = torch.clamp(row_of - dy_blk, 0, n_rows - 1)
        b = torch.clamp(bx_of - dx_blk, 0, n_bx - 1)
        rv = offl[r[:, None], b[None, :]]
        offx = 3 + (2 >> sx) * (3 + (rv >> 4))
        offy = 3 + (2 >> sy) * (3 + (rv & 0xF))
        iy = offy + y_in[:, None] + bs_y * dy_blk
        ix = offx + x_in[None, :] + bs_x * dx_blk
        # blended maps read past the LUT only where their mask is off
        return lf[torch.clamp(iy * lut_w + ix, 0, lf.numel() - 1)]

    G = take(0, 0)
    if not overlap:
        return G
    ctr = 128 << (bd - 8)
    xmask = ((x_in < min(2 >> sx, 2)) & (bx_of > 0))[None, :]
    ymask = ((y_in < min(2 >> sy, 2)) & (row_of > 0))[:, None]
    T = lambda a: torch.from_numpy(a).to(dev).long()
    wx0, wx1 = (T(v)[x_in][None, :] for v in _w_vecs(bs_x, sx))
    wy0, wy1 = (T(v)[y_in][:, None] for v in _w_vecs(bs_y, sy))
    GL, GT, GTL = take(1, 0), take(0, 1), take(1, 1)
    g1 = torch.where(xmask, torch.clamp(_rnd2(GL * wx0 + G * wx1, 5),
                                        -ctr, ctr - 1), G)
    t1 = torch.where(xmask, torch.clamp(_rnd2(GTL * wx0 + GT * wx1, 5),
                                        -ctr, ctr - 1), GT)
    return torch.where(ymask, torch.clamp(_rnd2(t1 * wy0 + g1 * wy1, 5),
                                          -ctr, ctr - 1), g1)


def fgy_plain(src, lut, scaling, off, bd, scaling_shift, overlap,
              clip_range):
    """Grained luma (src's (h, w) shape, int32), term for term as
    dav1d_tpu's `_fgy_fn`: src (h, w), lut (>= 73, 82), scaling
    (1 << bd,), off (n_rows, n_bx)."""
    bdm8 = bd - 8
    mn, mx = (16 << bdm8, 235 << bdm8) if clip_range else \
        (0, (1 << bd) - 1)
    g = _grain(src, lut, off, 0, 0, bd, overlap)
    sv = src.long()
    noise = _rnd2(scaling.long()[sv] * g, scaling_shift)
    return torch.clamp(sv + noise, mn, mx).to(torch.int32)


def fguv_plain(src, luma, lut, scaling, off, bd, scaling_shift, overlap,
               clip_range, is_id, sx, sy, csfl, uv_luma_mult, uv_mult,
               uv_offset):
    """Grained chroma (src's (h, w) shape, int32), term for term as
    dav1d_tpu's `_fguv_fn`: luma the clean luma plane's rows
    [:h << sy] and columns [:(w << sx) + sx]."""
    h, w = src.shape
    bdm8 = bd - 8
    mn = (16 << bdm8) if clip_range else 0
    mx = ((235 if is_id else 240) << bdm8) if clip_range else \
        (1 << bd) - 1
    g = _grain(src, lut, off, sx, sy, bd, overlap)
    ly = luma[::1 << sy, ::1 << sx][:h, :w].long()
    if sx:
        ly2 = luma[::1 << sy, 1::1 << sx][:h, :w].long()
        avg = (ly + ly2 + 1) >> 1
    else:
        avg = ly
    sv = src.long()
    if csfl:
        val = avg
    else:
        combined = avg * uv_luma_mult + sv * uv_mult
        val = torch.clamp((combined >> 6) + uv_offset * (1 << bdm8), 0,
                          (1 << bd) - 1)
    noise = _rnd2(scaling.long()[val] * g, scaling_shift)
    return torch.clamp(sv + noise, mn, mx).to(torch.int32)


@dataclass(frozen=True)
class GrainFrame:
    """The scalars of a frame's grain: its visible luma size, chroma
    subsampling, bitdepth, the grain-parameter flags, per plane whether
    it is grained and which scaling LUT it reads, and the chroma
    planes' multipliers and offsets."""
    w: int
    h: int
    sx: int
    sy: int
    bd: int
    scaling_shift: int
    overlap: bool
    clip_range: bool
    is_id: bool
    csfl: bool
    apply: tuple            # per plane: grained (True) or copied
    scale_idx: tuple        # per plane: its row of the scaling tables
    uv_luma_mult: tuple = (0, 0)
    uv_mult: tuple = (0, 0)
    uv_offset: tuple = (0, 0)

    @property
    def chroma(self):
        """(rows, columns) of the chroma planes' visible area."""
        return (self.h + self.sy) >> self.sy, (self.w + self.sx) >> self.sx


def frame_params(fgd, pic, seq):
    """The GrainFrame of a picture with grain parameters fgd."""
    csfl = bool(fgd.chroma_scaling_from_luma)
    n = 3 if pic.layout else 1
    uv = [bool(fgd.num_uv_points[pl] or csfl) for pl in range(2)]
    return GrainFrame(
        w=pic.w, h=pic.h, sx=pic.ss_hor, sy=pic.ss_ver, bd=pic.bpc,
        scaling_shift=int(fgd.scaling_shift),
        overlap=bool(fgd.overlap_flag),
        clip_range=bool(fgd.clip_to_restricted_range),
        is_id=getattr(seq, "mtrx", 0) == 0, csfl=csfl,
        apply=(bool(fgd.num_y_points), *uv)[:n],
        scale_idx=(0, 0 if csfl else 1, 0 if csfl else 2)[:n],
        uv_luma_mult=tuple(int(v) for v in fgd.uv_luma_mult),
        uv_mult=tuple(int(v) for v in fgd.uv_mult),
        uv_offset=tuple(int(v) for v in fgd.uv_offset))


def pack_tables(luts, scalings, bd):
    """_grain_data's LUTs as the kernel reads them: (3, 74, 82) int16
    grain LUTs (luma's 73 rows, then zeros) and (3, 1 << bd) uint8
    scaling LUTs, zeros for the planes without one."""
    L = np.zeros((3, LUT_ROWS, GRAIN_WIDTH), np.int16)
    S = np.zeros((3, 1 << bd), np.uint8)
    for i in range(3):
        if luts[i] is not None:
            a = np.asarray(luts[i])
            if np.abs(a).max(initial=0) > 1 << 11:
                raise ValueError("grain LUT values past 12 bits")
            L[i, :a.shape[0]] = a
        if scalings[i] is not None:
            s = np.asarray(scalings[i])
            if s.min(initial=0) < 0 or s.max(initial=0) > 255:
                raise ValueError("scaling LUT values outside 0..255")
            S[i] = s
    return L, S


def grain_tables(fgd, ss_x, ss_y, bd, device):
    """The packed LUTs of a grain-parameter set on `device`, memoized
    there (made on the host by _grain_data, under "fg.luts")."""
    key = (_fgd_key(fgd, bd), ss_x, ss_y, str(device))
    hit = _DEVICE_CACHE.get(key)
    if hit is not None:
        return hit
    with timing.phase("fg.luts"):
        L, S = pack_tables(*_grain_data(fgd, ss_x, ss_y, bd), bd)
    if len(_DEVICE_CACHE) > 32:
        _DEVICE_CACHE.clear()
    hit = _DEVICE_CACHE[key] = (torch.from_numpy(L).to(device),
                                torch.from_numpy(S).to(device))
    return hit


def check_frame(planes, fr, luts, scal, off):
    """Raise unless the planes and tables fit the GrainFrame: 1 or 3
    int32 2-D planes on one device, the luma plane at least one column
    wider than the visible width where chroma reads past it, luts
    (3, 74, 82) int16, scal (3, 1 << bd) uint8 and off (n_rows, n_bx)
    int32 covering the visible luma in 32x32 blocks."""
    dev = planes[0].device
    if len(planes) not in (1, 3) or len(fr.apply) != len(planes):
        raise ValueError(f"{len(planes)} planes for {len(fr.apply)}")
    ch, cw = fr.chroma
    for p, t in enumerate(planes):
        rows, cols = (fr.h, fr.w) if p == 0 else (ch, cw)
        if t.device != dev or t.dtype != torch.int32 or t.dim() != 2 or \
                t.shape[0] < rows or t.shape[1] < cols:
            raise ValueError(f"plane {p}: {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}, visible {rows}x{cols}")
    # chroma reads luma rows y << sy and columns (x << sx) + sx
    if len(planes) == 3 and (planes[0].shape[0] < ch << fr.sy or
                             planes[0].shape[1] < cw << fr.sx):
        raise ValueError("luma too small for the chroma planes' reads")
    n_rows = -(-fr.h // FG_BLOCK_SIZE)
    n_bx = -(-fr.w // FG_BLOCK_SIZE)
    for name, t, dt, shape in (
            ("luts", luts, torch.int16, (3, LUT_ROWS, GRAIN_WIDTH)),
            ("scal", scal, torch.uint8, (3, 1 << fr.bd)),
            ("off", off, torch.int32, (n_rows, n_bx))):
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}, expected {dt} {shape}")
    if fr.bd not in (8, 10, 12) or not 8 <= fr.scaling_shift <= 11:
        raise ValueError(f"bitdepth {fr.bd}, scaling shift "
                         f"{fr.scaling_shift}")


def grain_units(shapes, sx, sy):
    """csrc/film_grain.cu's units over planes of `shapes` (luma first):
    unit u = (band k, column c), k = u // n_cols. Its lane loads and
    stores luma rows (k << sy) + dy (dy < 1 << sy), columns c * 128 +
    4 lane; chroma row k, columns c * (128 >> sx) + 4 (lane & 15) of
    plane 1 + (lane >> 4) when sx, else c * 128 + 4 lane of both planes.
    Returns (n_bands, n_cols, {plane: int64 (n, 4) array of (unit,
    lane, row, column) per int4}), without the int4s outside a plane
    (the kernel skips them)."""
    if len(shapes) == 1:
        sx = sy = 0                     # a single plane is luma
    n_bands = n_cols = 0
    for p, (rows, cols) in enumerate(shapes):
        s_x = sx if p else 0
        n_bands = max(n_bands, rows if p else -(-rows // (1 << sy)))
        n_cols = max(n_cols, -(-cols // (UNIT_W >> s_x)))
    u, lane = np.meshgrid(np.arange(n_bands * n_cols), np.arange(32),
                          indexing="ij")
    u, lane = u.ravel(), lane.ravel()
    k, c = u // n_cols, u % n_cols
    parts = {0: [(u, lane, (k << sy) + dy, c * UNIT_W + 4 * lane)
                 for dy in range(1 << sy)]}
    if len(shapes) == 3:
        for p in (1, 2):
            m = (lane >> 4) == p - 1 if sx else np.ones_like(lane, bool)
            x = c * (UNIT_W >> 1) + 4 * (lane & 15) if sx else \
                c * UNIT_W + 4 * lane
            parts[p] = [(u[m], lane[m], k[m], x[m])]
    out = {}
    for p, ps in parts.items():
        rows, cols = shapes[p]
        a = np.concatenate([np.stack(t, 1) for t in ps])
        out[p] = a[(a[:, 2] < rows) & (a[:, 3] < cols)]
    return n_bands, n_cols, out


def film_grain_plain(planes, fr, luts, scal, off):
    """film_grain_cuda's contract in plain torch: fgy_plain and
    fguv_plain on the visible area of each grained plane, copies
    elsewhere."""
    check_frame(planes, fr, luts, scal, off)
    out = [p.clone() for p in planes]
    h, w = fr.h, fr.w
    args = (fr.bd, fr.scaling_shift, fr.overlap, fr.clip_range)
    if fr.apply[0]:
        out[0][:h, :w] = fgy_plain(planes[0][:h, :w], luts[0].int(),
                                   scal[0].int(), off, *args)
    ch, cw = fr.chroma
    luma = planes[0][:ch << fr.sy, :(cw << fr.sx) + fr.sx]
    for pl in range(len(planes) - 1):
        if fr.apply[1 + pl]:
            out[1 + pl][:ch, :cw] = fguv_plain(
                planes[1 + pl][:ch, :cw], luma, luts[1 + pl].int(),
                scal[fr.scale_idx[1 + pl]].int(), off, *args, fr.is_id,
                fr.sx, fr.sy, fr.csfl, fr.uv_luma_mult[pl],
                fr.uv_mult[pl], fr.uv_offset[pl])
    return out


_LIB = []


def _lib():
    if not _LIB:
        from .cuda_build import load_library
        lib = load_library("film_grain")
        lib.film_grain_occupancy.restype = ct.c_int
        lib.film_grain_occupancy.argtypes = [ct.c_int] * 3 + \
            [ct.c_void_p] * 2
        lib.film_grain.restype = ct.c_int
        lib.film_grain.argtypes = [ct.c_void_p, ct.c_void_p, ct.c_void_p]
        _LIB.append(lib)
    return _LIB[0]


def film_grain_cuda(planes, fr, luts, scal, off):
    """The grain of a frame in one launch of csrc/film_grain.cu: planes
    the clean int32 CUDA planes (1 or 3, contiguous), fr their
    GrainFrame, luts / scal grain_tables', off _block_offsets' table on
    the device; plane rows 16-byte aligned (a multiple of 4 columns;
    raises otherwise). Returns new planes of the same shapes: grained in the
    visible area of each plane fr.apply marks, the source elsewhere.
    Launches on the current stream, does not synchronise."""
    check_frame(planes, fr, luts, scal, off)
    dev = planes[0].device
    if dev.type != "cuda":
        raise ValueError("film_grain_cuda needs CUDA tensors")
    for name, t in ((*((f"plane {p}", t) for p, t in enumerate(planes)),
                     ("luts", luts), ("scal", scal), ("off", off))):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for p, t in enumerate(planes):
        # the kernel's 16-byte loads and stores of 4 columns
        if t.shape[1] % 4 or t.data_ptr() % 16:
            raise ValueError(f"plane {p}: rows of {t.shape[1]} columns at "
                             f"{t.data_ptr():#x}: the kernel needs 16-byte "
                             f"aligned rows")
    out = [torch.empty_like(p) for p in planes]
    ptrs = [0] * 9
    dims = [0] * 12
    for p, (s, d) in enumerate(zip(planes, out)):
        ptrs[2 * p:2 * p + 2] = (s.data_ptr(), d.data_ptr())
        dims[4 * p:4 * p + 4] = (*s.shape, int(fr.apply[p]),
                                 fr.scale_idx[p])
    ptrs[6:] = (off.data_ptr(), luts.data_ptr(), scal.data_ptr())
    dims += [len(planes), fr.w, fr.h, *off.shape, fr.sx, fr.sy, fr.bd,
             fr.scaling_shift, int(fr.overlap), int(fr.clip_range),
             int(fr.is_id), int(fr.csfl), *fr.uv_luma_mult, *fr.uv_mult,
             *fr.uv_offset]
    rc = _lib().film_grain((ct.c_void_p * len(ptrs))(*ptrs),
                           (ct.c_int * len(dims))(*dims),
                           torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"film_grain kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES["film_grain"] += 1
    return out


def occupancy(n_planes, sx, sy):
    """(blocks a SM, SMs) of the kernel's persistent grid on the current
    CUDA device, for n_planes planes subsampled by (sx, sy)."""
    per_sm, sms = ct.c_int(), ct.c_int()
    rc = _lib().film_grain_occupancy(n_planes, sx, sy, ct.byref(per_sm),
                                     ct.byref(sms))
    if rc != 0:
        raise RuntimeError(f"film_grain occupancy query failed: CUDA error "
                           f"{rc}")
    return per_sm.value, sms.value


def film_grain(planes, fr, luts, scal, off):
    """The grain of a frame (film_grain_cuda's contract): one launch of
    the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if planes[0].is_cuda:
        return film_grain_cuda(planes, fr, luts, scal, off)
    from .mc import _cpu_only
    _cpu_only(planes[0])
    return film_grain_plain(planes, fr, luts, scal, off)


def apply_film_grain_device(pic, fh, seq, device):
    """The grained output copy of `pic` (fg_ref.apply_film_grain's
    contract), made on `device` from the picture's clean planes (its
    device planes, or its host planes uploaded); the copy's host planes
    become current at its first host consumer, and `pic` stays clean."""
    if not fh.film_grain_present:
        return pic
    from ..recon.picture import Picture
    from .device import planes_on_device, queue_plane_fetch
    fgd = fh.film_grain_data
    fr = frame_params(fgd, pic, seq)
    luts, scal = grain_tables(fgd, fr.sx, fr.sy, fr.bd, device)
    off = _block_offsets(fgd, -(-fr.h // FG_BLOCK_SIZE),
                         -(-fr.w // FG_BLOCK_SIZE))
    with timing.phase("fg.apply"):
        planes = planes_on_device(pic, device)
        grained = film_grain(planes, fr, luts, scal,
                             torch.from_numpy(off).to(device))
        out = Picture(pic.w, pic.h, pic.layout, pic.bpc)
        out.pending_fetch = queue_plane_fetch(grained, pic.bpc)
        out.host_stale = True
    return out
