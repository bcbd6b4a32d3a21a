"""Motion-compensation reference kernels (vectorized numpy, bit-exact).

Behavioral parity with the reference scalar DSP (reference
src/mc_tmpl.c:51-958): 8-tap/bilin put+prep, compound combines
(avg/w_avg/mask), OBMC & interintra blends, wedge/segmentation masks
(w_mask), affine warp 8x8, and emu_edge. All arithmetic in int32 with
the reference's exact rounding; these are the golden models the JAX/
Pallas kernels are validated against, and the scalar recon path uses
them directly.

Filter semantics (mc_tmpl.c:116-133):
  intermediate_bits = 4 for 8/10-bit (14 - bitdepth for HBD)
  PREP_BIAS = 0 (8-bit) / 8192 (HBD)
  subpel filter row: dav1d_mc_subpel_filters[type][pos-1]; 4-tap small-
  block variants at rows 3+(type&1) when w (or h) <= 4.
"""
from __future__ import annotations

import numpy as np

from .. import tables

_SUBPEL = None
_WARP = None
_OBMC = None


def _subpel_filters():
    global _SUBPEL
    if _SUBPEL is None:
        _SUBPEL = tables.get("dav1d_mc_subpel_filters").astype(np.int32)
    return _SUBPEL


def _warp_filter():
    global _WARP
    if _WARP is None:
        _WARP = tables.get("dav1d_mc_warp_filter").astype(np.int32)
    return _WARP


def obmc_masks():
    global _OBMC
    if _OBMC is None:
        _OBMC = tables.get("dav1d_obmc_masks").astype(np.int32)
    return _OBMC


def intermediate_bits(bpc: int) -> int:
    return 14 - bpc if bpc > 8 else 4


def prep_bias(bpc: int) -> int:
    return 8192 if bpc > 8 else 0


def _h_filter(mx, w, filter_type):
    if not mx:
        return None
    sub = _subpel_filters()
    if w > 4:
        return sub[filter_type & 3][mx - 1]
    return sub[3 + (filter_type & 1)][mx - 1]


def _v_filter(my, h, filter_type):
    if not my:
        return None
    sub = _subpel_filters()
    if h > 4:
        return sub[filter_type >> 2][my - 1]
    return sub[3 + ((filter_type >> 2) & 1)][my - 1]


def _conv8_h(a: np.ndarray, f: np.ndarray, w: int) -> np.ndarray:
    """8-tap horizontal over columns: a has w+7 cols; returns w cols."""
    out = np.zeros((a.shape[0], w), np.int32)
    for i in range(8):
        out += f[i] * a[:, i:i + w]
    return out


def _conv8_v(a: np.ndarray, f: np.ndarray, h: int) -> np.ndarray:
    out = np.zeros((h, a.shape[1]), np.int32)
    for i in range(8):
        out += f[i] * a[i:i + h, :]
    return out


def _rnd(v, sh):
    return (v + ((1 << sh) >> 1)) >> sh


def put_8tap(src: np.ndarray, y: int, x: int, w: int, h: int, mx: int,
             my: int, filter_type: int, bpc: int) -> np.ndarray:
    """reference mc_tmpl.c:130-188 put_8tap_c. src must cover
    [y-3, y+h+4) x [x-3, x+w+4) when subpel taps apply."""
    ib = intermediate_bits(bpc)
    imax_px = (1 << bpc) - 1
    fh = _h_filter(mx, w, filter_type)
    fv = _v_filter(my, h, filter_type)
    if fh is not None:
        if fv is not None:
            a = src[y - 3:y + h + 4, x - 3:x + w + 4].astype(np.int32)
            mid = _rnd(_conv8_h(a, fh, w), 6 - ib)
            out = _rnd(_conv8_v(mid, fv, h), 6 + ib)
            return np.clip(out, 0, imax_px)
        a = src[y:y + h, x - 3:x + w + 4].astype(np.int32)
        irnd = 32 + ((1 << (6 - ib)) >> 1)
        out = (_conv8_h(a, fh, w) + irnd) >> 6
        return np.clip(out, 0, imax_px)
    if fv is not None:
        a = src[y - 3:y + h + 4, x:x + w].astype(np.int32)
        out = _rnd(_conv8_v(a, fv, h), 6)
        return np.clip(out, 0, imax_px)
    return src[y:y + h, x:x + w].astype(np.int32)


def prep_8tap(src: np.ndarray, y: int, x: int, w: int, h: int, mx: int,
              my: int, filter_type: int, bpc: int) -> np.ndarray:
    """reference mc_tmpl.c:246-306 prep_8tap_c (int16 bias domain)."""
    ib = intermediate_bits(bpc)
    pb = prep_bias(bpc)
    fh = _h_filter(mx, w, filter_type)
    fv = _v_filter(my, h, filter_type)
    if fh is not None:
        if fv is not None:
            a = src[y - 3:y + h + 4, x - 3:x + w + 4].astype(np.int32)
            mid = _rnd(_conv8_h(a, fh, w), 6 - ib)
            return _rnd(_conv8_v(mid, fv, h), 6) - pb
        a = src[y:y + h, x - 3:x + w + 4].astype(np.int32)
        return _rnd(_conv8_h(a, fh, w), 6 - ib) - pb
    if fv is not None:
        a = src[y - 3:y + h + 4, x:x + w].astype(np.int32)
        return _rnd(_conv8_v(a, fv, h), 6 - ib) - pb
    return (src[y:y + h, x:x + w].astype(np.int32) << ib) - pb


def _bilin_h(a, mx, w, sh):
    v = 16 * a[:, :w] + mx * (a[:, 1:w + 1].astype(np.int32) - a[:, :w])
    return _rnd(v, sh)


def _bilin_v(a, my, h, sh):
    v = 16 * a[:h, :] + my * (a[1:h + 1, :].astype(np.int32) - a[:h, :])
    return _rnd(v, sh)


def put_bilin(src: np.ndarray, y: int, x: int, w: int, h: int, mx: int,
              my: int, bpc: int) -> np.ndarray:
    """reference mc_tmpl.c:434-490 put_bilin_c."""
    ib = intermediate_bits(bpc)
    imax_px = (1 << bpc) - 1
    if mx:
        if my:
            a = src[y:y + h + 1, x:x + w + 1].astype(np.int32)
            mid = _bilin_h(a, mx, w, 4 - ib)
            out = _bilin_v(mid, my, h, 4 + ib)
            return np.clip(out, 0, imax_px)
        a = src[y:y + h, x:x + w + 1].astype(np.int32)
        px = _bilin_h(a, mx, w, 4 - ib)
        return np.clip((px + ((1 << ib) >> 1)) >> ib, 0, imax_px)
    if my:
        a = src[y:y + h + 1, x:x + w].astype(np.int32)
        return np.clip(_bilin_v(a, my, h, 4), 0, imax_px)
    return src[y:y + h, x:x + w].astype(np.int32)


def prep_bilin(src: np.ndarray, y: int, x: int, w: int, h: int, mx: int,
               my: int, bpc: int) -> np.ndarray:
    """reference mc_tmpl.c:533-587 prep_bilin_c."""
    ib = intermediate_bits(bpc)
    pb = prep_bias(bpc)
    if mx:
        if my:
            a = src[y:y + h + 1, x:x + w + 1].astype(np.int32)
            mid = _bilin_h(a, mx, w, 4 - ib)
            return _bilin_v(mid, my, h, 4) - pb
        a = src[y:y + h, x:x + w + 1].astype(np.int32)
        return _bilin_h(a, mx, w, 4 - ib) - pb
    if my:
        a = src[y:y + h + 1, x:x + w].astype(np.int32)
        return _bilin_v(a, my, h, 4 - ib) - pb
    return (src[y:y + h, x:x + w].astype(np.int32) << ib) - pb


def avg(tmp1: np.ndarray, tmp2: np.ndarray, bpc: int) -> np.ndarray:
    """reference mc_tmpl.c:628-643."""
    ib = intermediate_bits(bpc)
    rnd = (1 << ib) + prep_bias(bpc) * 2
    return np.clip((tmp1 + tmp2 + rnd) >> (ib + 1), 0, (1 << bpc) - 1)


def w_avg(tmp1: np.ndarray, tmp2: np.ndarray, weight: int,
          bpc: int) -> np.ndarray:
    """reference mc_tmpl.c:645-661."""
    ib = intermediate_bits(bpc)
    rnd = (8 << ib) + prep_bias(bpc) * 16
    return np.clip((tmp1 * weight + tmp2 * (16 - weight) + rnd) >> (ib + 4),
                   0, (1 << bpc) - 1)


def mask(tmp1: np.ndarray, tmp2: np.ndarray, m: np.ndarray,
         bpc: int) -> np.ndarray:
    """reference mc_tmpl.c:663-681. m: (h, w) uint8 weights 0..64."""
    ib = intermediate_bits(bpc)
    rnd = (32 << ib) + prep_bias(bpc) * 64
    m = m.astype(np.int32)
    return np.clip((tmp1 * m + tmp2 * (64 - m) + rnd) >> (ib + 6),
                   0, (1 << bpc) - 1)


def blend(dst: np.ndarray, tmp: np.ndarray, m: np.ndarray) -> np.ndarray:
    """reference mc_tmpl.c:683-694 (in-place result returned)."""
    m = m.astype(np.int32)
    return (dst * (64 - m) + tmp * m + 32) >> 6


def blend_v(dst: np.ndarray, tmp: np.ndarray, w: int, h: int) -> np.ndarray:
    """reference mc_tmpl.c:696-707. Blends the left 3/4 of the block."""
    m = obmc_masks()[w:w + ((w * 3) >> 2)]
    out = dst.copy()
    ww = (w * 3) >> 2
    out[:, :ww] = (dst[:, :ww] * (64 - m) + tmp[:, :ww] * m + 32) >> 6
    return out


def blend_h(dst: np.ndarray, tmp: np.ndarray, w: int, h: int) -> np.ndarray:
    """reference mc_tmpl.c:709-722. Blends the top 3/4 of the block."""
    hh = (h * 3) >> 2
    m = obmc_masks()[h:h + hh][:, None]
    out = dst.copy()
    out[:hh, :] = (dst[:hh, :] * (64 - m) + tmp[:hh, :] * m + 32) >> 6
    return out


def w_mask(tmp1: np.ndarray, tmp2: np.ndarray, sign: int, ss_hor: int,
           ss_ver: int, bpc: int):
    """reference mc_tmpl.c:724-768 w_mask_c.
    Returns (dst, mask) where mask has shape (h >> ss_ver, w >> ss_hor)."""
    h, w = tmp1.shape
    ib = intermediate_bits(bpc)
    sh = ib + 6
    rnd = (32 << ib) + prep_bias(bpc) * 64
    mask_sh = bpc + ib - 4
    mask_rnd = 1 << (mask_sh - 5)
    tmpdiff = tmp1 - tmp2
    m = np.minimum(38 + ((np.abs(tmpdiff) + mask_rnd) >> mask_sh), 64)
    dst = np.clip((tmpdiff * m + tmp2 * 64 + rnd) >> sh, 0, (1 << bpc) - 1)
    if ss_hor:
        mpair = m[:, 0::2] + m[:, 1::2]
        if ss_ver:
            out_m = (mpair[0::2] + mpair[1::2] + 2 - sign) >> 2
        else:
            out_m = (mpair + 1 - sign) >> 1
    else:
        out_m = m
    return dst, out_m.astype(np.uint8)


def warp_affine_8x8(src: np.ndarray, y: int, x: int, abcd, mx: int,
                    my: int, bpc: int) -> np.ndarray:
    """reference mc_tmpl.c:799-832. src must cover
    [y-3, y+11) x [x-3, x+11)."""
    ib = intermediate_bits(bpc)
    wf = _warp_filter()
    mid = np.zeros((15, 8), np.int32)
    a = src[y - 3:y + 12, x - 3:x + 12].astype(np.int32)
    row_mx = mx
    for yy in range(15):
        tmx = row_mx
        for xx in range(8):
            f = wf[64 + ((tmx + 512) >> 10)]
            mid[yy, xx] = _rnd((f * a[yy, xx:xx + 8]).sum(), 7 - ib)
            tmx += abcd[0]
        row_mx += abcd[1]
    out = np.zeros((8, 8), np.int32)
    row_my = my
    for yy in range(8):
        tmy = row_my
        for xx in range(8):
            f = wf[64 + ((tmy + 512) >> 10)]
            out[yy, xx] = _rnd((f * mid[yy:yy + 8, xx]).sum(), 7 + ib)
            tmy += abcd[2]
        row_my += abcd[3]
    return np.clip(out, 0, (1 << bpc) - 1)


def warp_affine_8x8t(src: np.ndarray, y: int, x: int, abcd, mx: int,
                     my: int, bpc: int) -> np.ndarray:
    """reference mc_tmpl.c:834-866 (prep domain)."""
    ib = intermediate_bits(bpc)
    pb = prep_bias(bpc)
    wf = _warp_filter()
    mid = np.zeros((15, 8), np.int32)
    a = src[y - 3:y + 12, x - 3:x + 12].astype(np.int32)
    row_mx = mx
    for yy in range(15):
        tmx = row_mx
        for xx in range(8):
            f = wf[64 + ((tmx + 512) >> 10)]
            mid[yy, xx] = _rnd((f * a[yy, xx:xx + 8]).sum(), 7 - ib)
            tmx += abcd[0]
        row_mx += abcd[1]
    out = np.zeros((8, 8), np.int32)
    row_my = my
    for yy in range(8):
        tmy = row_my
        for xx in range(8):
            f = wf[64 + ((tmy + 512) >> 10)]
            out[yy, xx] = _rnd((f * mid[yy:yy + 8, xx]).sum(), 7) - pb
            tmy += abcd[2]
        row_my += abcd[3]
    return out


def emu_edge(bw: int, bh: int, iw: int, ih: int, x: int, y: int,
             ref: np.ndarray) -> np.ndarray:
    """reference mc_tmpl.c:868-916: clamp-extend a (bh, bw) block whose
    top-left is (y, x) in a (ih, iw) picture."""
    ys = np.clip(np.arange(y, y + bh), 0, ih - 1)
    xs = np.clip(np.arange(x, x + bw), 0, iw - 1)
    return ref[np.ix_(ys, xs)]


# ---------------------------------------------------------------------------
# wedge / interintra masks (reference src/wedge.h:34-92 Dav1dMasks)
# ---------------------------------------------------------------------------
_MASKS_BLOB = None
_MASK_OFFSETS = None
N_INTER_INTRA_PRED_MODES = 4


def _masks():
    """Parse the dumped Dav1dMasks blob: leading offsets table
    (uint16, units of 8 bytes from struct start) then the mask bytes."""
    global _MASKS_BLOB, _MASK_OFFSETS
    if _MASKS_BLOB is None:
        blob = tables.get("dav1d_masks")
        _MASKS_BLOB = blob
        # offsets[3][BS_8x8 - BS_32x32 + 1 = 11] (reference wedge.h:39)
        n_off = 3 * 11 * (2 * 16 + N_INTER_INTRA_PRED_MODES)
        off = blob[:n_off * 2].view(np.uint16).reshape(
            3, 11, 2 * 16 + N_INTER_INTRA_PRED_MODES)
        _MASK_OFFSETS = off
    return _MASKS_BLOB, _MASK_OFFSETS


# BS_32x32..BS_8x8 index into the offsets table (wedge.h offsets[][])
BS_32X32 = 7  # lv.BS_32x32


def wedge_mask(layout_idx: int, bs: int, sign: int, idx: int, w: int,
               h: int) -> np.ndarray:
    """WEDGE_MASK(c, bs, sign, idx) (reference wedge.h:88-91).
    layout_idx: 0=444, 1=422, 2=420; w/h in the mask's plane domain."""
    blob, off = _masks()
    o = int(off[layout_idx, bs - BS_32X32, sign * 16 + idx]) * 8
    return blob[o:o + w * h].reshape(h, w)


def ii_mask(layout_idx: int, bs: int, interintra_type: int,
            interintra_mode: int, wedge_idx: int, w: int,
            h: int) -> np.ndarray:
    """II_MASK(c, bs, b) (reference wedge.h:83-86).
    interintra_type: 1=blend (uses ii[mode]), 2=wedge (uses
    wedge[0][wedge_idx])."""
    blob, off = _masks()
    INTER_INTRA_BLEND = 1
    if interintra_type == INTER_INTRA_BLEND:
        o = int(off[layout_idx, bs - BS_32X32, 2 * 16 + interintra_mode]) * 8
    else:
        o = int(off[layout_idx, bs - BS_32X32, wedge_idx]) * 8
    return blob[o:o + w * h].reshape(h, w)


# Filter2d -> put/prep_8tap filter_type (h | v<<2); reference
# mc_tmpl.c:968-977 init order with levels.h:184-196 enum
FILTER2D_TO_TYPE = [0, 4, 8, 2, 6, 10, 1, 5, 9, -1]  # -1 = bilinear


def put_8tap_scaled(src: np.ndarray, y: int, x: int, w: int, h: int,
                    mx: int, my: int, dx: int, dy: int, filter_type: int,
                    bpc: int) -> np.ndarray:
    """reference mc_tmpl.c:189-245 put_8tap_scaled_c.
    (y, x): position of the first sample; mx/my: initial 10-bit subpel
    phases; dx/dy: per-pixel steps."""
    ib = intermediate_bits(bpc)
    irnd = (1 << ib) >> 1
    sub = _subpel_filters()
    out = np.zeros((h, w), np.int32)
    # horizontal pass rows are produced on demand; emulate with a cache
    hrows = {}

    def hrow(sy):
        if sy in hrows:
            return hrows[sy]
        row = np.zeros(w, np.int32)
        imx, ioff = mx, 0
        srow = src[y + sy].astype(np.int32)
        for ox in range(w):
            hmx = imx >> 6
            if hmx:
                fh = sub[filter_type & 3][hmx - 1] if w > 4 else \
                    sub[3 + (filter_type & 1)][hmx - 1]
                v = 0
                for i in range(8):
                    v += int(fh[i]) * int(srow[x + ioff - 3 + i])
                row[ox] = _rnd(v, 6 - ib)
            else:
                row[ox] = int(srow[x + ioff]) << ib
            imx += dx
            ioff += imx >> 10
            imx &= 0x3FF
        hrows[sy] = row
        return row

    cmy = my
    for oy in range(h):
        src_y = cmy >> 10
        vmy = (cmy & 0x3FF) >> 6
        if vmy:
            fv = sub[filter_type >> 2][vmy - 1] if h > 4 else \
                sub[3 + ((filter_type >> 2) & 1)][vmy - 1]
            v = np.zeros(w, np.int64)
            for i in range(8):
                v += int(fv[i]) * hrow(src_y - 3 + i).astype(np.int64)
            out[oy] = np.clip(_rnd(v, 6 + ib), 0, (1 << bpc) - 1)
        else:
            out[oy] = np.clip((hrow(src_y) + irnd) >> ib, 0,
                              (1 << bpc) - 1)
        cmy += dy
    return out


def prep_8tap_scaled(src: np.ndarray, y: int, x: int, w: int, h: int,
                     mx: int, my: int, dx: int, dy: int, filter_type: int,
                     bpc: int) -> np.ndarray:
    """reference mc_tmpl.c:307-360 prep_8tap_scaled_c."""
    ib = intermediate_bits(bpc)
    pb = prep_bias(bpc)
    sub = _subpel_filters()
    out = np.zeros((h, w), np.int32)
    hrows = {}

    def hrow(sy):
        if sy in hrows:
            return hrows[sy]
        row = np.zeros(w, np.int32)
        imx, ioff = mx, 0
        srow = src[y + sy].astype(np.int32)
        for ox in range(w):
            hmx = imx >> 6
            if hmx:
                fh = sub[filter_type & 3][hmx - 1] if w > 4 else \
                    sub[3 + (filter_type & 1)][hmx - 1]
                v = 0
                for i in range(8):
                    v += int(fh[i]) * int(srow[x + ioff - 3 + i])
                row[ox] = _rnd(v, 6 - ib)
            else:
                row[ox] = int(srow[x + ioff]) << ib
            imx += dx
            ioff += imx >> 10
            imx &= 0x3FF
        hrows[sy] = row
        return row

    cmy = my
    for oy in range(h):
        src_y = cmy >> 10
        vmy = (cmy & 0x3FF) >> 6
        if vmy:
            fv = sub[filter_type >> 2][vmy - 1] if h > 4 else \
                sub[3 + ((filter_type >> 2) & 1)][vmy - 1]
            v = np.zeros(w, np.int64)
            for i in range(8):
                v += int(fv[i]) * hrow(src_y - 3 + i).astype(np.int64)
            out[oy] = _rnd(v, 6) - pb
        else:
            out[oy] = hrow(src_y) - pb
        cmy += dy
    return out


_RESIZE = None


def _resize_filter():
    global _RESIZE
    if _RESIZE is None:
        _RESIZE = tables.get("dav1d_resize_filter").astype(np.int32)
    return _RESIZE


def _bilin_scaled_rows(src, y, x, w, h, mx, my, dx, dy, ib):
    """Shared h/v walk of the bilin scaled kernels (reference
    mc_tmpl.c:492-589 put/prep_bilin_scaled_c). Yields (mid1, mid2,
    vmy4) per output row; rows are 16*(4-ib)-domain intermediates."""
    hrows = {}

    def hrow(sy):
        if sy in hrows:
            return hrows[sy]
        row = np.zeros(w, np.int32)
        srow = src[y + sy].astype(np.int32)
        imx, ioff = mx, 0
        for ox in range(w):
            hmx = imx >> 6
            v = 16 * int(srow[x + ioff]) + hmx * (
                int(srow[x + ioff + 1]) - int(srow[x + ioff]))
            row[ox] = _rnd(v, 4 - ib)
            imx += dx
            ioff += imx >> 10
            imx &= 0x3FF
        hrows[sy] = row
        return row

    cmy = my
    for _oy in range(h):
        sy = cmy >> 10
        yield hrow(sy), hrow(sy + 1), (cmy & 0x3FF) >> 6
        cmy += dy


def put_bilin_scaled(src: np.ndarray, y: int, x: int, w: int, h: int,
                     mx: int, my: int, dx: int, dy: int,
                     bpc: int) -> np.ndarray:
    """reference mc_tmpl.c:492-538 put_bilin_scaled_c."""
    ib = intermediate_bits(bpc)
    out = np.zeros((h, w), np.int32)
    for oy, (m1, m2, vmy) in enumerate(
            _bilin_scaled_rows(src, y, x, w, h, mx, my, dx, dy, ib)):
        v = 16 * m1 + vmy * (m2 - m1)
        out[oy] = np.clip(_rnd(v, 4 + ib), 0, (1 << bpc) - 1)
    return out


def prep_bilin_scaled(src: np.ndarray, y: int, x: int, w: int, h: int,
                      mx: int, my: int, dx: int, dy: int,
                      bpc: int) -> np.ndarray:
    """reference mc_tmpl.c:540-589 prep_bilin_scaled_c."""
    ib = intermediate_bits(bpc)
    pb = prep_bias(bpc)
    out = np.zeros((h, w), np.int32)
    for oy, (m1, m2, vmy) in enumerate(
            _bilin_scaled_rows(src, y, x, w, h, mx, my, dx, dy, ib)):
        v = 16 * m1 + vmy * (m2 - m1)
        out[oy] = _rnd(v, 4) - pb
    return out


def resize_row(src_row: np.ndarray, dst_w: int, src_w: int, dx: int,
               mx0: int, bpc: int) -> np.ndarray:
    """reference mc_tmpl.c:918-958 resize_c (one row)."""
    F = _resize_filter()
    out = np.zeros(dst_w, np.int32)
    mx = mx0
    src_x = -1
    s = src_row.astype(np.int32)
    for ox in range(dst_w):
        f = F[mx >> 8]
        v = 0
        for i in range(8):
            v += int(f[i]) * int(s[min(max(src_x - 3 + i, 0), src_w - 1)])
        out[ox] = min(max((-v + 64) >> 7, 0), (1 << bpc) - 1)
        mx += dx
        src_x += mx >> 14
        mx &= 0x3FFF
    return out


def scale_fac(ref_sz: int, this_sz: int) -> int:
    return ((ref_sz << 14) + (this_sz >> 1)) // this_sz


def get_upscale_x0(in_w: int, out_w: int, step: int) -> int:
    """reference decode.c:3321-3325."""
    err = out_w * step - (in_w << 14)
    x0 = (-((out_w - in_w) << 13) + (out_w >> 1)) // out_w + 128 - (err // 2)
    return x0 & 0x3FFF


def resize_plane(src: np.ndarray, src_w: int, h: int, dst_w: int,
                 step: int, mx0: int, bpc: int) -> np.ndarray:
    out = np.zeros((h, dst_w), np.int32)
    for yy in range(h):
        out[yy] = resize_row(src[yy], dst_w, src_w, step, mx0, bpc)
    return out
