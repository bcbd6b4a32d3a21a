"""Intra prediction — scalar-exact reference implementation.

All AV1 intra predictors with the reference's exact integer semantics
(reference src/ipred_tmpl.c:58-782): DC family, V/H, paeth, smooth
family, directional Z1/Z2/Z3 with edge filter/upsampling, filter-intra,
CFL (ac extraction + prediction), palette. Plus the edge constructor
dav1d_prepare_intra_edges (reference src/ipred_prepare_tmpl.c:36-203).

Works on numpy int32/uint16 planes; the edge buffer convention matches
the reference: topleft_out index 0 = top-left pixel, [1..] top row,
[-1..] left column (we realize it as a center-anchored array).
"""
from __future__ import annotations

import numpy as np

from .. import tables
from ..entropy import levels as lv
from ..entropy.intra_edge import (EDGE_I444_TOP_HAS_RIGHT,
                                  EDGE_I444_LEFT_HAS_BOTTOM)

ANGLE_USE_EDGE_FILTER_FLAG = 1024
ANGLE_SMOOTH_EDGE_FLAG = 512

# DSP-level mode indices beyond the coded ones
DC_PRED, VERT_PRED, HOR_PRED = 0, 1, 2
LEFT_DC_PRED, TOP_DC_PRED, DC_128_PRED, Z1_PRED, Z2_PRED, Z3_PRED = range(3, 9)
SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED, PAETH_PRED = 9, 10, 11, 12
FILTER_PRED = 13

_MODE_TO_ANGLE = [90, 180, 45, 135, 113, 157, 203, 67]

_EDGE_REQ = {
    # mode: (left, top, topleft, topright, bottomleft)
    DC_PRED: (1, 1, 0, 0, 0),
    VERT_PRED: (0, 1, 0, 0, 0),
    HOR_PRED: (1, 0, 0, 0, 0),
    LEFT_DC_PRED: (1, 0, 0, 0, 0),
    TOP_DC_PRED: (0, 1, 0, 0, 0),
    DC_128_PRED: (0, 0, 0, 0, 0),
    Z1_PRED: (0, 1, 1, 1, 0),
    Z2_PRED: (1, 1, 1, 0, 0),
    Z3_PRED: (1, 0, 1, 0, 1),
    SMOOTH_PRED: (1, 1, 0, 0, 0),
    SMOOTH_V_PRED: (1, 1, 0, 0, 0),
    SMOOTH_H_PRED: (1, 1, 0, 0, 0),
    PAETH_PRED: (1, 1, 1, 0, 0),
    FILTER_PRED: (1, 1, 1, 0, 0),
}


class Edge:
    """Center-anchored edge buffer: buf[center + i] == topleft_out[i]."""

    __slots__ = ("buf", "center")

    def __init__(self, size=257):
        self.buf = np.zeros(2 * 160 + 1, np.int32)
        self.center = 160

    def __getitem__(self, i):
        return self.buf[self.center + i]

    def __setitem__(self, i, v):
        self.buf[self.center + i] = v

    def rng(self, lo, n):
        """View of topleft_out[lo .. lo+n-1]."""
        return self.buf[self.center + lo: self.center + lo + n]


def prepare_intra_edges(x, have_left, y, have_top, w, h, edge_flags,
                        dst_plane, px, py, top_sb_edge_row, mode, angle,
                        tw, th, filter_edge, edge: Edge, bitdepth):
    """reference ipred_prepare_tmpl.c:74-203. Coordinates:
    x/y block position (4px units, absolute); w/h tile end (4px units);
    px/py pixel position of the block in dst_plane; top_sb_edge_row is
    the saved pre-filter row (np 1-D across the plane) or None.
    Returns (dsp_mode, angle_out)."""
    if VERT_PRED <= mode <= lv.VERT_LEFT_PRED:
        angle = _MODE_TO_ANGLE[mode - VERT_PRED] + 3 * angle
        if angle <= 90:
            mode = Z1_PRED if angle < 90 and have_top else VERT_PRED
        elif angle < 180:
            mode = Z2_PRED
        else:
            mode = Z3_PRED if angle > 180 and have_left else HOR_PRED
    elif mode == DC_PRED:
        mode = (DC_PRED if have_top else LEFT_DC_PRED) if have_left else \
            (TOP_DC_PRED if have_top else DC_128_PRED)
    elif mode == PAETH_PRED:
        mode = (PAETH_PRED if have_top else HOR_PRED) if have_left else \
            (VERT_PRED if have_top else DC_128_PRED)

    needs_left, needs_top, needs_topleft, needs_topright, needs_bottomleft = \
        _EDGE_REQ[mode]

    def dst_top(i):
        if top_sb_edge_row is not None:
            return int(top_sb_edge_row[x * 4 + i])
        return int(dst_plane[py - 1, px + i])

    def dst_top_vec(i0, n):
        if top_sb_edge_row is not None:
            return top_sb_edge_row[x * 4 + i0:x * 4 + i0 + n]
        return dst_plane[py - 1, px + i0:px + i0 + n]

    have_dst_top = have_top and (needs_top or needs_topleft or
                                 (needs_left and not have_left))

    if needs_left:
        sz = th << 2
        if have_left:
            px_have = min(sz, (h - y) << 2)
            edge.rng(-px_have, px_have)[:] = \
                dst_plane[py:py + px_have, px - 1][::-1]
            if px_have < sz:
                edge.rng(-sz, sz - px_have)[:] = edge[-px_have]
        else:
            fill = dst_top(0) if have_dst_top else ((1 << bitdepth) >> 1) + 1
            edge.rng(-sz, sz)[:] = fill
        if needs_bottomleft:
            have_bl = 0 if (not have_left or y + th >= h) else \
                (edge_flags & EDGE_I444_LEFT_HAS_BOTTOM)
            if have_bl:
                px_have = min(sz, (h - y - th) << 2)
                edge.rng(-sz - px_have, px_have)[:] = \
                    dst_plane[py + sz:py + sz + px_have, px - 1][::-1]
                if px_have < sz:
                    edge.rng(-2 * sz, sz - px_have)[:] = edge[-sz - px_have]
            else:
                edge.rng(-2 * sz, sz)[:] = edge[-sz]

    if needs_top:
        sz = tw << 2
        if have_top:
            px_have = min(sz, (w - x) << 2)
            edge.rng(1, px_have)[:] = dst_top_vec(0, px_have)
            if px_have < sz:
                edge.rng(1 + px_have, sz - px_have)[:] = edge[px_have]
        else:
            fill = int(dst_plane[py, px - 1]) if have_left \
                else ((1 << bitdepth) >> 1) - 1
            edge.rng(1, sz)[:] = fill
        if needs_topright:
            have_tr = 0 if (not have_top or x + tw >= w) else \
                (edge_flags & EDGE_I444_TOP_HAS_RIGHT)
            if have_tr:
                px_have = min(sz, (w - x - tw) << 2)
                edge.rng(1 + sz, px_have)[:] = dst_top_vec(sz, px_have)
                if px_have < sz:
                    edge.rng(1 + sz + px_have, sz - px_have)[:] = \
                        edge[sz + px_have]
            else:
                edge.rng(1 + sz, sz)[:] = edge[sz]

    if needs_topleft:
        if have_left:
            edge[0] = dst_top(-1) if have_top else int(dst_plane[py, px - 1])
        else:
            edge[0] = dst_top(0) if have_top else (1 << bitdepth) >> 1
        if mode == Z2_PRED and tw + th >= 6 and filter_edge:
            edge[0] = ((int(edge[-1]) + int(edge[1])) * 5 +
                       int(edge[0]) * 6 + 8) >> 4

    return mode, angle


# ---------------------------------------------------------------------------
# predictors: fn(edge, width, height, angle, bitdepth) -> (h, w) int32
# ---------------------------------------------------------------------------

def _splat(v, w, h):
    return np.full((h, w), v, np.int32)


def _dc_gen_top(e: Edge, w):
    return (int(e.rng(1, w).sum()) + (w >> 1)) >> w.bit_length() - 1


def _dc_gen_left(e: Edge, h):
    return (int(e.rng(-h, h).sum()) + (h >> 1)) >> h.bit_length() - 1


def _dc_gen(e: Edge, w, h, bitdepth):
    dc = (w + h) >> 1
    dc += int(e.rng(1, w).sum()) + int(e.rng(-h, h).sum())
    dc >>= ((w + h) & -(w + h)).bit_length() - 1   # ctz(w + h)
    if w != h:
        if bitdepth == 8:
            mult = 0x3334 if (w > h * 2 or h > w * 2) else 0x5556
            dc = (dc * mult) >> 16
        else:
            mult = 0x6667 if (w > h * 2 or h > w * 2) else 0xAAAB
            dc = (dc * mult) >> 17
    return dc


def ipred_dc(e, w, h, angle, bd):
    return _splat(_dc_gen(e, w, h, bd), w, h)


def ipred_dc_128(e, w, h, angle, bd):
    return _splat((1 << bd) >> 1, w, h)


def ipred_dc_top(e, w, h, angle, bd):
    return _splat(_dc_gen_top(e, w), w, h)


def ipred_dc_left(e, w, h, angle, bd):
    return _splat(_dc_gen_left(e, h), w, h)


def ipred_v(e, w, h, angle, bd):
    return np.tile(e.rng(1, w).astype(np.int32), (h, 1))


def ipred_h(e, w, h, angle, bd):
    left = e.rng(-h, h)[::-1].astype(np.int32)   # top-most first
    return np.tile(left[:, None], (1, w))


def ipred_paeth(e, w, h, angle, bd):
    topleft = int(e[0])
    top = e.rng(1, w).astype(np.int32)[None, :]
    left = e.rng(-h, h)[::-1].astype(np.int32)[:, None]
    base = left + top - topleft
    ldiff = np.abs(left - base)
    tdiff = np.abs(top - base)
    tldiff = np.abs(topleft - base)
    out = np.where((ldiff <= tdiff) & (ldiff <= tldiff),
                   np.broadcast_to(left, (h, w)),
                   np.where(tdiff <= tldiff,
                            np.broadcast_to(top, (h, w)), topleft))
    return out.astype(np.int32)


def _sm_weights(n):
    return tables.get("dav1d_sm_weights")[n:n + n].astype(np.int32)


def ipred_smooth(e, w, h, angle, bd):
    wh = _sm_weights(w)[None, :]
    wv = _sm_weights(h)[:, None]
    right = int(e[w])
    bottom = int(e[-h])
    top = e.rng(1, w).astype(np.int32)[None, :]
    left = e.rng(-h, h)[::-1].astype(np.int32)[:, None]
    pred = wv * top + (256 - wv) * bottom + wh * left + (256 - wh) * right
    return (pred + 256) >> 9


def ipred_smooth_v(e, w, h, angle, bd):
    wv = _sm_weights(h)[:, None]
    bottom = int(e[-h])
    top = e.rng(1, w).astype(np.int32)[None, :]
    pred = wv * top + (256 - wv) * bottom
    return (pred + 128) >> 8


def ipred_smooth_h(e, w, h, angle, bd):
    wh = _sm_weights(w)[None, :]
    right = int(e[w])
    left = e.rng(-h, h)[::-1].astype(np.int32)[:, None]
    pred = wh * left + (256 - wh) * right
    return (pred + 128) >> 8


def _get_filter_strength(wh, angle, is_sm):
    """reference ipred_tmpl.c:330-361."""
    if is_sm:
        if wh <= 8:
            if angle >= 64:
                return 2
            if angle >= 40:
                return 1
        elif wh <= 16:
            if angle >= 48:
                return 2
            if angle >= 20:
                return 1
        elif wh <= 24:
            if angle >= 4:
                return 3
        else:
            return 3
    else:
        if wh <= 8:
            if angle >= 56:
                return 1
        elif wh <= 16:
            if angle >= 40:
                return 1
        elif wh <= 24:
            if angle >= 32:
                return 3
            if angle >= 16:
                return 2
            if angle >= 8:
                return 1
        elif wh <= 32:
            if angle >= 32:
                return 3
            if angle >= 4:
                return 2
            return 1
        else:
            return 3
    return 0


_EDGE_KERNELS = np.array([[0, 4, 8, 4, 0], [0, 5, 6, 5, 0], [2, 4, 4, 4, 2]],
                         np.int32)


def _filter_edge(sz, lim_from, lim_to, src, src_from, src_to, strength):
    """reference ipred_tmpl.c:363-386. src: callable i -> value with
    clipping indices [src_from, src_to); may carry (arr, base) attrs
    for a vectorized gather."""
    kern = _EDGE_KERNELS[strength - 1]
    idx = np.clip(np.arange(-2, sz + 2), src_from, src_to - 1)
    arrbase = getattr(src, "arrbase", None)
    if arrbase is not None:
        arr, base = arrbase
        vals = arr[base + idx].astype(np.int64)
    else:
        vals = np.array([src(int(i)) for i in idx], np.int64)
    acc = np.zeros(sz, np.int64)
    for j in range(5):
        k = int(kern[j])
        if k:
            acc += vals[j:j + sz] * k
    filt = (acc + 8) >> 4
    i = np.arange(sz)
    passthru = vals[2:2 + sz]          # idx[i+2] == clip(i, ...)
    out = np.where((i < min(sz, lim_from)) | (i >= min(lim_to, sz)),
                   passthru, filt)
    return out.astype(np.int32)


def _get_upsample(wh, angle, is_sm):
    return angle < 40 and wh <= (16 >> is_sm)


def _upsample_edge(hsz, src, src_from, src_to, bd):
    """reference ipred_tmpl.c:392-407; returns 2*hsz-1 values."""
    out = np.zeros(hsz * 2, np.int32)
    bd_max = (1 << bd) - 1
    idx = np.clip(np.arange(-1, hsz + 1), src_from, src_to - 1)
    arrbase = getattr(src, "arrbase", None)
    if arrbase is not None:
        arr, base = arrbase
        vals = arr[base + idx].astype(np.int64)
    else:
        vals = np.array([src(int(i)) for i in idx], np.int64)
    n = hsz - 1
    out[0:2 * n:2] = vals[1:1 + n]
    s = (-vals[0:n] + 9 * vals[1:1 + n] + 9 * vals[2:2 + n]
         - vals[3:3 + n] + 8) >> 4
    out[1:2 * n:2] = np.clip(s, 0, bd_max)
    out[n * 2] = vals[1 + n]
    return out


def ipred_z1(e, w, h, angle, bd):
    is_sm = (angle >> 9) & 1
    enable_ief = angle >> 10
    angle &= 511
    dx = int(tables.get("dav1d_dr_intra_derivative")[angle >> 1])
    upsample_above = _get_upsample(w + h, 90 - angle, is_sm) if enable_ief else 0

    def src(i):
        return int(e[1 + i])
    src.arrbase = (e.buf, e.center + 1)

    if upsample_above:
        top = _upsample_edge(w + h, src, -1, w + min(w, h), bd)
        max_base_x = 2 * (w + h) - 2
        dx <<= 1
    else:
        strength = _get_filter_strength(w + h, 90 - angle, is_sm) \
            if enable_ief else 0
        if strength:
            top = _filter_edge(w + h, 0, w + h, src, -1, w + min(w, h),
                               strength)
            max_base_x = w + h - 1
        else:
            top = e.buf[e.center + 1:e.center + 1 + w + min(w, h)] \
                .astype(np.int32)
            max_base_x = w + min(w, h) - 1
    base_inc = 1 + upsample_above
    top = np.asarray(top, np.int64)
    xpos = dx * np.arange(1, h + 1)
    frac = (xpos & 0x3E)[:, None]
    base = (xpos >> 6)[:, None] + np.arange(w)[None, :] * base_inc
    bc = np.minimum(base, max_base_x)
    v = top[bc] * (64 - frac) + top[np.minimum(bc + 1, top.shape[0] - 1)] \
        * frac
    out = np.where(base < max_base_x, (v + 32) >> 6, top[max_base_x])
    return out.astype(np.int32)


def ipred_z2(e, w, h, angle, bd, max_width, max_height):
    is_sm = (angle >> 9) & 1
    enable_ief = angle >> 10
    angle &= 511
    deriv = tables.get("dav1d_dr_intra_derivative")
    dy = int(deriv[(angle - 90) >> 1])
    dx = int(deriv[(180 - angle) >> 1])
    upsample_left = _get_upsample(w + h, 180 - angle, is_sm) if enable_ief else 0
    upsample_above = _get_upsample(w + h, angle - 90, is_sm) if enable_ief else 0

    # local edge buffer centered at 64
    buf = np.zeros(64 + 64 + 1, np.int32)
    C = 64

    def src_top(i):      # topleft_in[1 + i]
        return int(e[1 + i])
    src_top.arrbase = (e.buf, e.center + 1)

    def src_tl(i):       # topleft_in[i]
        return int(e[i])
    src_tl.arrbase = (e.buf, e.center)

    if upsample_above:
        up = _upsample_edge(w + 1, src_tl, 0, w + 1, bd)
        buf[C:C + 2 * w + 1] = up[:2 * w + 1]
        dx <<= 1
    else:
        strength = _get_filter_strength(w + h, angle - 90, is_sm) \
            if enable_ief else 0
        if strength:
            buf[C + 1:C + 1 + w] = _filter_edge(w, 0, max_width, src_top,
                                                -1, w, strength)
        else:
            buf[C + 1:C + 1 + w] = e.buf[e.center + 1:e.center + 1 + w]
    if upsample_left:
        def src_l(i):    # topleft_in[-height + i]
            return int(e[-h + i])
        src_l.arrbase = (e.buf, e.center - h)
        up = _upsample_edge(h + 1, src_l, 0, h + 1, bd)
        buf[C - 2 * h:C + 1] = up[:2 * h + 1]
        dy <<= 1
    else:
        strength = _get_filter_strength(w + h, 180 - angle, is_sm) \
            if enable_ief else 0
        if strength:
            def src_l(i):
                return int(e[-h + i])
            src_l.arrbase = (e.buf, e.center - h)
            buf[C - h:C] = _filter_edge(h, h - max_height, h, src_l,
                                        0, h + 1, strength)
        else:
            buf[C - h:C] = e.buf[e.center - h:e.center]
    buf[C] = int(e[0])

    base_inc_x = 1 + upsample_above
    left_off = -(1 + upsample_left)
    b64 = buf.astype(np.int64)
    ys = np.arange(h)[:, None]
    xs = np.arange(w)[None, :]
    xpos = ((1 + upsample_above) << 6) - dx * (ys + 1)
    base_x = (xpos >> 6) + xs * base_inc_x
    frac_x = xpos & 0x3E
    ia = np.clip(C + base_x, 0, b64.shape[0] - 2)
    va = b64[ia] * (64 - frac_x) + b64[ia + 1] * frac_x
    ypos = (ys << (6 + upsample_left)) - dy * (xs + 1)
    base_y = ypos >> 6
    frac_y = ypos & 0x3E
    il = np.clip(C + left_off - base_y, 1, b64.shape[0] - 1)
    vl = b64[il] * (64 - frac_y) + b64[il - 1] * frac_y
    out = np.where(base_x >= 0, (va + 32) >> 6, (vl + 32) >> 6)
    return out.astype(np.int32)


def ipred_z3(e, w, h, angle, bd):
    is_sm = (angle >> 9) & 1
    enable_ief = angle >> 10
    angle &= 511
    dy = int(tables.get("dav1d_dr_intra_derivative")[(270 - angle) >> 1])
    upsample_left = _get_upsample(w + h, angle - 180, is_sm) if enable_ief else 0

    def src(i):      # topleft_in[-(w+h) + i]
        return int(e[-(w + h) + i])
    src.arrbase = (e.buf, e.center - (w + h))

    if upsample_left:
        arr = _upsample_edge(w + h, src, max(w - h, 0), w + h + 1, bd)
        # left[-i] = arr[2*(w+h)-2 - i]
        base_arr = arr
        left_anchor = 2 * (w + h) - 2
        max_base_y = 2 * (w + h) - 2
        dy <<= 1
    else:
        strength = _get_filter_strength(w + h, angle - 180, is_sm) \
            if enable_ief else 0
        if strength:
            base_arr = _filter_edge(w + h, 0, w + h, src, max(w - h, 0),
                                    w + h + 1, strength)
            left_anchor = w + h - 1
            max_base_y = w + h - 1
        else:
            base_arr = e.buf[e.center - (w + h):e.center] \
                .astype(np.int32)
            left_anchor = w + h - 1   # left = topleft_in[-1]
            max_base_y = h + min(w, h) - 1
    base_inc = 1 + upsample_left
    arr = np.asarray(base_arr, np.int64)
    ys = np.arange(h)[:, None]
    xs = np.arange(w)[None, :]
    ypos = dy * (xs + 1)
    frac = ypos & 0x3E
    base = (ypos >> 6) + ys * base_inc
    bc = np.minimum(base, max_base_y)
    i0 = np.clip(left_anchor - bc, 0, arr.shape[0] - 1)
    i1 = np.clip(left_anchor - bc - 1, 0, arr.shape[0] - 1)
    v = arr[i0] * (64 - frac) + arr[i1] * frac
    out = np.where(base < max_base_y, (v + 32) >> 6,
                   arr[left_anchor - max_base_y])
    return out.astype(np.int32)


_FILTER_TAPS = {}


def _filter_tap_matrix(filt_idx):
    """(8, 7) de-interleaved taps from the x86 layout the table dump
    carries (reference tables.c:751-757): row fi = taps for output
    pixel fi, columns p0..p6."""
    m = _FILTER_TAPS.get(filt_idx)
    if m is None:
        flt = tables.get("dav1d_filter_intra_taps")[filt_idx]             .astype(np.int64)
        m = np.zeros((8, 7), np.int64)
        for fi in range(8):
            m[fi] = (flt[2 * fi], flt[2 * fi + 1], flt[16 + 2 * fi],
                     flt[17 + 2 * fi], flt[32 + 2 * fi], flt[33 + 2 * fi],
                     flt[48 + 2 * fi])
        _FILTER_TAPS[filt_idx] = m = [[int(v) for v in row] for row in m]
    return m


def ipred_filter(e, w, h, filt_idx, bd):
    """reference ipred_tmpl.c:620-659. 4x2 blocks have a raster
    wavefront dependency (left/top outputs feed the next block), so the
    walk is scalar; the 8-tap accumulation per block is unrolled on
    Python ints (no per-pixel ufunc dispatch)."""
    filt_idx &= 511
    M = _filter_tap_matrix(filt_idx)
    bd_max = (1 << bd) - 1
    eb, ec = e.buf, e.center
    out = [[0] * w for _ in range(h)]

    for y in range(0, h, 2):
        for x in range(0, w, 4):
            if y == 0:
                p0 = int(eb[ec + x - 1 + 1]) if x else int(eb[ec])
                p1, p2, p3, p4 = (int(eb[ec + 1 + x]), int(eb[ec + 2 + x]),
                                  int(eb[ec + 3 + x]), int(eb[ec + 4 + x]))
            else:
                row = out[y - 1]
                p0 = row[x - 1] if x else int(eb[ec - y])
                p1, p2, p3, p4 = row[x], row[x + 1], row[x + 2], row[x + 3]
            if x:
                p5, p6 = out[y][x - 1], out[y + 1][x - 1]
            else:
                p5, p6 = int(eb[ec - (y + 1)]), int(eb[ec - (y + 2)])
            r0, r1 = out[y], out[y + 1]
            for fi in range(8):
                t = M[fi]
                acc = (t[0] * p0 + t[1] * p1 + t[2] * p2 + t[3] * p3 +
                       t[4] * p4 + t[5] * p5 + t[6] * p6 + 8) >> 4
                if acc < 0:
                    acc = 0
                elif acc > bd_max:
                    acc = bd_max
                if fi < 4:
                    r0[x + fi] = acc
                else:
                    r1[x + fi - 4] = acc
    return np.asarray(out, np.int32)


def cfl_ac(y_plane, py, px, ss_hor, ss_ver, w_pad, h_pad, cw, ch):
    """Chroma-from-luma AC extraction (reference ipred_tmpl.c:661-720).
    y_plane: luma plane; (py, px) luma pixel origin; cw/ch chroma pred
    size in px. Returns (ch, cw) int32."""
    ac = np.zeros((ch, cw), np.int32)
    nh, nw = ch - 4 * h_pad, cw - 4 * w_pad
    src = y_plane[py:py + (nh << ss_ver), px:px + (nw << ss_hor)] \
        .astype(np.int32)
    blk = src[::1 << ss_ver, ::1 << ss_hor].copy()
    if ss_hor:
        blk += src[::1 << ss_ver, 1::2]
    if ss_ver:
        blk += src[1::2, ::1 << ss_hor]
        if ss_hor:
            blk += src[1::2, 1::2]
    ac[:nh, :nw] = blk << (1 + (not ss_ver) + (not ss_hor))
    if nw < cw:
        ac[:nh, nw:] = ac[:nh, nw - 1:nw]
    if nh < ch:
        ac[nh:] = ac[nh - 1]
    log2sz = (cw.bit_length() - 1) + (ch.bit_length() - 1)
    total = int(ac.sum()) + ((1 << log2sz) >> 1)
    total >>= log2sz
    return ac - total


def cfl_pred(dc, ac, alpha, w, h, bd):
    """reference ipred_tmpl.c:91-104."""
    bd_max = (1 << bd) - 1
    diff = alpha * ac[:h, :w]
    v = np.abs(diff)
    v = (v + 32) >> 6
    v = np.where(diff < 0, -v, v)
    return np.clip(dc + v, 0, bd_max)


def pal_pred(pal, idx, w, h):
    """pal: 8 entries; idx: (h, w) palette index array."""
    return pal[idx[:h, :w]]


PREDICTORS = {
    DC_PRED: ipred_dc, DC_128_PRED: ipred_dc_128, TOP_DC_PRED: ipred_dc_top,
    LEFT_DC_PRED: ipred_dc_left, HOR_PRED: ipred_h, VERT_PRED: ipred_v,
    PAETH_PRED: ipred_paeth, SMOOTH_PRED: ipred_smooth,
    SMOOTH_V_PRED: ipred_smooth_v, SMOOTH_H_PRED: ipred_smooth_h,
    Z1_PRED: ipred_z1, Z3_PRED: ipred_z3, FILTER_PRED: ipred_filter,
}

CFL_PREDICTORS = {
    DC_PRED: _dc_gen, DC_128_PRED: None, TOP_DC_PRED: _dc_gen_top,
    LEFT_DC_PRED: _dc_gen_left,
}


def cfl_dc(mode, e, w, h, bd):
    if mode == DC_PRED:
        return _dc_gen(e, w, h, bd)
    if mode == DC_128_PRED:
        return (1 << bd) >> 1
    if mode == TOP_DC_PRED:
        return _dc_gen_top(e, w)
    if mode == LEFT_DC_PRED:
        return _dc_gen_left(e, h)
    raise AssertionError(mode)
