"""Film grain synthesis (out-of-loop), scalar golden path.

Behavioral parity with the reference
(reference src/filmgrain_tmpl.c:38-445 grain generation + 32-row
application, src/fg_apply_tmpl.c:41-240 scaling LUTs + plane routing).
Grain is applied to the OUTPUT copy only — reference pictures stay
grain-free.
"""
from __future__ import annotations

import numpy as np

from .. import tables

GRAIN_WIDTH = 82
GRAIN_HEIGHT = 73
SUB_GRAIN_WIDTH = 44
SUB_GRAIN_HEIGHT = 38
FG_BLOCK_SIZE = 32

_GAUSS = None


def _gauss():
    global _GAUSS
    if _GAUSS is None:
        _GAUSS = tables.get("dav1d_gaussian_sequence").astype(np.int32)
    return _GAUSS


def _rand(state, bits):
    r = state[0]
    bit = ((r >> 0) ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1
    state[0] = (r >> 1) | (bit << 15)
    return (state[0] >> (16 - bits)) & ((1 << bits) - 1)


def _round2(x, shift):
    return (x + ((1 << shift) >> 1)) >> shift


def generate_grain_y(fgd, bd):
    """reference filmgrain_tmpl.c:51-87."""
    bdm8 = bd - 8
    state = [fgd.seed]
    shift = 4 - bdm8 + fgd.grain_scale_shift
    ctr = 128 << bdm8
    g = _gauss()
    buf = np.zeros((GRAIN_HEIGHT, GRAIN_WIDTH), np.int32)
    for y in range(GRAIN_HEIGHT):
        for x in range(GRAIN_WIDTH):
            buf[y, x] = _round2(int(g[_rand(state, 11)]), shift)
    lag = fgd.ar_coeff_lag
    coeffs = fgd.ar_coeffs_y
    for y in range(3, GRAIN_HEIGHT):
        for x in range(3, GRAIN_WIDTH - 3):
            ci = 0
            s = 0
            for dy in range(-lag, 1):
                for dx in range(-lag, lag + 1):
                    if not dx and not dy:
                        break
                    s += coeffs[ci] * buf[y + dy, x + dx]
                    ci += 1
            v = buf[y, x] + _round2(s, fgd.ar_coeff_shift)
            buf[y, x] = min(max(v, -ctr), ctr - 1)
    return buf


def generate_grain_uv(fgd, buf_y, uv, subx, suby, bd):
    """reference filmgrain_tmpl.c:89-145."""
    bdm8 = bd - 8
    state = [fgd.seed ^ (0x49D8 if uv else 0xB524)]
    shift = 4 - bdm8 + fgd.grain_scale_shift
    ctr = 128 << bdm8
    g = _gauss()
    cw = SUB_GRAIN_WIDTH if subx else GRAIN_WIDTH
    ch = SUB_GRAIN_HEIGHT if suby else GRAIN_HEIGHT
    buf = np.zeros((GRAIN_HEIGHT + 1, GRAIN_WIDTH), np.int32)
    for y in range(ch):
        for x in range(cw):
            buf[y, x] = _round2(int(g[_rand(state, 11)]), shift)
    lag = fgd.ar_coeff_lag
    coeffs = fgd.ar_coeffs_uv[uv]
    for y in range(3, ch):
        for x in range(3, cw - 3):
            ci = 0
            s = 0
            done = False
            for dy in range(-lag, 1):
                if done:
                    break
                for dx in range(-lag, lag + 1):
                    if not dx and not dy:
                        if fgd.num_y_points:
                            luma = 0
                            lx = ((x - 3) << subx) + 3
                            ly = ((y - 3) << suby) + 3
                            for i in range(suby + 1):
                                for j in range(subx + 1):
                                    luma += int(buf_y[ly + i, lx + j])
                            luma = _round2(luma, subx + suby)
                            s += luma * coeffs[ci]
                        done = True
                        break
                    s += coeffs[ci] * buf[y + dy, x + dx]
                    ci += 1
            v = buf[y, x] + _round2(s, fgd.ar_coeff_shift)
            buf[y, x] = min(max(v, -ctr), ctr - 1)
    return buf


def generate_scaling(bd, points, num):
    """reference fg_apply_tmpl.c:41-97."""
    shift_x = bd - 8
    size = 1 << bd
    scaling = np.zeros(size, np.int32)
    if num == 0:
        return scaling
    scaling[:points[0][0] << shift_x] = points[0][1]
    for i in range(num - 1):
        bx, by = points[i]
        ex, ey = points[i + 1]
        dx = ex - bx
        dy = ey - by
        delta = dy * ((0x10000 + (dx >> 1)) // dx)
        d = 0x8000
        for x in range(dx):
            scaling[(bx + x) << shift_x] = by + (d >> 16)
            d += delta
    n = points[num - 1][0] << shift_x
    scaling[n:] = points[num - 1][1]
    if bd > 8:
        pad = 1 << shift_x
        rnd = pad >> 1
        for i in range(num - 1):
            bx = points[i][0] << shift_x
            ex = points[i + 1][0] << shift_x
            for x in range(bx, ex, pad):
                rng = int(scaling[x + pad]) - int(scaling[x])
                r = rnd
                for k in range(1, pad):
                    r += rng
                    scaling[x + k] = scaling[x] + (r >> shift_x)
    return scaling


def _sample_lut(lut, offsets, subx, suby, bx, by, x, y):
    randval = offsets[bx][by]
    offx = 3 + (2 >> subx) * (3 + (randval >> 4))
    offy = 3 + (2 >> suby) * (3 + (randval & 0xF))
    return int(lut[offy + y + (FG_BLOCK_SIZE >> suby) * by,
                   offx + x + (FG_BLOCK_SIZE >> subx) * bx])


W_OVERLAP = ((27, 17), (17, 27))
W_OVERLAP_SUB = ((23, 22),)


def fgy_row(dst, src, fgd, pw, scaling, lut, bh, row_num, bd):
    """reference filmgrain_tmpl.c:169-263 fgy_32x32xn_c (one 32-row)."""
    rows = 1 + (fgd.overlap_flag and row_num > 0)
    bdm8 = bd - 8
    ctr = 128 << bdm8
    if fgd.clip_to_restricted_range:
        mn, mx = 16 << bdm8, 235 << bdm8
    else:
        mn, mx = 0, (1 << bd) - 1
    seeds = []
    for i in range(rows):
        s = fgd.seed
        s ^= (((row_num - i) * 37 + 178) & 0xFF) << 8
        s ^= ((row_num - i) * 173 + 105) & 0xFF
        seeds.append([s])
    offsets = [[0, 0], [0, 0]]

    def noise_at(x, y, grain):
        sv = int(src[y, x])
        noise = _round2(int(scaling[sv]) * grain, fgd.scaling_shift)
        dst[y, x] = min(max(sv + noise, mn), mx)

    bx = 0
    while bx < pw:
        bw = min(FG_BLOCK_SIZE, pw - bx)
        if fgd.overlap_flag and bx:
            for i in range(rows):
                offsets[1][i] = offsets[0][i]
        for i in range(rows):
            offsets[0][i] = _rand(seeds[i], 8)
        ystart = min(2, bh) if (fgd.overlap_flag and row_num) else 0
        xstart = min(2, bw) if (fgd.overlap_flag and bx) else 0
        w = W_OVERLAP
        for y in range(ystart, bh):
            for x in range(xstart, bw):
                noise_at(bx + x, y,
                         _sample_lut(lut, offsets, 0, 0, 0, 0, x, y))
            for x in range(xstart):
                g = _sample_lut(lut, offsets, 0, 0, 0, 0, x, y)
                o = _sample_lut(lut, offsets, 0, 0, 1, 0, x, y)
                g = _round2(o * w[x][0] + g * w[x][1], 5)
                g = min(max(g, -ctr), ctr - 1)
                noise_at(bx + x, y, g)
        for y in range(ystart):
            for x in range(xstart, bw):
                g = _sample_lut(lut, offsets, 0, 0, 0, 0, x, y)
                o = _sample_lut(lut, offsets, 0, 0, 0, 1, x, y)
                g = _round2(o * w[y][0] + g * w[y][1], 5)
                g = min(max(g, -ctr), ctr - 1)
                noise_at(bx + x, y, g)
            for x in range(xstart):
                top = _sample_lut(lut, offsets, 0, 0, 0, 1, x, y)
                o = _sample_lut(lut, offsets, 0, 0, 1, 1, x, y)
                top = _round2(o * w[x][0] + top * w[x][1], 5)
                top = min(max(top, -ctr), ctr - 1)
                g = _sample_lut(lut, offsets, 0, 0, 0, 0, x, y)
                o = _sample_lut(lut, offsets, 0, 0, 1, 0, x, y)
                g = _round2(o * w[x][0] + g * w[x][1], 5)
                g = min(max(g, -ctr), ctr - 1)
                g = _round2(top * w[y][0] + g * w[y][1], 5)
                g = min(max(g, -ctr), ctr - 1)
                noise_at(bx + x, y, g)
        bx += FG_BLOCK_SIZE


def fguv_row(dst, src, fgd, pw, scaling, lut, bh, row_num, luma, uv,
             is_id, sx, sy, bd):
    """reference filmgrain_tmpl.c:265-423 fguv_32x32xn_c."""
    rows = 1 + (fgd.overlap_flag and row_num > 0)
    bdm8 = bd - 8
    ctr = 128 << bdm8
    if fgd.clip_to_restricted_range:
        mn = 16 << bdm8
        mx = (235 if is_id else 240) << bdm8
    else:
        mn, mx = 0, (1 << bd) - 1
    seeds = []
    for i in range(rows):
        s = fgd.seed
        s ^= (((row_num - i) * 37 + 178) & 0xFF) << 8
        s ^= ((row_num - i) * 173 + 105) & 0xFF
        seeds.append([s])
    offsets = [[0, 0], [0, 0]]

    def noise_at(px, y, grain):
        lx = px << sx
        ly = y << sy
        avg = int(luma[ly, lx])
        if sx:
            avg = (avg + int(luma[ly, lx + 1]) + 1) >> 1
        sv = int(src[y, px])
        val = avg
        if not fgd.chroma_scaling_from_luma:
            combined = avg * fgd.uv_luma_mult[uv] + sv * fgd.uv_mult[uv]
            val = min(max((combined >> 6) +
                          fgd.uv_offset[uv] * (1 << bdm8), 0),
                      (1 << bd) - 1)
        noise = _round2(int(scaling[val]) * grain, fgd.scaling_shift)
        dst[y, px] = min(max(sv + noise, mn), mx)

    bx = 0
    step = FG_BLOCK_SIZE >> sx
    while bx < pw:
        bw = min(step, pw - bx)
        if fgd.overlap_flag and bx:
            for i in range(rows):
                offsets[1][i] = offsets[0][i]
        for i in range(rows):
            offsets[0][i] = _rand(seeds[i], 8)
        ystart = min(2 >> sy, bh) if (fgd.overlap_flag and row_num) else 0
        xstart = min(2 >> sx, bw) if (fgd.overlap_flag and bx) else 0
        wx = W_OVERLAP_SUB if sx else W_OVERLAP
        wy = W_OVERLAP_SUB if sy else W_OVERLAP
        for y in range(ystart, bh):
            for x in range(xstart, bw):
                noise_at(bx + x, y,
                         _sample_lut(lut, offsets, sx, sy, 0, 0, x, y))
            for x in range(xstart):
                g = _sample_lut(lut, offsets, sx, sy, 0, 0, x, y)
                o = _sample_lut(lut, offsets, sx, sy, 1, 0, x, y)
                g = _round2(o * wx[x][0] + g * wx[x][1], 5)
                g = min(max(g, -ctr), ctr - 1)
                noise_at(bx + x, y, g)
        for y in range(ystart):
            for x in range(xstart, bw):
                g = _sample_lut(lut, offsets, sx, sy, 0, 0, x, y)
                o = _sample_lut(lut, offsets, sx, sy, 0, 1, x, y)
                g = _round2(o * wy[y][0] + g * wy[y][1], 5)
                g = min(max(g, -ctr), ctr - 1)
                noise_at(bx + x, y, g)
            for x in range(xstart):
                top = _sample_lut(lut, offsets, sx, sy, 0, 1, x, y)
                o = _sample_lut(lut, offsets, sx, sy, 1, 1, x, y)
                top = _round2(o * wx[x][0] + top * wx[x][1], 5)
                top = min(max(top, -ctr), ctr - 1)
                g = _sample_lut(lut, offsets, sx, sy, 0, 0, x, y)
                o = _sample_lut(lut, offsets, sx, sy, 1, 0, x, y)
                g = _round2(o * wx[x][0] + g * wx[x][1], 5)
                g = min(max(g, -ctr), ctr - 1)
                g = _round2(top * wy[y][0] + g * wy[y][1], 5)
                g = min(max(g, -ctr), ctr - 1)
                noise_at(bx + x, y, g)
        bx += step


def apply_film_grain(pic, fh, seq):
    """Apply grain to a COPY of pic; returns the grained Picture
    (reference lib.c:485-524 dav1d_apply_grain + fg_apply_tmpl.c)."""
    fgd = fh.film_grain_data
    if not fh.film_grain_present:
        return pic
    from ..recon.picture import Picture
    bd = pic.bpc
    out = Picture(pic.w, pic.h, pic.layout, bd)
    for i, p in enumerate(pic.planes):
        out.planes[i][:] = p

    lut_y = generate_grain_y(fgd, bd)
    ss_x = pic.ss_hor
    ss_y = pic.ss_ver
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

    w, h = pic.w, pic.h
    is_id = getattr(seq, "mtrx", 0) == 0   # MC_IDENTITY
    n_rows = (h + FG_BLOCK_SIZE - 1) // FG_BLOCK_SIZE
    for row in range(n_rows):
        y0 = row * FG_BLOCK_SIZE
        bh = min(h - y0, FG_BLOCK_SIZE)
        if fgd.num_y_points:
            fgy_row(out.planes[0][y0:y0 + bh], pic.planes[0][y0:y0 + bh],
                    fgd, w, scalings[0], lut_y, bh, row, bd)
        if pic.layout == 0 or (not fgd.num_uv_points[0] and
                               not fgd.num_uv_points[1] and
                               not fgd.chroma_scaling_from_luma):
            continue
        cpw = (w + ss_x) >> ss_x
        cy0 = y0 >> ss_y
        cbh = (min(h - y0, FG_BLOCK_SIZE) + ss_y) >> ss_y
        luma = pic.planes[0][y0:]
        for pl in range(2):
            if not (fgd.num_uv_points[pl] or
                    fgd.chroma_scaling_from_luma):
                continue
            sc = scalings[1 + pl] if not fgd.chroma_scaling_from_luma \
                else scalings[0]
            fguv_row(out.planes[1 + pl][cy0:cy0 + cbh],
                     pic.planes[1 + pl][cy0:cy0 + cbh], fgd, cpw, sc,
                     luts[1 + pl], cbh, row, luma, pl, is_id, ss_x,
                     ss_y, bd)
    return out
