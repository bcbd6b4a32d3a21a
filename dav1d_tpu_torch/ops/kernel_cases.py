"""Seeded inputs for the inter Stage-B kernels (put, compound, residual)
that cover every case the kernels branch on, shared by the CPU parity
tests and chip_smoke.py.

Each case is a dict of numpy arrays in the layouts the wrappers take
(ops/mc.py, ops/itx.py). Destinations are packed so that no two jobs of
one call write the same pixel, as AV1's block partition guarantees on
the decode path. Reference windows are placed on and across every frame
edge, and the frame (rh, rw) is smaller than the allocated reference
plane, as a 1080-row frame sits in 1152 allocated rows.
"""
from __future__ import annotations

import itertools

import numpy as np

from ..entropy import levels as lv
from .mc_ref import BS_32X32, FILTER2D_TO_TYPE

# the emitter's filter types: 0..10 are 8-tap (h = ft & 3,
# v = (ft >> 2) & 3), -1 is bilinear
FT_VALUES = sorted(set(FILTER2D_TO_TYPE))

# (h, w) of puts: luma blocks 4..128 and chroma blocks down to 2x2
PUT_SIZES = [(2, 2), (2, 4), (4, 2), (4, 4), (4, 8), (8, 4), (4, 16),
             (16, 4), (8, 8), (8, 16), (16, 8), (16, 16), (8, 32), (32, 8),
             (16, 32), (32, 16), (32, 32), (16, 64), (64, 16), (32, 64),
             (64, 32), (64, 64), (64, 128), (128, 64), (128, 128)]
# (h, w) of luma compound blocks (8x8 and up)
COMP_SIZES = [(8, 8), (8, 16), (16, 8), (16, 16), (8, 32), (32, 8),
              (16, 32), (32, 16), (32, 32), (16, 64), (64, 16), (32, 64),
              (64, 32), (64, 64), (64, 128), (128, 64), (128, 128)]
# luma sizes with wedge masks (reference wedge.h:39)
WEDGE_SIZES = [(8, 8), (8, 16), (16, 8), (16, 16), (8, 32), (32, 8),
               (16, 32), (32, 16), (32, 32)]
# (ss_hor, ss_ver) -> the wedge LUT's layout index
LAYOUT_CLIDX = {(0, 0): 0, (1, 0): 1, (1, 1): 2}
MODE_WAVG, MODE_AVG, MODE_SEG, MODE_MASK = 1, 2, 3, 4
REF_SHAPE = (160, 224)           # allocated reference plane
FRAME = (150, 208)               # the frame's valid rows and columns


def pack(sizes, width, align=8):
    """Non-overlapping (py, px) for (h, w) sizes on shelves of a plane
    `width` wide; returns (py, px, height)."""
    py = np.zeros(len(sizes), np.int32)
    px = np.zeros(len(sizes), np.int32)
    x = y = shelf = 0
    for i, (h, w) in enumerate(sizes):
        wa, ha = -(-w // align) * align, -(-h // align) * align
        if x + wa > width:
            y, x, shelf = y + shelf, 0, 0
        py[i], px[i] = y, x
        x += wa
        shelf = max(shelf, ha)
    return py, px, y + shelf


def _edge_pos(rng, size, bound):
    """A window origin above / across / inside / across / below one
    frame edge pair."""
    return int(rng.choice([-size - 9, -size // 2 - 3,
                           int(rng.integers(0, max(1, bound - size))),
                           bound - size // 2, bound + 4]))


def _refs(rng, bd, n_refs, shape=REF_SHAPE):
    return rng.integers(0, 1 << bd, (n_refs, *shape)).astype(np.int32)


def _mv(rng, h, w, n_refs, rh, rw, ft):
    """One prediction: [dy, dx, amx, amy, ft, slot]."""
    return [_edge_pos(rng, h, rh), _edge_pos(rng, w, rw),
            int(rng.integers(0, 16)), int(rng.integers(0, 16)), ft,
            int(rng.integers(0, n_refs))]


def put_case(bd, seed, n_refs=3, width=512, sizes=None,
             ref_shape=REF_SHAPE, frame=FRAME):
    """Puts with every filter type (8-tap and bilinear) in turn. sizes:
    (h, w, copy) per job, copy meaning integer motion (amx = amy = 0;
    other jobs get a nonzero phase); by default every put size twice
    with subpel motion, then every size once more as a copy. ref_shape:
    the allocated reference planes, frame their valid (rows, columns).
    Returns {refs (R, H, W), jobs (n, 11), dst_shape, rh, rw}."""
    rng = np.random.default_rng(seed)
    rh, rw = frame
    if sizes is None:
        sizes = [(h, w, False) for h, w in PUT_SIZES for _ in range(2)] + \
            [(h, w, True) for h, w in PUT_SIZES]
    py, px, height = pack([s[:2] for s in sizes], width)
    jobs = []
    for i, (h, w, copy) in enumerate(sizes):
        ft = FT_VALUES[(i + seed) % len(FT_VALUES)]
        dy, dx, amx, amy, _, slot = _mv(rng, h, w, n_refs, rh, rw, ft)
        if copy:
            amx = amy = 0
        elif amx == amy == 0:
            amx = 8
        jobs.append([0, h, w, py[i], px[i], slot, dy, dx, amx, amy, ft])
    return {"refs": _refs(rng, bd, n_refs, ref_shape),
            "jobs": np.asarray(jobs, np.int32),
            "dst_shape": (height, width), "rh": rh, "rw": rw}


def ragged_put_sizes():
    """(h, w, copy) of puts that leave a ragged last kernel block in
    every class the kernel bins them into (ops/mc.py put_blocks): one
    job more than a block holds of each class up to 32x32 (sides 2..32,
    at most 4:1), filtered and as copies, then every size larger than
    32x32 (split into 32-wide tiles) twice of each kind."""
    from .mc import put_jobs_per_block
    small = [(h, w) for h in (2, 4, 8, 16, 32) for w in (2, 4, 8, 16, 32)
             if max(h, w) <= 4 * min(h, w)]
    out = [(h, w, copy) for copy in (False, True) for h, w in small
           for _ in range(put_jobs_per_block(h, w, copy) + 1)]
    return out + [(h, w, copy) for copy in (False, True)
                  for h, w in PUT_SIZES if max(h, w) > 32 for _ in range(2)]


def _wedge_bs(h, w):
    for bs, d in enumerate(lv.block_dimensions):
        if (4 * int(d[0]), 4 * int(d[1])) == (w, h):
            return bs
    raise ValueError((h, w))


def ragged_comp_sizes():
    """Luma compound sizes that leave a ragged last kernel block in every
    class the kernel bins them into (ops/mc.py comp_blocks): one job more
    than a block holds of each luma class up to 32x32, then every size
    larger than 32x32 (split into 32-wide tiles) three times, so that
    the chroma classes they make are ragged too where a block holds
    more than one job."""
    from .mc import comp_jobs_per_block
    small = [(h, w) for h in (8, 16, 32) for w in (8, 16, 32)
             if max(h, w) <= 4 * min(h, w)]
    sizes = [s for s in small for _ in range(comp_jobs_per_block(*s) + 1)]
    return sizes + [s for s in COMP_SIZES if max(s) > 32 for _ in range(3)]


def comp_case(bd, seed, ss_hor, ss_ver, n_refs=3, width=512, sizes=None,
              ref_shape=REF_SHAPE, frame=FRAME):
    """Luma and chroma compound jobs with every combine mode: avg,
    distance-weighted avg, seg mask (luma computes it, chroma reads the
    seg plane) and wedge (classes 16 and 32, the layout's masks). With
    `sizes` (luma (h, w) per job), those jobs, the modes in turn (wedge
    where the size has masks). ref_shape: the allocated luma reference
    plane, frame its valid (rows, columns). Returns {refs_y, refs_c,
    jobs_y (n, 25), jobs_c (n, 25), dst_y, dst_c, seg_shape, bounds_y,
    bounds_c}."""
    rng = np.random.default_rng(seed)
    clidx = LAYOUT_CLIDX[(ss_hor, ss_ver)]
    if sizes is None:
        kinds = [(s, m) for s in COMP_SIZES
                 for m in (MODE_AVG, MODE_WAVG, MODE_SEG)]
        kinds += [(s, MODE_MASK) for s in WEDGE_SIZES for _ in range(2)]
    else:
        modes = (MODE_AVG, MODE_WAVG, MODE_SEG, MODE_MASK)
        kinds = [(s, modes[i % (4 if s in WEDGE_SIZES else 3)])
                 for i, s in enumerate(sizes)]
    py, px, height = pack([s for s, _ in kinds], width)
    rh, rw = frame
    rhc, rwc = (rh + ss_ver) >> ss_ver, (rw + ss_hor) >> ss_hor
    shape_c = (ref_shape[0] >> ss_ver, ref_shape[1] >> ss_hor)
    jobs_y, jobs_c = [], []
    for i, ((h, w), mode) in enumerate(kinds):
        jw = int(rng.integers(0, 17))
        sign = int(rng.integers(0, 2))
        bs = _wedge_bs(h, w) if mode == MODE_MASK else 0
        widx = int(rng.integers(0, 16))
        ft0, ft1 = (FT_VALUES[1 + int(k)] for k in rng.integers(0, 9, 2))
        hc, wc = h >> ss_ver, w >> ss_hor
        mk_y = [0, bs, 0, widx] if mode == MODE_MASK else [0, 0, 0, 0]
        jobs_y.append([0, h, w, py[i], px[i], mode, jw, sign,
                       1 if mode == MODE_MASK else 0, *mk_y,
                       *_mv(rng, h, w, n_refs, rh, rw, ft0),
                       *_mv(rng, h, w, n_refs, rh, rw, ft1)])
        if mode == MODE_SEG:
            mode_c, mkind_c, mk_c = MODE_MASK, 2, [0, 0, 0, 0]
        elif mode == MODE_MASK:
            mode_c, mkind_c, mk_c = MODE_MASK, 1, [clidx, bs, sign, widx]
        else:
            mode_c, mkind_c, mk_c = mode, 0, [0, 0, 0, 0]
        jobs_c.append([1, hc, wc, py[i] >> ss_ver, px[i] >> ss_hor,
                       mode_c, jw, sign, mkind_c, *mk_c,
                       *_mv(rng, hc, wc, n_refs, rhc, rwc, ft0),
                       *_mv(rng, hc, wc, n_refs, rhc, rwc, ft1)])
    dst_c = (height >> ss_ver, width >> ss_hor)
    return {"refs_y": _refs(rng, bd, n_refs, ref_shape),
            "refs_c": _refs(rng, bd, n_refs, shape_c),
            "jobs_y": np.asarray(jobs_y, np.int32),
            "jobs_c": np.asarray(jobs_c, np.int32),
            "dst_y": (height, width), "dst_c": dst_c, "seg_shape": dst_c,
            "bounds_y": (rh, rw), "bounds_c": (rhc, rwc)}


def _coefs(rng, n, bd, style):
    """n dequantized coefficients in the decoder's range: dense small,
    sparse at full range, or DC only."""
    cf_max = (1 << (7 + bd)) - 1 if bd > 8 else (1 << 15) - 1
    if style == 0:
        return rng.integers(-64, 65, n)
    if style == 1:
        v = rng.integers(-cf_max - 1, cf_max + 1, n)
        return np.where(rng.random(n) < 4.0 / n, v, 0)
    out = np.zeros(n, np.int64)
    out[0] = rng.integers(-cf_max // 8, cf_max // 8)
    return out


def itx_case(bd, seed, width=512, repeat=1):
    """One residual job per (tx, row kind, column kind) of all 19
    transform sizes (each `repeat` times), plus a table of WHT jobs.
    Returns {pool, jobs
    (n, 6) [tx, ridx, cidx, py, px, cfoff], wht (m, 6), plane}."""
    from .itx import CF_LEN, res_tx_kinds
    rng = np.random.default_rng(seed)
    combos = []
    for tx in range(len(lv.TXFM_INFO)):
        rk, ck = res_tx_kinds(tx)
        combos += [(tx, r, c) for r, c in itertools.product(
            range(len(rk)), range(len(ck)))]
    combos *= repeat
    n_wht = 24
    sizes = [(4 * lv.TXFM_INFO[tx].h, 4 * lv.TXFM_INFO[tx].w)
             for tx, _, _ in combos] + [(4, 4)] * n_wht
    py, px, height = pack(sizes, width, align=4)
    parts, pos, rows = [], 0, []
    for i, (tx, r, c) in enumerate(combos):
        n = int(CF_LEN[tx])
        parts.append(_coefs(rng, n, bd, i % 3))
        rows.append([tx, r, c, py[i], px[i], pos])
        pos += n
    wht = []
    for k in range(n_wht):
        i = len(combos) + k
        parts.append(rng.integers(-1024, 1025, 16))
        wht.append([0, 0, 0, py[i], px[i], pos])
        pos += 16
    plane = rng.integers(0, 1 << bd, (height, width)).astype(np.int32)
    return {"pool": np.concatenate(parts).astype(np.int32),
            "jobs": np.asarray(rows, np.int32),
            "wht": np.asarray(wht, np.int32), "plane": plane}


def _extreme_coefs(rng, tx, bd, k):
    """Pattern k of a block's x-major coefficients at the decoder's full
    range: all max, all min, signs alternating along x, along y or both,
    DC max or min, random signs, random values."""
    t = lv.TXFM_INFO[tx]
    sw, sh = min(4 * t.w, 32), min(4 * t.h, 32)
    hi = (1 << (7 + bd)) - 1 if bd > 8 else (1 << 15) - 1
    lo = ~hi
    x, y = np.arange(sw)[:, None], np.arange(sh)[None, :]
    k %= 9
    if k < 5:
        sgn = [x * 0 + y * 0, x * 0 + y * 0 + 1, x % 2 + y * 0,
               y % 2 + x * 0, (x + y) % 2][k]
        v = np.where(sgn == 1, lo, hi)
    elif k < 7:
        v = np.zeros((sw, sh), np.int64)
        v[0, 0] = hi if k == 5 else lo
    elif k == 7:
        v = np.where(rng.random((sw, sh)) < 0.5, hi, lo)
    else:
        v = rng.integers(lo, hi + 1, (sw, sh))
    return v.reshape(-1)


def itx_stress_case(bd, seed, width=512):
    """Two residual tables over one pool and plane. "extreme": one job
    per (tx, row kind, column kind) with coefficients at the decoder's
    full range (_extreme_coefs, the pattern cycling). "ragged": for
    every tx, one job more than a kernel block holds (ops/itx.py
    jobs_per_block) of one kind pair, with dense, sparse or DC
    coefficients, so every class ends in a ragged block. Returns {pool,
    plane, extreme (n, 6), ragged (m, 6)}."""
    from .itx import CF_LEN, jobs_per_block, res_tx_kinds
    rng = np.random.default_rng(seed)
    extreme = []
    for tx in range(len(lv.TXFM_INFO)):
        rk, ck = res_tx_kinds(tx)
        extreme += [(tx, r, c) for r, c in itertools.product(
            range(len(rk)), range(len(ck)))]
    ragged = []
    for tx in range(len(lv.TXFM_INFO)):
        rk, ck = res_tx_kinds(tx)
        r, c = tx % len(rk), (tx // 2) % len(ck)
        ragged += [(tx, r, c)] * (jobs_per_block(tx) + 1)
    out, parts, pos = {}, [], 0
    planes_h = 0
    for name, combos in (("extreme", extreme), ("ragged", ragged)):
        sizes = [(4 * lv.TXFM_INFO[tx].h, 4 * lv.TXFM_INFO[tx].w)
                 for tx, _, _ in combos]
        py, px, height = pack(sizes, width, align=4)
        planes_h = max(planes_h, height)
        rows = []
        for i, (tx, r, c) in enumerate(combos):
            parts.append(_extreme_coefs(rng, tx, bd, i)
                         if name == "extreme"
                         else _coefs(rng, int(CF_LEN[tx]), bd, i % 3))
            rows.append([tx, r, c, py[i], px[i], pos])
            pos += int(CF_LEN[tx])
        out[name] = np.asarray(rows, np.int32)
    out["pool"] = np.concatenate(parts).astype(np.int32)
    out["plane"] = rng.integers(0, 1 << bd, (planes_h, width)).astype(
        np.int32)
    return out


def overlaps(py, px, h, w, shape):
    """Pixels of a (H, W) plane that the (py, px, h, w) rectangles of
    one table of jobs write more than once."""
    cnt = np.zeros(shape, np.int32)
    for y, x, hh, ww in zip(py.tolist(), px.tolist(), h.tolist(),
                            w.tolist()):
        cnt[y:y + hh, x:x + ww] += 1
    return int((cnt > 1).sum())


# the emitter's OBMC filter types: every 8-tap type (it never writes a
# bilinear lap)
OBMC_FT = [ft for ft in FT_VALUES if ft >= 0]
# shear at the ends of its valid range (4|alpha| + 7|beta| and 4|gamma|
# + 4|delta| below 2^16, multiples of 64), and the fractions that take
# the filter row to 0 and to 192
WARP_EXTREMES = [(16320, 0, 8128, 8128, 0, 0),
                 (-16320, 0, -8128, -8128, 65535, 65535),
                 (0, 9344, 0, 16320, 0, 65535),
                 (0, -9344, 16320, 0, 65535, 0),
                 (7616, 4992, -8128, 8128, 32768, 4096)]


def _plane_geo(ss_hor, ss_ver, ref_shape=REF_SHAPE, frame=FRAME):
    """Per plane of a 3-plane frame: (ref_shape, (rh, rw), ss_h, ss_v)."""
    out = []
    for pi in range(3):
        sh, sv = (ss_hor, ss_ver) if pi else (0, 0)
        out.append(((ref_shape[0] >> sv, ref_shape[1] >> sh),
                    ((frame[0] + sv) >> sv, (frame[1] + sh) >> sh),
                    sh, sv))
    return out


def _warp_params(rng):
    """(alpha, beta, gamma, delta, frac_x, frac_y) of a valid shear,
    each a multiple of 64."""
    a = int(rng.integers(-255, 256)) * 64
    b_max = (65535 - 4 * abs(a)) // (7 * 64)
    b = int(rng.integers(-b_max, b_max + 1)) * 64
    g = int(rng.integers(-255, 256)) * 64
    d_max = (65535 - 4 * abs(g)) // (4 * 64)
    d = int(rng.integers(-d_max, d_max + 1)) * 64
    return a, b, g, d, int(rng.integers(0, 65536)), int(rng.integers(0,
                                                                     65536))


def warp_case(bd, seed, ss_hor=1, ss_ver=1, n_refs=3, tiles=48,
              width=256, ref_shape=REF_SHAPE, frame=FRAME):
    """Warp tiles of a 3-plane frame, `tiles` per plane: random valid
    shears and the WARP_EXTREMES (filter rows 0 and 192 reached), windows
    on and across every frame edge. mx / my carry the emitter's offsets:
    ((frac - 4 alpha - 7 beta) & ~63, (frac - 4 gamma - 4 delta) & ~63).
    ref_shape, frame: the luma reference planes' allocated and valid
    shapes. Returns {planes: [{refs (R, H, W), dst_shape, rh, rw}], jobs
    (n, 12)}."""
    rng = np.random.default_rng(seed)
    planes, jobs = [], []
    for pi, (ref_shape, (rh, rw), _, _) in enumerate(
            _plane_geo(ss_hor, ss_ver, ref_shape, frame)):
        py, px, height = pack([(8, 8)] * tiles, width)
        for i in range(tiles):
            if i < len(WARP_EXTREMES):
                a, b, g, d, fx, fy = WARP_EXTREMES[i]
            else:
                a, b, g, d, fx, fy = _warp_params(rng)
            mx = (fx - 4 * a - 7 * b) & ~63
            my = (fy - 4 * g - 4 * d) & ~63
            jobs.append([pi, py[i], px[i], int(rng.integers(0, n_refs)),
                         _edge_pos(rng, 8, rh), _edge_pos(rng, 8, rw),
                         mx, my, a, b, g, d])
        planes.append({"refs": _refs(rng, bd, n_refs, ref_shape),
                       "dst_shape": (height, width), "rh": rh, "rw": rw})
    return {"planes": planes, "jobs": np.asarray(jobs, np.int32)}


def obmc_geometries(top, h_mul, v_mul):
    """Every (ww, hh, lap_h) the emitter writes for a lap of direction
    `top` on a plane of (h_mul, v_mul) pixels per 4x4 luma unit
    (native/interjobs.cpp emit_obmc): top laps of ow4 in 2..16 and oh4
    in 1..8 units, left laps of ow4 in 1..8 and oh4 in 2..16."""
    if top:
        return [(ow4 * h_mul, oh4 * v_mul, ((oh4 * 3 + 3) >> 2) * v_mul)
                for ow4 in (2, 4, 8, 16) for oh4 in (1, 2, 4, 8)]
    return [(ow4 * h_mul, oh4 * v_mul, oh4 * v_mul)
            for ow4 in (1, 2, 4, 8) for oh4 in (2, 4, 8, 16)]


def obmc_case(bd, seed, ss_hor=1, ss_ver=1, n_refs=3, width=256,
              ref_shape=REF_SHAPE, frame=FRAME, repeat=1):
    """OBMC laps of a 3-plane frame: per plane, every top and every left
    geometry the emitter writes (obmc_geometries), paired on blocks, a
    top and a left lap at the same (py, px) (the left one reading the
    corner the top one wrote); every 8-tap filter type in turn, random
    phases (0 included), windows on and across every frame edge; and
    blocks across the plane's right edge, its bottom edge and its corner
    (their writes cut at the plane); the pairs `repeat` times. ref_shape,
    frame: as warp_case's. Returns {planes: [{refs, plane (the
    predictions blended into), rh, rw}], top (n, 13), left (m, 13)}."""
    rng = np.random.default_rng(seed)
    planes, laps = [], {1: [], 0: []}
    k = 0
    for pi, (ref_shape, (rh, rw), sh, sv) in enumerate(
            _plane_geo(ss_hor, ss_ver, ref_shape, frame)):
        geo = {t: obmc_geometries(t, 4 >> sh, 4 >> sv) for t in (1, 0)}
        n = max(len(geo[1]), len(geo[0])) * repeat
        pairs = [(geo[1][i % len(geo[1])], geo[0][(i * 5) % len(geo[0])])
                 for i in range(n)]
        # edge blocks: the largest top lap, the largest left laps
        edge = [(geo[1][-1], geo[0][-1 - i]) for i in range(4)]

        def foot(p):
            (tw, th, _), (lw, lh, _) = p
            return max((th * 3) >> 2, lh), max(tw, (lw * 3) >> 2)
        py, px, height = pack([foot(p) for p in pairs], width)
        H, W = height + 40, width + 40
        # a block across the right edge, two across the bottom edge and
        # one at the corner, apart from each other and the packed ones
        at = [(0, W - 8), (H - 4, 0), (H - 25, 80), (H - 3, W - 5)]
        for (y, x), p in zip(list(zip(py, px)) + at, pairs + edge):
            for t, (ww, hh, lap_h) in zip((1, 0), p):
                ft = OBMC_FT[k % len(OBMC_FT)]
                k += 1
                laps[t].append([t, pi, ww, hh, lap_h, y, x,
                                int(rng.integers(0, n_refs)),
                                _edge_pos(rng, lap_h, rh),
                                _edge_pos(rng, ww, rw),
                                int(rng.integers(0, 16)),
                                int(rng.integers(0, 16)), ft])
        planes.append({"refs": _refs(rng, bd, n_refs, ref_shape),
                       "plane": rng.integers(0, 1 << bd, (H, W)).astype(
                           np.int32), "rh": rh, "rw": rw})
    return {"planes": planes, "top": np.asarray(laps[1], np.int32),
            "left": np.asarray(laps[0], np.int32)}


def case_planes(case, device):
    """[(refs, plane, rh, rw)] tensors on `device` of a warp_case (zeroed
    destinations) or an obmc_case (its predictions), as the wrappers of
    ops/mc_warp.py and ops/mc_obmc.py take them."""
    import torch
    out = []
    for p in case["planes"]:
        if "plane" in p:
            dst = torch.from_numpy(p["plane"].copy()).to(device)
        else:
            dst = torch.zeros(p["dst_shape"], dtype=torch.int32,
                              device=device)
        out.append(([torch.from_numpy(r).to(device) for r in p["refs"]],
                    dst, p["rh"], p["rw"]))
    return out


# CDEF: layouts (0 monochrome, 1 4:2:0, 2 4:2:2, 3 4:4:4) and the
# geometries (frame height, width, padded luma plane rows, columns) of
# the cases: the 70x50 frame, whose 4x4 grid (56 x 72) ends inside the
# 64x64 tiles and inside the padded plane, a frame of several tiles
# that end ragged, and a 100x60 frame in a plane padded far beyond it
# (whole tiles below and right of its 64 x 104 crop, copied through)
CDEF_LAYOUTS = (0, 1, 2, 3)
CDEF_GEOMETRIES = ((50, 70, 96, 128), (130, 196, 160, 256),
                   (60, 100, 192, 256))


def _cdef_blocks(rng, h, w, bd, kinds):
    """An (h, w) plane of 8x8 blocks, each of one kind in turn: random,
    smooth (a level with small noise, which the filter changes most),
    flat 0, flat 2^bd - 1, a checkerboard of the two values at -128 and
    +127 around the direction search's bias, a checkerboard of 0 and
    2^bd - 1, lines in the 8 directions
    (the largest costs of each), a random edge."""
    top = (1 << bd) - 1
    hi = 255 << (bd - 8)
    yy, xx = np.mgrid[0:8, 0:8]
    lines = [(xx + 2 * yy) % 4, (xx + yy) % 3, (2 * xx + yy) % 4, xx % 2,
             (2 * xx - yy) % 4, (xx - yy) % 3, (xx - 2 * yy) % 4, yy % 2]
    out = np.empty((h, w), np.int32)
    k = 0
    for by in range(0, h, 8):
        for bx in range(0, w, 8):
            kind = kinds[k % len(kinds)]
            k += 1
            if kind == "random":
                b = rng.integers(0, top + 1, (8, 8))
            elif kind == "smooth":
                amp = 1 << (bd - 5)
                b = np.clip(int(rng.integers(0, top + 1)) +
                            rng.integers(-amp, amp + 1, (8, 8)), 0, top)
            elif kind == "zero":
                b = np.zeros((8, 8), np.int64)
            elif kind == "max":
                b = np.full((8, 8), top)
            elif kind == "checker":
                b = np.where((yy + xx) % 2, hi, 0)
            elif kind == "alt":
                b = np.where((yy + xx) % 2, top, 0)
            elif kind == "edge":
                b = np.where(xx * int(rng.integers(-3, 4)) +
                             yy * int(rng.integers(-3, 4)) > 0,
                             int(rng.integers(0, top + 1)),
                             int(rng.integers(0, top + 1)))
            else:
                b = np.where(lines[int(kind[4:])] == 0, hi, 0)
            out[by:by + 8, bx:bx + 8] = b[:h - by, :w - bx]
    return out


def cdef_case(bd, seed, layout, geometry=CDEF_GEOMETRIES[0]):
    """CDEF of one frame: the 8x8 block kinds of _cdef_blocks on every
    plane (the padding too), random per-block maps over every primary
    strength 0..15 and secondary 0..4 (<< bd - 8) of both planes, blocks
    with apply off, damping in 3..6 (+ bd - 8). Returns {planes: the
    full padded int32 planes (1 or 3), maps (6, nby, nbx) int32, Hy, Wy
    (the crop: the frame's 4x4 grid), layout, bd, damping}, the
    arguments of ops/cdef.py cdef_planes."""
    rng = np.random.default_rng(seed)
    fh, fw, ph, pw = geometry
    Hy, Wy = ((fh + 7) >> 3) << 3, ((fw + 7) >> 3) << 3
    kinds = ["random", "smooth", "zero", "smooth", "max", "smooth",
             "checker", "smooth", "edge", "smooth"] + \
        [f"line{d}" for d in range(8)]
    planes = [_cdef_blocks(rng, ph, pw, bd, kinds)]
    if layout:
        ss_ver, ss_hor = int(layout == 1), int(layout != 3)
        planes += [_cdef_blocks(rng, ph >> ss_ver, pw >> ss_hor, bd,
                                kinds[::-1]) for _ in range(2)]
    nby, nbx = Hy // 8, Wy // 8
    bdm8 = bd - 8
    n = nby * nbx
    maps = np.stack([
        np.arange(n) % 16 << bdm8,
        rng.integers(0, 5, n) << bdm8,
        rng.permutation(np.arange(n) % 16) << bdm8,
        rng.integers(0, 5, n) << bdm8,
        rng.random(n) < 0.85,
        rng.random(n) < 0.85]).reshape(6, nby, nbx).astype(np.int32)
    return {"planes": planes, "maps": maps, "Hy": Hy, "Wy": Wy,
            "layout": layout, "bd": bd,
            "damping": int(rng.integers(3, 7)) + bdm8}


def cdef_case_at(bd, layout, g):
    """The CDEF case of bit depth bd, layout and geometry index g."""
    return cdef_case(bd, 10 * bd + layout + 5 * g, layout,
                     CDEF_GEOMETRIES[g])


# the direction pairs that tie on blocks symmetric about the main
# diagonal (2 = 6, 1 = 7, 3 = 5) or about the vertical axis (0 = 4,
# 1 = 3, 5 = 7)
TIE_PAIRS = ((2, 6), (1, 7), (3, 5), (0, 4), (1, 3), (5, 7))


def _tie_blocks(rng, n, bd):
    """(n, 8, 8) int32 blocks whose largest direction cost is held by
    exactly one pair of TIE_PAIRS, each pair about as often: noise and
    noise on ramps and stripes, made symmetric about the main diagonal
    or the vertical axis, kept where a tied pair holds the maximum
    (cdef.dir_costs_plain); none is flat."""
    import torch
    from .cdef import dir_costs_plain, proj_matrix
    proj = torch.from_numpy(proj_matrix().astype(np.float64))
    top = (1 << bd) - 1
    yy, xx = np.mgrid[0:8, 0:8]
    want = -(-n // len(TIE_PAIRS))
    pools = {pair: [] for pair in TIE_PAIRS}
    for _ in range(400):
        if all(len(v) >= want for v in pools.values()):
            break
        m = 256
        amp = rng.integers(0, 1 << (bd - 3), (m, 1, 1))
        kind = np.arange(m)[:, None, None] % 3
        pattern = np.where(kind == 1, yy - xx * rng.integers(-2, 3, (m, 1, 1)),
                           ((yy * rng.integers(0, 3, (m, 1, 1)) +
                             xx * rng.integers(0, 3, (m, 1, 1))) % 3) * 4)
        R = np.clip(rng.integers(0, top + 1, (m, 8, 8)) // 4 +
                    np.where(kind > 0, amp * pattern, 0) + (top + 1) // 4,
                    0, top)
        C = np.concatenate([np.triu(R) + np.triu(R, 1).transpose(0, 2, 1),
                            np.concatenate([R[:, :, :4], R[:, :, 3::-1]],
                                           axis=2)]).astype(np.int32)
        costs = dir_costs_plain(torch.from_numpy(C.reshape(-1, 8)), bd,
                                proj).numpy()
        top_dirs = costs == costs.max(1, keepdims=True)
        for pair in TIE_PAIRS:
            mask = np.zeros(8, bool)
            mask[list(pair)] = True
            hit = (top_dirs == mask).all(1) & \
                (C.reshape(len(C), -1).std(1) > 0)
            pools[pair].extend(C[hit][:want - len(pools[pair])])
    C = np.array([b for k in range(want) for v in pools.values()
                  if k < len(v) for b in v[k:k + 1]], np.int32)
    if len(C) < n:
        raise RuntimeError(f"{len(C)} tie blocks, {n} wanted")
    return C[:n]


def cdef_tie_case(bd, layout):
    """The 70x50 cdef_case (geometry 0) with every 8x8 block of its luma
    crop replaced by a _tie_blocks block: the direction search meets
    exact cost ties between directions on blocks that are not flat,
    where the first maximum must win."""
    case = cdef_case(bd, 1000 + 10 * bd + layout, layout)
    rng = np.random.default_rng(2000 + 10 * bd + layout)
    nby, nbx = case["Hy"] // 8, case["Wy"] // 8
    blocks = _tie_blocks(rng, nby * nbx, bd)
    y = case["planes"][0]
    y[:nby * 8, :nbx * 8] = blocks.reshape(nby, nbx, 8, 8).transpose(
        0, 2, 1, 3).reshape(nby * 8, nbx * 8)
    return case


def cdef_cases():
    """Every CDEF case the kernel tests run: each layout and bit depth
    on every geometry, and the tie case of each."""
    return [cdef_case_at(bd, layout, g) for bd in (8, 10, 12)
            for layout in CDEF_LAYOUTS
            for g in range(len(CDEF_GEOMETRIES))] + \
        [cdef_tie_case(bd, layout) for bd in (8, 10, 12)
         for layout in CDEF_LAYOUTS]


def cdef_args(case, device):
    """cdef_planes' arguments of a cdef_case, with tensors on device."""
    import torch
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return ([T(p) for p in case["planes"]], T(case["maps"]), case["Hy"],
            case["Wy"], case["layout"], case["bd"], case["damping"])


# loop restoration: Wiener tap ranges (coefficients 0..2 of a 7-tap
# filter, AV1 spec 5.11.58), unit sizes (log2; wmax = 1.5 units: 48, 96,
# 192, 384), stripe heights as _collect_items emits them per hmax (the
# first stripe 8 >> ss_ver short, full stripes, the frame's last stripe
# of any height, odd ones included)
WIENER_TAPS = ((-5, 10), (-23, 8), (-17, 46))
LR_UNIT_LOG2 = (5, 6, 7, 8)
LR_STRIPES = {64: (56, 64, 37, 1, 64, 12, 63, 2),
              32: (28, 32, 17, 1, 32, 6, 31, 2)}
LR_KINDS = ("random", "smooth", "alt", "max", "zero", "checker", "smooth",
            "edge")


def _wiener_taps(rng, k):
    """Taps 0..2 of item k: every combination of the coefficients' ends
    in turn, then random ones."""
    if k < 8:
        return [WIENER_TAPS[i][(k >> i) & 1] for i in range(3)]
    return [int(rng.integers(lo, hi + 1)) for lo, hi in WIENER_TAPS]


def lr_case(bd, seed, kind, us_log2, hmax):
    """One plane's Wiener or SGR items: a row of units (full units and a
    last one of up to 1.5 units) over stripes of every height of
    LR_STRIPES[hmax]; the items take the 16 edge-flag combinations in
    turn. Wiener: taps at every combination of their ends, then random;
    SGR: the 16 rows of dav1d_sgr_params in turn (s0 = 0 and s1 = 0 among
    them), weights at their ends (w0 in -96..31, w1 in -32..95) and
    random. The pre-LR and pre-CDEF planes hold 8x8 blocks of the
    _cdef_blocks kinds, the checkerboard of 0 and 2^bd - 1 (SGR's
    largest box3 variance) and flat 2^bd - 1 (its largest box5 sums)
    among them. Returns {cur, pre (Hp, Wp) int32, w (the plane's valid
    columns), items (_collect_items tuples), kind, hmax, wmax, bd}."""
    rng = np.random.default_rng(seed)
    us = 1 << us_log2
    wmax = us + us // 2
    last = wmax if seed % 2 else us // 2 + 1 + int(rng.integers(0, us))
    units = [us] * (1 if us_log2 == 8 else 2) + [last]
    w = sum(units)
    heights = LR_STRIPES[hmax]
    Hp, Wp = sum(heights) + 8, w + 16
    cur = _cdef_blocks(rng, Hp, Wp, bd, LR_KINDS)
    pre = _cdef_blocks(rng, Hp, Wp, bd, LR_KINDS[::-1])
    items = []
    y = 0
    for h in heights:
        x = 0
        for uw in units:
            k = len(items)
            if kind == "wiener":
                u = {"type": 2, "filter_h": _wiener_taps(rng, k),
                     "filter_v": _wiener_taps(rng, k + 3)}
            else:
                sw = ([-96, 31][k & 1], [-32, 95][(k >> 1) & 1]) \
                    if k < 8 else (int(rng.integers(-96, 32)),
                                   int(rng.integers(-32, 96)))
                u = {"type": 3 + k % 16, "sgr_weights": sw}
            items.append((y, x, uw, h, k % 16, u))
            x += uw
        y += h
    return {"cur": cur, "pre": pre, "w": w, "items": items, "kind": kind,
            "hmax": hmax, "wmax": wmax, "bd": bd}


def lr_case_at(bd, kind, us_log2, hmax):
    """The LR case of bit depth bd, filter kind, unit size and hmax."""
    seed = 100 * bd + 10 * us_log2 + (hmax == 32) + 2 * (kind == "sgr")
    return lr_case(bd, seed, kind, us_log2, hmax)


def lr_cases(bds=(8, 10, 12)):
    """Every LR case the kernel tests run: both filters, every unit size
    and both stripe heights (luma 64, 4:2:0 chroma 32) at each bit
    depth."""
    return [lr_case_at(bd, kind, u, hmax) for bd in bds
            for kind in ("wiener", "sgr") for u in LR_UNIT_LOG2
            for hmax in (64, 32)]


def lr_args(case, device):
    """The arguments of ops/lr.py wiener_items_plain / sgr_items_plain
    (SGR: without the x_by_x table) of an lr_case on device: the edge-padded sources,
    a fresh destination (a copy of cur) and the int32 item tables, built
    by the decoder's own lr.item_tables / plane_sources."""
    import torch
    from . import lr
    from .restore_ref import _sgr_params_tbl
    cur = torch.from_numpy(case["cur"]).to(device)
    pre = torch.from_numpy(case["pre"]).to(device)
    curp, prep = lr.plane_sources(cur, pre, case["w"], case["wmax"])
    tbl = lr.item_tables(case["kind"], case["items"], _sgr_params_tbl(),
                         case["hmax"], cur.shape[0])
    return (curp, prep, cur.clone(), *lr.upload_tables(tbl, device),
            case["hmax"], case["wmax"], case["bd"])


def frame_case(bd, layout, kind, w_y=3 * 64 + 90, repeat=2):
    """The items of every plane of one frame for the one-launch Wiener
    or SGR kernel (kind): luma and (but for monochrome, layout 0) two
    chroma planes of the layout's shape, each with its own valid width
    (columns beyond it junk, which the clamped reads must not reach),
    stripe height (luma 64, 4:2:0 chroma 32) and unit size (luma 64,
    chroma 32); units across the whole width as _collect_items cuts them
    (the first at ox = 0, the last ending at ox + ows = w; luma w_y
    wide) over the LR_STRIPES heights `repeat` times (16 stripes by
    default), with edge flags (stripe + 5 unit) %
    16, so that every combination meets both plane edges. Items of
    `kind` everywhere but luma's second unit column, which is of the
    other filter; Wiener taps as lr_case, SGR parameter rows in turn
    with random weights. Returns {planes: [{cur, pre, w, hmax, items}],
    layout, bd}."""
    rng = np.random.default_rng((3000 if kind == "wiener" else 4000) +
                                10 * bd + layout)
    ss_ver, ss_hor = int(layout == 1), int(layout != 3)
    planes = []
    for p in range(3 if layout else 1):
        sv, sh = (ss_ver, ss_hor) if p else (0, 0)
        w = (w_y + sh) >> sh
        hmax = 64 >> sv
        us = 64 if p == 0 else 32
        units, x = [], 0
        while x < w:
            units.append(w - x if x + us + us // 2 > w else us)
            x += units[-1]
        heights = LR_STRIPES[hmax] * repeat
        Hp, Wp = sum(heights) + 8, w + 16
        cur = _cdef_blocks(rng, Hp, Wp, bd, LR_KINDS)
        pre = _cdef_blocks(rng, Hp, Wp, bd, LR_KINDS[::-1])
        items, y = [], 0
        for s, h in enumerate(heights):
            x = 0
            for k, uw in enumerate(units):
                if (kind == "sgr") != (p == 0 and k == 1):
                    u = {"type": 3 + s % 16,
                         "sgr_weights": (int(rng.integers(-96, 32)),
                                         int(rng.integers(-32, 96)))}
                else:
                    u = {"type": 2,
                         "filter_h": _wiener_taps(rng, len(items)),
                         "filter_v": _wiener_taps(rng, len(items) + 3)}
                items.append((y, x, uw, h, (s + 5 * k) % 16, u))
                x += uw
            y += h
        planes.append({"cur": cur, "pre": pre, "w": w, "hmax": hmax,
                       "items": items})
    return {"planes": planes, "layout": layout, "bd": bd}


def frame_cases(kind):
    """Every frame case of Wiener or SGR items (kind): each layout at bd
    8/10/12."""
    return [frame_case(bd, layout, kind) for bd in (8, 10, 12)
            for layout in CDEF_LAYOUTS]


def lr_frame_case(case):
    """An lr_case as a frame case of one plane."""
    return {"planes": [{k: case[k] for k in ("cur", "pre", "w", "hmax",
                                              "items")}],
            "layout": None, "bd": case["bd"]}


def frame_args(case, device, kind):
    """The arguments of ops/lr.py wiener_frame or sgr_frame (kind) of a
    frame case on device: [(src, pre, dst (a copy of src), w, hmax)] per
    plane and the host tables of its items of that kind
    (lr.frame_tables), and bd."""
    import torch
    from . import lr
    from .restore_ref import _sgr_params_tbl
    planes, groups = [], []
    for pl in case["planes"]:
        cur = torch.from_numpy(pl["cur"]).to(device)
        planes.append((cur, torch.from_numpy(pl["pre"]).to(device),
                       cur.clone(), pl["w"], pl["hmax"]))
        groups.append(([it for it in pl["items"]
                        if (it[5]["type"] == 2) == (kind == "wiener")],
                       pl["hmax"], cur.shape[0]))
    return planes, lr.frame_tables(kind, groups, _sgr_params_tbl()), \
        case["bd"]


def _pad128(n):
    return -(-n // 128) * 128


def _layout_ss(layout):
    """(ss_hor, ss_ver) of a layout (0 monochrome, 1 4:2:0, 2 4:2:2,
    3 4:4:4)."""
    return int(layout in (1, 2)), int(layout == 1)


# super-res: (coded luma width, output luma width, rows) of the cases;
# odd widths, a width whose chroma rounds up, the 2x step, and widths
# up to the 8192 a frame may have
SUPERRES_GEOMETRIES = ((53, 70, 21), (96, 128, 40), (64, 128, 9),
                       (157, 256, 12), (4101, 8192, 3))


# super-res edge geometries of the kernel's tiling, in planes padded to
# 4 columns only: a last tile cut by the output width and by the
# plane's (1500 of 1500 columns, 17 rows: a tile of one row), and a
# source narrower than one tile's staged span
SUPERRES_EDGE_GEOMETRIES = ((1000, 1500, 17), (9, 16, 4))


def _pad(n, m):
    return -(-n // m) * m


def superres_case(bd, layout, in_w, out_w, h, pre=True, seed=0, pad=128):
    """The resize jobs of one super-res frame: every plane of the layout
    from a coded width in_w to out_w over h rows, and (pre) the
    pre-CDEF snapshot's planes too, with the geometry of ops/superres.py
    frame_geometry (the even-rounded coded width as the source width,
    chroma's step and x0 from the rounded chroma widths). Sources are
    random pixels in planes padded as a Picture's (columns past src_w
    junk, which the clamped reads must not reach); destinations have the
    output Picture's padded shape (with pad=4, planes padded to whole
    16-byte rows only). Returns {jobs: [(src, src_w, h, dst_shape,
    dst_w, step, mx0)], bd, layout}."""
    from .mc_ref import get_upscale_x0, scale_fac
    rng = np.random.default_rng(seed + 100 * bd + 10 * layout + in_w)
    sh, sv = _layout_ss(layout)
    bw4 = ((in_w + 7) >> 3) << 3          # 4 * f.bw
    step = [scale_fac(in_w, out_w),
            scale_fac((in_w + sh) >> sh, (out_w + sh) >> sh)]
    x0 = [get_upscale_x0(in_w, out_w, step[0]),
          get_upscale_x0((in_w + sh) >> sh, (out_w + sh) >> sh, step[1])]
    Hs, Ws, Wd = _pad(h, pad), _pad(bw4, pad), _pad(out_w, pad)
    jobs = []
    for _src in range(2 if pre else 1):
        for p in range(3 if layout else 1):
            c = int(bool(p))
            def cols(n):            # whole 16-byte rows
                return _pad((n + sh * c) >> (sh * c), 4)
            shape = ((Hs + sv * c) >> (sv * c), cols(Ws))
            jobs.append((rng.integers(0, 1 << bd, shape).astype(np.int32),
                         bw4 >> (sh * c), (h + sv * c) >> (sv * c),
                         ((Hs + sv * c) >> (sv * c), cols(Wd)),
                         (out_w + sh * c) >> (sh * c), step[c], x0[c]))
    return {"jobs": jobs, "bd": bd, "layout": layout}


def superres_cases():
    """Every super-res case: each geometry of SUPERRES_GEOMETRIES in
    each layout at bd 8/10/12 (with the pre-CDEF snapshot at bd 8 and
    12, without it at bd 10)."""
    return [superres_case(bd, layout, *g, pre=bd != 10)
            for bd in (8, 10, 12) for layout in (0, 1, 2, 3)
            for g in SUPERRES_GEOMETRIES]


def superres_edge_cases():
    """The SUPERRES_EDGE_GEOMETRIES in each layout at bd 8/10/12, planes
    padded to 4 columns (with the pre-CDEF snapshot at bd 8)."""
    return [superres_case(bd, layout, *g, pre=bd == 8, pad=4)
            for bd in (8, 10, 12) for layout in (0, 1, 2, 3)
            for g in SUPERRES_EDGE_GEOMETRIES]


def superres_args(case, device):
    """resize_frame's jobs of a superres_case on `device`: destinations
    filled with -1 (the kernel writes every pixel, zeros outside the
    resized area)."""
    import torch
    return [(torch.from_numpy(src).to(device), src_w, h,
             torch.full(dst_shape, -1, dtype=torch.int32, device=device),
             dst_w, step, mx0)
            for src, src_w, h, dst_shape, dst_w, step, mx0 in case["jobs"]]


def grain_case(bd, layout, w, h, overlap=True, csfl=False, clip=False,
               is_id=False, apply=None, seed=0, pad=128):
    """One frame's film grain inputs: random clean planes of a
    Picture's padded shapes (w x h visible), random grain LUTs in the
    grain range, scaling LUTs in 0..255, block offsets 0..255, a scaling
    shift of 8..11 and chroma multipliers and offsets over their whole
    ranges; apply (per plane: grained or copied) defaults to every
    plane; planes padded as a Picture's or, with pad=4, to whole 16-byte
    rows only. Returns {planes, luts (3, 74, 82) int16, scal (3, 1 <<
    bd) uint8, off (n_rows, n_bx) int32, params (GrainFrame's
    fields)}."""
    from .fg import LUT_ROWS
    rng = np.random.default_rng(seed + 1000 * bd + 100 * layout + w + h)
    sh, sv = _layout_ss(layout)
    H, W = _pad(h, pad), _pad(w, pad)
    n = 3 if layout else 1
    shapes = [(H, W)] + [((H + sv) >> sv, _pad((W + sh) >> sh, 4))] * \
        (n - 1)
    ctr = 128 << (bd - 8)
    apply = tuple(apply if apply is not None else (True,) * n)
    csfl = bool(csfl and layout)
    return {
        "planes": [rng.integers(0, 1 << bd, s).astype(np.int32)
                   for s in shapes],
        "luts": rng.integers(-ctr, ctr, (3, LUT_ROWS, 82)).astype(np.int16),
        "scal": rng.integers(0, 256, (3, 1 << bd)).astype(np.uint8),
        "off": rng.integers(0, 256, (-(-h // 32), -(-w // 32))).astype(
            np.int32),
        "params": dict(
            w=w, h=h, sx=sh, sy=sv, bd=bd,
            scaling_shift=int(rng.integers(8, 12)), overlap=overlap,
            clip_range=clip, is_id=is_id, csfl=csfl, apply=apply,
            scale_idx=(0, 0 if csfl else 1, 0 if csfl else 2)[:n],
            uv_luma_mult=tuple(int(v) for v in rng.integers(-128, 128, 2)),
            uv_mult=tuple(int(v) for v in rng.integers(-128, 128, 2)),
            uv_offset=tuple(int(v) for v in rng.integers(-256, 256, 2)))}


# film grain: (visible width, height) of the cases: odd sizes whose
# chroma luma read goes one column past the luma width, blocks cut at
# both edges, and whole blocks filling the padded planes' width
GRAIN_GEOMETRIES = ((71, 49), (128, 64), (130, 97))
# the per-frame flags in combination, a layout each: overlap off, chroma
# scaling from luma, the restricted range with and without is_id,
# copied planes
GRAIN_VARIANTS = {
    "mono-clip": dict(bd=8, layout=0, overlap=False, clip=True),
    "420-csfl-clip": dict(bd=10, layout=1, overlap=False, csfl=True,
                          clip=True),
    "422-csfl-clip-id": dict(bd=12, layout=2, csfl=True, clip=True,
                             is_id=True),
    "444-clip-id-copy": dict(bd=10, layout=3, overlap=False, clip=True,
                             is_id=True, apply=(False, True, True)),
}


def grain_variant(name):
    """The GRAIN_VARIANTS case of `name`, 71x49."""
    v = dict(GRAIN_VARIANTS[name])
    return grain_case(v.pop("bd"), v.pop("layout"), 71, 49, seed=7, **v)


def grain_cases():
    """Every film grain case: each layout at bd 8/10/12 on each geometry
    with overlap, then the GRAIN_VARIANTS."""
    return [grain_case(bd, layout, w, h, seed=k)
            for bd in (8, 10, 12) for layout in (0, 1, 2, 3)
            for k, (w, h) in enumerate(GRAIN_GEOMETRIES)] + \
        [grain_variant(name) for name in GRAIN_VARIANTS]


def grain_edge_cases():
    """The GRAIN_GEOMETRIES of odd sizes in each layout at bd 8/10/12,
    planes padded to 4 columns: a unit's 128 columns cut by the plane,
    and the chroma's luma read past an odd width in the last int4."""
    return [grain_case(bd, layout, w, h, seed=k, pad=4)
            for bd in (8, 10, 12) for layout in (0, 1, 2, 3)
            for k, (w, h) in enumerate(GRAIN_GEOMETRIES) if (w | h) & 1]


def grain_args(case, device):
    """film_grain's arguments of a grain_case on `device`: (planes,
    GrainFrame, luts, scal, off)."""
    import torch
    from .fg import GrainFrame
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return ([T(p) for p in case["planes"]], GrainFrame(**case["params"]),
            T(case["luts"]), T(case["scal"]), T(case["off"]))


# intra leftover levels (ops/ipred.py): the (w, h) of every transform
# size (4..64, ratio up to 4); filter-intra and CFL go to 32x32
IPRED_SIZES = sorted({(4 * t.w, 4 * t.h) for t in lv.TXFM_INFO})
IPRED_SMALL = [(w, h) for w, h in IPRED_SIZES if w <= 32 and h <= 32]
IPRED_MODES = (0, 1, 2, 3, 4, 5, 9, 10, 11, 12)   # the splat family
CFL_DC_MODES = (0, 3, 4, 5)                       # DC, LEFT, TOP, 128
# (bd, ss_hor, ss_ver, planes): 4:2:0, 4:4:4 and monochrome at 8 bit,
# 4:2:2 at 10, 4:2:0 at 12
IPRED_LAYOUTS = ((8, 1, 1, 3), (8, 0, 0, 3), (8, 1, 1, 1), (10, 1, 0, 3),
                 (12, 1, 1, 3))
IPRED_READ_ROWS = 64          # every edge and luma rect reads rows above
IPRED_STRIP = 32              # right-edge units live in this strip


def _ipred_params(rng, fam, w, h, deriv):
    """p0 .. p7 of one unit of `fam` (ops/ipred.py), the upsample flags
    only where the reference allows them (w + h <= 16)."""
    from . import ipred
    p = [0] * 8
    d = lambda: int(deriv[rng.integers(1, len(deriv))])
    small = w + h <= 16
    if fam == ipred.FAM_S:
        p[0] = int(rng.choice(IPRED_MODES))
    elif fam == ipred.FAM_F:
        p[0] = int(rng.integers(0, 5))
    elif fam in (ipred.FAM_Z1, ipred.FAM_Z3):
        up = int(small and rng.integers(0, 2))
        p[:3] = [d() << up, 0 if up else int(rng.integers(0, 4)), up]
    elif fam == ipred.FAM_Z2:
        ua = int(small and rng.integers(0, 2))
        ul = int(small and rng.integers(0, 2))
        p = [d() << ua, d() << ul, 0 if ua else int(rng.integers(0, 4)),
             0 if ul else int(rng.integers(0, 4)),
             int(rng.integers(1, w + 9)), int(rng.integers(1, h + 9)), ua,
             ul]
    return p


def _edge_source(rng, W, nflat, w, h, rows):
    """A w x h unit's edges from the availability walk at a random
    position whose edges lie in the plane's first `rows` rows (the walk's
    tile ends there): random neighbours, edge flags, mode, angle and edge
    filter. Returns (run row (NRUN,), index row (321,)):
    recon/ipred_device.py edge_runs and edge_indices on the same
    arguments."""
    from ..recon.ipred_device import edge_indices, edge_runs
    tw, th, w4, h4 = w // 4, h // 4, W // 4, rows // 4
    x = int(rng.integers(0, w4 - tw + 1))
    y = int(rng.integers(0, h4 - th + 1))
    args = (x, bool(x > 0 and rng.integers(0, 4)), y,
            bool(y > 0 and rng.integers(0, 4)), w4, h4,
            int(rng.integers(0, 64)), W, 4 * x, 4 * y,
            int(rng.integers(0, 14)), int(rng.integers(-3, 4)), tw, th,
            int(rng.integers(0, 2)), nflat)
    return np.asarray(edge_runs(*args)[2]), edge_indices(*args)[2]


def _ipred_units(rng, deriv, pl, W, ss_hor, ss_ver, y0, sizes, luma_w,
                 cut_bottom):
    """One plane's units of a level, packed below row y0: every family
    at each of `sizes` it takes (filter-intra and CFL up to 32x32, CFL
    on chroma planes), random parameters and tlf; units half past the
    plane's right edge in a strip, and with cut_bottom a shelf the
    plane's bottom edge cuts. Returns (unit rows without their run
    column, the rows the level takes, the plane's height if cut)."""
    from . import ipred
    R = IPRED_READ_ROWS
    units = [(fam, w, h) for fam in (ipred.FAM_S, ipred.FAM_Z1,
                                     ipred.FAM_Z2, ipred.FAM_Z3)
             for w, h in sizes]
    units += [(ipred.FAM_F, w, h) for w, h in sizes if w <= 32 and h <= 32]
    if pl:
        units += [(ipred.FAM_CFL, w, h) for w, h in sizes
                  if w <= 32 and h <= 32 and (w << ss_hor) <= 64 and
                  (h << ss_ver) <= R]
    order = rng.permutation(len(units))
    units = [units[i] for i in order]
    py, px, used = pack([(h, w) for _, w, h in units], W - IPRED_STRIP,
                        align=4)
    py = py + y0
    # the right edge: units half past the plane in the strip; the bottom
    # edge: a shelf the plane cuts through the middle
    right = [(fam, 16, 8) for fam in range(6) if fam != ipred.FAM_CFL or pl]
    geo = [(f, w, h, int(y), int(x)) for (f, w, h), y, x in
           zip(units, py, px)]
    geo += [(f, w, h, y0 + 8 * i, W - 8) for i, (f, w, h) in
            enumerate(right)]
    H = None
    if cut_bottom:
        bottom = [(fam, 8, 16) for fam in range(6)
                  if fam != ipred.FAM_CFL or pl]
        H = y0 + used + 8
        geo += [(f, w, h, H - 8, 16 * i) for i, (f, w, h) in
                enumerate(bottom)]
    rows = []
    for fam, w, h, y, x in geo:
        p = _ipred_params(rng, fam, w, h, deriv)
        if fam == ipred.FAM_CFL:
            nh = 4 * int(rng.integers(1, h // 4 + 1))
            nw = 4 * int(rng.integers(1, w // 4 + 1))
            p[:6] = [4 * int(rng.integers(0, (R - (h << ss_ver)) // 4 + 1)),
                     4 * int(rng.integers(0, (luma_w - (w << ss_hor)) // 4
                                          + 1)),
                     nh, nw, int(rng.integers(-16, 17)),
                     int(rng.choice(CFL_DC_MODES))]
        tlf = 0 if fam == ipred.FAM_CFL else int(rng.integers(0, 2))
        rows.append([pl, fam, w, h, y, x, tlf, 0] + p)
    return rows, max(used, 8 * len(right)), H


def _edges_of(rng, units, shapes, read_rows):
    """Runs and index rows of each unit, its edges in the first
    read_rows[k] rows of its plane (unit k's)."""
    from . import ipred
    n = len(units)
    runs = np.empty((n, ipred.NRUN), np.int64)
    idx = np.empty((n, ipred.EDGE_LEN), np.int64)
    for i, (pl, w, h) in enumerate(units[:, [0, 2, 3]]):
        H, W = shapes[pl]
        runs[i], idx[i] = _edge_source(rng, W, H * W, int(w), int(h),
                                       int(read_rows[i]))
    return runs, idx


def ipred_case(bd, ss_hor, ss_ver, n_planes, seed, width=512):
    """One level of leftover units over every plane: each family at
    every geometry it takes (splat, Z1, Z2, Z3 at every transform size,
    filter-intra at those up to 32x32, CFL at chroma sizes up to 32x32
    on the chroma planes), random parameters and tlf, units cut by the
    plane's right and bottom edges. Every unit writes below row
    IPRED_READ_ROWS and its edges, from the availability walk at a
    random position (_edge_source), read pixels above it (or the four
    constants), CFL luma rects lie above it too, and no two units write
    the same pixel: the level scheduler's guarantee. Returns {"bd",
    "ss_hor", "ss_ver", "planes": [int32 (H, W)], "units": (n, NCOL)
    int32 (column 7 the unit's row of runs and idx), "runs": (n, NRUN)
    int32, "idx": (n, 321) int32, their expansion}."""
    from . import ipred
    from .. import tables
    rng = np.random.default_rng(seed)
    deriv = tables.get("dav1d_dr_intra_derivative")
    R = IPRED_READ_ROWS
    rows, shapes = [], []
    for pl in range(n_planes):
        W = width >> (ss_hor if pl else 0)
        r, _, H = _ipred_units(rng, deriv, pl, W, ss_hor, ss_ver, R,
                               IPRED_SIZES, width, True)
        rows += r
        shapes.append((H, W))
    planes = [rng.integers(0, 1 << bd, s).astype(np.int32) for s in shapes]
    units = np.asarray(rows, np.int64)
    runs, idx = _edges_of(rng, units, shapes, np.full(len(units), R))
    order = np.argsort(ipred.unit_class(units), kind="stable")
    units, runs, idx = units[order], runs[order], idx[order]
    units[:, 7] = np.arange(len(units))
    return {"bd": bd, "ss_hor": ss_hor, "ss_ver": ss_ver, "planes": planes,
            "units": units.astype(np.int32), "runs": runs.astype(np.int32),
            "idx": idx.astype(np.int32)}


def ipred_cases():
    """ipred_case for every IPRED_LAYOUTS entry."""
    return [ipred_case(bd, sh, sv, n, seed=90 + k)
            for k, (bd, sh, sv, n) in enumerate(IPRED_LAYOUTS)]


def ipred_args(case, device):
    """(planes, units, idx) of a case as tensors on `device`."""
    import torch
    dev = torch.device(device)
    return ([torch.from_numpy(p.copy()).to(dev) for p in case["planes"]],
            torch.from_numpy(case["units"]).to(dev),
            torch.from_numpy(case["idx"]).to(dev))


# the multi-level plan cases: (bd, ss_hor, ss_ver, planes), levels,
# the geometries a level and plane takes at random
PLAN_LAYOUTS = ((8, 1, 1, 3), (10, 1, 0, 3), (12, 1, 1, 3))
PLAN_LEVELS = 3
PLAN_SIZES = 2


def plan_case(bd, ss_hor, ss_ver, n_planes, seed, width=512):
    """A frame's leftover plan of PLAN_LEVELS levels over every plane:
    level L's units (every family at 4x4, PLAN_SIZES random transform
    sizes and one 64 wide or tall, units cut by the plane's right
    edge and, at the last level, its bottom edge) write a band of rows
    below the previous level's, their edges read anywhere above their
    band (lower levels' outputs, with their residuals, among them); about
    half the units carry a residual of their own size (random kinds,
    dense, sparse full-range or DC-only coefficients), 4x4 ones a WHT
    job one time in two. Returns {"bd", "ss_hor", "ss_ver", "planes",
    "pool", "levels": [{"units" (n, NCOL) int32, column 7 the row of
    "runs" and "idx"; "runs", "idx", "jobs" (m, 6) ops/itx.py job rows,
    "plane" (m,), "wht" (m,) bool}]}."""
    from . import ipred
    from .itx import CF_LEN, res_tx_kinds
    from .. import tables
    rng = np.random.default_rng(seed)
    deriv = tables.get("dav1d_dr_intra_derivative")
    tx_of = {(4 * t.w, 4 * t.h): k for k, t in enumerate(lv.TXFM_INFO)}
    big = [s for s in IPRED_SIZES if 64 in s]
    y0 = [IPRED_READ_ROWS] * n_planes
    levels, shapes = [], [None] * n_planes
    for L in range(PLAN_LEVELS):
        rows, reads = [], []
        for pl in range(n_planes):
            W = width >> (ss_hor if pl else 0)
            pick = rng.choice(len(IPRED_SIZES) - 1, PLAN_SIZES,
                              replace=False)
            sizes = [(4, 4)] + [IPRED_SIZES[1 + i] for i in pick] + \
                [big[rng.integers(len(big))]]
            last = L == PLAN_LEVELS - 1
            r, used, H = _ipred_units(rng, deriv, pl, W, ss_hor, ss_ver,
                                      y0[pl], sizes, width, last)
            rows += r
            reads += [y0[pl]] * len(r)
            y0[pl] += used
            if last:
                shapes[pl] = (H, W)
        levels.append((np.asarray(rows, np.int64), reads))
    planes = [rng.integers(0, 1 << bd, s).astype(np.int32) for s in shapes]
    out, parts, pos = [], [], 0
    for units, reads in levels:
        runs, idx = _edges_of(rng, units, shapes, reads)
        units[:, 7] = np.arange(len(units))
        jobs, plane, wht = [], [], []
        for pl, _, w, h, py, px in units[:, :6]:
            if rng.random() < 0.5:
                continue
            tx = tx_of[(int(w), int(h))]
            if (w, h) == (4, 4) and rng.random() < 0.5:
                parts.append(rng.integers(-1024, 1025, 16))
                jobs.append([0, 0, 0, py, px, pos])
                wht.append(True)
                pos += 16
            else:
                rk, ck = res_tx_kinds(tx)
                parts.append(_coefs(rng, int(CF_LEN[tx]), bd,
                                    int(rng.integers(0, 3))))
                jobs.append([tx, rng.integers(len(rk)),
                             rng.integers(len(ck)), py, px, pos])
                wht.append(False)
                pos += int(CF_LEN[tx])
            plane.append(pl)
        out.append({"units": units.astype(np.int32),
                    "runs": runs.astype(np.int32),
                    "idx": idx.astype(np.int32),
                    "jobs": np.asarray(jobs, np.int32).reshape(-1, 6),
                    "plane": np.asarray(plane, np.int64),
                    "wht": np.asarray(wht, bool)})
    return {"bd": bd, "ss_hor": ss_hor, "ss_ver": ss_ver, "planes": planes,
            "pool": np.concatenate(parts).astype(np.int32),
            "levels": out}


def plan_cases():
    """plan_case for every PLAN_LAYOUTS entry."""
    return [plan_case(bd, sh, sv, n, seed=120 + k)
            for k, (bd, sh, sv, n) in enumerate(PLAN_LAYOUTS)]


def plan_args(case, device):
    """(planes, tables, pool) of an ipred_case (one level, no residuals)
    or a plan_case as tensors on `device`: the tables ops/ipred.py
    pack_plan makes of its levels."""
    import torch
    from .ipred import pack_plan
    dev = torch.device(device)
    levels = case.get("levels") or [{
        "units": case["units"], "runs": case["runs"],
        "jobs": np.zeros((0, 6), np.int32), "plane": np.zeros(0, np.int64),
        "wht": np.zeros(0, bool)}]
    tables = pack_plan([(lv_["units"], lv_["runs"], lv_["jobs"],
                         lv_["plane"], lv_["wht"]) for lv_ in levels])
    pool = case.get("pool", np.zeros(1, np.int32))
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return ([T(p.copy()) for p in case["planes"]],
            {k: T(v) for k, v in tables.items()}, T(pool))


def shard_planes(planes, T, device, ss_hor=1):
    """A case's planes (numpy, luma first, chroma subsampled by ss_hor)
    column-sharded over T shards all on `device`, as
    recon/sharded_stageb.py holds a frame's planes: luma bands of the
    least multiple of 64 columns that covers every plane, chroma bands
    that >> ss_hor. Returns (the sharded planes, the T devices)."""
    import torch
    from ..recon.sharded_stageb import to_sharded
    sh = [ss_hor if k else 0 for k in range(len(planes))]
    sw = max(64, max(-(-(p.shape[1] << s) // T // 64) * 64
                     for p, s in zip(planes, sh)))
    devices = [torch.device(device)] * T
    return [to_sharded(np.ascontiguousarray(p, np.int32), T, sw >> s,
                       devices) for p, s in zip(planes, sh)], devices



# dav1d_tpu's batched per-block MC programs (ops/mc.py `_put8_fn` ...
# `_residual_scatter_fn`): MC_BATCH_N jobs a case on references of
# MC_BATCH_REF, windows from origins on and past every edge (clamped),
# the scatter forms' jobs on disjoint cells of MC_BATCH_PLANE with the
# padding's destinations past either end of the plane
MC_BATCH_N = 32
MC_BATCH_REF = (3, 96, 112)
MC_BATCH_PLANE = (128, 128)
MC_BATCH_SENTINEL = 1 << 20


def mc_batch_cases(bd, seed=0):
    """[(program name, numpy args, trailing args)] of every batched
    program of ops/mc.py at bd: puts and preps (8-tap, bilinear, warp),
    compounds of every combine mode at 4:2:0, 4:2:2 and 4:4:4, OBMC top
    and left laps, residual adds, and each scatter form."""
    from .mc import COMP_AVG, COMP_MASK, COMP_SEG, COMP_WAVG, filter_banks
    rng = np.random.default_rng(7000 + bd + seed)
    n = MC_BATCH_N
    R, HR, WR = MC_BATCH_REF
    H, W = MC_BATCH_PLANE
    px = lambda *shape: rng.integers(0, 1 << bd, shape).astype(np.int32)
    REF, plane = px(R, HR, WR), px(H, W)
    fb = filter_banks()

    def ids(length, size):
        start = rng.integers(-6, size + 2, n)[:, None]
        return np.clip(start + np.arange(length), 0, size - 1).astype(
            np.int32)

    def slot():
        return rng.integers(0, R, n).astype(np.int32)

    def taps(h, w):
        ft, mx, my = (rng.integers(0, 16, n) for _ in range(3))
        return fb[int(w <= 4), ft & 3, mx], fb[int(h <= 4), (ft >> 2) & 3, my]

    def win8(h, w):
        return (ids(h + 7, HR), ids(w + 7, WR), slot(), *taps(h, w))

    def phases():
        return (rng.integers(0, 16, n).astype(np.int32),
                rng.integers(0, 16, n).astype(np.int32))

    def warp():
        return (ids(15, HR), ids(15, WR), slot(),
                *rng.integers(-20000, 20000, (2, n)).astype(np.int32),
                *rng.integers(-1000, 1000, (4, n)).astype(np.int32))

    def comb(h, w):
        modes = np.array([COMP_AVG, COMP_WAVG, COMP_SEG, COMP_MASK])
        return (modes[np.arange(n) % 4].astype(np.int32),
                rng.integers(0, 17, n).astype(np.int32),
                rng.integers(0, 2, n).astype(np.int32),
                rng.integers(0, 65, (n, h, w)).astype(np.int8))

    def region(rows, cols):
        return (ids(rows, H), ids(cols, W))

    def padded(h, w, ph, pw):
        cells = rng.permutation((H // ph) * (W // pw))[:n]
        drows = (cells // (W // pw))[:, None] * ph + np.arange(ph)
        dcols = (cells % (W // pw))[:, None] * pw + np.arange(pw)
        s = MC_BATCH_SENTINEL
        drows[:, h:] = np.where(np.arange(ph - h) % 2, s, -s)
        dcols[:, w:] = s
        return drows.astype(np.int32), dcols.astype(np.int32)

    res = lambda h, w: rng.integers(-(2 << bd), 2 << bd, (n, h, w)).astype(
        np.int32)
    out = []
    for put in (True, False):
        out += [("_put8_fn", (REF, *win8(16, 8)), (bd, put)),
                ("_bilin_fn", (REF, ids(9, HR), ids(17, WR), slot(),
                               *phases()), (bd, put)),
                ("_warp_fn", (REF, *warp()), (bd, put))]
    for ss in ((1, 1), (1, 0), (0, 0)):
        out.append(("_compound_fn", (REF, *win8(16, 16), *win8(16, 16),
                                     *comb(16, 16)), (bd, *ss)))
    out += [("_obmc_blend_fn", (REF, *win8(16, 32), plane,
                                *region(12, 32)), (bd, True)),
            ("_obmc_blend_fn", (REF, *win8(32, 16), plane,
                                *region(32, 12)), (bd, False)),
            ("_residual_fn", (plane, *region(8, 16), res(8, 16)), (bd,))]
    out += [("_put8_scatter_fn", (REF, *win8(16, 16), plane,
                                  *padded(12, 10, 16, 16)), (bd,)),
            ("_bilin_scatter_fn", (REF, ids(17, HR), ids(17, WR), slot(),
                                   *phases(), plane,
                                   *padded(12, 10, 16, 16)), (bd,)),
            ("_warp_scatter_fn", (REF, *warp(), plane,
                                  *padded(8, 8, 8, 8)), (bd,)),
            ("_compound_scatter_fn", (REF, *win8(16, 16), *win8(16, 16),
                                      *comb(16, 16), plane,
                                      *padded(12, 10, 16, 16)), (bd, 1, 1)),
            ("_obmc_scatter_fn", (REF, *win8(16, 16), plane,
                                  *padded(12, 16, 16, 16)), (bd, True)),
            ("_residual_scatter_fn", (plane, *padded(12, 10, 16, 16),
                                      res(16, 16)), (bd,))]
    return out
