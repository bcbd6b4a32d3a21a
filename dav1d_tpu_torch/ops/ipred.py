"""Intra prediction and residuals of the device leftover levels
(recon/ipred_device.py).

Port of dav1d_tpu's ops/ipred.py: the eight device programs that
predict a level of leftover intra units from per-unit EDGE BUFFERS —
(n, 321) arrays with the golden Edge layout (center C = 160,
buf[C + i] == topleft_out[i]) gathered from the current planes (an
index >= the plane's flat size selects one of the four constants
half + 1, half - 1, half, 0). Every rounding rule is ops/ipred_ref.py's
(reference src/ipred_tmpl.c:44-720). Two implementations:

- the plain versions, batched torch over units of one geometry:
  `edge_gather_plain`, `splat_family_plain` (DC variants, V, H, Paeth,
  smooth), `z1_plain`, `z2_plain`, `z3_plain`, `filter_plain`,
  `cfl_plain`, `scatter_pred_plain`, `level_plain` (a whole level over
  every plane, from index rows) and `plan_plain` (a frame's plan: every
  level's units, edges expanded from their runs by `run_indices`, then
  the level's residuals through ops/itx.py `itx_add_plain`); used for
  CPU tensors only;
- the hand-written CUDA kernel csrc/ipred.cu (`plan_cuda`): one
  cooperative launch a frame over every level's units and residuals,
  edges staged in shared memory, predictions stored straight into the
  planes; used for every CUDA tensor (`ipred_plan` dispatches).

A unit (int32 row of NCOL columns, one per transform unit):
  plane, family, w, h, py, px, tlf, row, p0 .. p7
`row` is the unit's row of the run table (for `level_plain`: of the
index table); `tlf` asks for the Z2 top-left 5-6-5 filter. The
parameters per family:
  FAM_S   p0 dsp mode (DC, DC_128, TOP_DC, LEFT_DC, V, H, PAETH,
          SMOOTH, SMOOTH_V, SMOOTH_H)
  FAM_F   p0 filter-intra kind (0..4)
  FAM_Z1  p0 dx (doubled when upsampled), p1 strength, p2 upsample
  FAM_Z3  p0 dy (doubled when upsampled), p1 strength, p2 upsample
  FAM_Z2  p0 dx, p1 dy (each doubled when its edge is upsampled),
          p2 top strength, p3 left strength, p4 max_w, p5 max_h,
          p6 upsample above, p7 upsample left
  FAM_CFL p0 ypy, p1 ypx, p2 nh, p3 nw, p4 alpha, p5 dc mode (w, h:
          the chroma size; the luma rect is read from plane 0)
A unit's edges (int32 row of NRUN columns, recon/ipred_device.py
`edge_runs`): four runs (start, stride, count, size) -- left,
bottom-left, top, top-right -- and the top-left source; `run_indices`
expands them to the index row the availability walk of `edge_indices`
gives. The units of one level only read pixels that lower levels wrote
(the level scheduler's guarantee), so they run in any order.

What existed only to keep the TPU's compiled programs few is gone: no
batch-size ladder, no out-of-bounds padding lanes, no per-geometry
cache of jitted functions, no scatter program (the kernel stores), no
index rows on the device.
"""
from __future__ import annotations

import ctypes as ct
from functools import lru_cache

import numpy as np
import torch

from .. import tables
from . import ipred_ref as r
from . import itx
from .cuda_build import count_launch, launch_stream

C = 160                 # edge buffer center (matches ipred_ref.Edge)
EDGE_LEN = 2 * C + 1
NCOL = 16
# a run row: left, bottom-left, top, top-right runs of (start, stride,
# count, size) at columns RUN_LEFT .., and the top-left source
NRUN = 17
RUN_LEFT, RUN_BL, RUN_TOP, RUN_TR, RUN_TL = 0, 4, 8, 12, 16
# the frame tables' row widths (csrc/ipred.cu): a level (u0, ub, u1,
# b0, b1, w0, w1), a residual block (ops/itx.py res_blocks' cls, first,
# count, and the plane), a WHT job (ops/itx.py's 6 columns and the
# plane)
NLEV, BCOL, WCOL = 7, 4, 7
# the frame tables (pack_plan) and their row widths, in the kernel's
# argument order
PLAN_TABLES = {"units": NCOL, "runs": NRUN, "res": 6, "blocks": BCOL,
               "wht": WCOL, "levels": NLEV}
FAM_S, FAM_F, FAM_Z1, FAM_Z2, FAM_Z3, FAM_CFL = range(6)
FAMILIES = {"s": FAM_S, "f": FAM_F, "z1": FAM_Z1, "z2": FAM_Z2,
            "z3": FAM_Z3, "cfl": FAM_CFL}

# kernel launches per name (counted where the CUDA kernel is launched)
LAUNCHES = {"ipred": 0}

_EDGE_KERNELS = ((0, 4, 8, 4, 0), (0, 5, 6, 5, 0), (2, 4, 4, 4, 2))


@lru_cache(maxsize=None)
def _sm_weights_np(n):
    return tables.get("dav1d_sm_weights")[n:n + n].astype(np.int64)


def filter_tap_matrices(flt):
    """(5, 8, 7) int32 filter-intra taps from dav1d_filter_intra_taps
    (5, 64) in the x86 layout of the table dump: [kind][output pixel
    fi][p0..p6] (ipred_ref._filter_tap_matrix for every kind)."""
    flt = np.asarray(flt, np.int64)
    fi = np.arange(8)
    cols = np.stack([2 * fi, 2 * fi + 1, 16 + 2 * fi, 17 + 2 * fi,
                     32 + 2 * fi, 33 + 2 * fi, 48 + 2 * fi], axis=1)
    return np.ascontiguousarray(flt[:, cols], np.int32)


def filter_taps(filt_idx):
    """(8, 7) int32 tap matrix of one filter-intra kind."""
    return filter_tap_matrices(
        tables.get("dav1d_filter_intra_taps"))[filt_idx]


def _dc_consts(w, h, bd):
    ctz = ((w + h) & -(w + h)).bit_length() - 1
    if w == h:
        return ctz, 1, 0
    if bd == 8:
        return ctz, (0x3334 if (w > h * 2 or h > w * 2) else 0x5556), 16
    return ctz, (0x6667 if (w > h * 2 or h > w * 2) else 0xAAAB), 17


def _dc_values(top, left, w, h, bd):
    """(dc, dc_top, dc_left) of (n, w) top and (n, h) left edges."""
    ctz, mult, msh = _dc_consts(w, h, bd)
    sum_t, sum_l = top.sum(1), left.sum(1)
    dc = (sum_t + sum_l + ((w + h) >> 1)) >> ctz
    if mult != 1:
        dc = (dc * mult) >> msh
    dc_top = (sum_t + (w >> 1)) >> (w.bit_length() - 1)
    dc_left = (sum_l + (h >> 1)) >> (h.bit_length() - 1)
    return dc, dc_top, dc_left


def edge_gather_plain(src_flat, idx, tlf):
    """(src_flat (N + 4,), idx (n, 321), tlf (n,)) -> int64 edges
    (n, 321), with the Z2 top-left 5-6-5 filter applied where tlf != 0
    (reference ipred_prepare_tmpl.c:186-190)."""
    e = src_flat[idx.long()].long()
    filt = ((e[:, C - 1] + e[:, C + 1]) * 5 + e[:, C] * 6 + 8) >> 4
    e[:, C] = torch.where(tlf != 0, filt, e[:, C])
    return e


def splat_family_plain(edges, mode, w, h, bd):
    """Non-angular predictors over (n, 321) edges; the per-unit dsp
    `mode` selects among DC / DC_128 / TOP_DC / LEFT_DC / V / H / PAETH /
    SMOOTH / SMOOTH_V / SMOOTH_H (reference ipred_tmpl.c:44-328).
    Returns (n, h, w) int64."""
    n = edges.shape[0]
    half = (1 << bd) >> 1
    top = edges[:, C + 1:C + 1 + w]
    left = edges[:, C - h:C].flip(1)                    # top-most first
    tl = edges[:, C][:, None, None]
    t3, l3 = top[:, None, :], left[:, :, None]
    dc, dc_top, dc_left = _dc_values(top, left, w, h, bd)

    base = l3 + t3 - tl
    ldiff, tdiff, tldiff = (l3 - base).abs(), (t3 - base).abs(), \
        (tl - base).abs()
    paeth = torch.where((ldiff <= tdiff) & (ldiff <= tldiff), l3,
                        torch.where(tdiff <= tldiff, t3, tl))
    dev = edges.device
    swh = torch.from_numpy(_sm_weights_np(w)).to(dev)[None, None, :]
    swv = torch.from_numpy(_sm_weights_np(h)).to(dev)[None, :, None]
    right = edges[:, C + w][:, None, None]
    bottom = edges[:, C - h][:, None, None]
    smooth = (swv * t3 + (256 - swv) * bottom +
              swh * l3 + (256 - swh) * right + 256) >> 9
    smooth_v = (swv * t3 + (256 - swv) * bottom + 128) >> 8
    smooth_h = (swh * l3 + (256 - swh) * right + 128) >> 8

    shape = (n, h, w)
    m = mode.long()[:, None, None]
    out = dc[:, None, None].expand(shape)
    for k, v in ((r.DC_128_PRED, torch.full_like(out, half)),
                 (r.TOP_DC_PRED, dc_top[:, None, None]),
                 (r.LEFT_DC_PRED, dc_left[:, None, None]),
                 (r.VERT_PRED, t3), (r.HOR_PRED, l3),
                 (r.PAETH_PRED, paeth), (r.SMOOTH_PRED, smooth),
                 (r.SMOOTH_V_PRED, smooth_v), (r.SMOOTH_H_PRED, smooth_h)):
        out = torch.where(m == k, v.expand(shape), out)
    return out


def _filter_edges(edges, base, sz, src_from, src_to, lim_from, lim_to,
                  strength):
    """Batched ipred_tmpl.c:363-386 with a per-unit strength (0: the
    raw edges[base .. base + sz)). lim_from / lim_to: (n,) tensors or
    ints. Returns (n, sz) int64."""
    dev = edges.device
    idx = torch.clamp(torch.arange(-2, sz + 2, device=dev), src_from,
                      src_to - 1)
    vals = edges[:, base + idx]                          # (n, sz + 4)
    i = torch.arange(sz, device=dev)[None, :]
    lf = torch.as_tensor(lim_from, device=dev).clamp(max=sz)
    lt = torch.as_tensor(lim_to, device=dev).clamp(max=sz)
    if lf.dim():
        lf = lf[:, None]
    if lt.dim():
        lt = lt[:, None]
    keep = (i < lf) | (i >= lt)
    passthru = vals[:, 2:2 + sz]
    out = edges[:, base:base + sz]
    s = strength.long()[:, None]
    for k, kern in enumerate(_EDGE_KERNELS, 1):
        acc = sum(vals[:, j:j + sz] * kern[j] for j in range(5) if kern[j])
        out = torch.where(s == k, torch.where(keep, passthru,
                                              (acc + 8) >> 4), out)
    return out


def _upsample_edges(edges, base, hsz, src_from, src_to, bd):
    """Batched ipred_tmpl.c:392-407; returns (n, 2 * hsz) int64."""
    dev = edges.device
    idx = torch.clamp(torch.arange(-1, hsz + 1, device=dev), src_from,
                      src_to - 1)
    vals = edges[:, base + idx]                          # (n, hsz + 2)
    nn = hsz - 1
    s = (-vals[:, 0:nn] + 9 * vals[:, 1:1 + nn] + 9 * vals[:, 2:2 + nn]
         - vals[:, 3:3 + nn] + 8) >> 4
    out = torch.zeros((edges.shape[0], hsz * 2), dtype=torch.int64,
                      device=dev)
    out[:, 0:2 * nn:2] = vals[:, 1:1 + nn]
    out[:, 1:2 * nn:2] = s.clamp(0, (1 << bd) - 1)
    out[:, nn * 2] = vals[:, 1 + nn]
    return out


def _take(arr, idx):
    """arr (n, L), idx (n, h, w) -> arr[k, idx[k]] (n, h, w)."""
    n, h, w = idx.shape
    return torch.gather(arr, 1, idx.reshape(n, h * w)).reshape(n, h, w)


def z1_plain(edges, dx, strength, w, h, bd, upsample):
    """Z1 (reference ipred_tmpl.c:409-461) over per-unit dx (doubled
    when upsampled) and strength (0: raw). Returns (n, h, w) int64."""
    dev = edges.device
    n = edges.shape[0]
    wmin = min(w, h)
    if upsample:
        top = _upsample_edges(edges, C + 1, w + h, -1, w + wmin, bd)
        L = 2 * (w + h)
        max_base = torch.full((n,), 2 * (w + h) - 2, dtype=torch.int64,
                              device=dev)
        base_inc = 2
    else:
        L = w + h
        raw = edges[:, C + 1 + torch.clamp(torch.arange(L, device=dev),
                                           max=w + wmin - 1)]
        filt = _filter_edges(edges, C + 1, w + h, -1, w + wmin, 0, w + h,
                             strength)
        on = (strength > 0)
        top = torch.where(on[:, None], filt, raw)
        max_base = torch.where(on, w + h - 1, w + wmin - 1).long()
        base_inc = 1
    xpos = dx.long()[:, None] * torch.arange(1, h + 1, device=dev)[None]
    frac = (xpos & 0x3E)[:, :, None]
    base = (xpos >> 6)[:, :, None] + \
        (torch.arange(w, device=dev) * base_inc)[None, None, :]
    mb = max_base[:, None, None]
    bc = torch.minimum(base, mb)
    v = _take(top, bc) * (64 - frac) + \
        _take(top, torch.clamp(bc + 1, max=L - 1)) * frac
    last = torch.gather(top, 1, max_base[:, None])[:, :, None]
    return torch.where(base < mb, (v + 32) >> 6, last)


def z3_plain(edges, dy, strength, w, h, bd, upsample):
    """Z3 (reference ipred_tmpl.c:529-581) over per-unit dy (doubled
    when upsampled) and strength. Returns (n, h, w) int64."""
    dev = edges.device
    n = edges.shape[0]
    wmin = min(w, h)
    base0 = C - (w + h)
    sfrom = max(w - h, 0)
    if upsample:
        arr = _upsample_edges(edges, base0, w + h, sfrom, w + h + 1, bd)
        L = 2 * (w + h)
        anchor = 2 * (w + h) - 2
        max_base = torch.full((n,), anchor, dtype=torch.int64, device=dev)
    else:
        L = w + h
        anchor = w + h - 1
        filt = _filter_edges(edges, base0, w + h, sfrom, w + h + 1, 0,
                             w + h, strength)
        on = (strength > 0)
        arr = torch.where(on[:, None], filt, edges[:, base0:base0 + L])
        max_base = torch.where(on, w + h - 1, h + wmin - 1).long()
    ypos = dy.long()[:, None] * torch.arange(1, w + 1, device=dev)[None]
    frac = (ypos & 0x3E)[:, None, :]
    base = (ypos >> 6)[:, None, :] + \
        (torch.arange(h, device=dev) * (1 + upsample))[None, :, None]
    mb = max_base[:, None, None]
    bc = torch.minimum(base, mb)
    v = _take(arr, torch.clamp(anchor - bc, 0, L - 1)) * (64 - frac) + \
        _take(arr, torch.clamp(anchor - bc - 1, 0, L - 1)) * frac
    last = torch.gather(arr, 1, torch.clamp(anchor - max_base, 0,
                                            L - 1)[:, None])[:, :, None]
    return torch.where(base < mb, (v + 32) >> 6, last)


def z2_plain(edges, dx, dy, str_t, str_l, max_w, max_h, w, h, bd,
             up_above, up_left):
    """Z2 (reference ipred_tmpl.c:463-527) over per-unit dx / dy
    (doubled for an upsampled edge), strengths and max_width /
    max_height. Returns (n, h, w) int64."""
    dev = edges.device
    n = edges.shape[0]
    C2, BL = 64, 129
    buf = torch.zeros((n, BL), dtype=torch.int64, device=dev)
    if up_above:
        up = _upsample_edges(edges, C, w + 1, 0, w + 1, bd)
        buf[:, C2:C2 + 2 * w + 1] = up[:, :2 * w + 1]
    else:
        top = _filter_edges(edges, C + 1, w, -1, w, 0, max_w, str_t)
        buf[:, C2 + 1:C2 + 1 + w] = top
    if up_left:
        up = _upsample_edges(edges, C - h, h + 1, 0, h + 1, bd)
        buf[:, C2 - 2 * h:C2 + 1] = up[:, :2 * h + 1]
    else:
        lf = _filter_edges(edges, C - h, h, 0, h + 1, h - max_h, h, str_l)
        buf[:, C2 - h:C2] = lf
    buf[:, C2] = edges[:, C]

    ys = torch.arange(h, device=dev)[None, :, None]
    xs = torch.arange(w, device=dev)[None, None, :]
    xpos = ((1 + up_above) << 6) - dx.long()[:, None, None] * (ys + 1)
    base_x = (xpos >> 6) + xs * (1 + up_above)
    frac_x = xpos & 0x3E
    ia = torch.clamp(C2 + base_x, 0, BL - 2)
    va = _take(buf, ia) * (64 - frac_x) + _take(buf, ia + 1) * frac_x
    ypos = (ys << (6 + up_left)) - dy.long()[:, None, None] * (xs + 1)
    base_y = ypos >> 6
    frac_y = ypos & 0x3E
    il = torch.clamp(C2 - (1 + up_left) - base_y, 1, BL - 1)
    vl = _take(buf, il) * (64 - frac_y) + _take(buf, il - 1) * frac_y
    return torch.where(base_x >= 0, (va + 32) >> 6, (vl + 32) >> 6)


def filter_plain(edges, taps, w, h, bd):
    """FILTER_PRED (reference ipred_tmpl.c:620-659): 4x2 sub-blocks in
    raster order, each an (8, 7) tap product over its 7 neighbours
    (left / top outputs of earlier sub-blocks). taps: (n, 8, 7).
    Returns (n, h, w) int64."""
    n = edges.shape[0]
    bd_max = (1 << bd) - 1
    taps = taps.long()
    out = torch.zeros((n, h, w), dtype=torch.int64, device=edges.device)
    for y in range(0, h, 2):
        for x in range(0, w, 4):
            if y == 0:
                top = edges[:, C + x:C + x + 5]
            else:
                p0 = out[:, y - 1, x - 1] if x else edges[:, C - y]
                top = torch.cat([p0[:, None], out[:, y - 1, x:x + 4]], 1)
            if x:
                left = out[:, y:y + 2, x - 1]
            else:
                left = edges[:, [C - (y + 1), C - (y + 2)]]
            ps = torch.cat([top, left], 1)                   # (n, 7)
            acc = ((taps * ps[:, None, :]).sum(2) + 8) >> 4
            out[:, y:y + 2, x:x + 4] = acc.clamp(0, bd_max).reshape(n, 2, 4)
    return out


def cfl_plain(y_plane, edges, jobs, cw, ch, ss_hor, ss_ver, bd):
    """Chroma from luma (reference ipred_tmpl.c:91-104, 661-720): the
    AC of the luma rect (summed, padded by replicating the summed values
    past nh / nw), minus its average, scaled by alpha, on the DC of the
    chroma edges. jobs (n, 6): ypy, ypx, nh, nw, alpha, dc mode.
    Returns (n, ch, cw) int64."""
    dev = edges.device
    half = (1 << bd) >> 1
    j = jobs.long()
    ypy, ypx, nh, nw, alpha, mode = (j[:, k] for k in range(6))
    bi = torch.minimum(torch.arange(ch, device=dev)[None], nh[:, None] - 1)
    bj = torch.minimum(torch.arange(cw, device=dev)[None], nw[:, None] - 1)
    rows = (ypy[:, None] + (bi << ss_ver))[:, :, None]
    cols = (ypx[:, None] + (bj << ss_hor))[:, None, :]
    yp = y_plane.long()
    ac = yp[rows, cols]
    if ss_hor:
        ac = ac + yp[rows, cols + 1]
    if ss_ver:
        ac = ac + yp[rows + 1, cols]
        if ss_hor:
            ac = ac + yp[rows + 1, cols + 1]
    ac = ac << (1 + (not ss_ver) + (not ss_hor))
    log2sz = (cw.bit_length() - 1) + (ch.bit_length() - 1)
    total = (ac.sum((1, 2)) + ((1 << log2sz) >> 1)) >> log2sz
    ac = ac - total[:, None, None]

    dc, dc_top, dc_left = _dc_values(edges[:, C + 1:C + 1 + cw],
                                     edges[:, C - ch:C], cw, ch, bd)
    dc = torch.where(mode == r.DC_128_PRED, half,
                     torch.where(mode == r.TOP_DC_PRED, dc_top,
                                 torch.where(mode == r.LEFT_DC_PRED,
                                             dc_left, dc)))
    diff = alpha[:, None, None] * ac
    v = (diff.abs() + 32) >> 6
    v = torch.where(diff < 0, -v, v)
    return torch.clamp(dc[:, None, None] + v, 0, (1 << bd) - 1)


def scatter_pred_plain(plane, pys, pxs, preds):
    """Write (n, h, w) predictions into `plane` at per-unit (py, px),
    in place; pixels past the plane's edge are dropped."""
    H, W = plane.shape
    n, h, w = preds.shape
    dev = plane.device
    rows = pys.long()[:, None] + torch.arange(h, device=dev)
    cols = pxs.long()[:, None] + torch.arange(w, device=dev)
    ok = (rows < H)[:, :, None] & (cols < W)[:, None, :]
    idx = (rows[:, :, None] * W + cols[:, None, :])[ok]
    plane.view(-1)[idx] = preds[ok].to(plane.dtype)
    return plane


def unit_class(units):
    """(n,) int64 class of each unit row: family, w, h and the
    upsample flags (FAM_Z1 / FAM_Z3: p2; FAM_Z2: p6, p7). A level's
    rows go to the kernel sorted by it, so that neighbouring blocks run
    the same branch."""
    u = np.asarray(units, np.int64)
    fam = u[:, 1]
    up = np.where((fam == FAM_Z1) | (fam == FAM_Z3), u[:, 10],
                  np.where(fam == FAM_Z2, u[:, 14] * 2 + u[:, 15], 0))
    return (((fam * 128 + u[:, 2]) * 128 + u[:, 3]) * 4 + up)


def level_plain(planes, units, idx, bd, ss_hor, ss_ver):
    """One level of leftover intra units predicted into `planes` (int32
    (H, W) tensors, in place), plain torch: the contract of the kernel.
    units (n, NCOL) int32, idx (m, 321) int32 (rows per unit column 7).
    Every edge and luma rect is read before any unit of the level
    writes."""
    if not len(units):
        return planes
    dev = planes[0].device
    u = units.long().cpu().numpy()
    half = (1 << bd) >> 1
    consts = torch.tensor([half + 1, half - 1, half, 0], dtype=torch.int64,
                          device=dev)
    flats = [torch.cat([p.reshape(-1).long(), consts]) for p in planes]
    taps = torch.from_numpy(filter_tap_matrices(
        tables.get("dav1d_filter_intra_taps"))).to(dev)
    idx_rows = idx[torch.from_numpy(u[:, 7]).to(dev)]
    tlf = torch.from_numpy(u[:, 6]).to(dev)
    preds = []
    cls = unit_class(u) * 4 + u[:, 0]
    for key in np.unique(cls):
        sel = np.flatnonzero(cls == key)
        pl, fam, w, h = (int(v) for v in u[sel[0], :4])
        s = torch.from_numpy(sel).to(dev)
        p = torch.from_numpy(u[sel, 8:]).to(dev)
        e = edge_gather_plain(flats[pl], idx_rows[s], tlf[s])
        if fam == FAM_S:
            pred = splat_family_plain(e, p[:, 0], w, h, bd)
        elif fam == FAM_F:
            pred = filter_plain(e, taps[p[:, 0]], w, h, bd)
        elif fam == FAM_Z1:
            pred = z1_plain(e, p[:, 0], p[:, 1], w, h, bd,
                            int(u[sel[0], 10]))
        elif fam == FAM_Z3:
            pred = z3_plain(e, p[:, 0], p[:, 1], w, h, bd,
                            int(u[sel[0], 10]))
        elif fam == FAM_Z2:
            pred = z2_plain(e, p[:, 0], p[:, 1], p[:, 2], p[:, 3], p[:, 4],
                            p[:, 5], w, h, bd, int(u[sel[0], 14]),
                            int(u[sel[0], 15]))
        elif fam == FAM_CFL:
            pred = cfl_plain(planes[0], e, p[:, :6], w, h, ss_hor, ss_ver,
                             bd)
        else:
            raise ValueError(f"unit family {fam}")
        preds.append((pl, s, pred))
    for pl, s, pred in preds:         # every unit read before any write
        scatter_pred_plain(planes[pl], torch.from_numpy(u[:, 4]).to(dev)[s],
                           torch.from_numpy(u[:, 5]).to(dev)[s], pred)
    return planes




def run_indices(runs, nflat):
    """(n, EDGE_LEN) int64 index rows of (n, NRUN) run rows: entry i <
    size of a run is start + stride * min(i, count - 1), the left runs
    laid down from C - 1 (the bottom-left after the left's size), the
    top runs up from C + 1 (the top-right after the top's size), the
    top-left source at C, every other entry nflat + 3 (the constant 0).
    nflat: (n,) or a scalar, the flat size of each unit's plane."""
    r = np.asarray(runs, np.int64).reshape(-1, NRUN)
    n = len(r)
    nflat = np.broadcast_to(np.asarray(nflat, np.int64), (n,))
    idx = np.repeat(nflat[:, None] + 3, EDGE_LEN, axis=1)
    i = np.arange(64)[None]
    rows = np.broadcast_to(np.arange(n)[:, None], (n, 64))
    for col, prev, sign in ((RUN_LEFT, None, -1), (RUN_BL, RUN_LEFT, -1),
                            (RUN_TOP, None, 1), (RUN_TR, RUN_TOP, 1)):
        start, stride, count, size = (r[:, col + j, None] for j in range(4))
        off = 0 if prev is None else r[:, prev + 3, None]
        src = start + stride * np.minimum(i, count - 1)
        pos = np.broadcast_to(C + sign * (1 + off + i), (n, 64))
        m = i < size
        idx[rows[m], pos[m]] = src[m]
    idx[:, C] = r[:, RUN_TL]
    return idx


# units a whole block of the frame kernel takes besides the 64-wide or
# 64-tall ones (a warp takes up to 32x32): those of at least this many
# pixels (tools/torch_ipred_variants.py times the choice)
BLOCK_AREA = 256


def block_units(units, area=BLOCK_AREA):
    """(n,) bool: the units (n, NCOL) that a whole block of the frame
    kernel takes, 64 wide or tall or of at least `area` pixels; a warp
    takes the others."""
    w, h = units[:, 2], units[:, 3]
    return (w == 64) | (h == 64) | (w * h >= area)


def pack_plan(levels):
    """A frame's leftover plan as the kernel's flat tables. levels: per
    level (units (n, NCOL), runs (n, NRUN), jobs (m, 6) ops/itx.py job
    rows, their planes (m,), is_wht (m,) bool). Returns {name: int32
    array} over PLAN_TABLES: "units" (each level's block_units first,
    each range sorted by unit_class; column 7 the unit's row of "runs",
    its own), "runs", "res" (each level's non-WHT jobs binned by
    itx.res_blocks per plane), "blocks" ((nb, BCOL): res_blocks' rows,
    `first` into "res", and the plane), "wht" ((nw, WCOL): the WHT jobs
    and their planes) and "levels" ((nl, NLEV): u0, ub, u1, b0, b1, w0,
    w1, the level's ranges of units (a block each [u0, ub), a warp each
    [ub, u1)), blocks and WHT jobs)."""
    out = {k: [] for k in PLAN_TABLES}
    nu = nr = nb = nw = 0
    for units, runs, jobs, plane, is_wht in levels:
        u = np.asarray(units, np.int64).reshape(-1, NCOL)
        ru = np.asarray(runs, np.int64).reshape(-1, NRUN)
        jobs = np.asarray(jobs, np.int64).reshape(-1, 6)
        plane = np.asarray(plane, np.int64).reshape(-1)
        is_wht = np.asarray(is_wht, bool).reshape(-1)
        big = block_units(u)
        order = np.lexsort((unit_class(u), ~big))
        u, ru = u[order], ru[order]
        u[:, 7] = nu + np.arange(len(u))
        out["units"].append(u)
        out["runs"].append(ru)
        b0 = nb
        for pl in np.unique(plane[~is_wht]):
            rows, blk = itx.res_blocks(jobs[(plane == pl) & ~is_wht])
            blk = np.concatenate([blk, np.full((len(blk), 1), pl)], axis=1)
            blk[:, 1] += nr
            out["res"].append(rows)
            out["blocks"].append(blk)
            nr += len(rows)
            nb += len(blk)
        w = np.concatenate([jobs[is_wht], plane[is_wht, None]], axis=1)
        out["wht"].append(w)
        out["levels"].append([[nu, nu + int(big.sum()), nu + len(u), b0,
                               nb, nw, nw + len(w)]])
        nu += len(u)
        nw += len(w)
    return {k: np.ascontiguousarray(np.concatenate(v) if v else np.zeros(
        (0, PLAN_TABLES[k])), np.int32).reshape(-1, PLAN_TABLES[k])
        for k, v in out.items()}


def plan_plain(planes, tables, pool, bd, ss_hor, ss_ver):
    """A frame's leftover plan (pack_plan's tables as tensors) into
    `planes` (int32 (H, W) tensors, in place), plain torch: the contract
    of the frame kernel. For each level in order: `level_plain` on its
    units with the edges expanded from their runs, then on each plane
    `itx.itx_add_plain` for the level's residual jobs and its WHT
    jobs. pool: the frame's int32 coefficient pool. Runs on the device
    of its tensors (chip_smoke.py holds the kernel to it on the card)."""
    levels = tables["levels"].long().tolist()
    units, res = tables["units"], tables["res"]
    runs = tables["runs"].cpu().numpy()
    blocks = tables["blocks"].long().cpu().numpy()
    wht = tables["wht"]
    nflat = np.array([p.numel() for p in planes], np.int64)
    for u0, _, u1, b0, b1, w0, w1 in levels:
        if u1 > u0:
            u = units[u0:u1].clone()
            u[:, 7] = torch.arange(u1 - u0, dtype=u.dtype)
            idx = run_indices(runs[u0:u1],
                              nflat[u[:, 0].long().cpu().numpy()])
            level_plain(planes, u, torch.from_numpy(idx).to(u.device), bd,
                        ss_hor, ss_ver)
        for pl, plane in enumerate(planes):
            mine = [res[f:f + c] for _, f, c, p in blocks[b0:b1] if p == pl]
            if mine:
                itx.itx_add_plain(pool, torch.cat(mine), plane, bd)
            w = wht[w0:w1]
            w = w[w[:, 6] == pl, :6]
            if len(w):
                itx.itx_add_plain(pool, w, plane, bd, wht=True)
    return planes


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from .cuda_build import load_library
        lib = load_library("ipred")
        lib.ipred_plan.restype = ct.c_int
        lib.ipred_plan.argtypes = (
            [ct.c_void_p] * 3 + [ct.c_int] * 6 + [ct.c_void_p] * 6 +
            [ct.c_int] + [ct.c_void_p] * 3 + [ct.c_int] * 3 +
            [ct.c_void_p, ct.POINTER(ct.c_int)])
        lib.ipred_occupancy.restype = ct.c_int
        lib.ipred_occupancy.argtypes = [ct.c_int, ct.POINTER(ct.c_int)]
        lay = (ct.c_int * 6)()
        lib.ipred_layout(lay)
        if tuple(lay) != (NCOL, NRUN, NLEV, BCOL, WCOL,
                          itx.BLOCK_THREADS):
            raise RuntimeError(f"ipred: table layout of the kernel "
                               f"{tuple(lay)} and of ops/ipred.py differ")
        _LIB = lib
    return _LIB


def occupancy(bd):
    """(blocks a SM, SMs, dynamic shared bytes of a block) of the frame
    kernel at `bd` on the current CUDA device."""
    out = (ct.c_int * 3)()
    rc = _lib().ipred_occupancy(bd, out)
    if rc != 0:
        raise RuntimeError(f"ipred occupancy query failed: CUDA error {rc}")
    return tuple(out)


def plan_cuda(planes, tables, pool, bd, ss_hor, ss_ver):
    """A frame's leftover plan with csrc/ipred.cu: same contract as
    plan_plain, CUDA tensors only (1 to 3 int32 planes, the tables and
    the pool on their device). One cooperative launch over every level,
    on the current stream, not synchronised; a failed launch, or a grid
    the card cannot hold at once, raises."""
    from .cuda_build import check_tensor
    from .device import device_tables
    if not planes or not planes[0].is_cuda:
        raise ValueError("plan_cuda needs CUDA tensors")
    dev = planes[0].device
    if bd not in (8, 10, 12):
        raise ValueError(f"bitdepth {bd}")
    if len(planes) > 3:
        raise ValueError(f"{len(planes)} planes")
    for i, p in enumerate(planes):
        check_tensor(p, f"planes[{i}]", torch.int32, dev)
    for k, width in PLAN_TABLES.items():
        t = tables[k]
        check_tensor(t, k, torch.int32, dev, (len(t), width))
    check_tensor(pool, "pool", torch.int32, dev, ndim=1)
    if len(tables["runs"]) != len(tables["units"]):
        raise ValueError("ipred: a run row per unit row")
    n_levels = len(tables["levels"])
    if not n_levels:
        return planes
    lut = device_tables(dev)
    check_tensor(lut["ipred_sm_weights"], "smooth weights", torch.int32, dev,
                 (128,))
    check_tensor(lut["ipred_filter_taps"], "filter taps", torch.int32, dev,
                 (5, 8, 7))
    ptrs = [p.data_ptr() for p in planes] + [0] * (3 - len(planes))
    dims = []
    for i in range(3):
        p = planes[i] if i < len(planes) else planes[0]
        dims += [p.shape[0], p.shape[1]]
    grid = ct.c_int(0)
    rc = _lib().ipred_plan(
        *ptrs, *dims, *(tables[k].data_ptr() for k in PLAN_TABLES),
        n_levels, pool.data_ptr(),
        lut["ipred_sm_weights"].data_ptr(),
        lut["ipred_filter_taps"].data_ptr(), bd, ss_hor, ss_ver,
        launch_stream(dev), ct.byref(grid))
    if rc != 0:
        per, sms, smem = occupancy(bd)
        raise RuntimeError(
            f"ipred frame kernel launch failed: CUDA error {rc} (grid "
            f"{grid.value} blocks of {itx.BLOCK_THREADS} threads, {per} "
            f"a SM on {sms} SMs, {smem} B dynamic shared; {n_levels} "
            f"levels, {len(tables['units'])} units)")
    count_launch(LAUNCHES, "ipred")
    return planes


def ipred_plan(planes, tables, pool, bd, ss_hor, ss_ver):
    """A frame's leftover plan into `planes`: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if planes[0].is_cuda:
        return plan_cuda(planes, tables, pool, bd, ss_hor, ss_ver)
    if planes[0].device.type != "cpu":
        raise ValueError(f"unsupported device {planes[0].device}")
    return plan_plain(planes, tables, pool, bd, ss_hor, ss_ver)
