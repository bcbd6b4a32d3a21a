"""Intra prediction of the device leftover levels (recon/ipred_device.py).

Port of dav1d_tpu's ops/ipred.py: the eight device programs that
predict a level of leftover intra units from per-unit EDGE BUFFERS —
(n, 321) arrays with the golden Edge layout (center C = 160,
buf[C + i] == topleft_out[i]) gathered from the current planes by
host-built index rows (an index >= the plane's flat size selects one of
the four constants half + 1, half - 1, half, 0). Every rounding rule is
ops/ipred_ref.py's (reference src/ipred_tmpl.c:44-720). Two
implementations:

- the plain versions, batched torch over units of one geometry:
  `edge_gather_plain`, `splat_family_plain` (DC variants, V, H, Paeth,
  smooth), `z1_plain`, `z2_plain`, `z3_plain`, `filter_plain`,
  `cfl_plain`, `scatter_pred_plain`, and `level_plain`, a whole level
  over every plane; used for CPU tensors only;
- the hand-written CUDA kernel csrc/ipred.cu (`level_cuda`): one launch
  a level over every plane's units, edges staged in shared memory, the
  prediction stored straight into the plane; used for every CUDA
  tensor (`ipred_level` dispatches).

A level's units (int32 rows of NCOL columns, one per transform unit):
  plane, family, w, h, py, px, tlf, row, p0 .. p7
`row` is the unit's index row in the level's (m, 321) int32 index
table; `tlf` asks for the Z2 top-left 5-6-5 filter. The parameters per
family:
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
The units of one level only read pixels that lower levels wrote
(the level scheduler's guarantee), so they run in any order.

What existed only to keep the TPU's compiled programs few is gone: no
batch-size ladder, no out-of-bounds padding lanes, no per-geometry
cache of jitted functions, no scatter program (the kernel stores).
"""
from __future__ import annotations

import ctypes as ct
from functools import lru_cache

import numpy as np
import torch

from .. import tables
from . import ipred_ref as r

C = 160                 # edge buffer center (matches ipred_ref.Edge)
EDGE_LEN = 2 * C + 1
NCOL = 16
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


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from .cuda_build import load_library
        lib = load_library("ipred")
        lib.ipred_level.restype = ct.c_int
        lib.ipred_level.argtypes = (
            [ct.c_void_p] * 3 + [ct.c_int] * 6 +
            [ct.c_void_p, ct.c_int, ct.c_void_p, ct.c_int, ct.c_void_p,
             ct.c_void_p, ct.c_int, ct.c_int, ct.c_int, ct.c_void_p])
        lib.ipred_ncol.restype = ct.c_int
        if lib.ipred_ncol() != NCOL:
            raise RuntimeError("ipred: unit columns of the kernel and of "
                               "ops/ipred.py differ")
        _LIB = lib
    return _LIB


def level_cuda(planes, units, idx, bd, ss_hor, ss_ver):
    """One level with csrc/ipred.cu: same contract as level_plain, CUDA
    tensors only (1 to 3 int32 planes, units (n, NCOL), idx (m, 321)).
    Launches on the current stream, does not synchronise."""
    from .cuda_build import check_tensor
    from .device import device_tables
    if not planes or not planes[0].is_cuda:
        raise ValueError("level_cuda needs CUDA tensors")
    dev = planes[0].device
    if bd not in (8, 10, 12):
        raise ValueError(f"bitdepth {bd}")
    if len(planes) > 3:
        raise ValueError(f"{len(planes)} planes")
    for i, p in enumerate(planes):
        check_tensor(p, f"planes[{i}]", torch.int32, dev)
    check_tensor(units, "units", torch.int32, dev, (len(units), NCOL))
    check_tensor(idx, "idx", torch.int32, dev, (len(idx), EDGE_LEN))
    if not len(units):
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
    rc = _lib().ipred_level(
        *ptrs, *dims, units.data_ptr(), len(units), idx.data_ptr(),
        len(idx), lut["ipred_sm_weights"].data_ptr(),
        lut["ipred_filter_taps"].data_ptr(), bd, ss_hor, ss_ver,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ipred kernel launch failed: CUDA error {rc}")
    LAUNCHES["ipred"] += 1
    return planes


def ipred_level(planes, units, idx, bd, ss_hor, ss_ver):
    """One level of leftover intra units into `planes`: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors."""
    if planes[0].is_cuda:
        return level_cuda(planes, units, idx, bd, ss_hor, ss_ver)
    if planes[0].device.type != "cpu":
        raise ValueError(f"unsupported device {planes[0].device}")
    return level_plain(planes, units, idx, bd, ss_hor, ss_ver)
