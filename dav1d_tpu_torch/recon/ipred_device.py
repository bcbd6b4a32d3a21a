"""Intra leftovers on the device: dependency-levelized units, one
kernel launch a frame.

Port of dav1d_tpu's recon/ipred_device.py. Inter frames carry sparse
intra blocks ("leftovers") whose prediction reads the current picture.
The host replay (recon/inter_device.py) costs a mid-frame round trip:
the rows are fetched after the residual pass, replayed and uploaded
again. This module keeps those blocks on the device instead:

  1. `build`: per leftover transform unit, the exact reference
     edge-availability walk (reference src/ipred_prepare_tmpl.c:74-203)
     runs SYMBOLICALLY on the host (`edge_runs`): instead of copying
     pixels it emits the unit's edges as runs of plane-flat positions
     (ops/ipred.py's run rows: left, bottom-left, top, top-right, the
     top-left source; a position past the plane's end names one of 4
     constants for the no-neighbour fills). A level scheduler gives each
     unit 1 + the highest level of every pixel its edges read, on
     per-plane pixel maps, so that the units of a level only read pixels
     of lower levels. `Unservable`, `STATS`, `edge_indices` (dav1d_tpu's
     (321,) index rows, which tests hold `edge_runs` to),
     `DevLeftoverPlan`, `_Builder` and `build` are copies of
     dav1d_tpu's, identical but for the import paths and the runs in
     place of the index rows.
  2. `level_tables`: the frame's kernel tables, built on the host once
     a frame (ops/ipred.py `pack_plan`): every level's prediction units
     of every plane and family with their runs, and its residual rows
     with their ops/itx.py res_blocks tables (pool offsets bases[tile] +
     cf_local_off). They cross to the device in the frame's one upload
     (ops/mc_fused.py execute).
  3. `execute`: one ops/ipred.py `ipred_plan` call (csrc/ipred.cu, one
     cooperative launch) over every level: a level's predictions, then
     its residuals from the frame's coefficient pool on the device, then
     the next level. Predictions of a level go before its residuals, and
     residuals land before the next level reads, which reproduces the
     reference's sequential recon_b_intra order
     (src/recon_tmpl.c:1176-1556).

Frames whose leftovers need the host (a palette leftover: Unservable;
a leftover that is not pure intra, or interintra; no native tiles) take
the host replay in recon/inter_device.py, as in dav1d_tpu; so does every
frame under DAV1D_TPU_LO other than "auto" or "device", and under
"auto" a frame with more than AUTO_LIMIT leftovers (DAV1D_TPU_LO_LIMIT,
0 by default in the port: under auto every frame with leftovers takes
the host route, measured cheaper on the H100; DAV1D_TPU_LO=device
forces the route).
"""
from __future__ import annotations

import os

import numpy as np

from ..entropy import levels as lv
from ..entropy.intra_edge import (EDGE_I444_TOP_HAS_RIGHT,
                                  EDGE_I444_LEFT_HAS_BOTTOM,
                                  EDGE_I420_TOP_HAS_RIGHT,
                                  EDGE_I420_LEFT_HAS_BOTTOM)
from ..ops import ipred, ipred_ref, itx

C = ipred.C
FILTER_PRED = ipred_ref.FILTER_PRED


class Unservable(Exception):
    """A leftover block needs a tool with no device path yet."""


# observability: frames served on device / units batched / host fallbacks
STATS = {"frames": 0, "units": 0, "levels": 0, "fallbacks": 0}


def _deriv():
    from .. import tables
    return tables.get("dav1d_dr_intra_derivative")


# ---------------------------------------------------------------------------
# symbolic edge preparation
# ---------------------------------------------------------------------------

def edge_indices(x, have_left, y, have_top, w, h, edge_flags, W, px, py,
                 mode, angle, tw, th, filter_edge, base_const):
    """Symbolic twin of ipred_ref.prepare_intra_edges: same mode/angle
    remap and availability walk, but emits plane-flat indices (stride
    W; constants at base_const+0: half+1, +1: half-1, +2: half,
    +3: zero) instead of pixel values. Returns (mode, angle, idx, tlf)
    where tlf=1 requests the device-side Z2 5-6-5 topleft filter."""
    if ipred_ref.VERT_PRED <= mode <= lv.VERT_LEFT_PRED:
        angle = ipred_ref._MODE_TO_ANGLE[mode - ipred_ref.VERT_PRED] \
            + 3 * angle
        if angle <= 90:
            mode = ipred_ref.Z1_PRED if angle < 90 and have_top \
                else ipred_ref.VERT_PRED
        elif angle < 180:
            mode = ipred_ref.Z2_PRED
        else:
            mode = ipred_ref.Z3_PRED if angle > 180 and have_left \
                else ipred_ref.HOR_PRED
    elif mode == ipred_ref.DC_PRED:
        mode = (ipred_ref.DC_PRED if have_top else
                ipred_ref.LEFT_DC_PRED) if have_left else \
            (ipred_ref.TOP_DC_PRED if have_top else ipred_ref.DC_128_PRED)
    elif mode == ipred_ref.PAETH_PRED:
        mode = (ipred_ref.PAETH_PRED if have_top else
                ipred_ref.HOR_PRED) if have_left else \
            (ipred_ref.VERT_PRED if have_top else ipred_ref.DC_128_PRED)

    needs_left, needs_top, needs_topleft, needs_topright, \
        needs_bottomleft = ipred_ref._EDGE_REQ[mode]

    idx = np.full(ipred.EDGE_LEN, base_const + 3, np.int64)

    def top_i(i):
        return (py - 1) * W + px + i

    have_dst_top = have_top and (needs_top or needs_topleft or
                                 (needs_left and not have_left))

    if needs_left:
        sz = th << 2
        if have_left:
            px_have = min(sz, (h - y) << 2)
            idx[C - px_have:C] = \
                ((py + np.arange(px_have)) * W + px - 1)[::-1]
            if px_have < sz:
                idx[C - sz:C - px_have] = idx[C - px_have]
        else:
            idx[C - sz:C] = top_i(0) if have_dst_top else base_const + 0
        if needs_bottomleft:
            have_bl = 0 if (not have_left or y + th >= h) else \
                (edge_flags & EDGE_I444_LEFT_HAS_BOTTOM)
            if have_bl:
                px_have = min(sz, (h - y - th) << 2)
                idx[C - sz - px_have:C - sz] = \
                    ((py + sz + np.arange(px_have)) * W + px - 1)[::-1]
                if px_have < sz:
                    idx[C - 2 * sz:C - sz - px_have] = \
                        idx[C - sz - px_have]
            else:
                idx[C - 2 * sz:C - sz] = idx[C - sz]

    if needs_top:
        sz = tw << 2
        if have_top:
            px_have = min(sz, (w - x) << 2)
            idx[C + 1:C + 1 + px_have] = top_i(0) + np.arange(px_have)
            if px_have < sz:
                idx[C + 1 + px_have:C + 1 + sz] = idx[C + px_have]
        else:
            idx[C + 1:C + 1 + sz] = (py * W + px - 1) if have_left \
                else base_const + 1
        if needs_topright:
            have_tr = 0 if (not have_top or x + tw >= w) else \
                (edge_flags & EDGE_I444_TOP_HAS_RIGHT)
            if have_tr:
                px_have = min(sz, (w - x - tw) << 2)
                idx[C + 1 + sz:C + 1 + sz + px_have] = \
                    top_i(sz) + np.arange(px_have)
                if px_have < sz:
                    idx[C + 1 + sz + px_have:C + 1 + 2 * sz] = \
                        idx[C + sz + px_have]
            else:
                idx[C + 1 + sz:C + 1 + 2 * sz] = idx[C + sz]

    tlf = 0
    if needs_topleft:
        if have_left:
            idx[C] = top_i(-1) if have_top else py * W + px - 1
        else:
            idx[C] = top_i(0) if have_top else base_const + 2
        if mode == ipred_ref.Z2_PRED and tw + th >= 6 and filter_edge:
            tlf = 1

    return mode, angle, idx, tlf


def edge_runs(x, have_left, y, have_top, w, h, edge_flags, W, px, py,
              mode, angle, tw, th, filter_edge, base_const):
    """`edge_indices` with the same arguments and walk, emitting the
    edges as one run row (ops/ipred.py NRUN columns) instead of a (321,)
    index row: the left, bottom-left, top and top-right runs of (start,
    stride, count, size) -- entry i < size is start + stride * min(i,
    count - 1), the walk's pixels then its repeat of the last one -- and
    the top-left source. Constants are base_const + k as there; a run
    the mode does not need has size 0, an absent top-left the constant
    0. Returns (mode, angle, runs (a tuple), tlf);
    ops/ipred.py run_indices(runs) == edge_indices' row."""
    if ipred_ref.VERT_PRED <= mode <= lv.VERT_LEFT_PRED:
        angle = ipred_ref._MODE_TO_ANGLE[mode - ipred_ref.VERT_PRED] \
            + 3 * angle
        if angle <= 90:
            mode = ipred_ref.Z1_PRED if angle < 90 and have_top \
                else ipred_ref.VERT_PRED
        elif angle < 180:
            mode = ipred_ref.Z2_PRED
        else:
            mode = ipred_ref.Z3_PRED if angle > 180 and have_left \
                else ipred_ref.HOR_PRED
    elif mode == ipred_ref.DC_PRED:
        mode = (ipred_ref.DC_PRED if have_top else
                ipred_ref.LEFT_DC_PRED) if have_left else \
            (ipred_ref.TOP_DC_PRED if have_top else ipred_ref.DC_128_PRED)
    elif mode == ipred_ref.PAETH_PRED:
        mode = (ipred_ref.PAETH_PRED if have_top else
                ipred_ref.HOR_PRED) if have_left else \
            (ipred_ref.VERT_PRED if have_top else ipred_ref.DC_128_PRED)

    needs_left, needs_top, needs_topleft, needs_topright, \
        needs_bottomleft = ipred_ref._EDGE_REQ[mode]
    runs = [0] * 16 + [base_const + 3]
    top0 = (py - 1) * W + px
    have_dst_top = have_top and (needs_top or needs_topleft or
                                 (needs_left and not have_left))

    if needs_left:
        sz = th << 2
        if have_left:
            left = (py * W + px - 1, W, min(sz, (h - y) << 2), sz)
        else:
            left = (top0 if have_dst_top else base_const + 0, 0, 1, sz)
        runs[0:4] = left
        if needs_bottomleft:
            have_bl = 0 if (not have_left or y + th >= h) else \
                (edge_flags & EDGE_I444_LEFT_HAS_BOTTOM)
            if have_bl:
                runs[4:8] = ((py + sz) * W + px - 1, W,
                             min(sz, (h - y - th) << 2), sz)
            else:
                runs[4:8] = (left[0] + left[1] * (left[2] - 1), 0, 1, sz)

    if needs_top:
        sz = tw << 2
        if have_top:
            top = (top0, 1, min(sz, (w - x) << 2), sz)
        else:
            top = ((py * W + px - 1) if have_left else base_const + 1, 0, 1,
                   sz)
        runs[8:12] = top
        if needs_topright:
            have_tr = 0 if (not have_top or x + tw >= w) else \
                (edge_flags & EDGE_I444_TOP_HAS_RIGHT)
            if have_tr:
                runs[12:16] = (top0 + sz, 1, min(sz, (w - x - tw) << 2), sz)
            else:
                runs[12:16] = (top[0] + top[1] * (top[2] - 1), 0, 1, sz)

    tlf = 0
    if needs_topleft:
        if have_left:
            runs[16] = top0 - 1 if have_top else py * W + px - 1
        else:
            runs[16] = top0 if have_top else base_const + 2
        if mode == ipred_ref.Z2_PRED and tw + th >= 6 and filter_edge:
            tlf = 1

    return mode, angle, tuple(runs), tlf


# ---------------------------------------------------------------------------
# plan builder
# ---------------------------------------------------------------------------

class DevLeftoverPlan:
    __slots__ = ("levels", "n_units")

    def __init__(self, levels, n_units):
        self.levels = levels      # [ {groupkey: [job rows]} ] per level
        self.n_units = n_units


class _Builder:
    def __init__(self, recon):
        self.r = recon
        self.f = recon.f
        self.bd = recon.bitdepth
        self.planes = recon.pic.planes
        self.strides = [p.shape[1] for p in self.planes]
        self.nflat = [p.shape[0] * p.shape[1] for p in self.planes]
        self.lvl = [np.zeros(p.shape, np.int16) for p in self.planes]
        self.lvl_flat = [m.reshape(-1) for m in self.lvl]
        self.levels = []          # level -> {key: [rows]}
        self.n_units = 0
        self.deriv = _deriv()

    # -- level bookkeeping -------------------------------------------------
    def _read_level_runs(self, pl, runs):
        """The highest level of the pixels a unit's edge runs read (the
        pixels of dav1d_tpu's index row): each run's strip of lvl, the
        top-left source."""
        flat = self.lvl_flat[pl]
        nflat = self.nflat[pl]
        m = int(flat[runs[16]]) if runs[16] < nflat else 0
        for c in (0, 4, 8, 12):
            start, stride, count, size = runs[c:c + 4]
            if size and start < nflat:
                m = max(m, int(flat[start:start + stride * (count - 1) + 1:
                                    stride or 1].max()))
        return m

    def _read_level_rect(self, pl, py, px, h, w):
        m = self.lvl[pl][py:py + h, px:px + w]
        return int(m.max()) if m.size else 0

    def _emit(self, level, key, row):
        while len(self.levels) < level:
            self.levels.append({})
        self.levels[level - 1].setdefault(key, []).append(row)
        self.n_units += 1

    def _mark_write(self, pl, py, px, h, w, level):
        self.lvl[pl][py:py + h, px:px + w] = level

    def _mark_write_max(self, pl, py, px, h, w, level):
        m = self.lvl[pl][py:py + h, px:px + w]
        np.maximum(m, level, out=m)

    # -- per-unit emitters ---------------------------------------------------
    def _pred_unit(self, pl, px, py, w_px, h_px, mode, angle, flags,
                   runs, tlf, max_w, max_h):
        """Emit one prediction unit; returns its level."""
        rl = self._read_level_runs(pl, runs)
        L = rl + 1
        is_sm = (flags >> 9) & 1
        ief = (flags >> 10) & 1
        w, h = w_px, h_px
        if mode in (ipred_ref.Z1_PRED, ipred_ref.Z3_PRED,
                    ipred_ref.Z2_PRED):
            a = angle & 511
            if mode == ipred_ref.Z1_PRED:
                dx = int(self.deriv[a >> 1])
                up = ipred_ref._get_upsample(w + h, 90 - a, is_sm) \
                    if ief else 0
                st = 0 if up else (
                    ipred_ref._get_filter_strength(w + h, 90 - a, is_sm)
                    if ief else 0)
                key = (pl, "z1", w, h, up)
                row = (runs, tlf, dx << 1 if up else dx, st, py, px)
            elif mode == ipred_ref.Z3_PRED:
                dy = int(self.deriv[(270 - a) >> 1])
                up = ipred_ref._get_upsample(w + h, a - 180, is_sm) \
                    if ief else 0
                st = 0 if up else (
                    ipred_ref._get_filter_strength(w + h, a - 180, is_sm)
                    if ief else 0)
                key = (pl, "z3", w, h, up)
                row = (runs, tlf, dy << 1 if up else dy, st, py, px)
            else:
                dy = int(self.deriv[(a - 90) >> 1])
                dx = int(self.deriv[(180 - a) >> 1])
                ua = ipred_ref._get_upsample(w + h, a - 90, is_sm) \
                    if ief else 0
                ul = ipred_ref._get_upsample(w + h, 180 - a, is_sm) \
                    if ief else 0
                st = 0 if ua else (
                    ipred_ref._get_filter_strength(w + h, a - 90, is_sm)
                    if ief else 0)
                sl = 0 if ul else (
                    ipred_ref._get_filter_strength(w + h, 180 - a, is_sm)
                    if ief else 0)
                key = (pl, "z2", w, h, ua, ul)
                row = (runs, tlf, dx << 1 if ua else dx,
                       dy << 1 if ul else dy, st, sl, max_w, max_h,
                       py, px)
        elif mode == FILTER_PRED:
            key = (pl, "f", w, h)
            row = (runs, tlf, angle & 511, py, px)
        else:
            key = (pl, "s", w, h)
            row = (runs, tlf, mode, py, px)
        self._emit(L, key, row)
        self._mark_write(pl, py, px, h_px, w_px, L)
        return L

    def _res_unit(self, cb, level):
        t = cb._tile
        if t is None:
            raise Unservable()
        key = (cb.plane, "res", cb.tx, cb.txtp)
        loff = int(t["coefs"][cb._idx, 6])
        self._emit(level, key, (cb.y4 * 4, cb.x4 * 4,
                                t["tile_idx"], loff))
        # The residual is a WRITE at `level`: a later reader of this
        # rect must schedule strictly after it. The pred usually marks
        # the rect at the same level, but the CFL path can emit the
        # residual at max(U, V) pred level — above this plane's pred
        # mark — and a reader between the two levels would gather
        # pre-residual pixels (found via a V-plane DC unit reading a
        # CFL neighbor's pred-only top edge; 188-pixel mismatch vs the
        # reference on a tiles+masked-compound stream).
        td = lv.TXFM_INFO[cb.tx]
        self._mark_write_max(cb.plane, cb.y4 * 4, cb.x4 * 4,
                             td.h * 4, td.w * 4, level)

    # -- block walk (mirrors recon/intra_ref.py _recon_block) ---------------
    def add_block(self, b, bounds):
        if b.pal_sz[0] or b.pal_sz[1]:
            raise Unservable()   # palette leftovers replay on host
        f = self.f
        col_start, col_end, row_start, row_end = bounds
        ss_ver, ss_hor = f.ss_ver, f.ss_hor
        b_dim = lv.block_dimensions[b.bs]
        bw4, bh4 = int(b_dim[0]), int(b_dim[1])
        w4 = min(bw4, f.bw - b.bx)
        h4 = min(bh4, f.bh - b.by)
        cw4 = (w4 + ss_hor) >> ss_hor
        ch4 = (h4 + ss_ver) >> ss_ver
        cbw4 = (bw4 + ss_hor) >> ss_hor
        cbh4 = (bh4 + ss_ver) >> ss_ver
        t_dim = lv.TXFM_INFO[b.tx]
        uv_t_dim = lv.TXFM_INFO[b.uvtx]
        ief = f.seq_hdr.intra_edge_filter
        sm_fl = b.sm_fl | (ief << 10)
        cbmap = {}
        for cb in b._cbs:
            cbmap.setdefault((cb.plane, cb.x4, cb.y4), cb)

        for init_y in range(0, h4, 16):
            sub_h4 = min(h4, 16 + init_y)
            sub_ch4 = min(ch4, (init_y + 16) >> ss_ver)
            for init_x in range(0, w4, 16):
                sub_w4 = min(w4, init_x + 16)
                sb_has_tr = (1 if init_x + 16 < w4 else 0 if init_y else
                             b.edge_flags & EDGE_I444_TOP_HAS_RIGHT)
                sb_has_bl = (0 if init_x else 1 if init_y + 16 < h4 else
                             b.edge_flags & EDGE_I444_LEFT_HAS_BOTTOM)
                y = init_y
                while y < sub_h4:
                    x = init_x
                    while x < sub_w4:
                        self._luma_unit(
                            b, cbmap, b.bx + x, b.by + y, x, y, init_x,
                            init_y, sub_w4, sub_h4, sb_has_tr, sb_has_bl,
                            t_dim, sm_fl, col_start, col_end, row_start,
                            row_end)
                        x += t_dim.w
                    y += t_dim.h

                if not b.has_chroma:
                    continue

                cfl_level = 0
                if b.uv_mode == lv.CFL_PRED and init_x == 0 and \
                        init_y == 0:
                    cfl_level = self._cfl_units(
                        b, cw4, ch4, cbw4, cbh4, uv_t_dim, col_start,
                        col_end, row_start, row_end)

                sub_cw4 = min(cw4, (init_x + 16) >> ss_hor)
                uv_sb_has_tr = (
                    1 if ((init_x + 16) >> ss_hor) < cw4 else
                    0 if init_y else b.edge_flags &
                    (EDGE_I420_TOP_HAS_RIGHT >> (int(f.layout) - 1)))
                uv_sb_has_bl = (
                    0 if init_x else
                    1 if ((init_y + 16) >> ss_ver) < ch4 else
                    b.edge_flags &
                    (EDGE_I420_LEFT_HAS_BOTTOM >> (int(f.layout) - 1)))
                for pl in range(2):
                    y = init_y >> ss_ver
                    while y < sub_ch4:
                        x = init_x >> ss_hor
                        while x < sub_cw4:
                            self._uv_unit(
                                b, cbmap, pl, x, y, init_x, init_y,
                                sub_cw4, sub_ch4, uv_sb_has_tr,
                                uv_sb_has_bl, uv_t_dim, b.sm_uv_fl,
                                col_start, col_end, row_start, row_end,
                                cfl_level)
                            x += uv_t_dim.w
                        y += uv_t_dim.h

    def _luma_unit(self, b, cbmap, bx, by, x, y, init_x, init_y, sub_w4,
                   sub_h4, sb_has_tr, sb_has_bl, t_dim, sm_fl,
                   col_start, col_end, row_start, row_end):
        f = self.f
        px, py = bx * 4, by * 4
        edge_flags = (
            (0 if ((y > init_y or not sb_has_tr) and
                   (x + t_dim.w >= sub_w4))
             else EDGE_I444_TOP_HAS_RIGHT) |
            (0 if (x > init_x or (not sb_has_bl and y + t_dim.h >= sub_h4))
             else EDGE_I444_LEFT_HAS_BOTTOM))
        mode, angle, runs, tlf = edge_runs(
            bx, bx > col_start, by, by > row_start, col_end, row_end,
            edge_flags, self.strides[0], px, py, b.y_mode, b.y_angle,
            t_dim.w, t_dim.h, f.seq_hdr.intra_edge_filter, self.nflat[0])
        L = self._pred_unit(0, px, py, t_dim.w * 4, t_dim.h * 4, mode,
                            angle, sm_fl, runs, tlf,
                            4 * f.bw - 4 * bx, 4 * f.bh - 4 * by)
        if not b.skip:
            cb = cbmap.get((0, bx, by))
            if cb is not None and cb.eob >= 0:
                self._res_unit(cb, L)

    def _uv_unit(self, b, cbmap, pl, x, y, init_x, init_y, sub_cw4,
                 sub_ch4, uv_sb_has_tr, uv_sb_has_bl, uv_t_dim, sm_uv_fl,
                 col_start, col_end, row_start, row_end, cfl_level):
        f = self.f
        ss_ver, ss_hor = f.ss_ver, f.ss_hor
        cbx = (b.bx >> ss_hor) + x
        cby = (b.by >> ss_ver) + y
        px, py = cbx * 4, cby * 4
        is_cfl = b.uv_mode == lv.CFL_PRED
        L = cfl_level
        if not (is_cfl and b.cfl_alpha[pl]):
            edge_flags = (
                (0 if ((y > (init_y >> ss_ver) or not uv_sb_has_tr) and
                       (x + uv_t_dim.w >= sub_cw4))
                 else EDGE_I444_TOP_HAS_RIGHT) |
                (0 if (x > (init_x >> ss_hor) or
                       (not uv_sb_has_bl and y + uv_t_dim.h >= sub_ch4))
                 else EDGE_I444_LEFT_HAS_BOTTOM))
            uv_mode = lv.DC_PRED if is_cfl else b.uv_mode
            mode, angle, runs, tlf = edge_runs(
                cbx, cbx > (col_start >> ss_hor), cby,
                cby > (row_start >> ss_ver), col_end >> ss_hor,
                row_end >> ss_ver, edge_flags, self.strides[1 + pl],
                px, py, uv_mode, b.uv_angle, uv_t_dim.w, uv_t_dim.h,
                f.seq_hdr.intra_edge_filter, self.nflat[1 + pl])
            flags = (f.seq_hdr.intra_edge_filter << 10) | sm_uv_fl
            max_w = (4 * f.bw + ss_hor - 4 * (b.bx & ~ss_hor)) >> ss_hor
            max_h = (4 * f.bh + ss_ver - 4 * (b.by & ~ss_ver)) >> ss_ver
            L = self._pred_unit(1 + pl, px, py, uv_t_dim.w * 4,
                                uv_t_dim.h * 4, mode, angle, flags, runs,
                                tlf, max_w, max_h)
        if not b.skip:
            cb = cbmap.get((1 + pl, cbx, cby))
            if cb is not None and cb.eob >= 0:
                if L == 0:
                    # CFL rect: residual must follow the CFL pred
                    L = self._read_level_rect(1 + pl, py, px,
                                              uv_t_dim.h * 4,
                                              uv_t_dim.w * 4)
                    L = max(L, 1)
                self._res_unit(cb, L)

    def _cfl_units(self, b, cw4, ch4, cbw4, cbh4, uv_t_dim, col_start,
                   col_end, row_start, row_end):
        """CFL pred per chroma plane (golden _recon_cfl). Returns the
        max level used so following uv residuals order after it."""
        f = self.f
        ss_ver, ss_hor = f.ss_ver, f.ss_hor
        t_dim = lv.TXFM_INFO[b.tx]
        cw_px, ch_px = cbw4 * 4, cbh4 * 4
        if uv_t_dim.w * 4 != cw_px or uv_t_dim.h * 4 != ch_px:
            raise Unservable()   # CFL is single-tx by spec; be safe
        ypx = 4 * (b.bx & ~ss_hor)
        ypy = 4 * (b.by & ~ss_ver)
        furthest_r = ((cw4 << ss_hor) + t_dim.w - 1) & ~(t_dim.w - 1)
        furthest_b = ((ch4 << ss_ver) + t_dim.h - 1) & ~(t_dim.h - 1)
        w_pad = cbw4 - (furthest_r >> ss_hor)
        h_pad = cbh4 - (furthest_b >> ss_ver)
        nh, nw = ch_px - 4 * h_pad, cw_px - 4 * w_pad
        luma_rl = self._read_level_rect(0, ypy, ypx, nh << ss_ver,
                                        nw << ss_hor)
        out_level = 0
        for pl in range(2):
            if not b.cfl_alpha[pl]:
                continue
            cbx = b.bx >> ss_hor
            cby = b.by >> ss_ver
            px, py = cbx * 4, cby * 4
            mode, _, runs, _tlf = edge_runs(
                cbx, cbx > (col_start >> ss_hor), cby,
                cby > (row_start >> ss_ver), col_end >> ss_hor,
                row_end >> ss_ver, 0, self.strides[1 + pl], px, py,
                lv.DC_PRED, 0, uv_t_dim.w, uv_t_dim.h, 0,
                self.nflat[1 + pl])
            rl = max(self._read_level_runs(1 + pl, runs), luma_rl)
            L = rl + 1
            key = (1 + pl, "cfl", cw_px, ch_px, ss_hor, ss_ver)
            self._emit(L, key, (runs, ypy, ypx, nh, nw,
                                b.cfl_alpha[pl], mode, py, px))
            self._mark_write(1 + pl, py, px, ch_px, cw_px, L)
            out_level = max(out_level, L)
        return out_level

    def finish(self):
        return DevLeftoverPlan(self.levels, self.n_units)


# auto mode: frames with more leftover blocks than this replay on the
# host instead. dav1d_tpu's default is 1200, a TPU measurement. On the
# H100 the device route cost more than the host route on every frame
# measured, 5 to 3294 leftovers (PERF.md section 5: the host plan walk
# alone, ~4 ms a frame on s31, outweighs the ~2 ms round trip it saves),
# so the port's default serves no frame under auto; DAV1D_TPU_LO=device
# forces the route, DAV1D_TPU_LO_LIMIT moves the cut-over.
AUTO_LIMIT = int(os.environ.get("DAV1D_TPU_LO_LIMIT", "0"))


def build(recon, leftovers):
    """Build a device plan for the frame's leftover blocks, or None if
    any block needs the host replay (then inter_device falls back)."""
    mode = os.environ.get("DAV1D_TPU_LO", "auto")
    if mode not in ("device", "auto"):
        return None
    if mode == "auto" and len(leftovers) > AUTO_LIMIT:
        return None
    plan = recon.plan
    if not plan.native_tiles:
        return None
    from ..entropy import native_tile as nt
    tiles_rec = plan.native_tiles
    for gi, _tlf, tidx in leftovers:
        tr = tiles_rec[tidx]
        brow = tr["blocks"][gi - tr["block_base"]]
        if not brow[nt.BF_INTRA] or brow[nt.BF_INTERINTRA_TYPE]:
            return None
    try:
        bld = _Builder(recon)
        for gi, _tlf, tidx in leftovers:
            tr = tiles_rec[tidx]
            b = nt.materialize_block(plan, tr, gi - tr["block_base"])
            bounds = (tr["col_start"], tr["col_end"],
                      tr["row_start"], tr["row_end"])
            bld.add_block(b, bounds)
        out = bld.finish()
        STATS["frames"] += 1
        STATS["units"] += out.n_units
        STATS["levels"] += len(out.levels)
        return out
    except Unservable:
        STATS["fallbacks"] += 1
        return None


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------

def _pred_rows(key, rows):
    """A plan group's kernel unit rows (n, ipred.NCOL) and run rows (n,
    ipred.NRUN), int64."""
    pl, kind, w, h = key[:4]
    n = len(rows)
    u = np.zeros((n, ipred.NCOL), np.int64)
    u[:, 0], u[:, 1], u[:, 2], u[:, 3] = pl, ipred.FAMILIES[kind], w, h
    runs = np.asarray([r[0] for r in rows], np.int64)
    rest = np.asarray([r[1:] for r in rows], np.int64)
    if kind == "cfl":                     # ypy, ypx, nh, nw, alpha, mode
        u[:, 8:14] = rest[:, 0:6]
    else:
        u[:, 6] = rest[:, 0]              # tlf
        npar = rest.shape[1] - 3
        u[:, 8:8 + npar] = rest[:, 1:1 + npar]
        if kind in ("z1", "z3"):
            u[:, 10] = key[4]             # upsample
        elif kind == "z2":
            u[:, 14], u[:, 15] = key[4], key[5]
    u[:, 4], u[:, 5] = rest[:, -2], rest[:, -1]   # py, px
    return u, runs


def level_tables(dplan, bases, pool_len):
    """The frame's kernel tables, host side: {("lo", name): int32 array}
    over ops/ipred.py PLAN_TABLES (pack_plan: every level's units and
    runs, its residual job rows binned per plane with their block rows,
    its WHT jobs, the per-level offsets). bases: the pool offset of each
    tile; pool_len: the pool's length (a residual that reads past it
    raises)."""
    levels = []
    for groups in dplan.levels:
        units, runs, res = [], [], []
        for key, rows in groups.items():
            if key[1] == "res":
                # emitter RES layout: plane, tx, txtp, py, px, off, tile
                res += [(key[0], key[2], key[3], r[0], r[1], r[3], r[2])
                        for r in rows]
                continue
            u, ru = _pred_rows(key, rows)
            units.append(u)
            runs.append(ru)
        jobs, plane, is_wht = np.zeros((0, 6)), (), ()
        if res:
            res = np.asarray(res, np.int64)
            cfoff = bases[res[:, 6]] + res[:, 5]
            if int((cfoff + itx.CF_LEN[res[:, 1]]).max()) > pool_len:
                raise ValueError("leftover residual reads past the "
                                 "coefficient pool")
            jobs, is_wht = itx.job_rows(res, cfoff)
            plane = res[:, 0]
        levels.append((np.concatenate(units) if units else (),
                       np.concatenate(runs) if runs else (), jobs, plane,
                       is_wht))
    return {("lo", k): v for k, v in ipred.pack_plan(levels).items()}


def execute(recon):
    """Run the frame's leftover plan on its device planes
    (recon.pic.dev), in place, in one ops/ipred.py `ipred_plan` call:
    the plan's tables and the coefficient pool are the device views
    ops/mc_fused.py execute left on the reconstructor (recon.lo_views,
    recon.cf_pool_dev)."""
    f = recon.f
    tables = {k[1]: v for k, v in recon.lo_views.items()}
    ipred.ipred_plan(recon.pic.dev, tables, recon.cf_pool_dev,
                     recon.bitdepth, f.ss_hor, f.ss_ver)
