"""Intra frame reconstruction — the reference walk.

Consumes a FramePlan (Stage-A output) and reconstructs the picture with
behavioral parity to the reference's recon_b_intra walk
(reference src/recon_tmpl.c:1176-1556): per block, per 16x16-b4 band,
per tx block: edge preparation → prediction → inverse transform add;
CFL after luma; sbrow pre-filter edge snapshots (backup_ipred_edge,
reference recon_tmpl.c:2111-2136) for cross-superblock-row intra.

A copy of dav1d_tpu's recon/intra_ref.py: the golden walk that the
inter reconstructor (recon/inter_ref.py) extends, for intrabc frames
and the host replay of inter leftovers, and the fallback of intra
frames that the native engine (recon/intra.py) cannot serve.
"""
from __future__ import annotations

import numpy as np

from ..bitstream.headers import PixelLayout
from ..entropy import levels as lv
from ..entropy.decode import FramePlan
from ..entropy.intra_edge import (EDGE_I444_TOP_HAS_RIGHT,
                                  EDGE_I444_LEFT_HAS_BOTTOM,
                                  EDGE_I420_TOP_HAS_RIGHT,
                                  EDGE_I420_LEFT_HAS_BOTTOM)
from ..ops import ipred_ref, itx_ref
from .picture import Picture

SMOOTH_MODES = (lv.SMOOTH_PRED, lv.SMOOTH_V_PRED, lv.SMOOTH_H_PRED)


class IntraReconstructor:
    def __init__(self, plan: FramePlan):
        self.plan = plan
        self.f = plan.f
        f = self.f
        self.bitdepth = 8 + 2 * f.seq_hdr.hbd if f.seq_hdr.hbd < 2 else 12
        self.pic = Picture(f.frame_hdr.width[0], f.frame_hdr.height,
                           int(f.layout), self.bitdepth)
        # coef blocks indexed for consumption in decode order
        self.coef_iter = iter(plan.coefs)
        self.coef_by_pos = {}
        for cb in plan.coefs:
            self.coef_by_pos.setdefault((cb.plane, cb.x4, cb.y4), cb)
        # saved pre-filter rows per plane per sbrow (ipred_edge analog);
        # without in-loop filters these equal the plane rows, but we keep
        # the mechanism so filters can land without touching this walk.
        self.ipred_edge = [None, None, None]
        self.edge = ipred_ref.Edge()

    # ------------------------------------------------------------------
    def run(self) -> Picture:
        f = self.f
        fh = f.frame_hdr
        # group blocks by tile: plan.blocks are stored in global decode
        # order (tile after tile); replay per tile with its bounds
        tiles = []
        for tr in range(fh.tiling.rows):
            for tc in range(fh.tiling.cols):
                cs = fh.tiling.col_start_sb[tc] << f.sb_shift
                ce = min(fh.tiling.col_start_sb[tc + 1] << f.sb_shift, f.bw)
                rs = fh.tiling.row_start_sb[tr] << f.sb_shift
                re = min(fh.tiling.row_start_sb[tr + 1] << f.sb_shift, f.bh)
                tiles.append((cs, ce, rs, re))
        # assign blocks to tiles by position
        def tile_of(b):
            for i, (cs, ce, rs, re) in enumerate(tiles):
                if cs <= b.bx < ce and rs <= b.by < re:
                    return i
            raise AssertionError
        # blocks are interleaved across sb rows in tile order already;
        # recon is position-independent given neighbor pixels, so decode
        # order (the stored order) works: within a tile it is raster over
        # superblocks, and tiles are independent except pixels at tile
        # boundaries are NOT used (have_left/top clamp at tile edges).
        for b in self.plan.blocks:
            cs, ce, rs, re = tiles[tile_of(b)]
            self._quad_tl_restore(b)
            self._recon_block(b, cs, ce, rs, re)
            self._quad_tl_save(b)
        return self.pic

    # -- tl_4x4_filter bookkeeping around BL_8X8 4-way splits ----------
    # (reference decode.c:2191-2200: the bottom-right 4x4 of an 8x8
    # split sees the tl_4x4_filter state saved right after the
    # top-left 4x4, not the bottom-left's. BS_4x4 blocks only arise
    # from that split, so position parity identifies the quad corners.)
    def _quad_tl_restore(self, b):
        if b.bs == lv.BS_4x4 and (b.bx & 1) and (b.by & 1) and \
                hasattr(self, "tl_4x4_filter"):
            self.tl_4x4_filter = getattr(self, "_quad_tl_saved",
                                         self.tl_4x4_filter)

    def _quad_tl_save(self, b):
        if b.bs == lv.BS_4x4 and not (b.bx & 1) and not (b.by & 1) and \
                hasattr(self, "tl_4x4_filter"):
            self._quad_tl_saved = self.tl_4x4_filter

    # ------------------------------------------------------------------
    def _recon_block(self, b, col_start, col_end, row_start, row_end):
        f = self.f
        plan = self.plan
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
        bd = self.bitdepth
        y_plane = self.pic.planes[0]
        fh = f.frame_hdr

        # smooth-neighbor flags captured at parse time (Block.sm_fl)
        intra_edge_filter_flag = f.seq_hdr.intra_edge_filter << 10
        sm_fl = b.sm_fl | intra_edge_filter_flag

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
                        bx = b.bx + x
                        by = b.by + y
                        self._recon_tx_block(
                            b, bx, by, x, y, init_x, init_y, sub_w4, sub_h4,
                            sb_has_tr, sb_has_bl, t_dim, sm_fl,
                            col_start, col_end, row_start, row_end)
                        x += t_dim.w
                    y += t_dim.h

                if not b.has_chroma:
                    continue

                # CFL: ac + per-plane pred (only at init 0,0)
                if b.uv_mode == lv.CFL_PRED and init_x == 0 and init_y == 0:
                    self._recon_cfl(b, cw4, ch4, cbw4, cbh4, uv_t_dim,
                                    col_start, col_end, row_start, row_end)

                sub_cw4 = min(cw4, (init_x + 16) >> ss_hor)
                uv_sb_has_tr = (1 if ((init_x + 16) >> ss_hor) < cw4 else
                                0 if init_y else
                                b.edge_flags &
                                (EDGE_I420_TOP_HAS_RIGHT >> (int(f.layout) - 1)))
                uv_sb_has_bl = (0 if init_x else
                                1 if ((init_y + 16) >> ss_ver) < ch4 else
                                b.edge_flags &
                                (EDGE_I420_LEFT_HAS_BOTTOM >> (int(f.layout) - 1)))
                sm_uv_fl = b.sm_uv_fl
                for pl in range(2):
                    y = init_y >> ss_ver
                    while y < sub_ch4:
                        x = init_x >> ss_hor
                        while x < sub_cw4:
                            self._recon_uv_tx_block(
                                b, pl, x, y, init_x, init_y, sub_cw4, sub_ch4,
                                uv_sb_has_tr, uv_sb_has_bl, uv_t_dim,
                                sm_uv_fl, col_start, col_end,
                                row_start, row_end)
                            x += uv_t_dim.w
                        y += uv_t_dim.h

    # ------------------------------------------------------------------
    def _sm_uv_flags(self, b, col_start, row_start):
        plan = self.plan
        f = self.f
        fl = 0
        # above (cby4): uvmode of block above in chroma grid == b4 grid
        if b.by - 1 >= row_start:
            m = int(plan.b4_uvmode[b.by - 1, b.bx])
            if m in SMOOTH_MODES:
                fl |= ipred_ref.ANGLE_SMOOTH_EDGE_FLAG
        if b.bx - 1 >= col_start:
            m = int(plan.b4_uvmode[b.by, b.bx - 1])
            if m in SMOOTH_MODES:
                fl |= ipred_ref.ANGLE_SMOOTH_EDGE_FLAG
        return fl

    # ------------------------------------------------------------------
    def _recon_tx_block(self, b, bx, by, x, y, init_x, init_y, sub_w4, sub_h4,
                        sb_has_tr, sb_has_bl, t_dim, sm_fl,
                        col_start, col_end, row_start, row_end):
        f = self.f
        bd = self.bitdepth
        plane = self.pic.planes[0]
        px, py = bx * 4, by * 4
        if b.pal_sz[0]:
            # palette prediction (reference recon_tmpl.c:1242-1258)
            w_px, h_px = t_dim.w * 4, t_dim.h * 4
            ox, oy = (bx - b.bx) * 4, (by - b.by) * 4
            pred = b.pal[0][b.pal_idx_y[oy:oy + h_px, ox:ox + w_px]]
            plane[py:py + h_px, px:px + w_px] = pred.astype(plane.dtype)
            if not b.skip:
                cb = self.coef_by_pos.get((0, bx, by))
                if cb is not None and cb.eob >= 0:
                    itx_ref.add_residual(
                        plane[py:py + h_px, px:px + w_px], cb, bd)
            return
        edge_flags = (
            (0 if ((y > init_y or not sb_has_tr) and (x + t_dim.w >= sub_w4))
             else EDGE_I444_TOP_HAS_RIGHT) |
            (0 if (x > init_x or (not sb_has_bl and y + t_dim.h >= sub_h4))
             else EDGE_I444_LEFT_HAS_BOTTOM))
        angle = b.y_angle
        mode, angle = ipred_ref.prepare_intra_edges(
            bx, bx > col_start, by, by > row_start,
            col_end, row_end, edge_flags, plane, px, py,
            None, b.y_mode, angle, t_dim.w, t_dim.h,
            f.seq_hdr.intra_edge_filter, self.edge, bd)
        w_px, h_px = t_dim.w * 4, t_dim.h * 4
        if mode == ipred_ref.Z2_PRED:
            pred = ipred_ref.ipred_z2(self.edge, w_px, h_px,
                                      angle | sm_fl, bd,
                                      4 * f.bw - 4 * bx, 4 * f.bh - 4 * by)
        elif mode in (ipred_ref.Z1_PRED, ipred_ref.Z3_PRED):
            pred = ipred_ref.PREDICTORS[mode](self.edge, w_px, h_px,
                                              angle | sm_fl, bd)
        elif mode == ipred_ref.FILTER_PRED:
            pred = ipred_ref.ipred_filter(self.edge, w_px, h_px,
                                          angle | sm_fl, bd)
        else:
            pred = ipred_ref.PREDICTORS[mode](self.edge, w_px, h_px,
                                              angle | sm_fl, bd)
        plane[py:py + h_px, px:px + w_px] = pred.astype(plane.dtype)

        if not b.skip:
            cb = self.coef_by_pos.get((0, bx, by))
            if cb is not None and cb.eob >= 0:
                itx_ref.add_residual(plane[py:py + h_px, px:px + w_px],
                                     cb, bd)

    # ------------------------------------------------------------------
    def _recon_uv_tx_block(self, b, pl, x, y, init_x, init_y, sub_cw4,
                           sub_ch4, uv_sb_has_tr, uv_sb_has_bl, uv_t_dim,
                           sm_uv_fl, col_start, col_end, row_start, row_end):
        f = self.f
        bd = self.bitdepth
        ss_ver, ss_hor = f.ss_ver, f.ss_hor
        plane = self.pic.planes[1 + pl]
        cbx = (b.bx >> ss_hor) + x
        cby = (b.by >> ss_ver) + y
        px, py = cbx * 4, cby * 4
        if b.pal_sz[1]:
            w_px, h_px = uv_t_dim.w * 4, uv_t_dim.h * 4
            ox = (cbx - (b.bx >> ss_hor)) * 4
            oy = (cby - (b.by >> ss_ver)) * 4
            pred = b.pal[1 + pl][b.pal_idx_uv[oy:oy + h_px, ox:ox + w_px]]
            plane[py:py + h_px, px:px + w_px] = pred.astype(plane.dtype)
            if not b.skip:
                cb = self.coef_by_pos.get((1 + pl, cbx, cby))
                if cb is not None and cb.eob >= 0:
                    itx_ref.add_residual(
                        plane[py:py + h_px, px:px + w_px], cb, bd)
            return
        is_cfl = b.uv_mode == lv.CFL_PRED

        if not (is_cfl and b.cfl_alpha[pl]):
            edge_flags = (
                (0 if ((y > (init_y >> ss_ver) or not uv_sb_has_tr) and
                       (x + uv_t_dim.w >= sub_cw4))
                 else EDGE_I444_TOP_HAS_RIGHT) |
                (0 if (x > (init_x >> ss_hor) or
                       (not uv_sb_has_bl and y + uv_t_dim.h >= sub_ch4))
                 else EDGE_I444_LEFT_HAS_BOTTOM))
            uv_mode = lv.DC_PRED if is_cfl else b.uv_mode
            angle = b.uv_angle
            xstart = col_start >> ss_hor
            ystart = row_start >> ss_ver
            mode, angle = ipred_ref.prepare_intra_edges(
                cbx, cbx > xstart, cby, cby > ystart,
                col_end >> ss_hor, row_end >> ss_ver, edge_flags,
                plane, px, py, None, uv_mode, angle,
                uv_t_dim.w, uv_t_dim.h, f.seq_hdr.intra_edge_filter,
                self.edge, bd)
            w_px, h_px = uv_t_dim.w * 4, uv_t_dim.h * 4
            full_angle = angle | (f.seq_hdr.intra_edge_filter << 10) | sm_uv_fl
            if mode == ipred_ref.Z2_PRED:
                pred = ipred_ref.ipred_z2(
                    self.edge, w_px, h_px, full_angle, bd,
                    (4 * f.bw + ss_hor - 4 * (b.bx & ~ss_hor)) >> ss_hor,
                    (4 * f.bh + ss_ver - 4 * (b.by & ~ss_ver)) >> ss_ver)
            else:
                pred = ipred_ref.PREDICTORS[mode](self.edge, w_px, h_px,
                                                  full_angle, bd)
            plane[py:py + h_px, px:px + w_px] = pred.astype(plane.dtype)

        if not b.skip:
            cb = self.coef_by_pos.get((1 + pl, cbx, cby))
            if cb is not None and cb.eob >= 0:
                w_px, h_px = uv_t_dim.w * 4, uv_t_dim.h * 4
                itx_ref.add_residual(plane[py:py + h_px, px:px + w_px],
                                     cb, bd)

    # ------------------------------------------------------------------
    def _recon_cfl(self, b, cw4, ch4, cbw4, cbh4, uv_t_dim,
                   col_start, col_end, row_start, row_end):
        f = self.f
        bd = self.bitdepth
        ss_ver, ss_hor = f.ss_ver, f.ss_hor
        t_dim = lv.TXFM_INFO[b.tx]
        y_plane = self.pic.planes[0]
        ypx = 4 * (b.bx & ~ss_hor)
        ypy = 4 * (b.by & ~ss_ver)
        furthest_r = ((cw4 << ss_hor) + t_dim.w - 1) & ~(t_dim.w - 1)
        furthest_b = ((ch4 << ss_ver) + t_dim.h - 1) & ~(t_dim.h - 1)
        ac = ipred_ref.cfl_ac(y_plane, ypy, ypx, ss_hor, ss_ver,
                              cbw4 - (furthest_r >> ss_hor),
                              cbh4 - (furthest_b >> ss_ver),
                              cbw4 * 4, cbh4 * 4)
        for pl in range(2):
            if not b.cfl_alpha[pl]:
                continue
            plane = self.pic.planes[1 + pl]
            cbx = b.bx >> ss_hor
            cby = b.by >> ss_ver
            px, py = cbx * 4, cby * 4
            xstart = col_start >> ss_hor
            ystart = row_start >> ss_ver
            angle = 0
            mode, _ = ipred_ref.prepare_intra_edges(
                cbx, cbx > xstart, cby, cby > ystart,
                col_end >> ss_hor, row_end >> ss_ver, 0,
                plane, px, py, None, lv.DC_PRED, angle,
                uv_t_dim.w, uv_t_dim.h, 0, self.edge, bd)
            dc = ipred_ref.cfl_dc(mode, self.edge, uv_t_dim.w * 4,
                                  uv_t_dim.h * 4, bd)
            pred = ipred_ref.cfl_pred(dc, ac, b.cfl_alpha[pl],
                                      uv_t_dim.w * 4, uv_t_dim.h * 4, bd)
            plane[py:py + uv_t_dim.h * 4, px:px + uv_t_dim.w * 4] = \
                pred.astype(plane.dtype)
