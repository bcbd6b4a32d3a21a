"""Inter-frame reconstruction (scalar/numpy golden path).

Behavioral parity with the reference's inter recon
(reference src/recon_tmpl.c:938-1168 mc/obmc/warp_affine and
1557-1985 dav1d_recon_b_inter): single-ref and compound prediction
(avg / weighted avg / wedge / segmentation masks), OBMC, warped and
global motion, interintra, sub-8x8 chroma handling, followed by the
inverse-transform residual adds. Intra blocks inside inter frames run
through the shared intra reconstructor.

A copy of dav1d_tpu's recon/inter_ref.py. The port runs it for intrabc
frames (reconstruct_inter_frame) and for the leftover blocks of inter
frames that the device passes leave to the host
(recon/inter_device.py); compute_jnt_weights also feeds the native job
emitter.
"""
from __future__ import annotations

import numpy as np

from ..bitstream.headers import WarpedMotionType
from ..bitstream.obu import get_poc_diff
from ..entropy import levels as lv
from ..ops import ipred_ref, itx_ref, mc_ref
from .intra_ref import IntraReconstructor

COMP_INTER_NONE = 0
COMP_INTER_WEIGHTED_AVG = 1
COMP_INTER_AVG = 2
COMP_INTER_SEG = 3
COMP_INTER_WEDGE = 4

MM_OBMC = 1
MM_WARP = 2

II_SMOOTH_PRED = 3
SMOOTH_PRED = 9

QUANT_DIST_WEIGHT = ((2, 3), (2, 5), (2, 7))
QUANT_DIST_LOOKUP = ((9, 7), (11, 5), (12, 4), (13, 3))


def compute_jnt_weights(f, refp):
    """reference decode.c:3085-3121."""
    ohb = f.seq_hdr.order_hint_n_bits
    poc = f.frame_hdr.frame_offset
    w = np.zeros((7, 7), np.int32)
    if not (f.seq_hdr.jnt_comp and f.frame_hdr.switchable_comp_refs and
            f.seq_hdr.order_hint) or refp[0] is None:
        return w
    for i in range(7):
        ref0poc = refp[i].poc
        for j in range(i + 1, 7):
            ref1poc = refp[j].poc
            d1 = min(abs(get_poc_diff(ohb, ref0poc, poc)), 31)
            d0 = min(abs(get_poc_diff(ohb, ref1poc, poc)), 31)
            order = int(d0 <= d1)
            for k in range(3):
                c0 = QUANT_DIST_WEIGHT[k][order]
                c1 = QUANT_DIST_WEIGHT[k][1 - order]
                d0_c0, d1_c1 = d0 * c0, d1 * c1
                if (d0 > d1 and d0_c0 < d1_c1) or \
                        (d0 <= d1 and d0_c0 > d1_c1):
                    break
            else:
                k = 3
            w[i][j] = QUANT_DIST_LOOKUP[k][order]
    return w


class InterReconstructor(IntraReconstructor):
    """Extends the intra reconstructor with the inter prediction path."""

    def __init__(self, plan, refp):
        super().__init__(plan)
        self.refp = refp                      # 7 RefSlot objects
        self.rf = plan.f.rf                   # RefMvsFrame (r grids)
        self.jnt_weights = compute_jnt_weights(plan.f, refp)
        self.tl_4x4_filter = 0

    # -- low-level helpers ---------------------------------------------
    def _ref_plane(self, refidx, pl):
        refpic = self.refp[refidx].pic
        if getattr(refpic, "host_stale", False):
            from ..ops.device import fetch_pic_host
            fetch_pic_host(refpic)
        return refpic.planes[pl]

    def _mc(self, put, bw4, bh4, bx, by, pl, mv, refidx, filter2d,
            self_ref=False):
        """reference recon_tmpl.c:938-1054 mc() (non-scaled path).
        put=True -> pixel block; False -> prep (int16 bias domain).
        self_ref: intra block copy (reads the current picture; bounds
        are the even-rounded coded area, recon_tmpl.c:960-967)."""
        f = self.f
        bd = self.bitdepth
        ss_ver = int(bool(pl)) and f.ss_ver
        ss_hor = int(bool(pl)) and f.ss_hor
        h_mul, v_mul = 4 >> ss_hor, 4 >> ss_ver
        mvy, mvx = mv
        if not self_ref and f.svc[refidx][0][0]:
            return self._mc_scaled(put, bw4, bh4, bx, by, pl, mv, refidx,
                                   filter2d, ss_hor, ss_ver)
        mx = mvx & (15 >> (1 - ss_hor))
        my = mvy & (15 >> (1 - ss_ver))
        if self_ref:
            ref = self.pic.planes[pl]
            w = (f.bw * 4) >> ss_hor
            h = (f.bh * 4) >> ss_ver
        else:
            ref = self._ref_plane(refidx, pl)
            w = (f.frame_hdr.width[0] + ss_hor) >> ss_hor
            h = (f.frame_hdr.height + ss_ver) >> ss_ver
        dx = bx * h_mul + (mvx >> (3 + ss_hor))
        dy = by * v_mul + (mvy >> (3 + ss_ver))
        bw_px, bh_px = bw4 * h_mul, bh4 * v_mul
        have_mx, have_my = int(mx != 0), int(my != 0)
        if (dx < have_mx * 3 or dy < have_my * 3 or
                dx + bw_px + have_mx * 4 > w or
                dy + bh_px + have_my * 4 > h):
            blk = mc_ref.emu_edge(bw_px + have_mx * 7, bh_px + have_my * 7,
                                  w, h, dx - have_mx * 3, dy - have_my * 3,
                                  ref)
            src, sy, sx = blk, have_my * 3, have_mx * 3
        else:
            src, sy, sx = ref, dy, dx
        ft = mc_ref.FILTER2D_TO_TYPE[filter2d]
        amx, amy = mx << (1 - ss_hor), my << (1 - ss_ver)
        if put:
            if ft < 0:
                return mc_ref.put_bilin(src, sy, sx, bw_px, bh_px, amx,
                                        amy, bd)
            return mc_ref.put_8tap(src, sy, sx, bw_px, bh_px, amx, amy,
                                   ft, bd)
        if ft < 0:
            return mc_ref.prep_bilin(src, sy, sx, bw_px, bh_px, amx, amy, bd)
        return mc_ref.prep_8tap(src, sy, sx, bw_px, bh_px, amx, amy, ft, bd)

    def _mc_scaled(self, put, bw4, bh4, bx, by, pl, mv, refidx, filter2d,
                   ss_hor, ss_ver):
        """Scaled-reference MC (reference recon_tmpl.c:995-1050 mc(),
        else-branch): positions walk the reference picture at svc
        scale/step granularity with 10-bit subpel phases."""
        f = self.f
        bd = self.bitdepth
        h_mul, v_mul = 4 >> ss_hor, 4 >> ss_ver
        mvy, mvx = mv
        (xscale, xstep), (yscale, ystep) = f.svc[refidx]
        orig_x = (bx * h_mul << 4) + mvx * (1 << (1 - ss_hor))
        orig_y = (by * v_mul << 4) + mvy * (1 << (1 - ss_ver))

        def scale_mv(val, scale):
            tmp = val * scale + (scale - 0x4000) * 8
            r = (abs(tmp) + 128) >> 8
            return (r if tmp >= 0 else -r) + 32

        pos_x = scale_mv(orig_x, xscale)
        pos_y = scale_mv(orig_y, yscale)
        bw_px, bh_px = bw4 * h_mul, bh4 * v_mul
        left, top = pos_x >> 10, pos_y >> 10
        right = ((pos_x + (bw_px - 1) * xstep) >> 10) + 1
        bottom = ((pos_y + (bh_px - 1) * ystep) >> 10) + 1
        slot = self.refp[refidx]
        w = (slot.frame_hdr.width[1] + ss_hor) >> ss_hor
        h = (slot.frame_hdr.height + ss_ver) >> ss_ver
        ref = self._ref_plane(refidx, pl)
        if left < 3 or top < 3 or right + 4 > w or bottom + 4 > h:
            src = mc_ref.emu_edge(right - left + 7, bottom - top + 7,
                                  w, h, left - 3, top - 3, ref)
            sy, sx = 3, 3
        else:
            src, sy, sx = ref, top, left
        ft = mc_ref.FILTER2D_TO_TYPE[filter2d]
        if ft < 0:
            fn = mc_ref.put_bilin_scaled if put else mc_ref.prep_bilin_scaled
            return fn(src, sy, sx, bw_px, bh_px, pos_x & 0x3ff,
                      pos_y & 0x3ff, xstep, ystep, bd)
        fn = mc_ref.put_8tap_scaled if put else mc_ref.prep_8tap_scaled
        return fn(src, sy, sx, bw_px, bh_px, pos_x & 0x3ff, pos_y & 0x3ff,
                  xstep, ystep, ft, bd)

    def _warp_affine(self, put, b_dim, pl, refidx, wmp):
        """reference recon_tmpl.c:1115-1168 warp_affine()."""
        f = self.f
        bd = self.bitdepth
        ss_ver = int(bool(pl)) and f.ss_ver
        ss_hor = int(bool(pl)) and f.ss_hor
        h_mul, v_mul = 4 >> ss_hor, 4 >> ss_ver
        mat = wmp.matrix
        abcd = (wmp.alpha, wmp.beta, wmp.gamma, wmp.delta)
        ref = self._ref_plane(refidx, pl)
        width = (f.frame_hdr.width[0] + ss_hor) >> ss_hor
        height = (f.frame_hdr.height + ss_ver) >> ss_ver
        bw_px = int(b_dim[0]) * h_mul
        bh_px = int(b_dim[1]) * v_mul
        out = np.zeros((bh_px, bw_px), np.int32)
        for y in range(0, bh_px, 8):
            src_y = self.cur_by * 4 + ((y + 4) << ss_ver)
            mat3_y = mat[3] * src_y + mat[0]
            mat5_y = mat[5] * src_y + mat[1]
            for x in range(0, bw_px, 8):
                src_x = self.cur_bx * 4 + ((x + 4) << ss_hor)
                mvx = (mat[2] * src_x + mat3_y) >> ss_hor
                mvy = (mat[4] * src_x + mat5_y) >> ss_ver
                dx = (mvx >> 16) - 4
                mx = ((mvx & 0xffff) - wmp.alpha * 4 - wmp.beta * 7) \
                    & ~0x3f
                dy = (mvy >> 16) - 4
                my = ((mvy & 0xffff) - wmp.gamma * 4 - wmp.delta * 4) \
                    & ~0x3f
                if dx < 3 or dx + 12 > width or dy < 3 or dy + 12 > height:
                    src = mc_ref.emu_edge(15, 15, width, height, dx - 3,
                                          dy - 3, ref)
                    sy, sx = 3, 3
                else:
                    src, sy, sx = ref, dy, dx
                if put:
                    out[y:y + 8, x:x + 8] = mc_ref.warp_affine_8x8(
                        src, sy, sx, abcd, mx, my, bd)
                else:
                    out[y:y + 8, x:x + 8] = mc_ref.warp_affine_8x8t(
                        src, sy, sx, abcd, mx, my, bd)
        return out

    def _obmc(self, plane_idx, dst_py, dst_px, b_dim, pl, w4, h4,
              row_start, col_start):
        """reference recon_tmpl.c:1052-1113 obmc(); laps land at
        (dst_py, dst_px) of plane plane_idx via the executor leaves."""
        f = self.f
        rf = self.rf
        bx, by = self.cur_bx, self.cur_by
        ss_ver = int(bool(pl)) and f.ss_ver
        ss_hor = int(bool(pl)) and f.ss_hor
        h_mul, v_mul = 4 >> ss_hor, 4 >> ss_ver
        filt = self.plan.b4_filter
        if by > row_start and (not pl or
                               int(b_dim[0]) * h_mul +
                               int(b_dim[1]) * v_mul >= 16):
            i = x = 0
            while x < w4 and i < min(int(b_dim[2]), 4):
                ar_ref = int(rf.r_ref[by - 1, bx + x + 1, 0])
                a_bs = int(rf.r_bs[by - 1, bx + x + 1])
                step4 = min(max(int(lv.block_dimensions[a_bs][0]), 2), 16)
                if ar_ref > 0:
                    ow4 = min(step4, int(b_dim[0]))
                    oh4 = min(int(b_dim[1]), 16) >> 1
                    mv = (int(rf.r_mv[by - 1, bx + x + 1, 0, 0]),
                          int(rf.r_mv[by - 1, bx + x + 1, 0, 1]))
                    f2d = int(lv.filter_2d[filt[1, by - 1, bx + x + 1]]
                              [filt[0, by - 1, bx + x + 1]])
                    self._obmc_lap_top(plane_idx, dst_py, dst_px,
                                       x * h_mul, ow4, oh4, bx + x, by,
                                       pl, mv, ar_ref - 1, f2d, h_mul,
                                       v_mul)
                    i += 1
                x += step4
        if bx > col_start:
            i = y = 0
            while y < h4 and i < min(int(b_dim[3]), 4):
                lr_ref = int(rf.r_ref[by + y + 1, bx - 1, 0])
                l_bs = int(rf.r_bs[by + y + 1, bx - 1])
                step4 = min(max(int(lv.block_dimensions[l_bs][1]), 2), 16)
                if lr_ref > 0:
                    ow4 = min(int(b_dim[0]), 16) >> 1
                    oh4 = min(step4, int(b_dim[1]))
                    mv = (int(rf.r_mv[by + y + 1, bx - 1, 0, 0]),
                          int(rf.r_mv[by + y + 1, bx - 1, 0, 1]))
                    f2d = int(lv.filter_2d[filt[1, by + y + 1, bx - 1]]
                              [filt[0, by + y + 1, bx - 1]])
                    self._obmc_lap_left(plane_idx, dst_py, dst_px,
                                        y * v_mul, ow4, oh4, bx, by + y,
                                        pl, mv, lr_ref - 1, f2d, h_mul,
                                        v_mul)
                    i += 1
                y += step4
        return None

    def _interintra_pred(self, pl, plane, px, py, w4, h4, mode,
                         col_start, col_end, row_start, row_end,
                         pos4_x, pos4_y):
        """Intra part of interintra: prepare edges from the current
        (inter-predicted) plane and run the predictor into a tmp."""
        f = self.f
        bd = self.bitdepth
        m = SMOOTH_PRED if mode == II_SMOOTH_PRED else mode
        angle = 0
        m, angle = ipred_ref.prepare_intra_edges(
            pos4_x, pos4_x > col_start, pos4_y, pos4_y > row_start,
            col_end, row_end, 0, plane, px, py, None, m, angle,
            w4, h4, f.seq_hdr.intra_edge_filter, self.edge, bd)
        sm_fl = f.seq_hdr.intra_edge_filter << 10
        w_px, h_px = w4 * 4, h4 * 4
        if m == ipred_ref.Z2_PRED:
            pred = ipred_ref.ipred_z2(self.edge, w_px, h_px, angle | sm_fl,
                                      bd, 4 * f.bw - 4 * pos4_x,
                                      4 * f.bh - 4 * pos4_y)
        elif m == ipred_ref.FILTER_PRED:
            pred = ipred_ref.ipred_filter(self.edge, w_px, h_px,
                                          angle | sm_fl, bd)
        else:
            pred = ipred_ref.PREDICTORS[m](self.edge, w_px, h_px,
                                           angle | sm_fl, bd)
        return pred

    # -- executor leaves (overridden by the device batch collector) -----
    def _put_mc(self, plane_idx, py, px, bw4, bh4, bx, by, pl, mv,
                refidx, filter2d):
        """pred = mc(); plane[py:, px:] = pred (golden eager leaf)."""
        plane = self.pic.planes[plane_idx]
        pred = self._mc(True, bw4, bh4, bx, by, pl, mv, refidx, filter2d)
        ph, pw = pred.shape
        plane[py:py + ph, px:px + pw] = pred.astype(plane.dtype)

    def _put_warp(self, plane_idx, py, px, b_dim, pl, refidx, wmp):
        plane = self.pic.planes[plane_idx]
        pred = self._warp_affine(True, b_dim, pl, refidx, wmp)
        ph, pw = pred.shape
        plane[py:py + ph, px:px + pw] = pred.astype(plane.dtype)

    def _obmc_lap_top(self, plane_idx, py, px, x_off, ow4, oh4, bx, by,
                      pl, mv, refidx, f2d, h_mul, v_mul):
        """Top-neighbour OBMC lap: mc + blend_h into the dst region."""
        plane = self.pic.planes[plane_idx]
        lap = self._mc(True, ow4, (oh4 * 3 + 3) >> 2, bx, by, pl, mv,
                       refidx, f2d)
        hh = v_mul * oh4
        ww = h_mul * ow4
        sub = plane[py:py + hh, px + x_off:px + x_off + ww]
        sub[:] = mc_ref.blend_h(sub.astype(np.int32), lap, ww,
                                hh).astype(sub.dtype)

    def _obmc_lap_left(self, plane_idx, py, px, y_off, ow4, oh4, bx, by,
                       pl, mv, refidx, f2d, h_mul, v_mul):
        plane = self.pic.planes[plane_idx]
        lap = self._mc(True, ow4, oh4, bx, by, pl, mv, refidx, f2d)
        hh = v_mul * oh4
        ww = h_mul * ow4
        sub = plane[py + y_off:py + y_off + hh, px:px + ww]
        sub[:] = mc_ref.blend_v(sub.astype(np.int32), lap, ww,
                                hh).astype(sub.dtype)

    def _exec_compound(self, plane_idx, py, px, descs, comp_type, jw,
                       sign, msk, ss_hor, ss_ver):
        """descs: two ('mc'|'warp', args) prep sources; comp_type
        selects the combine; msk is the wedge/seg mask for MASK mode.
        Returns the seg mask when comp_type == SEG (luma call)."""
        bd = self.bitdepth
        plane = self.pic.planes[plane_idx]
        tmp = [None, None]
        for i, (kind, args) in enumerate(descs):
            if kind == "warp":
                tmp[i] = self._warp_affine(False, *args)
            else:
                tmp[i] = self._mc(False, *args)
        seg_mask = None
        if comp_type == COMP_INTER_AVG:
            dst = mc_ref.avg(tmp[0], tmp[1], bd)
        elif comp_type == COMP_INTER_WEIGHTED_AVG:
            dst = mc_ref.w_avg(tmp[0], tmp[1], jw, bd)
        elif comp_type == COMP_INTER_SEG:
            dst, seg_mask = mc_ref.w_mask(tmp[sign], tmp[1 - sign],
                                          sign, ss_hor, ss_ver, bd)
        else:   # WEDGE or chroma mask apply
            dst = mc_ref.mask(tmp[sign], tmp[1 - sign], msk, bd)
        ph, pw = dst.shape
        plane[py:py + ph, px:px + pw] = dst.astype(plane.dtype)
        return seg_mask

    def _add_residuals(self, b):
        plan = self.plan
        bd = self.bitdepth
        for cb in plan.coefs[b.coef_start:b.coef_end]:
            if cb.eob < 0:
                continue
            t_dim = lv.TXFM_INFO[cb.tx]
            plane = self.pic.planes[cb.plane]
            ppx, ppy = cb.x4 * 4, cb.y4 * 4
            itx_ref.add_residual(
                plane[ppy:ppy + t_dim.h * 4, ppx:ppx + t_dim.w * 4],
                cb, bd)

    # -- main block recon ----------------------------------------------
    def _recon_block(self, b, col_start, col_end, row_start, row_end):
        if b.intra:
            super()._recon_block(b, col_start, col_end, row_start,
                                 row_end)
            return
        self._recon_b_inter(b, col_start, col_end, row_start, row_end)

    def _recon_b_inter(self, b, col_start, col_end, row_start, row_end):
        f = self.f
        fh = f.frame_hdr
        bd = self.bitdepth
        plan = self.plan
        ss_ver, ss_hor = f.ss_ver, f.ss_hor
        b_dim = lv.block_dimensions[b.bs]
        bw4, bh4 = int(b_dim[0]), int(b_dim[1])
        w4 = min(bw4, f.bw - b.bx)
        h4 = min(bh4, f.bh - b.by)
        cbw4 = (bw4 + ss_hor) >> ss_hor
        cbh4 = (bh4 + ss_ver) >> ss_ver
        has_chroma = b.has_chroma
        chr_layout_idx = (0 if f.layout == 0 else 3 - int(f.layout))
        self.cur_bx, self.cur_by = b.bx, b.by
        y_plane = self.pic.planes[0]
        px, py = b.bx * 4, b.by * 4

        if f.key_or_intra:
            # intra block copy (reference recon_tmpl.c:1583-1596)
            FILTER_2D_BILINEAR = 9
            pred = self._mc(True, bw4, bh4, b.bx, b.by, 0, b.mv[0], 0,
                            FILTER_2D_BILINEAR, self_ref=True)
            y_plane[py:py + bh4 * 4, px:px + bw4 * 4] = \
                pred.astype(y_plane.dtype)
            if has_chroma:
                for pl in range(2):
                    plane = self.pic.planes[1 + pl]
                    mbw4 = bw4 << int(bw4 == ss_hor)
                    mbh4 = bh4 << int(bh4 == ss_ver)
                    pred = self._mc(True, mbw4, mbh4, b.bx & ~ss_hor,
                                    b.by & ~ss_ver, 1 + pl, b.mv[0], 0,
                                    FILTER_2D_BILINEAR, self_ref=True)
                    uv_px = (b.bx >> ss_hor) * 4
                    uv_py = (b.by >> ss_ver) * 4
                    ph, pw = pred.shape
                    plane[uv_py:uv_py + ph, uv_px:uv_px + pw] = \
                        pred.astype(plane.dtype)
        elif b.comp_type == COMP_INTER_NONE:
            filter2d = b.filter2d
            if (min(bw4, bh4) > 1 and
                ((b.inter_mode == lv.GLOBALMV and
                  f.gmv_warp_allowed[b.ref[0]]) or
                 (b.motion_mode == MM_WARP and
                  b.warpmv is not None and
                  b.warpmv.type > WarpedMotionType.TRANSLATION))):
                wmp = b.warpmv if b.motion_mode == MM_WARP \
                    else fh.gmv[b.ref[0]]
                self._put_warp(0, py, px, b_dim, 0, b.ref[0], wmp)
            else:
                self._put_mc(0, py, px, bw4, bh4, b.bx, b.by, 0, b.mv[0],
                             b.ref[0], filter2d)
                if b.motion_mode == MM_OBMC:
                    self._obmc(0, py, px, b_dim, 0, w4, h4, row_start,
                               col_start)
            if b.interintra_type:
                ii = mc_ref.ii_mask(0, b.bs, b.interintra_type,
                                    b.interintra_mode, b.wedge_idx,
                                    bw4 * 4, bh4 * 4)
                ipred = self._interintra_pred(
                    0, y_plane, px, py, bw4, bh4, b.interintra_mode,
                    col_start, col_end, row_start, row_end, b.bx, b.by)
                dst = y_plane[py:py + bh4 * 4, px:px + bw4 * 4]
                dst[:] = mc_ref.blend(dst.astype(np.int32), ipred,
                                      ii).astype(dst.dtype)

            if has_chroma:
                self._chroma_single(b, b_dim, bw4, bh4, cbw4, cbh4,
                                    filter2d, chr_layout_idx, col_start,
                                    col_end, row_start, row_end)
            self.tl_4x4_filter = filter2d
        else:
            self._compound(b, b_dim, bw4, bh4, cbw4, cbh4, has_chroma,
                           chr_layout_idx)

        # residual adds from the recorded coef range
        if not b.skip:
            self._add_residuals(b)

    # -- chroma for single-ref blocks ----------------------------------
    def _chroma_single(self, b, b_dim, bw4, bh4, cbw4, cbh4, filter2d,
                       chr_layout_idx, col_start, col_end, row_start,
                       row_end):
        f = self.f
        fh = f.frame_hdr
        rf = self.rf
        ss_ver, ss_hor = f.ss_ver, f.ss_hor
        filt = self.plan.b4_filter
        uv_px = (b.bx >> ss_hor) * 4
        uv_py = (b.by >> ss_ver) * 4

        is_sub8x8 = bw4 == ss_hor or bh4 == ss_ver
        if is_sub8x8:
            if bw4 == 1:
                is_sub8x8 &= int(rf.r_ref[b.by, b.bx - 1, 0]) > 0
            if bh4 == ss_ver:
                is_sub8x8 &= int(rf.r_ref[b.by - 1, b.bx, 0]) > 0
            if bw4 == 1 and bh4 == ss_ver:
                is_sub8x8 &= int(rf.r_ref[b.by - 1, b.bx - 1, 0]) > 0

        if is_sub8x8:
            h_off = v_off = 0
            if bw4 == 1 and bh4 == ss_ver:
                for pl in range(2):
                    mv = (int(rf.r_mv[b.by - 1, b.bx - 1, 0, 0]),
                          int(rf.r_mv[b.by - 1, b.bx - 1, 0, 1]))
                    refidx = int(rf.r_ref[b.by - 1, b.bx - 1, 0]) - 1
                    self._put_mc(1 + pl, uv_py, uv_px, bw4, bh4,
                                 b.bx - 1, b.by - 1, 1 + pl, mv, refidx,
                                 self.tl_4x4_filter)
                v_off = 2
                h_off = 2
            if bw4 == 1:
                left_f2d = int(lv.filter_2d[filt[1, b.by, b.bx - 1]]
                               [filt[0, b.by, b.bx - 1]])
                for pl in range(2):
                    mv = (int(rf.r_mv[b.by, b.bx - 1, 0, 0]),
                          int(rf.r_mv[b.by, b.bx - 1, 0, 1]))
                    refidx = int(rf.r_ref[b.by, b.bx - 1, 0]) - 1
                    self._put_mc(1 + pl, uv_py + v_off, uv_px, bw4, bh4,
                                 b.bx - 1, b.by, 1 + pl, mv, refidx,
                                 left_f2d)
                h_off = 2
            if bh4 == ss_ver:
                top_f2d = int(lv.filter_2d[filt[1, b.by - 1, b.bx]]
                              [filt[0, b.by - 1, b.bx]])
                for pl in range(2):
                    mv = (int(rf.r_mv[b.by - 1, b.bx, 0, 0]),
                          int(rf.r_mv[b.by - 1, b.bx, 0, 1]))
                    refidx = int(rf.r_ref[b.by - 1, b.bx, 0]) - 1
                    self._put_mc(1 + pl, uv_py, uv_px + h_off, bw4, bh4,
                                 b.bx, b.by - 1, 1 + pl, mv, refidx,
                                 top_f2d)
                v_off = 2
            for pl in range(2):
                self._put_mc(1 + pl, uv_py + v_off, uv_px + h_off, bw4,
                             bh4, b.bx, b.by, 1 + pl, b.mv[0], b.ref[0],
                             filter2d)
            return

        w4 = min(bw4, f.bw - b.bx)
        h4 = min(bh4, f.bh - b.by)
        if (min(cbw4, cbh4) > 1 and
            ((b.inter_mode == lv.GLOBALMV and
              f.gmv_warp_allowed[b.ref[0]]) or
             (b.motion_mode == MM_WARP and b.warpmv is not None and
              b.warpmv.type > WarpedMotionType.TRANSLATION))):
            wmp = b.warpmv if b.motion_mode == MM_WARP else fh.gmv[b.ref[0]]
            for pl in range(2):
                self._put_warp(1 + pl, uv_py, uv_px, b_dim, 1 + pl,
                               b.ref[0], wmp)
        else:
            mbw4 = bw4 << int(bw4 == ss_hor)
            mbh4 = bh4 << int(bh4 == ss_ver)
            mbx = b.bx & ~ss_hor
            mby = b.by & ~ss_ver
            for pl in range(2):
                self._put_mc(1 + pl, uv_py, uv_px, mbw4, mbh4, mbx, mby,
                             1 + pl, b.mv[0], b.ref[0], filter2d)
                if b.motion_mode == MM_OBMC:
                    self._obmc(1 + pl, uv_py, uv_px, b_dim, 1 + pl, w4,
                               h4, row_start, col_start)
        if b.interintra_type:
            ii = mc_ref.ii_mask(chr_layout_idx, b.bs, b.interintra_type,
                                b.interintra_mode, b.wedge_idx,
                                cbw4 * 4, cbh4 * 4)
            for pl in range(2):
                plane = self.pic.planes[1 + pl]
                ipred = self._interintra_pred(
                    1 + pl, plane, uv_px, uv_py, cbw4, cbh4,
                    b.interintra_mode, col_start >> ss_hor,
                    col_end >> ss_hor, row_start >> ss_ver,
                    row_end >> ss_ver, b.bx >> ss_hor, b.by >> ss_ver)
                dst = plane[uv_py:uv_py + cbh4 * 4, uv_px:uv_px + cbw4 * 4]
                dst[:] = mc_ref.blend(dst.astype(np.int32), ipred,
                                      ii).astype(dst.dtype)

    # -- compound -------------------------------------------------------
    def _compound(self, b, b_dim, bw4, bh4, cbw4, cbh4, has_chroma,
                  chr_layout_idx):
        f = self.f
        fh = f.frame_hdr
        bd = self.bitdepth
        ss_ver, ss_hor = f.ss_ver, f.ss_hor
        filter2d = b.filter2d
        y_plane = self.pic.planes[0]
        px, py = b.bx * 4, b.by * 4

        descs = []
        for i in range(2):
            if (b.inter_mode == lv.GLOBALMV_GLOBALMV and
                    f.gmv_warp_allowed[b.ref[i]]):
                descs.append(("warp", (b_dim, 0, b.ref[i],
                                       fh.gmv[b.ref[i]])))
            else:
                descs.append(("mc", (bw4, bh4, b.bx, b.by, 0,
                                     b.mv[i], b.ref[i], filter2d)))
        jw = int(self.jnt_weights[b.ref[0]][b.ref[1]])
        msk = None
        if b.comp_type == COMP_INTER_WEDGE:
            msk = mc_ref.wedge_mask(0, b.bs, 0, b.wedge_idx, bw4 * 4,
                                    bh4 * 4)
        seg_mask = self._exec_compound(0, py, px, descs, b.comp_type,
                                       jw, b.mask_sign, msk, ss_hor,
                                       ss_ver)
        if b.comp_type == COMP_INTER_SEG:
            msk = seg_mask
        elif b.comp_type == COMP_INTER_WEDGE and has_chroma:
            msk = mc_ref.wedge_mask(chr_layout_idx, b.bs, b.mask_sign,
                                    b.wedge_idx, cbw4 * 4, cbh4 * 4)

        if has_chroma:
            uv_px = (b.bx >> ss_hor) * 4
            uv_py = (b.by >> ss_ver) * 4
            uv_comp = b.comp_type if b.comp_type in (
                COMP_INTER_AVG, COMP_INTER_WEIGHTED_AVG) \
                else COMP_INTER_WEDGE
            for pl in range(2):
                cdescs = []
                for i in range(2):
                    if (b.inter_mode == lv.GLOBALMV_GLOBALMV and
                            min(cbw4, cbh4) > 1 and
                            f.gmv_warp_allowed[b.ref[i]]):
                        cdescs.append(("warp", (b_dim, 1 + pl, b.ref[i],
                                                fh.gmv[b.ref[i]])))
                    else:
                        cdescs.append(("mc", (bw4, bh4, b.bx, b.by,
                                              1 + pl, b.mv[i], b.ref[i],
                                              filter2d)))
                self._exec_compound(1 + pl, uv_py, uv_px, cdescs,
                                    uv_comp, jw, b.mask_sign, msk,
                                    ss_hor, ss_ver)


def reconstruct_inter_frame(plan, refp):
    if getattr(plan, "lazy_blocks", False):
        from ..entropy.native_tile import materialize_pending
        materialize_pending(plan)
    r = InterReconstructor(plan, refp)
    itx_ref.precompute_residuals_plan(plan, r.bitdepth)
    return r.run()
