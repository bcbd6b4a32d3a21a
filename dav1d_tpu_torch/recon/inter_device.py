"""Inter-frame reconstruction on the device.

Port of dav1d_tpu's recon/inter_device.py. On the default route
(`run_native`) the native job emitter (native/interjobs.cpp, bound in
inter_jobs_native) writes the frame's job tables straight from the
Stage-A pools, ops/mc_fused.execute runs them on the device (puts,
warps, compounds luma before chroma, OBMC top then left laps,
residuals), and then the leftover blocks take one of two routes:

- on the device (recon/ipred_device.py) under DAV1D_TPU_LO=device, or
  under the default DAV1D_TPU_LO=auto for a frame with at most
  DAV1D_TPU_LO_LIMIT leftovers (the port's default limit is 0: on the
  H100 the host route measured cheaper on every frame), when every
  leftover is pure intra without a palette: the plan is built before
  the inter passes (phase inter.lo_build), its tables cross in the
  frame's one upload, and after the residual pass the plan runs on the
  device planes in one launch (inter.lo_device): no mid-frame round
  trip;
- on the host otherwise (DAV1D_TPU_LO=host forces it): the leftover
  rows are fetched from the device after the residual pass
  (inter.fetch_region), runs of pure-intra leftovers go through
  native/intrarec.cpp (the golden walk where it declines), the other
  leftovers (interintra, blocks on scaled references, bilinear or
  warped compounds) through the golden InterReconstructor
  (recon/inter_ref.py) that this class extends, reading every reference
  picture's host planes (inter.leftovers); the replayed rows go back up
  before the filter chain (inter.region_upload).

Correctness of the split (as in dav1d_tpu): inter prediction never
reads the current picture, and intra edges only read raster-earlier
pixels, so batching the device passes before the leftovers reproduces
the reference's sequential walk. Reference planes are each reference
picture's device planes (`Picture.dev`), uploaded once for a reference
that has none; the device launches take only the references of the
current frame's size (the emitter leaves every block on a scaled
reference to the host).

A frame the native emitter does not serve (DAV1D_TPU_INTERJOBS=python,
a plan without native Stage-A records as under DAV1D_TPU_TRACE, a
mixed native / Python Stage A, the emitter's own declines) takes
dav1d_tpu's Python collector walk (`run`): the golden walk of
InterReconstructor with its leaves overridden to collect the same job
tables instead of pixels. A block the device passes do not serve (a
scaled reference, a warped or bilinear compound, an OBMC lap of a
bilinear filter) rolls its jobs back and replays eagerly on the host
planes (_RetryEager), and the device planes then start from those
planes. Intra and interintra blocks are left over and replayed after
the passes, as on the emitter route; coefficient blocks without a
native pool record (res_fixups) are added on the host before them.

dav1d_tpu's DAV1D_TPU_FUSED=0 (one XLA program a job group) has no
counterpart: the port runs every frame's tables through
ops/mc_fused.execute (ROADMAP section 3).
"""
from __future__ import annotations

import numpy as np

from ..entropy import levels as lv
from ..ops import itx_ref, mc_ref
from ..ops.device import fetch_rows, planes_on_device, upload_rows
from ..utils import timing
from .inter_ref import (COMP_INTER_AVG, COMP_INTER_NONE, COMP_INTER_SEG,
                        COMP_INTER_WEDGE, COMP_INTER_WEIGHTED_AVG,
                        InterReconstructor)


class _RetryEager(Exception):
    """Raised when a block needs the host path (scaled refs, warp-in-
    compound, bilinear compound/OBMC); the walk rolls the block's jobs
    back and replays it through the golden eager leaves."""


class DeviceInterReconstructor(InterReconstructor):
    # job layouts (native/interjobs.cpp), each run on the device by
    # ops/mc_fused.execute:
    #  puts  (n, 11): plane, h, w, py, px, ref, dy, dx, amx, amy, ft
    #  warps (n, 12): plane, py, px, ref, dy, dx, mx, my, al, be, ga, de
    #                 (one 8x8 tile each; ops/mc_warp.py)
    #  obmc  (n, 13): top, plane, ww, hh, lap_h, py, px, ref, dy, dx,
    #                 amx, amy, ft (one lap each; ops/mc_obmc.py)
    #  comp  (n, 25): plane, h, w, py, px, mode, jw, sign, mkind,
    #                 mk0..mk3, dy0, dx0, amx0, amy0, ft0, ref0,
    #                 dy1, dx1, amx1, amy1, ft1, ref1
    #  res   (n, 7):  plane, tx, txtp, py, px, cf_local_off, tile_idx
    def __init__(self, plan, refp, device, pool=None):
        super().__init__(plan, refp)
        self.device = device
        self.tile_pool = pool    # the leftover runs' tile calls, at once
        # the collector walk's job lists (run)
        self.collecting = False
        self.puts = []
        self.warps = []
        self.obmc_jobs = []
        self.comp = []
        self.res_jobs = []
        self._lists = (self.puts, self.warps, self.obmc_jobs, self.comp,
                       self.res_jobs)
        self.res_fixups = []  # coef blocks without a native pool record
        self.had_eager = False   # a _RetryEager replay wrote host pixels
        self._fused_res = bool(plan.native_tiles)
        # emitter route: (n, 3) [block, tl_4x4_filter, tile] rows; the
        # collector walk: (index, Block, tile bounds) tuples
        self.leftovers = np.zeros((0, 3), np.int64)
        self._lo_region = None   # (r0, r1) luma rows the host replay
        self._region_spans = None  # needs; None: the whole planes
        self._dev_lo = None      # the device leftover plan, when served
        self.lo_tables = None    # its tables (host), for the upload
        self.lo_views = {}       # the same on the device
        self.cf_pool_dev = None  # the frame's coefficient pool on the device

    # -- rollback ---------------------------------------------------------
    def _snapshot(self):
        return tuple(len(l) for l in self._lists)

    def _rollback(self, snap):
        for l, n in zip(self._lists, snap):
            del l[n:]

    # -- phase math shared with the golden _mc ---------------------------
    def _mc_args(self, bw4, bh4, bx, by, pl, mv, refidx, filter2d):
        f = self.f
        ss_ver = int(bool(pl)) and f.ss_ver
        ss_hor = int(bool(pl)) and f.ss_hor
        if f.svc[refidx][0][0]:
            raise _RetryEager()
        h_mul, v_mul = 4 >> ss_hor, 4 >> ss_ver
        mvy, mvx = mv
        mx = mvx & (15 >> (1 - ss_hor))
        my = mvy & (15 >> (1 - ss_ver))
        dx = bx * h_mul + (mvx >> (3 + ss_hor))
        dy = by * v_mul + (mvy >> (3 + ss_ver))
        amx, amy = mx << (1 - ss_hor), my << (1 - ss_ver)
        ft = mc_ref.FILTER2D_TO_TYPE[filter2d]
        return (bw4 * h_mul, bh4 * v_mul, dy, dx, amx, amy, ft, refidx)

    # -- executor leaf overrides: collect jobs while walking --------------
    def _put_mc(self, plane_idx, py, px, bw4, bh4, bx, by, pl, mv,
                refidx, filter2d):
        if not self.collecting:
            return super()._put_mc(plane_idx, py, px, bw4, bh4, bx, by,
                                   pl, mv, refidx, filter2d)
        w, h, dy, dx, amx, amy, ft, r = self._mc_args(
            bw4, bh4, bx, by, pl, mv, refidx, filter2d)
        self.puts.append((plane_idx, h, w, py, px, r, dy, dx, amx, amy,
                          ft))

    def _put_warp(self, plane_idx, py, px, b_dim, pl, refidx, wmp):
        if not self.collecting:
            return super()._put_warp(plane_idx, py, px, b_dim, pl,
                                     refidx, wmp)
        self._enqueue_warp(plane_idx, py, px, b_dim, pl, refidx, wmp)

    def _enqueue_warp(self, plane_idx, py, px, b_dim, pl, refidx, wmp):
        """Expand a warped block into per-8x8 jobs (the golden
        _warp_affine tiling, recon_tmpl.c:1115-1168)."""
        f = self.f
        ss_ver = int(bool(pl)) and f.ss_ver
        ss_hor = int(bool(pl)) and f.ss_hor
        h_mul, v_mul = 4 >> ss_hor, 4 >> ss_ver
        mat = wmp.matrix
        bw_px = int(b_dim[0]) * h_mul
        bh_px = int(b_dim[1]) * v_mul
        warps = self.warps
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
                warps.append((plane_idx, py + y, px + x, refidx, dy, dx,
                              mx, my, wmp.alpha, wmp.beta, wmp.gamma,
                              wmp.delta))

    def _obmc_lap_top(self, plane_idx, py, px, x_off, ow4, oh4, bx, by,
                      pl, mv, refidx, f2d, h_mul, v_mul):
        if not self.collecting:
            return super()._obmc_lap_top(plane_idx, py, px, x_off, ow4,
                                         oh4, bx, by, pl, mv, refidx,
                                         f2d, h_mul, v_mul)
        w, h, dy, dx, amx, amy, ft, r = self._mc_args(
            ow4, (oh4 * 3 + 3) >> 2, bx, by, pl, mv, refidx, f2d)
        if ft < 0:
            raise _RetryEager()
        hh = v_mul * oh4
        self.obmc_jobs.append((1, plane_idx, w, hh, h, py, px + x_off,
                               r, dy, dx, amx, amy, ft))

    def _obmc_lap_left(self, plane_idx, py, px, y_off, ow4, oh4, bx, by,
                       pl, mv, refidx, f2d, h_mul, v_mul):
        if not self.collecting:
            return super()._obmc_lap_left(plane_idx, py, px, y_off, ow4,
                                          oh4, bx, by, pl, mv, refidx,
                                          f2d, h_mul, v_mul)
        w, h, dy, dx, amx, amy, ft, r = self._mc_args(
            ow4, oh4, bx, by, pl, mv, refidx, f2d)
        if ft < 0:
            raise _RetryEager()
        self.obmc_jobs.append((0, plane_idx, w, h, h, py + y_off, px,
                               r, dy, dx, amx, amy, ft))

    def _exec_compound(self, plane_idx, py, px, descs, comp_type, jw,
                       sign, msk, ss_hor, ss_ver):
        if not self.collecting:
            return super()._exec_compound(plane_idx, py, px, descs,
                                          comp_type, jw, sign, msk,
                                          ss_hor, ss_ver)
        srcs = []
        for kind, args in descs:
            if kind == "warp":
                raise _RetryEager()
            srcs.append(self._mc_args(*args))
        w, h = srcs[0][0], srcs[0][1]
        if srcs[0][6] < 0:          # bilinear compound: host path
            raise _RetryEager()
        mkind, mk = 0, (0, 0, 0, 0)
        if comp_type not in (COMP_INTER_AVG, COMP_INTER_WEIGHTED_AVG,
                             COMP_INTER_SEG):
            if isinstance(msk, tuple) and msk and msk[0] == "seg":
                mkind = 2
            else:
                mkind, mk = 1, msk      # (clidx, bs, sign, wedge_idx)
        s0, s1 = srcs
        self.comp.append((plane_idx, h, w, py, px, comp_type, jw, sign,
                          mkind, mk[0], mk[1], mk[2], mk[3],
                          s0[2], s0[3], s0[4], s0[5], s0[6], s0[7],
                          s1[2], s1[3], s1[4], s1[5], s1[6], s1[7]))
        if comp_type == COMP_INTER_SEG and plane_idx == 0:
            return ("seg",)
        return None

    # -- wedge mask routing (the golden _compound passes mask arrays;
    #    the collector wants the table key instead) -----------------------
    def _compound(self, b, b_dim, bw4, bh4, cbw4, cbh4, has_chroma,
                  chr_layout_idx):
        if not self.collecting:
            return super()._compound(b, b_dim, bw4, bh4, cbw4, cbh4,
                                     has_chroma, chr_layout_idx)
        f = self.f
        fh = f.frame_hdr
        ss_ver, ss_hor = f.ss_ver, f.ss_hor
        filter2d = b.filter2d
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
            msk = (0, b.bs, 0, b.wedge_idx)
        seg_mask = self._exec_compound(0, py, px, descs, b.comp_type,
                                       jw, b.mask_sign, msk, ss_hor,
                                       ss_ver)
        if b.comp_type == COMP_INTER_SEG:
            msk = seg_mask
        elif b.comp_type == COMP_INTER_WEDGE and has_chroma:
            msk = (chr_layout_idx, b.bs, b.mask_sign, b.wedge_idx)

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

    def _rows_region(self, by, bh4):
        """Luma row span the host leftover replay touches, of blocks at
        4x4 rows `by` of heights `bh4` (in 4x4 units): block rects plus
        the intra edge reach (1 row above; the left edge extends up to
        2*h below the block top, ipred_prepare_tmpl.c:75-203)."""
        by = np.asarray(by, np.int64)
        bh4 = np.asarray(bh4, np.int64)
        ymin = int((by * 4).min())
        ymax = int((by * 4 + bh4 * 12).max())
        Hp = self.pic.planes[0].shape[0]
        r0 = max(0, ymin - 8) & ~7
        r1 = min(Hp, (ymax + 15) & ~7)
        return r0, r1

    def _leftover_region(self, lo):
        """_rows_region of the emitter's leftover rows (n, 3)."""
        from ..entropy import native_tile as nt
        tiles_rec = self.plan.native_tiles
        by, bs = [], []
        for tidx in np.unique(lo[:, 2]):
            tr = tiles_rec[tidx]
            li = lo[lo[:, 2] == tidx, 0] - tr["block_base"]
            by.append(tr["blocks"][li, nt.BF_BY])
            bs.append(tr["blocks"][li, nt.BF_BS])
        bh4 = np.asarray(lv.block_dimensions)[np.concatenate(bs), 1]
        return self._rows_region(np.concatenate(by), bh4)

    def run_native(self, jobs):
        """Execute the emitter's job tables on the device, then the
        leftover blocks: on the device when recon/ipred_device.py serves
        the frame, else replayed on the host."""
        from . import ipred_device
        lo = self.leftovers = np.asarray(jobs["leftovers"],
                                         np.int64).reshape(-1, 3)
        if len(lo):
            with timing.phase("inter.lo_build"):
                self._dev_lo = ipred_device.build(self, lo.tolist())
                if self._dev_lo is not None:
                    self.lo_tables = ipred_device.level_tables(
                        self._dev_lo, *self._cf_bases())
            if self._dev_lo is None:
                self._lo_region = self._leftover_region(lo)
        self._execute(jobs)
        if not len(lo):
            return self.pic
        if self._dev_lo is not None:
            with timing.phase("inter.lo_device"):
                ipred_device.execute(self)
            return self.pic
        with timing.phase("inter.leftovers"):
            self._replay_leftovers()
        with timing.phase("inter.region_upload"):
            upload_rows(self.pic.dev, self.pic.planes, self._region_spans)
        return self.pic

    def _replay_leftovers(self):
        """The leftover blocks in decode order into the host planes:
        each run of pure-intra blocks in one native call (the golden
        walk where the engine declines), every other block through the
        golden inter walk with the tl_4x4_filter state the emitter
        captured for it."""
        from ..entropy import native_tile as nt
        from . import intra_native
        tiles_rec = self.plan.native_tiles
        run_idxs = []

        def bounds(tr):
            return (tr["col_start"], tr["col_end"], tr["row_start"],
                    tr["row_end"])

        def replay(gi, tr):
            b = nt.materialize_block(self.plan, tr, gi - tr["block_base"])
            for cb in b._cbs:
                self.coef_by_pos.setdefault((cb.plane, cb.x4, cb.y4), cb)
            if b.intra:
                self._recon_block(b, *bounds(tr))
            else:
                self._recon_b_inter(b, *bounds(tr))

        def flush():
            if not run_idxs:
                return
            idxs = [g for g, _ in run_idxs]
            if not intra_native.recon_blocks_native(self.plan, self.pic,
                                                    idxs, self.tile_pool):
                for g, tr in run_idxs:
                    replay(g, tr)
            run_idxs.clear()

        for gi, tlf, tidx in self.leftovers.tolist():
            tr = tiles_rec[tidx]
            li = gi - tr["block_base"]
            if tr["blocks"][li, nt.BF_INTRA] and \
                    not tr["blocks"][li, nt.BF_INTERINTRA_TYPE]:
                run_idxs.append((gi, tr))
            else:
                flush()
                self.tl_4x4_filter = tlf
                replay(gi, tr)
        flush()

    # -- the collector walk ------------------------------------------------
    def run(self):
        """The golden walk over plan.blocks, collecting the job tables of
        every inter block the device passes serve (_RetryEager replays
        the others on the host planes); then the device passes, then the
        host part: the res_fixups, then the leftover blocks in decode
        order (runs of pure-intra ones through native/intrarec.cpp), and
        the rows they wrote back to the device planes."""
        f = self.f
        fh = f.frame_hdr
        tiles = []
        for tr in range(fh.tiling.rows):
            for tc in range(fh.tiling.cols):
                cs = fh.tiling.col_start_sb[tc] << f.sb_shift
                ce = min(fh.tiling.col_start_sb[tc + 1] << f.sb_shift,
                         f.bw)
                rs = fh.tiling.row_start_sb[tr] << f.sb_shift
                re = min(fh.tiling.row_start_sb[tr + 1] << f.sb_shift,
                         f.bh)
                tiles.append((cs, ce, rs, re))

        def tile_of(b):
            for i, t in enumerate(tiles):
                if t[0] <= b.bx < t[1] and t[2] <= b.by < t[3]:
                    return i
            raise AssertionError

        self.leftovers = []
        with timing.phase("inter.walk"):
            for bi, b in enumerate(self.plan.blocks):
                bounds = tiles[tile_of(b)]
                self._quad_tl_restore(b)
                if b.intra or b.interintra_type:
                    if b.interintra_type and \
                            b.comp_type == COMP_INTER_NONE:
                        # keep the tl filter state the golden walk would
                        # have
                        self.tl_4x4_filter = b.filter2d
                    self.leftovers.append((bi, b, bounds))
                    self._quad_tl_save(b)
                    continue
                snap = self._snapshot()
                tl = self.tl_4x4_filter
                self.collecting = True
                try:
                    self._recon_b_inter(b, *bounds)
                except _RetryEager:
                    self._rollback(snap)
                    self.tl_4x4_filter = tl
                    self.collecting = False
                    self.had_eager = True
                    self._recon_b_inter(b, *bounds)
                finally:
                    self.collecting = False
                self._quad_tl_save(b)

        if self.leftovers and not self.res_fixups:
            lo = [b for _, b, _ in self.leftovers]
            self._lo_region = self._rows_region(
                [b.by for b in lo],
                np.asarray(lv.block_dimensions)[[b.bs for b in lo], 1])
        jobs = {"puts": np.asarray(self.puts, np.int32).reshape(-1, 11),
                "warps": np.asarray(self.warps, np.int32).reshape(-1, 12),
                "obmc": np.asarray(self.obmc_jobs, np.int32)
                .reshape(-1, 13),
                "comp": np.asarray(self.comp, np.int32).reshape(-1, 25),
                "res": np.asarray(self.res_jobs, np.int32).reshape(-1, 7)}
        if any(len(t) for t in jobs.values()):
            self._execute(jobs)
        # (else no device planes: every block is on the host planes,
        # which the filter chain uploads)

        # the residuals of collected blocks without a native pool record:
        # before the leftovers, whose intra edges may read those blocks
        with timing.phase("inter.res_fixups"):
            for cb in self.res_fixups:
                t_dim = lv.TXFM_INFO[cb.tx]
                ppx, ppy = cb.x4 * 4, cb.y4 * 4
                itx_ref.add_residual(
                    self.pic.planes[cb.plane][ppy:ppy + t_dim.h * 4,
                                              ppx:ppx + t_dim.w * 4],
                    cb, self.bitdepth)
        # leftovers: sequential recon in decode order. Pure-intra
        # leftovers run natively (one C++ call per consecutive run);
        # interintra / anything the native engine can't serve replays
        # through the golden path. Order is preserved across the mix:
        # intra edges may read pixels an earlier leftover wrote.
        with timing.phase("inter.leftovers"):
            from . import intra_native
            run = []

            def flush():
                if not run:
                    return
                idxs = [i for i, _, _ in run]
                if not intra_native.recon_blocks_native(
                        self.plan, self.pic, idxs, self.tile_pool):
                    for _i, b, bounds in run:
                        self._recon_block(b, *bounds)
                run.clear()

            for bi, b, bounds in self.leftovers:
                if b.intra:
                    run.append((bi, b, bounds))
                else:
                    flush()
                    self._recon_block(b, *bounds)
            flush()
        if self._region_spans is not None:
            with timing.phase("inter.region_upload"):
                upload_rows(self.pic.dev, self.pic.planes,
                            self._region_spans)
        return self.pic

    def _execute(self, jobs):
        """The frame's device passes over the job tables (ops/mc_fused.py);
        after an eager replay (had_eager) its device planes start from
        the host planes, which hold the replayed blocks."""
        from ..ops import mc_fused
        mc_fused.execute(self, jobs)

    def _add_residuals(self, b):
        if not self.collecting:
            if getattr(b, "_cbs", None) is not None:
                return self._add_residuals_cbs(b)
            return super()._add_residuals(b)
        res_jobs = self.res_jobs
        for cb in self.plan.coefs[b.coef_start:b.coef_end]:
            if cb.eob < 0:
                continue
            t = cb._tile
            if self._fused_res and t is not None:
                res_jobs.append((cb.plane, cb.tx, cb.txtp, cb.y4 * 4,
                                 cb.x4 * 4,
                                 int(t["coefs"][cb._idx, 6]),
                                 t["tile_idx"]))
            else:
                self.res_fixups.append(cb)

    def _add_residuals_cbs(self, b):
        """A lazily materialized leftover block's residuals from its own
        coefficient records (materialize_block's b._cbs)."""
        for cb in b._cbs:
            if cb.eob < 0:
                continue
            t_dim = lv.TXFM_INFO[cb.tx]
            ppx, ppy = cb.x4 * 4, cb.y4 * 4
            itx_ref.add_residual(
                self.pic.planes[cb.plane][ppy:ppy + t_dim.h * 4,
                                          ppx:ppx + t_dim.w * 4],
                cb, self.bitdepth)

    def _ref_bounds(self, pl_type):
        """Valid reference rows and columns: the frame size, not the
        allocated plane size."""
        f = self.f
        ss_hor = f.ss_hor if pl_type else 0
        ss_ver = f.ss_ver if pl_type else 0
        return ((f.frame_hdr.height + ss_ver) >> ss_ver,
                (f.frame_hdr.width[0] + ss_hor) >> ss_hor)

    def _ref_planes(self):
        """Per plane index, the distinct reference pictures' int32 device
        planes, plus the (7,) refidx -> list slot lut. Only references
        of the current frame's size go to the device (a scaled one's
        entry in the lut is -1: no device job reads it). A reference
        without device planes uploads once and keeps them."""
        n_planes = len(self.pic.planes)
        per_plane = [[] for _ in range(n_planes)]
        ids = {}
        lut = np.full(7, -1, np.int32)
        for i in range(7):
            s = self.refp[i]
            if s is None or s.pic is None or \
                    any(sc for (sc, _step) in self.f.svc[i]):
                continue
            pic = s.pic
            if id(pic) not in ids:
                ids[id(pic)] = len(per_plane[0])
                dev = planes_on_device(pic, self.device)
                for pi in range(n_planes):
                    per_plane[pi].append(dev[pi])
            lut[i] = ids[id(pic)]
        return per_plane, lut

    def _cf_bases(self):
        """(bases, length): each tile's offset in the frame's
        coefficient pool (_build_cf_pool) and the pool's length."""
        tiles = self.plan.native_tiles
        bases = np.zeros(max(len(tiles), 1), np.int64)
        pos = 0
        for t in tiles:
            bases[t["tile_idx"]] = pos
            pos += int(t.get("cf_used", len(t["cf_pool"])))
        return bases, pos

    def _build_cf_pool(self):
        """Concatenate the per-tile Stage-A coefficient pools (used
        span only) into one int32 frame pool; returns (pool, bases)."""
        tiles = self.plan.native_tiles
        bases, _ = self._cf_bases()
        parts = [t["cf_pool"][:int(t.get("cf_used", len(t["cf_pool"])))]
                 for t in tiles]
        if not parts:
            return np.zeros(0, np.int32), bases
        return np.concatenate(parts).astype(np.int32, copy=False), bases

    def _finish_device_planes(self, planes):
        """Keep the planes on the device; with work for the host (leftovers
        to replay, res_fixups to add), bring down first (after the
        residual pass) the rows the leftovers touch, or with res_fixups
        or without a region the whole planes."""
        if (len(self.leftovers) and self._dev_lo is None) or \
                self.res_fixups:
            spans = [(0, hp.shape[0]) for hp in self.pic.planes]
            region = None if self.res_fixups else self._lo_region
            if region is not None:
                r0, r1 = region
                for i, hp in enumerate(self.pic.planes):
                    ssv = self.pic.ss_ver if i else 0
                    spans[i] = (r0 >> ssv, min(hp.shape[0], r1 >> ssv))
            with timing.phase("inter.fetch" if region is None
                              else "inter.fetch_region"):
                fetch_rows(planes, self.pic.planes, spans, self.bitdepth)
            self._region_spans = spans
        self.pic.dev = planes
        self.pic.dev_c = None
        self.pic.host_stale = True


def reconstruct_inter_frame_device(plan, refp, device, pool=None):
    """Stage B of one inter frame on `device`: the native emitter's
    tables, or the Python collector walk for a frame it does not serve;
    the host replay's tile calls run on `pool` when given. Returns the
    Picture with its planes on the device (`pic.dev`), or on the host
    when no block ran on the device."""
    return reconstruct_with(DeviceInterReconstructor(plan, refp, device,
                                                     pool))


def reconstruct_with(r):
    """Stage B of r's frame (r: a DeviceInterReconstructor): the native
    emitter's tables through r.run_native, or the collector walk
    (r.run) for a frame the emitter does not serve. The frame's
    leftover blocks, on the device or the host route, add to the
    recorder's counter `inter.leftover_blocks`."""
    from . import inter_jobs_native
    plan = r.plan
    jobs = None
    if r._fused_res:
        with timing.phase("inter.emit_jobs"):
            jobs = inter_jobs_native.emit(plan, plan.f, r.jnt_weights)
    if jobs is not None:
        pic = r.run_native(jobs)
        timing.count("inter.leftover_blocks", len(r.leftovers))
        return pic
    # the golden Python collector walk (also the
    # DAV1D_TPU_INTERJOBS=python oracle of the emitter); it needs the
    # Python Block objects
    if getattr(plan, "lazy_blocks", False):
        from ..entropy.native_tile import materialize_pending
        with timing.phase("inter.materialize"):
            materialize_pending(plan)
        # the reconstructor indexed the coefficient blocks before they
        # existed
        for cb in plan.coefs:
            r.coef_by_pos.setdefault((cb.plane, cb.x4, cb.y4), cb)
        r.coef_iter = iter(plan.coefs)
    if not r._fused_res:
        with timing.phase("inter.itx_residuals"):
            itx_ref.precompute_residuals_plan(plan, r.bitdepth)
    pic = r.run()
    timing.count("inter.leftover_blocks", len(r.leftovers))
    return pic
