"""Inter-frame reconstruction on the device, on the native-emitter route.

Port of dav1d_tpu's recon/inter_device.py restricted to `run_native`:
the native job emitter (native/interjobs.cpp, bound in
inter_jobs_native) writes the frame's job tables straight from the
Stage-A pools, ops/mc_fused.execute runs them on the device (puts,
warps, compounds luma before chroma, OBMC top then left laps,
residuals), and then the leftover blocks take one of two routes:

- on the device (recon/ipred_device.py) under DAV1D_TPU_LO=device, or
  under the default DAV1D_TPU_LO=auto for a frame with at most
  DAV1D_TPU_LO_LIMIT leftovers (the port's default limit is 0: on the
  H100 the host route measured cheaper on every frame), when every
  leftover is pure intra without a palette: the plan is built before
  the inter passes (phase inter.lo_build), its level tables cross in
  the frame's one upload, and after the residual pass the levels run
  on the device planes (inter.lo_device): no mid-frame round trip;
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

Not on this route: frames the native emitter cannot serve (the Python
collector walk, raising NotImplementedError with ROADMAP item 9; among
them OBMC laps of a bilinear filter, which the emitter never writes).
"""
from __future__ import annotations

import numpy as np

from ..entropy import levels as lv
from ..ops import itx_ref
from ..ops.device import fetch_pic_host, fetch_rows, sync_if_timed, \
    upload_planes, upload_rows
from ..utils import timing
from .inter_ref import InterReconstructor


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
    def __init__(self, plan, refp, device):
        super().__init__(plan, refp)
        self.device = device
        self.leftovers = np.zeros((0, 3), np.int64)
        self._lo_region = None   # (r0, r1) luma rows the host replay needs
        self._region_spans = None
        self._dev_lo = None      # the device leftover plan, when served
        self.lo_tables = None    # its level tables (host), for the upload
        self.lo_views = {}       # the same on the device
        self.cf_pool_dev = None  # the frame's coefficient pool on the device

    def _leftover_region(self, lo):
        """Luma row span the host leftover replay touches: block rects
        plus the intra edge reach (1 row above; the left edge extends
        up to 2*h below the block top, ipred_prepare_tmpl.c:75-203)."""
        from ..entropy import native_tile as nt
        tiles_rec = self.plan.native_tiles
        ymin, ymax = 1 << 30, 0
        for tidx in np.unique(lo[:, 2]):
            tr = tiles_rec[tidx]
            li = lo[lo[:, 2] == tidx, 0] - tr["block_base"]
            blocks = tr["blocks"]
            by = blocks[li, nt.BF_BY].astype(np.int64)
            bs = blocks[li, nt.BF_BS]
            bh4 = np.asarray(lv.block_dimensions)[bs, 1].astype(np.int64)
            ymin = min(ymin, int((by * 4).min()))
            ymax = max(ymax, int((by * 4 + bh4 * 12).max()))
        Hp = self.pic.planes[0].shape[0]
        r0 = max(0, ymin - 8) & ~7
        r1 = min(Hp, (ymax + 15) & ~7)
        return r0, r1

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
                        self._dev_lo, *self._cf_bases(),
                        len(self.pic.planes))
            if self._dev_lo is None:
                self._lo_region = self._leftover_region(lo)
        from ..ops import mc_fused
        mc_fused.execute(self, jobs)
        if not len(lo):
            return self.pic
        if self._dev_lo is not None:
            with timing.phase("inter.lo_device"):
                ipred_device.execute(self, self._dev_lo)
                sync_if_timed(self.device)
            return self.pic
        with timing.phase("inter.leftovers"):
            self._replay_leftovers()
        with timing.phase("inter.region_upload"):
            upload_rows(self.pic.dev, self.pic.planes, self._region_spans)
            sync_if_timed(self.device)
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
                                                    idxs):
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

    def _add_residuals(self, b):
        """A replayed block's residuals from its own coefficient records
        (materialize_block's b._cbs)."""
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
                dev = pic.dev
                if dev is None:
                    fetch_pic_host(pic)
                    dev = pic.dev = upload_planes(pic.planes, self.device)
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
        """Keep the planes on the device; with leftovers for the host
        replay, bring the rows it touches down first (after the residual
        pass)."""
        if len(self.leftovers) and self._dev_lo is None:
            r0, r1 = self._lo_region
            spans = []
            for i, hp in enumerate(self.pic.planes):
                ssv = self.pic.ss_ver if i else 0
                spans.append((r0 >> ssv, min(hp.shape[0], r1 >> ssv)))
            with timing.phase("inter.fetch_region"):
                fetch_rows(planes, self.pic.planes, spans, self.bitdepth)
            self._region_spans = spans
        self.pic.dev = planes
        self.pic.dev_c = None
        self.pic.host_stale = True


def reconstruct_inter_frame_device(plan, refp, device):
    """Stage B of one inter frame on `device`; returns the Picture with
    its planes on the device (`pic.dev`)."""
    from . import inter_jobs_native
    r = DeviceInterReconstructor(plan, refp, device)
    jobs = None
    if plan.native_tiles:
        with timing.phase("inter.emit_jobs"):
            jobs = inter_jobs_native.emit(plan, plan.f, r.jnt_weights)
    if jobs is None:
        raise NotImplementedError(
            "inter frames the native job emitter cannot serve (the Python "
            "collector walk) not ported yet: ROADMAP item 9")
    return r.run_native(jobs)
