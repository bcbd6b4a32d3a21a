"""Inter Stage B on the device: the frame's MC and residual passes over
the native emitter's job tables.

Port of dav1d_tpu's ops/mc_fused.py `execute` (the single-program inter
Stage B), keeping its job-table layouts (recon/inter_device.py) and its
pass order (`segments`):

  puts      single-reference 8-tap / bilinear, every plane in one
            launch
  warps     8x8 affine warp tiles, every plane in one launch
  compounds luma before chroma: luma seg-mask jobs write the seg plane
            that chroma jobs with mkind 2 read (two launches in order on
            one stream)
  OBMC      laps blended into the puts' and warps' predictions: the top
            laps of every plane, then the left laps (a block's left laps
            read its top-left corner after its top laps wrote it), in
            one launch with a grid-wide barrier between the two
  residuals inverse transform + add from the frame's coefficient pool,
            then the lossless WHT jobs

What existed only for the TPU is gone: segments as while_loops over
fixed chunks, pow2 buffer ladders, the PAD apron and the
block-gather-and-roll windows, used-prefix and int16 / lo-hi pool
uploads. Here the puts are one kernel launch for every plane and each
other pass one launch per plane, the job tables, their block tables,
the leftover plan's tables of a frame whose intra leftovers run on the
device (recon/ipred_device.py level_tables: units, edge runs, residual
jobs and blocks, WHT jobs, level offsets; no index rows) and the int32
coefficient pool cross to
the device in one copy, and the kernels read the reference planes in
place. As dav1d_tpu bins residual
jobs into one segment per transform size, the host sorts each plane's
put, compound and residual jobs by class and cuts them into
class-uniform kernel blocks (ops/mc.py put_blocks, comp_blocks,
ops/itx.py res_blocks); warp tiles and OBMC laps go unsorted, one
warp per tile or lap (ops/mc_warp.py, mc_obmc.py).
"""
from __future__ import annotations

import itertools
from functools import lru_cache

import numpy as np
import torch

from ..utils import timing
from . import itx, mc, mc_obmc, mc_warp
from .device import upload, upload_planes


# dense per-class wedge mask LUTs: every (layout, bs, sign, idx) combo
# expanded to the class square, so a job reads its mask at [y][x] of one
# (c, c) block. Wedge masks exist only for blocks up to 32x32
# (reference wedge.h:39), so only classes 16 and 32 carry a LUT.
@lru_cache(maxsize=None)
def _wedge_lut(c):
    from .mc_ref import BS_32X32, wedge_mask
    from ..entropy import levels as _lv
    out = np.zeros((3 * 11 * 32, c, c), np.int8)
    for clidx in range(3):
        ss_hor = 1 if clidx else 0
        ss_ver = 1 if clidx == 2 else 0
        for bsrel in range(11):
            dims = _lv.block_dimensions[BS_32X32 + bsrel]
            w = (int(dims[0]) * 4) >> ss_hor
            h = (int(dims[1]) * 4) >> ss_ver
            if w > c or h > c:
                continue
            for sidx in range(32):
                try:
                    m = wedge_mask(clidx, BS_32X32 + bsrel, sidx >> 4,
                                   sidx & 15, w, h)
                except Exception:
                    continue
                key = (clidx * 11 + bsrel) * 32 + sidx
                out[key, :h, :w] = m
    return out


def _plane_tables(jobs, lut, bases, n_planes):
    """The emitter's tables with reference slots and pool offsets
    resolved (lut: refidx -> slot of the device references, -1 for one
that is not on the device, which no job may read): "put", every
plane's puts in one table, and "put_blocks",
    its put_blocks table (one launch serves all planes); "warp", every
    plane's warp tiles, and ("obmc", top) for top in 1, 0, every
    plane's laps of that direction; per plane, {(kind, plane): (n, K)
    int32}, kind in comp, res, wht, plus the kernels' block tables
    comp_blocks and res_blocks. Put, comp and res rows are class-sorted
    to match their blocks."""
    def slots(refidx):
        s = lut[refidx]
        if (s < 0).any():
            raise ValueError("a device job reads a reference that is not "
                             "on the device (of another size)")
        return s

    out = {}
    puts = jobs["puts"].copy()
    puts[:, 5] = slots(puts[:, 5])
    out["warp"] = jobs["warps"].copy()
    out["warp"][:, 3] = slots(out["warp"][:, 3])
    obmc = jobs["obmc"].copy()
    obmc[:, 7] = slots(obmc[:, 7])
    for top in (1, 0):
        out["obmc", top] = obmc[obmc[:, 0] == top]
        mc_obmc.check_geometry(out["obmc", top], top)
    comp = jobs["comp"].copy()
    comp[:, 18] = slots(comp[:, 18])
    comp[:, 24] = slots(comp[:, 24])
    res = jobs["res"]
    cfoff = bases[res[:, 6]] + res[:, 5]
    rows, is_wht = itx.job_rows(res, cfoff)
    # one binning call per kind for every plane; the plane is the
    # leading sort key, so each plane's rows and blocks are contiguous
    out["put"], out["put_blocks"] = mc.put_blocks(puts, group=puts[:, 0])
    comp, comp_blk = mc.comp_blocks(comp, group=comp[:, 0])
    res_pl = res[~is_wht, 0]
    res_rows, res_blk = itx.res_blocks(rows[~is_wht], group=res_pl)
    res_pl = np.sort(res_pl, kind="stable")
    for pi in range(n_planes):
        for kind, t, blk, pl in (("comp", comp, comp_blk, comp[:, 0]),
                                 ("res", res_rows, res_blk, res_pl)):
            a, b = np.searchsorted(pl, [pi, pi + 1])
            mine = blk[(blk[:, 1] >= a) & (blk[:, 1] < b)]
            mine[:, 1] -= a                 # first job, within the plane
            out[kind, pi], out[kind + "_blocks", pi] = t[a:b], mine
        out["wht", pi] = rows[(res[:, 0] == pi) & is_wht]
    return {k: np.ascontiguousarray(v, np.int32) for k, v in out.items()
            if len(v)}


def check_pool(tables, n_pool, n_planes):
    """Raise when a residual job of _plane_tables' `tables` reads past
    the coefficient pool of n_pool entries."""
    for key in itertools.product(("res", "wht"), range(n_planes)):
        t = tables.get(key)
        if t is not None and \
                int((t[:, 5] + itx.CF_LEN[t[:, 0]]).max()) > n_pool:
            raise ValueError("residual job reads past the coefficient pool")


def _upload(tables, pool, device):
    """One host->device copy of every job table and the pool; returns
    ({key: (n, K) view}, pool view)."""
    parts = [t.reshape(-1) for t in tables.values()] + [pool]
    buf = upload(np.concatenate(parts), device)
    views, pos = {}, 0
    for k, t in tables.items():
        views[k] = buf[pos:pos + t.size].view(t.shape)
        pos += t.size
    return views, buf[pos:]


def execute(recon, jobs):
    """Run the frame's MC and residual passes on recon.device; the
    planes go to recon._finish_device_planes. They start from zeros, or
    from the host planes after the collector walk's eager replays wrote
    blocks there (recon.had_eager)."""
    f = recon.f
    pic = recon.pic
    dev = recon.device
    bd = recon.bitdepth
    n_planes = len(pic.planes)
    with timing.phase("inter.upload"):
        refs, lut = recon._ref_planes()
        pool, bases = recon._build_cf_pool()
        tables = _plane_tables(jobs, lut, bases, n_planes)
        check_pool(tables, len(pool), n_planes)
        # the leftover plan's tables (recon/ipred_device.py) cross in
        # the same copy; its residuals read the same pool
        lo = recon.lo_tables or {}
        T, pool_d = _upload({**tables, **lo}, pool, dev)
        recon.lo_views = {k: T[k] for k in lo}
        recon.cf_pool_dev = pool_d
        if recon.had_eager:
            planes = upload_planes(pic.planes, dev)
        else:
            planes = [torch.zeros(p.shape, dtype=torch.int32, device=dev)
                      for p in pic.planes]
    bounds = [recon._ref_bounds(int(bool(pi))) for pi in range(n_planes)]
    run_passes(T, refs, planes, bounds, pool_d, bd, f.ss_hor, f.ss_ver)
    recon._finish_device_planes(planes)


def run_passes(T, refs, planes, bounds, pool_d, bd, ss_hor, ss_ver):
    """The frame's passes in order, in place on `planes` (one int32
    tensor a plane, on one device): T the uploaded tables
    (_plane_tables' keys), refs per plane its reference planes, bounds
    per plane its (rh, rw), pool_d the coefficient pool on the
    device."""
    dev = planes[0].device
    n_planes = len(planes)
    per_plane = [(refs[pi], planes[pi], *bounds[pi])
                 for pi in range(n_planes)]

    with timing.phase("inter.puts"):
        if "put" in T:
            mc.put_planes(per_plane, T["put"], bd, blocks=T["put_blocks"])

    with timing.phase("inter.warps"):
        if "warp" in T:
            mc_warp.warp_planes(per_plane, T["warp"], bd)

    with timing.phase("inter.comps"):
        seg = None
        if n_planes > 1 and any(("comp", pi) in T for pi in range(n_planes)):
            seg = torch.zeros(planes[-1].shape, dtype=torch.int32,
                              device=dev)
        for pi in range(n_planes):        # luma (seg producer) first
            if ("comp", pi) in T:
                mc.comp(refs[pi], T["comp", pi], planes[pi], seg,
                        *bounds[pi], bd, pi == 0, ss_hor, ss_ver,
                        blocks=T["comp_blocks", pi])

    with timing.phase("inter.obmc"):
        laps = [T.get(("obmc", top)) for top in (1, 0)]
        if any(t is not None for t in laps):   # top laps before left laps
            mc_obmc.obmc_planes(per_plane, *laps, bd)

    with timing.phase("inter.residuals"):
        for pi in range(n_planes):
            if ("res", pi) in T:
                itx.itx_add(pool_d, T["res", pi], planes[pi], bd,
                            blocks=T["res_blocks", pi])
            if ("wht", pi) in T:
                itx.itx_add(pool_d, T["wht", pi], planes[pi], bd, wht=True)
