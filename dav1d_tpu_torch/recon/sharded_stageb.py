"""Whole-pipeline sharded Stage B: inter MC and residuals, then the
in-loop filters, column-sharded over a mesh's shards.

Port of dav1d_tpu's recon/sharded_stageb.py onto the port's kernels:
the sharded programs of dav1d_tpu are its single-device programs run
per shard, so here each shard runs the port's own kernels on its
window of the planes.

- MC passes (puts, warps, compounds, OBMC laps, residuals) run per shard
  on a left-apron extended local plane (APRON_L luma columns, chroma
  APRON_L >> ss_hor): jobs partition to every shard whose owned columns
  their destination rect intersects (`_partition`), destination x
  translates to local space, and writes past the local plane drop in
  the kernels (each guards px < dst_w; the apron covers the widest
  block, so no translated px is negative). OBMC and residual reads are
  elementwise in destination coordinates, so apron garbage only makes
  apron outputs, which are discarded. Reference planes are on each
  shard's device (one copy a device); no exchange runs inside the MC
  passes.
- The in-loop filters couple neighbouring shards and read real
  neighbour columns (parallel/sharded.py `window`, `halo_exchange`):
  the deblock on halo-extended shards with the ownership-shifted
  stitch-back; CDEF and loop restoration on windows cropped so that a
  window's own edges are the frame's (shard 0 has no left halo, the
  crop ends at the frame's width), since both kernels fill or clamp at
  the edges of what they are given. Each stage computes its boundary
  region redundantly inside the halo and keeps only its owned columns,
  bit-exactly.
- Super-res resamples whole rows: the coded-width planes gather to the
  decode's device, run there as on one device (ops/superres.py), and
  re-shard at the output width.
- Between passes the planes stay on the devices as column-sharded
  planes: per plane a list of T (Hp, sw) int32 tensors, shard s on its
  device, covering the 128-aligned padded plane (`_shard_widths`). The
  finished frame gathers once into the reference planes the next frame
  reads (`Picture.dev` on the decode's device, a copy on each other
  device of the mesh in `Picture.dev_rep`).

The single-device path (recon/inter_device.py + recon/filters.py) is
the oracle: the sharded decode is md5-identical to it at every shard
count (tests/test_torch_sharded.py).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.cuda_build import device_guard
from ..ops.device import fetch_rows, upload, upload_planes
from ..parallel.sharded import (HALO, distinct, halo_exchange,
                                norm_device, stitch, window)
from ..utils import timing
from .inter_device import DeviceInterReconstructor, reconstruct_with

OOB = 1 << 20      # px / py of a padding row of _partition's tables
APRON_L = 128      # MC left apron = max luma block width


def _shard_widths(plan, T, out=False):
    """Owned column-band widths per plane kind, covering the FULL
    128-aligned padded plane (prediction overshoot and edge filters
    live in the padding, exactly like the single-device kernels). Luma
    bands are 64-aligned so chroma stays 32-aligned (halo- and
    8x8-block-aligned)."""
    f = plan.f
    aw = (f.frame_hdr.width[1 if out else 0] + 127) & ~127
    sw = max(64, ((-(-aw // T) + 63) // 64) * 64)
    return sw, sw >> f.ss_hor


def to_sharded(src, T, sw, devices):
    """A host (Hp, W) numpy plane or an (Hp, W) tensor -> the
    column-sharded plane: T int32 (Hp, sw) tensors, shard s on
    devices[s] holding columns [s*sw, (s+1)*sw) of src, zeros past its
    width."""
    H, W = src.shape
    out = []
    for s, d in enumerate(devices):
        a, b = s * sw, min((s + 1) * sw, W)
        t = torch.zeros((H, sw), dtype=torch.int32, device=d)
        if b > a:
            if isinstance(src, np.ndarray):
                t[:, :b - a] = upload_planes([src[:, a:b]], d)[0]
            else:
                t[:, :b - a] = src[:, a:b]
        out.append(t)
    return out


def gather(shards, W, device):
    """Columns [0, W) of a column-sharded plane as one (Hp, W) int32
    tensor on `device`."""
    H, sw = shards[0].shape
    out = torch.empty((H, W), dtype=torch.int32, device=device)
    for s, t in enumerate(shards):
        a, b = s * sw, min((s + 1) * sw, W)
        if b > a:
            out[:, a:b] = t[:, :b - a]
    return out


# ---------------------------------------------------------------------------
# job partitioning
# ---------------------------------------------------------------------------

def _partition(tbl, px_col, py_col, widths, T, sw, apron):
    """Distribute an (n, K) job table to shards: each job lands on every
    shard whose owned band [s*sw, (s+1)*sw) its dst rect [px, px+w)
    intersects, with px translated to px - s*sw + apron (>= 1 for every
    assigned job since apron covers the widest block). Returns
    ((T, m, K) int32, (T, m) source-row map or -1); padding rows carry
    py=px=OOB."""
    K = tbl.shape[1]
    n = len(tbl)
    if n == 0:
        out = np.zeros((T, 1, K), np.int32)
        out[:, :, px_col] = OOB
        out[:, :, py_col] = OOB
        return out, np.full((T, 1), -1, np.int64)
    px = tbl[:, px_col].astype(np.int64)
    w = np.broadcast_to(np.asarray(widths, np.int64), (n,))
    lo = np.clip(px // sw, 0, T - 1)
    hi = np.clip((px + w - 1) // sw, 0, T - 1)
    reps = hi - lo + 1
    rows = np.repeat(np.arange(n), reps)
    cum = np.cumsum(reps)
    offs = np.arange(cum[-1]) - np.repeat(cum - reps, reps)
    shards = lo[rows] + offs
    order = np.argsort(shards, kind="stable")
    rows_s = rows[order]
    shards_s = shards[order]
    counts = np.bincount(shards_s, minlength=T)
    m = 1 << max(2, int(counts.max() - 1).bit_length())
    out = np.zeros((T, m, K), np.int32)
    out[:, :, px_col] = OOB
    out[:, :, py_col] = OOB
    src = np.full((T, m), -1, np.int64)
    pos = np.arange(len(rows_s)) - np.repeat(np.cumsum(counts) - counts,
                                             counts)
    out[shards_s, pos] = tbl[rows_s]
    out[shards_s, pos, px_col] = (tbl[rows_s, px_col]
                                  - shards_s * sw + apron).astype(np.int32)
    src[shards_s, pos] = rows_s
    return out, src


def _job_widths(kind, t):
    """Destination widths of an emitter table's rows (the rect
    _partition intersects with the bands)."""
    from ..entropy import levels as lv
    if kind == "warps":
        return 8
    if kind == "obmc":             # the blended region (mc_obmc blend_dims)
        return np.where(t[:, 0] == 1, t[:, 2], (t[:, 2] * 3) >> 2)
    if kind == "res":
        return 4 * np.array([x.w for x in lv.TXFM_INFO], np.int64)[t[:, 1]]
    return t[:, 2]                 # puts, comp


# per emitter table: (plane column, px column, py column)
_COLS = {"puts": (0, 4, 3), "warps": (0, 2, 1), "obmc": (1, 6, 5),
         "comp": (0, 4, 3), "res": (0, 4, 3)}


def shard_jobs(jobs, T, sws, aprons):
    """The emitter's tables ({kind: (n, K)} of _COLS' kinds) split into T
    per-shard tables of the same layout, destination x local to each
    shard's apron-extended plane (per plane index its band width sws[pi]
    and apron aprons[pi])."""
    out = [{} for _ in range(T)]
    for kind, (pcol, pxcol, pycol) in _COLS.items():
        tbl = np.asarray(jobs[kind], np.int32)
        parts = [[] for _ in range(T)]
        for pi in range(len(sws)):
            sub = tbl[tbl[:, pcol] == pi]
            if not len(sub):
                continue
            t, src = _partition(sub, pxcol, pycol, _job_widths(kind, sub), T,
                                sws[pi], aprons[pi])
            if (t[src >= 0][:, pxcol] < 0).any():
                raise ValueError(f"a {kind} job reaches past the "
                                 f"{aprons[pi]}-column apron")
            for s in range(T):
                parts[s].append(t[s][src[s] >= 0])
        for s in range(T):
            out[s][kind] = (np.concatenate(parts[s]) if parts[s]
                            else tbl[:0])
    return out


# ---------------------------------------------------------------------------
# inter Stage B: the MC and residual passes per shard
# ---------------------------------------------------------------------------

def ref_planes_on(pic, device, main):
    """A reference picture's clean int32 planes on `device`: its planes
    on the decode's device `main` (uploaded from its host planes when it
    has none), copied once to any other device and kept there
    (pic.dev_rep)."""
    from ..ops.device import planes_on_device
    dev = planes_on_device(pic, main)
    if device == main:
        return dev
    with pic.lock:
        rep = pic.dev_rep if pic.dev_rep is not None else {}
        planes = rep.get(device)
        if planes is None:
            planes = rep[device] = [p.to(device) for p in dev]
            pic.dev_rep = rep
    return planes


class ShardedInterReconstructor(DeviceInterReconstructor):
    """Inter Stage B with the MC and residual passes column-sharded over
    the mesh's shards (`devices`, parallel/sharded.py resolve_mesh).
    Leftover blocks and res_fixups replay on the host after the shards'
    planes are fetched (the device leftover route is not taken)."""

    def __init__(self, plan, refp, device, devices, pool=None):
        super().__init__(plan, refp, device, pool)
        self.shard_devices = devices

    def run_native(self, jobs):
        self.leftovers = np.asarray(jobs["leftovers"],
                                    np.int64).reshape(-1, 3)
        self._execute(jobs)
        if len(self.leftovers):
            with timing.phase("inter.leftovers"):
                self._replay_leftovers()
        return self.pic

    def _execute(self, jobs):
        execute_sharded(self, jobs)

    def _ref_planes_on(self, device):
        """_ref_planes with each reference's planes on `device`."""
        n_planes = len(self.pic.planes)
        main = norm_device(self.device)
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
                dev = ref_planes_on(pic, device, main)
                for pi in range(n_planes):
                    per_plane[pi].append(dev[pi])
            lut[i] = ids[id(pic)]
        return per_plane, lut


def _ext_from_host(hp, s, sw, apron, device):
    """Columns [s*sw - apron, (s+1)*sw) of a host plane (zeros outside
    it) as an int32 tensor on `device`."""
    H, W = hp.shape
    x0 = s * sw - apron
    t = torch.zeros((H, apron + sw), dtype=torch.int32, device=device)
    a, b = max(0, x0), min(W, (s + 1) * sw)
    if b > a:
        t[:, a - x0:b - x0] = upload_planes([hp[:, a:b]], device)[0]
    return t


def execute_sharded(recon, jobs):
    """The frame's MC and residual passes (ops/mc_fused.py run_passes)
    on every shard: its partitioned, binned tables in one upload, the
    references and the coefficient pool once a device. The planes stay
    on the shards (pic.dev, pic.dev_grid) unless the host has work
    (leftovers, res_fixups): then they are fetched whole into the host
    planes, which the filter chain uploads sharded."""
    from ..ops import mc_fused
    f = recon.f
    pic = recon.pic
    bd = recon.bitdepth
    devices = recon.shard_devices
    T = len(devices)
    n_planes = len(pic.planes)
    sw_l, sw_c = _shard_widths(recon.plan, T)
    sws = [sw_l] + [sw_c] * (n_planes - 1)
    aprons = [APRON_L] + [APRON_L >> f.ss_hor] * (n_planes - 1)
    bounds = [recon._ref_bounds(int(bool(pi))) for pi in range(n_planes)]
    with timing.phase("inter.sharded_exec"):
        pool, bases = recon._build_cf_pool()
        parts = shard_jobs(jobs, T, sws, aprons)
        on_dev = {}
        planes = [[None] * T for _ in range(n_planes)]
        for s, dev in enumerate(devices):
            with device_guard(dev):
                if dev not in on_dev:
                    refs, lut = recon._ref_planes_on(dev)
                    on_dev[dev] = (refs, lut, upload(pool, dev))
                refs, lut, pool_d = on_dev[dev]
                tables = mc_fused._plane_tables(parts[s], lut, bases,
                                                n_planes)
                mc_fused.check_pool(tables, len(pool), n_planes)
                tbl, _ = mc_fused._upload(tables, np.zeros(0, np.int32), dev)
                if recon.had_eager:
                    ext = [_ext_from_host(hp, s, sws[pi], aprons[pi], dev)
                           for pi, hp in enumerate(pic.planes)]
                else:
                    ext = [torch.zeros((hp.shape[0], aprons[pi] + sws[pi]),
                                       dtype=torch.int32, device=dev)
                           for pi, hp in enumerate(pic.planes)]
                mc_fused.run_passes(tbl, refs, ext, bounds, pool_d, bd,
                                    f.ss_hor, f.ss_ver)
                for pi in range(n_planes):
                    planes[pi][s] = ext[pi][:, aprons[pi]:]
        if len(recon.leftovers) or recon.res_fixups:
            main = norm_device(recon.device)
            with device_guard(main):
                full = [gather(pl, hp.shape[1], main)
                        for pl, hp in zip(planes, pic.planes)]
                fetch_rows(full, pic.planes,
                           [(0, hp.shape[0]) for hp in pic.planes], bd)
            pic.dev = None
            pic.dev_grid = False
            pic.host_stale = False
        else:
            # the planes stay on the shard grid; the filter chain
            # consumes them sharded and gathers at its end
            pic.dev = planes
            pic.dev_c = None
            pic.dev_grid = True
            pic.host_stale = True


def reconstruct_inter_frame_sharded(plan, refp, device, devices,
                                    pool=None):
    """Stage B of one inter frame column-sharded over `devices` (the
    mesh's shards), the leftover replay's tile calls on `pool` when
    given; the picture's planes stay on the shards (pic.dev_grid), or on
    the host when it had host work or no block ran on the device."""
    return reconstruct_with(ShardedInterReconstructor(plan, refp, device,
                                                      devices, pool))


# ---------------------------------------------------------------------------
# sharded in-loop filter chain
# ---------------------------------------------------------------------------

def deblock_planes_sharded(planes, plan, bd, devices):
    """The deblock over column-sharded planes: ops/lf.py's maps on the
    shard grid grown by HALO // 4 inactive entries a side, each shard's
    slice of them in one upload, one deblock launch a shard over its
    halo-extended planes, then the stitch-back. Returns new planes."""
    from ..ops import lf
    from ..ops.device import device_tables
    T = len(devices)
    with timing.phase("deblock.masks"):
        maps = lf.frame_maps(plan, [(pl[0].shape[0], T * pl[0].shape[1])
                                    for pl in planes])
    out = list(planes)
    if not maps:
        return out
    he = HALO // 4

    def pad(pair):
        return [np.pad(a, ((0, 0), (he, he)), constant_values=fill)
                for a, fill in zip(pair, (-1, 0))]
    maps = [(pi, luma, pad(vm), pad(hm)) for pi, luma, vm, hm in maps]
    exts = {pi: halo_exchange(planes[pi]) for pi, *_ in maps}
    sharp = plan.f.frame_hdr.loopfilter.sharpness
    got = {pi: [None] * T for pi, *_ in maps}
    for s, dev in enumerate(devices):
        def part(a, pi):
            swe = planes[pi][0].shape[1] // 4
            return np.ascontiguousarray(a[:, s * swe:(s + 1) * swe + 2 * he])
        with device_guard(dev):
            with timing.phase("deblock.maps_upload"):
                dm = lf.upload_maps(
                    [(pi, luma, tuple(part(a, pi) for a in vm),
                      tuple(part(a, pi) for a in hm))
                     for pi, luma, vm, hm in maps], dev)
            tb = device_tables(dev)
            with timing.phase("deblock.launch"):
                res = lf.deblock_frame(
                    [(exts[pi][s], luma, vm, hm) for pi, luma, vm, hm in dm],
                    tb["lf_lut_e"][sharp].contiguous(),
                    tb["lf_lut_i"][sharp].contiguous(), bd)
        for (pi, *_), r in zip(dm, res):
            got[pi][s] = r
    for pi, r in got.items():
        out[pi] = stitch(r, planes[pi][0].shape[1])
    return out


def cdef_planes_sharded(planes, plan, bd, devices):
    """CDEF over a frame's column-sharded planes (cdef_shards with the
    frame's block maps, crop and damping, as ops/cdef.py
    cdef_planes_device)."""
    from ..ops import cdef
    f = plan.f
    return cdef_shards(planes, cdef._block_maps(plan, bd), f.bh * 4,
                       f.bw * 4, int(f.layout), bd,
                       f.frame_hdr.cdef.damping + (bd - 8), devices)


def cdef_shards(planes, maps, Hy, Wy, layout, bd, damping, devices):
    """ops/cdef.py cdef_planes' contract (maps: the (6, Hy/8, Wy/8)
    int32 numpy block maps) over column-sharded planes: each shard runs
    the CDEF kernel on its window [g0, g0 + w) of the frame, w the
    window's width cut at the crop's width Wy: shard 0 from column 0,
    the others from HALO columns left of their band, HALO columns
    right of it, so that the kernel's FILL at its crop's left and right
    edges falls where the frame's does (past it only halo outputs,
    which are dropped). A shard wholly past the crop keeps its pixels.
    Returns new planes (the inputs stay: LR reads them)."""
    from ..ops import cdef
    ss_hor = int(layout != 3)
    sw = planes[0][0].shape[1]
    out = [list(p) for p in planes]
    for s, dev in enumerate(devices):
        left = HALO if s else 0
        g0 = s * sw - left
        crop_w = min(left + sw + HALO, Wy - g0)
        if crop_w <= 0:
            continue
        with device_guard(dev):
            wins = [window(planes[k], s, left >> (ss_hor if k else 0),
                           HALO >> (ss_hor if k else 0))
                    for k in range(len(planes))]
            m = upload(np.ascontiguousarray(
                maps[:, :, g0 // 8:(g0 + crop_w) // 8]), dev)
            res = cdef.cdef_planes(wins, m, Hy, crop_w, layout, bd, damping)
        for k, r in enumerate(res):
            sh = ss_hor if k else 0
            out[k][s] = r[:, left >> sh:(left + sw) >> sh]
    return out


def lr_planes_sharded(planes, pre_cdef, plan, bd, devices):
    """Loop restoration over a frame's column-sharded planes (lr_shards
    of the frame's items, ops/lr.py plane_items)."""
    from ..ops import lr
    return lr_shards(planes, pre_cdef, lr.plane_items(plan), bd, devices)


def lr_shards(planes, pre_cdef, groups, bd, devices):
    """ops/lr.py lr_planes_device over column-sharded planes (groups:
    plane_items' [(plane, w, hmax, wmax, {"wiener": items, "sgr":
    items})]): each shard restores the output columns of its band,
    items cut to the band, in one Wiener and one SGR call (ops/lr.py
    wiener_frame, sgr_frame) over its windows of the post-CDEF and
    pre-CDEF planes (shard 0 from column 0, the others from HALO columns
    left of their band, HALO columns right of it). The kernels clamp
    columns to a window's valid width, which is the frame's edge
    replication where the window holds the frame's edge and otherwise
    touches only halo outputs (an output reads 3 columns a side).
    Returns new planes."""
    from ..ops import lr
    from ..ops.restore_ref import _sgr_params_tbl
    sgrp = _sgr_params_tbl()
    out = [list(p) for p in planes]
    for s, dev in enumerate(devices):
        left = HALO if s else 0
        runs = {"wiener": [], "sgr": []}
        done = []
        for plane, w, hmax, _wmax, kinds in groups:
            sw = planes[plane][0].shape[1]
            g0 = s * sw - left
            lo, hi = s * sw, min((s + 1) * sw, w)
            cut = {k: [(y, max(x, lo) - g0, min(x + uw, hi) - max(x, lo),
                        sh, e, u) for y, x, uw, sh, e, u in items
                       if x < hi and x + uw > lo]
                   for k, items in kinds.items()}
            if not any(cut.values()):
                continue
            with device_guard(dev):
                src = window(planes[plane], s, left, HALO)
                pre = window(pre_cdef[plane], s, left, HALO)[:src.shape[0]]
                dst = src.clone()
            w_loc = min(w, g0 + src.shape[1]) - g0
            for k, items in cut.items():
                if items:
                    runs[k].append((src, pre, dst, w_loc, hmax, items))
            done.append((plane, dst, sw))
        with device_guard(dev):
            for kind, run in (("wiener", lr.wiener_frame),
                              ("sgr", lr.sgr_frame)):
                sel = runs[kind]
                if sel:
                    run([e[:5] for e in sel],
                        lr.frame_tables(kind, [(items, hmax, src.shape[0])
                                               for src, _, _, _, hmax, items
                                               in sel], sgrp), bd)
        for plane, dst, sw in done:
            out[plane][s] = dst[:, left:left + sw]
    return out


def run_filter_chain_sharded(pic, plan, inloop_filters, device, devices):
    """Sharded equivalent of recon/filters.py run_filter_chain_device.
    pic.dev holds column-sharded planes on entry (pic.dev_grid, set by
    the sharded MC) or None (host pixels, uploaded sharded); the
    finished planes gather into the reference planes on the decode's
    device (pic.dev, with a copy on each other device of the mesh in
    pic.dev_rep), whose download is queued as on one device. Returns
    the final Picture (a new, output-width one on a super-res
    frame)."""
    from .filters import enabled_stages
    f = plan.f
    fh = f.frame_hdr
    T = len(devices)
    main = norm_device(device)
    sw_l, sw_c = _shard_widths(plan, T)
    do_deblock, do_cdef, do_sr, do_lr = enabled_stages(plan, inloop_filters)
    grid = pic.dev is not None and pic.dev_grid
    if not (do_deblock or do_cdef or do_sr or do_lr):
        if grid:
            return _finish(pic.dev, pic, main, devices)
        return pic

    if grid:
        planes = pic.dev
    else:
        with timing.phase("filters.upload"):
            src = pic.dev if pic.dev is not None else pic.planes
            planes = [to_sharded(p, T, sw_l if pi == 0 else sw_c, devices)
                      for pi, p in enumerate(src)]

    if do_deblock:
        with timing.phase("filters.deblock"):
            planes = deblock_planes_sharded(planes, plan, pic.bpc, devices)

    pre_cdef = planes if do_lr else None   # post-deblock lpf snapshot

    if do_cdef:
        with timing.phase("filters.cdef"):
            planes = cdef_planes_sharded(planes, plan, pic.bpc, devices)

    out_pic = pic
    if do_sr:
        # super-res is a whole-row horizontal resample: gather the
        # coded-width planes, run the single-device kernel, re-shard at
        # the output width
        from ..ops.superres import superres_planes_device
        with timing.phase("filters.superres"), device_guard(main):
            full = [gather(pl, hp.shape[1], main)
                    for pl, hp in zip(planes, pic.planes)]
            pre = [gather(pl, hp.shape[1], main)
                   for pl, hp in zip(pre_cdef, pic.planes)] if do_lr else None
            out_pic, full, pre = superres_planes_device(full, pre, plan, pic)
            osw_l, osw_c = _shard_widths(plan, T, out=True)
            planes = [to_sharded(p, T, osw_l if pi == 0 else osw_c, devices)
                      for pi, p in enumerate(full)]
            if do_lr:
                pre_cdef = [to_sharded(p, T, osw_l if pi == 0 else osw_c,
                                       devices) for pi, p in enumerate(pre)]
        pic.dev = None          # the coded-width picture is dropped
        pic.dev_c = None
        pic.dev_rep = None
        pic.dev_grid = False

    if do_lr:
        with timing.phase("filters.lr"):
            planes = lr_planes_sharded(planes, pre_cdef, plan, pic.bpc,
                                       devices)

    return _finish(planes, out_pic, main, devices)


def _finish(planes, pic, main, devices):
    """Gather the column-sharded planes into pic's reference planes on
    `main`, copy them to every other device of the mesh, and queue the
    download (recon/filters.py _keep_and_fetch)."""
    from .filters import _keep_and_fetch
    with timing.phase("filters.gather"), device_guard(main):
        full = [gather(pl, hp.shape[1], main)
                for pl, hp in zip(planes, pic.planes)]
        rep = {d: [p.to(d) for p in full] for d in distinct(devices)
               if d != main}
    pic.dev_grid = False
    pic.dev_rep = rep or None
    _keep_and_fetch(pic, full)
    return pic
