"""ctypes binding for the native inter-job emitter
(native/interjobs.cpp): walks the dense Stage-A block pools in C++ and
emits the compact PUT/WARP/OBMC/COMP/RES job tables consumed by
recon/inter_device.py, plus the leftover list (blocks that need the
golden host path). This removes the per-block Python materialize +
job-collection walk from the hot path — the reference's equivalent
seam never re-boxes block state either (src/recon_tmpl.c:1557-1986).

The Python collector walk in inter_device.py remains the golden model
(DAV1D_TPU_INTERJOBS=python forces it)."""
from __future__ import annotations

import ctypes as ct
import os

import numpy as np

from ..entropy import levels as lv
from ..entropy import native, native_tile
from ..ops import mc_ref

u8p = ct.POINTER(ct.c_uint8)
i32p = ct.POINTER(ct.c_int32)


class _InterJobCtx(ct.Structure):
    _fields_ = [
        ("bw", ct.c_int32), ("bh", ct.c_int32),
        ("ss_hor", ct.c_int32), ("ss_ver", ct.c_int32),
        ("layout", ct.c_int32),
        ("svc_scaled", ct.c_int32 * 7),
        ("gmv_warp_allowed", ct.c_int32 * 7),
        ("gmv", (ct.c_int32 * 11) * 7),
        ("jnt_weights", (ct.c_int32 * 7) * 7),
        ("b4_filter0", u8p), ("b4_filter1", u8p),
        ("r_mv", i32p), ("r_ref", i32p), ("r_bs", i32p),
        ("rf_w4a", ct.c_int32),
        ("block_dimensions", i32p),
        ("filter_2d", i32p), ("f2d_cols", ct.c_int32),
        ("filter2d_to_type", i32p),
        ("puts", i32p), ("puts_cap", ct.c_int64), ("n_puts", ct.c_int64),
        ("warps", i32p), ("warps_cap", ct.c_int64),
        ("n_warps", ct.c_int64),
        ("obmc", i32p), ("obmc_cap", ct.c_int64), ("n_obmc", ct.c_int64),
        ("comp", i32p), ("comp_cap", ct.c_int64), ("n_comp", ct.c_int64),
        ("res", i32p), ("res_cap", ct.c_int64), ("n_res", ct.c_int64),
        ("left", i32p), ("left_cap", ct.c_int64), ("n_left", ct.c_int64),
    ]


class _TileDesc(ct.Structure):
    _fields_ = [
        ("blocks", i32p), ("n_blocks", ct.c_int64),
        ("coefs", i32p), ("n_coefs", ct.c_int64),
        ("col_start", ct.c_int32), ("col_end", ct.c_int32),
        ("row_start", ct.c_int32), ("row_end", ct.c_int32),
        ("block_base", ct.c_int32), ("tile_idx", ct.c_int32),
    ]


def _load():
    if not native.available():
        return None
    lib = native._lib
    try:
        fn = lib.emit_inter_jobs
    except AttributeError:
        return None
    fn.restype = ct.c_int
    fn.argtypes = [ct.c_void_p, ct.c_void_p, ct.c_int]
    return lib


_lib = _load()
_TABLES = None


def available() -> bool:
    return _lib is not None and \
        os.environ.get("DAV1D_TPU_INTERJOBS", "native") == "native"


def _tables():
    global _TABLES
    if _TABLES is None:
        bd = np.ascontiguousarray(lv.block_dimensions, np.int32)
        f2d = np.ascontiguousarray(lv.filter_2d, np.int32)
        f2t = np.ascontiguousarray(mc_ref.FILTER2D_TO_TYPE, np.int32)
        _TABLES = (bd, f2d, f2t)
    return _TABLES


def _p(arr, typ=i32p):
    return arr.ctypes.data_as(typ)


def emit(plan, f, jnt_weights):
    """Run the native walk; returns a dict of int32 job arrays
    {puts, warps, obmc, comp, res, leftovers} or None when the native
    path can't serve this frame (caller falls back to the Python
    collector walk)."""
    # the emitter walks ONLY native-parsed tiles; a mixed native/Python
    # Stage A must use the Python collector walk
    if not available() or not native_tile.native_complete(plan) or \
            f.rf is None:
        return None
    tiles = plan.native_tiles
    for t in tiles:
        if not (t["blocks"].flags["C_CONTIGUOUS"] and
                t["coefs"].flags["C_CONTIGUOUS"]):
            return None
    fh = f.frame_hdr
    c = _InterJobCtx()
    c.bw, c.bh = f.bw, f.bh
    c.ss_hor, c.ss_ver = f.ss_hor, f.ss_ver
    c.layout = int(f.layout)
    for i in range(7):
        c.svc_scaled[i] = int(bool(f.svc[i][0][0]))
        c.gmv_warp_allowed[i] = int(f.gmv_warp_allowed[i])
        g = fh.gmv[i]
        for k in range(6):
            c.gmv[i][k] = int(g.matrix[k])
        c.gmv[i][6] = int(g.alpha)
        c.gmv[i][7] = int(g.beta)
        c.gmv[i][8] = int(g.gamma)
        c.gmv[i][9] = int(g.delta)
        c.gmv[i][10] = int(g.type)
    jw = np.asarray(jnt_weights, np.int32)
    for i in range(7):
        for j in range(7):
            c.jnt_weights[i][j] = int(jw[i, j])
    b4f = plan.b4_filter
    if not b4f.flags["C_CONTIGUOUS"]:
        b4f = np.ascontiguousarray(b4f)
    c.b4_filter0 = _p(b4f[0], u8p)
    c.b4_filter1 = _p(b4f[1], u8p)
    rf = f.rf
    for g in (rf.r_mv, rf.r_ref, rf.r_bs):
        if not g.flags["C_CONTIGUOUS"] or g.dtype != np.int32:
            return None
    c.r_mv = _p(rf.r_mv)
    c.r_ref = _p(rf.r_ref)
    c.r_bs = _p(rf.r_bs)
    c.rf_w4a = rf.r_mv.shape[1]
    bdt, f2d, f2t = _tables()
    c.block_dimensions = _p(bdt)
    c.filter_2d = _p(f2d)
    c.f2d_cols = f2d.shape[1]
    c.filter2d_to_type = _p(f2t)

    nb = sum(len(t["blocks"]) for t in tiles)
    ncf = sum(len(t["coefs"]) for t in tiles)
    cells = f.bw * f.bh
    caps = dict(puts=4 * nb + 64, warps=cells // 2 + 2 * nb + 64,
                obmc=8 * nb + 64, comp=3 * nb + 64, res=ncf + 4,
                left=nb + 4)
    widths = dict(puts=11, warps=12, obmc=13, comp=25, res=7, left=3)

    tds = (_TileDesc * len(tiles))()
    for i, t in enumerate(tiles):
        td = tds[i]
        td.blocks = _p(t["blocks"])
        td.n_blocks = len(t["blocks"])
        td.coefs = _p(t["coefs"])
        td.n_coefs = len(t["coefs"])
        td.col_start, td.col_end = t["col_start"], t["col_end"]
        td.row_start, td.row_end = t["row_start"], t["row_end"]
        td.block_base = t["block_base"]
        td.tile_idx = t["tile_idx"]

    for _attempt in range(6):
        bufs = {k: np.empty((caps[k], widths[k]), np.int32)
                for k in caps}
        for k in caps:
            setattr(c, k, _p(bufs[k]))
            setattr(c, k + "_cap", caps[k])
        ret = _lib.emit_inter_jobs(ct.addressof(c), ct.addressof(tds),
                                   len(tiles))
        if ret == 0:
            return dict(
                puts=bufs["puts"][:c.n_puts].copy(),
                warps=bufs["warps"][:c.n_warps].copy(),
                obmc=bufs["obmc"][:c.n_obmc].copy(),
                comp=bufs["comp"][:c.n_comp].copy(),
                res=bufs["res"][:c.n_res].copy(),
                leftovers=bufs["left"][:c.n_left].copy())
        if ret == 2:     # a table overflowed: double everything, retry
            caps = {k: v * 2 for k, v in caps.items()}
            continue
        return None
    return None
