"""ctypes binding for the native intra reconstruction engine
(native/intrarec.cpp): the keyframe recon_b_intra walk and the
intra-leftover replay inside inter frames run as one C++ call per tile
(of a leftover run, per tile that has some) straight off the raw Stage-A
records — no Python per-block walk, no per-pixel ufunc dispatch. A
frame's tile calls run at once on the Stage-B pool the decoder hands in
(ctypes releases the GIL), or one after another without one.

The vectorized-numpy golden model (recon/intra_ref.py + ops/ipred_ref.py)
remains the parity oracle; DAV1D_TPU_INTRA=numpy forces it.
"""
from __future__ import annotations

import ctypes as ct
import os
from concurrent.futures import wait

import numpy as np

from .. import tables
from ..entropy import levels as lv
from ..entropy import native, native_tile
from ..ops import itx_native
from ..utils import timing

u8p = ct.POINTER(ct.c_uint8)
u16p = ct.POINTER(ct.c_uint16)
i8p = ct.POINTER(ct.c_int8)
i32p = ct.POINTER(ct.c_int32)
i64p = ct.POINTER(ct.c_int64)


class _IpredTables(ct.Structure):
    _fields_ = [
        ("sm_weights", u8p), ("dr_intra_derivative", u16p),
        ("filter_intra_taps", i8p), ("block_dimensions", i32p),
    ]


class _IntraCtx(ct.Structure):
    _fields_ = [
        ("planes", ct.c_void_p * 3), ("stride", ct.c_int64 * 3),
        ("bytes_pp", ct.c_int32), ("bd", ct.c_int32),
        ("bw", ct.c_int32), ("bh", ct.c_int32),
        ("ss_hor", ct.c_int32), ("ss_ver", ct.c_int32),
        ("layout", ct.c_int32), ("intra_edge_filter", ct.c_int32),
        ("col_start", ct.c_int32), ("col_end", ct.c_int32),
        ("row_start", ct.c_int32), ("row_end", ct.c_int32),
    ]


def _load():
    if not native.available() or not itx_native.available():
        return None
    lib = native._lib
    try:
        fn = lib.intra_recon_tile
    except AttributeError:
        return None
    fn.restype = ct.c_int32
    fn.argtypes = [ct.c_void_p, ct.c_void_p, ct.c_void_p,
                   i32p, ct.c_int64, i32p, i32p, i32p, u8p,
                   i64p, ct.c_int64]
    return lib


_lib = _load()
_TB = None


def available() -> bool:
    return _lib is not None and \
        os.environ.get("DAV1D_TPU_INTRA", "native") == "native"


def _tb():
    global _TB
    if _TB is None:
        keep = (np.ascontiguousarray(tables.get("dav1d_sm_weights"),
                                     np.uint8),
                np.ascontiguousarray(tables.get("dav1d_dr_intra_derivative"),
                                     np.uint16),
                np.ascontiguousarray(tables.get("dav1d_filter_intra_taps"),
                                     np.int8),
                np.ascontiguousarray(lv.block_dimensions, np.int32))
        st = _IpredTables(
            keep[0].ctypes.data_as(u8p), keep[1].ctypes.data_as(u16p),
            keep[2].ctypes.data_as(i8p), keep[3].ctypes.data_as(i32p))
        _TB = (st, keep)
    return _TB[0]


def _ctx_for(plan, pic, tile):
    f = plan.f
    c = _IntraCtx()
    itemsize = pic.planes[0].dtype.itemsize
    for i in range(3):
        if i < len(pic.planes):
            p = pic.planes[i]
            if p.strides[1] != itemsize:
                return None           # column-strided view: golden path
            c.planes[i] = p.ctypes.data
            c.stride[i] = p.strides[0] // itemsize
        else:
            c.planes[i] = None
            c.stride[i] = 0
    c.bytes_pp = itemsize
    c.bd = pic.bpc
    c.bw, c.bh = f.bw, f.bh
    c.ss_hor, c.ss_ver = f.ss_hor, f.ss_ver
    c.layout = int(f.layout)
    c.intra_edge_filter = f.seq_hdr.intra_edge_filter
    c.col_start = tile["col_start"]
    c.col_end = tile["col_end"]
    c.row_start = tile["row_start"]
    c.row_end = tile["row_end"]
    return c


def _call(plan, pic, tile, sel):
    c = _ctx_for(plan, pic, tile)
    if c is None:
        return False
    blocks = tile["blocks"]
    coefs = tile["coefs"]
    if not (blocks.flags["C_CONTIGUOUS"] and coefs.flags["C_CONTIGUOUS"]):
        return False
    itx_tb = itx_native._ctx()[0]
    if sel is None:
        sel_p, n_sel = None, 0
    else:
        sel = np.ascontiguousarray(sel, np.int64)
        sel_p, n_sel = sel.ctypes.data_as(i64p), len(sel)
    ret = _lib.intra_recon_tile(
        ct.addressof(c), ct.addressof(_tb()), ct.addressof(itx_tb),
        blocks.ctypes.data_as(i32p), len(blocks),
        coefs.ctypes.data_as(i32p),
        tile["cf_pool"].ctypes.data_as(i32p),
        tile["pal_pool"].ctypes.data_as(i32p),
        tile["palidx_pool"].ctypes.data_as(u8p),
        sel_p, n_sel)
    return ret == 0


def _run_tiles(plan, pic, jobs, pool):
    """The engine's calls `jobs`, (tile, sel) pairs, into pic: at once
    when a `pool` is given and more than one tile has work, the first
    on this thread and the rest on the pool (so a decoder of `n_threads`
    runs at most that many calls, its pool holding one thread fewer);
    else one after another on this thread. The tiles read none of each
    other's pixels (intra edges stop at the tile bounds) and write
    disjoint rectangles, so their order does not matter. Every call has
    ended when this returns; True when each succeeded. The calls run at
    once add to the recorder's counter `intra.pool_tiles`."""
    if pool is None or len(jobs) < 2:
        return all(_call(plan, pic, tile, sel) for tile, sel in jobs)
    _tb()                   # the shared read-only tables, built once
    itx_native._ctx()       # before the threads start
    futures = [pool.submit(_call, plan, pic, tile, sel)
               for tile, sel in jobs[1:]]
    timing.count("intra.pool_tiles", len(jobs))
    try:
        ok = _call(plan, pic, *jobs[0])
    finally:
        wait(futures)
    return all([ok] + [f.result() for f in futures])


def reconstruct_intra_frame_native(plan, pool=None):
    """Full keyframe walk, one native call per tile (on `pool` when
    given, see _run_tiles), off the tile records alone (a lazy plan has
    no Python Block objects). Returns the reconstructed Picture, or None
    when the native path can't serve this frame (no or partial native
    Stage-A records, forced off, exotic plane views, a failed tile
    call) — caller falls back to the golden model."""
    if not available() or not native_tile.native_complete(plan):
        return None
    from .picture import Picture
    f = plan.f
    bd = 8 + 2 * f.seq_hdr.hbd if f.seq_hdr.hbd < 2 else 12
    pic = Picture(f.frame_hdr.width[0], f.frame_hdr.height,
                  int(f.layout), bd)
    if not _run_tiles(plan, pic, [(t, None) for t in plan.native_tiles],
                      pool):
        return None     # picture discarded; golden redoes the frame
    return pic


def recon_blocks_native(plan, pic, idxs, pool=None) -> bool:
    """Reconstruct the given plan-block indices (intra blocks inside an
    inter frame, in decode order) natively, one call per tile that has
    some (on `pool` when given, see _run_tiles). Returns False when the
    native path can't serve them (caller replays via the golden path);
    a False from the checks before the calls has written nothing."""
    if not available() or not plan.native_tiles:
        return False
    tiles = plan.native_tiles
    idxs = np.asarray(idxs, np.int64)
    if not len(idxs):
        return True
    # the tile of each index (native_tiles are in decode order)
    base = np.array([t["block_base"] for t in tiles], np.int64)
    end = base + np.array([len(t["blocks"]) for t in tiles], np.int64)
    ti = np.searchsorted(base, idxs, side="right") - 1
    if ti[0] < 0 or (np.diff(ti) < 0).any() or (idxs >= end[ti]).any():
        return False
    starts = np.flatnonzero(np.diff(ti)) + 1
    jobs = [(tiles[ti[s]], part - base[ti[s]])
            for s, part in zip(np.r_[0, starts], np.split(idxs, starts))]
    # dry-run the ctx checks first so failure can't be partial
    for tile, _sel in jobs:
        if _ctx_for(plan, pic, tile) is None:
            return False
    return _run_tiles(plan, pic, jobs, pool)
