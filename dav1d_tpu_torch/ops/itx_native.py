"""ctypes binding for the native inverse-transform engine
(native/itxnat.cpp): host-side scalar residual computation straight
from the Stage-A coefficient records — no Python per-block walk, no
device roundtrip. This is the residual path of intra frames and host
walks when the native library is present; ops/itx_ref.py is the numpy
golden (DAV1D_TPU_ITX=numpy, or no native library). Inter frames'
residuals are added on the device (ops/itx.py, csrc/itx_add.cu).
"""
from __future__ import annotations

import ctypes as ct

import numpy as np

from .. import tables
from ..entropy import levels as lv
from ..entropy import native, native_tile
from .itx_ref import TX_SHIFT, TX1D_TYPES

u8p = ct.POINTER(ct.c_uint8)
i32p = ct.POINTER(ct.c_int32)
i64p = ct.POINTER(ct.c_int64)


class _ItxTables(ct.Structure):
    _fields_ = [
        ("txfm_info", i32p), ("tx_shift", i32p), ("tx1d_types", i32p),
        ("lastcol", u8p), ("lastcol_off", i32p),
    ]


_CTX = None     # (struct, keepalive arrays, wh_per_tx)


def _load():
    if not native.available():
        return None
    lib = native._lib
    try:
        fn = lib.itx_batch_residuals
    except AttributeError:
        return None
    fn.restype = ct.c_int64
    fn.argtypes = [ct.c_void_p, i32p, ct.c_int64, i32p, ct.c_int32,
                   i32p, i64p]
    lib.itx_block_residual.restype = None
    lib.itx_block_residual.argtypes = [
        ct.c_void_p, i32p, ct.c_int32, ct.c_int32, ct.c_int32,
        ct.c_int32, i32p]
    return lib


_lib = _load()


def available() -> bool:
    return _lib is not None


def _ctx():
    global _CTX
    if _CTX is None:
        txfm_info = np.ascontiguousarray(
            [[ti.w, ti.h, ti.lw, ti.lh] for ti in lv.TXFM_INFO], np.int32)
        tx_shift = np.ascontiguousarray(
            [TX_SHIFT[t] for t in range(19)], np.int32)
        t1d = np.zeros((16, 2), np.int32)
        for txtp, (a, b) in TX1D_TYPES.items():
            t1d[txtp] = (a, b)
        lcs = [tables.lastcol_from_eob(t) for t in range(19)]
        off = np.zeros(19, np.int32)
        pos = 0
        for t, lc in enumerate(lcs):
            off[t] = pos
            pos += len(lc)
        lastcol = np.ascontiguousarray(np.concatenate(lcs), np.uint8)
        keep = (txfm_info, tx_shift, np.ascontiguousarray(t1d),
                lastcol, np.ascontiguousarray(off))
        st = _ItxTables(
            keep[0].ctypes.data_as(i32p), keep[1].ctypes.data_as(i32p),
            keep[2].ctypes.data_as(i32p), keep[3].ctypes.data_as(u8p),
            keep[4].ctypes.data_as(i32p))
        wh = np.array([ti.w * ti.h * 16 for ti in lv.TXFM_INFO], np.int64)
        _CTX = (st, keep, wh)
    return _CTX


def block_residual(cf: np.ndarray, eob: int, tx: int, txtp: int,
                   bd: int) -> np.ndarray:
    """Single-block residual (h, w) int32 — test/debug entry."""
    st, _, _ = _ctx()
    ti = lv.TXFM_INFO[tx]
    res = np.empty(ti.h * 4 * ti.w * 4, np.int32)
    cfa = np.ascontiguousarray(cf, np.int32)
    _lib.itx_block_residual(ct.addressof(st), cfa.ctypes.data_as(i32p),
                            eob, tx, txtp, bd, res.ctypes.data_as(i32p))
    return res.reshape(ti.h * 4, ti.w * 4)


def precompute_native(plan, bitdepth: int) -> bool:
    """Compute the residual pools for every native tile and stash them
    in the tile records — CoefBlock.res materializes lazily from them
    (entropy/decode.py). Returns False when the plan has no (complete)
    native Stage-A output — caller falls back."""
    if _lib is None or not native_tile.native_complete(plan):
        return False
    st, _, wh = _ctx()
    for t in plan.native_tiles:
        if "res_off" in t:
            continue            # already computed for this tile
        coefs = t["coefs"]
        n = len(coefs)
        if n == 0:
            t["res_off"] = np.empty(0, np.int64)
            t["res_pool"] = np.empty(0, np.int32)
            continue
        cfp = t["cf_pool"]
        eligible = coefs[:, 5] >= 0
        cap = int(wh[coefs[eligible, 3]].sum())
        res_pool = np.empty(cap, np.int32)
        res_off = np.empty(n, np.int64)
        coefs_c = coefs if coefs.flags.c_contiguous else \
            np.ascontiguousarray(coefs)
        _lib.itx_batch_residuals(
            ct.addressof(st), coefs_c.ctypes.data_as(i32p), n,
            cfp.ctypes.data_as(i32p), bitdepth,
            res_pool.ctypes.data_as(i32p), res_off.ctypes.data_as(i64p))
        t["res_off"] = res_off
        t["res_pool"] = res_pool
    return True
