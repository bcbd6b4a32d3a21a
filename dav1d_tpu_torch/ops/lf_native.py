"""ctypes binding for the native loop-filter mask construction
(native/lfmask.cpp): fills the dense per-4x4-edge class/level grids
straight from the raw Stage-A block records, one call per tile in
decode order. ops/lf_ref.build_lf_masks remains the golden model
(DAV1D_TPU_LFMASK=numpy forces it)."""
from __future__ import annotations

import ctypes as ct
import os

import numpy as np

from ..entropy import levels as lv
from ..entropy import native, native_tile
from .lf_ref import LfMasks

u8p = ct.POINTER(ct.c_uint8)
i8p = ct.POINTER(ct.c_int8)
i32p = ct.POINTER(ct.c_int32)


class _LfMaskCtx(ct.Structure):
    _fields_ = [
        ("w4", ct.c_int32), ("h4", ct.c_int32),
        ("cw4", ct.c_int32), ("ch4", ct.c_int32),
        ("ss_hor", ct.c_int32), ("ss_ver", ct.c_int32),
        ("layout", ct.c_int32), ("lossless", ct.c_int32 * 8),
    ]


class _Grids(ct.Structure):
    _fields_ = [
        ("lvl", u8p), ("vcls_y", i8p), ("hcls_y", i8p),
        ("vcls_uv", i8p), ("hcls_uv", i8p),
        ("txw", u8p), ("txh", u8p), ("ctxw", u8p), ("ctxh", u8p),
    ]


def _load():
    if not native.available():
        return None
    lib = native._lib
    try:
        fn = lib.build_lf_masks_tile
    except AttributeError:
        return None
    fn.restype = None
    fn.argtypes = [ct.c_void_p, i32p, i32p, i32p, ct.c_int64,
                   ct.c_void_p]
    return lib


_lib = _load()
_TI = None


def available() -> bool:
    return _lib is not None and \
        os.environ.get("DAV1D_TPU_LFMASK", "native") == "native"


def _ti():
    global _TI
    if _TI is None:
        ti = np.ascontiguousarray(
            [[t.w, t.h, t.lw, t.lh, t.sub] for t in lv.TXFM_INFO],
            np.int32)
        bd = np.ascontiguousarray(lv.block_dimensions, np.int32)
        _TI = (ti, bd)
    return _TI


def build_lf_masks_native(plan):
    """Native mask build; returns an LfMasks or None (caller falls
    back to the golden model)."""
    if not available() or not native_tile.native_complete(plan):
        return None
    f = plan.f
    m = LfMasks(f)
    c = _LfMaskCtx()
    c.w4, c.h4 = f.w4, f.h4
    c.cw4, c.ch4 = m.cw4, m.ch4
    c.ss_hor, c.ss_ver = f.ss_hor, f.ss_ver
    c.layout = int(f.layout)
    for i in range(8):
        c.lossless[i] = int(f.frame_hdr.segmentation.lossless[i])
    ti, _bd = _ti()
    g = _Grids(
        m.lvl.ctypes.data_as(u8p),
        m.vcls_y.ctypes.data_as(i8p), m.hcls_y.ctypes.data_as(i8p),
        m.vcls_uv.ctypes.data_as(i8p), m.hcls_uv.ctypes.data_as(i8p),
        m.txw.ctypes.data_as(u8p), m.txh.ctypes.data_as(u8p),
        m.ctxw.ctypes.data_as(u8p), m.ctxh.ctypes.data_as(u8p))
    for tile in plan.native_tiles:
        blocks = tile["blocks"]
        if not blocks.flags["C_CONTIGUOUS"]:
            return None
        _lib.build_lf_masks_tile(
            ct.addressof(c), ti.ctypes.data_as(i32p),
            _ti()[1].ctypes.data_as(i32p),
            blocks.ctypes.data_as(i32p), len(blocks), ct.addressof(g))
    return m
