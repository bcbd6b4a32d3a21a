"""Inverse transforms — scalar-exact reference implementation.

Implements AV1's normative inverse DCT/ADST/identity/WHT butterfly
networks (spec §7.13.3) with the exact rounding, shift, and
intermediate-clamp semantics the reference uses
(reference src/itx_1d.c:66-1017, src/itx_tmpl.c:43-121). All arithmetic
is int64 numpy, so the reference's anti-overflow constant-splitting
tricks reduce to the plain spec formulas (they are bit-identical in wide
integers — itx_1d.c:39-63 explains the equivalence).

Functions operate on (batch, n) arrays, vectorizing each 1-D pass over
all rows/columns at once. A copy of dav1d_tpu's ops/itx_ref.py for the
host golden walks (recon/inter_ref.py, recon/intra_ref.py), without its
device backend: residuals come from the native engine
(ops/itx_native.py over native/itxnat.cpp) or from the numpy batch
below.

Memory layout matches the decoder's coefficient order: cf[rc] with
rc = x * min(h,32) + y (x-major / transposed), as produced by
entropy/decode.py and consumed at itx_tmpl.c:98-105.
"""
from __future__ import annotations

import numpy as np

from .. import tables
from ..entropy import levels as lv

I64 = np.int64


def _r12(v):
    return (v + 2048) >> 12


def _r11(v):
    return (v + 1024) >> 11


def _half_btf(a, ca, b, cb):
    """(a*ca + b*cb + 2048) >> 12 — the spec's B() rotation half."""
    return (a * ca + b * cb + 2048) >> 12


def _sqrt2(v):
    return (v * 181 + 128) >> 8


# ---------------------------------------------------------------------------
# 1-D transforms: f(x: (B, n_in) int64, mn, mx) -> (B, n_out) int64
# ---------------------------------------------------------------------------

from . import itx_core
from .itx_core import DCT, ADST, FLIPADST, IDENTITY


def _run_1d(fn, x, mn, mx):
    """Apply a core 1-D transform to a batch: x (B, n_in) int64 ->
    (B, n_out) int64 (itx_core butterflies over numpy columns)."""
    cols = [x[:, i] for i in range(x.shape[1])]

    def C(v):
        # in-place ufunc pair: ~4x cheaper than np.clip's dispatch on
        # the short vectors the butterfly network produces
        v = np.asarray(v)
        np.maximum(v, mn, out=v)
        np.minimum(v, mx, out=v)
        return v

    return np.stack(fn(cols, C), axis=1)


def wht4(x):
    return np.stack(itx_core.wht4([x[:, i] for i in range(4)]), axis=1)


_1D_FNS = {k: (lambda f: (lambda x, mn, mx: _run_1d(f, x, mn, mx)))(f)
           for k, f in itx_core.FNS.items()}


# Decoded txtp -> (first-pass type, second-pass type) in the transposed
# coefficient layout. Because cf[] is stored x-major, the reference's DSP
# init cross-assigns vertical/horizontal variants (itx_tmpl.c:230-251:
# itxfm_add[ADST_DCT] = ..dct_adst.., [H_DCT] = ..dct_identity..); the net
# effect is the reversed pair of itx_1d.c:1043's dav1d_tx1d_types.
TX1D_TYPES = {
    lv.DCT_DCT: (DCT, DCT), lv.ADST_DCT: (DCT, ADST),
    lv.DCT_ADST: (ADST, DCT), lv.ADST_ADST: (ADST, ADST),
    lv.FLIPADST_DCT: (DCT, FLIPADST), lv.DCT_FLIPADST: (FLIPADST, DCT),
    lv.FLIPADST_FLIPADST: (FLIPADST, FLIPADST),
    lv.ADST_FLIPADST: (FLIPADST, ADST), lv.FLIPADST_ADST: (ADST, FLIPADST),
    lv.IDTX: (IDENTITY, IDENTITY), lv.V_DCT: (IDENTITY, DCT),
    lv.H_DCT: (DCT, IDENTITY), lv.V_ADST: (IDENTITY, ADST),
    lv.H_ADST: (ADST, IDENTITY), lv.V_FLIPADST: (IDENTITY, FLIPADST),
    lv.H_FLIPADST: (FLIPADST, IDENTITY),
}

# per-rect-tx inter-pass shift (reference itx_tmpl.c:160-178 instantiation)
TX_SHIFT = {
    lv.TX_4X4: 0, lv.RTX_4X8: 0, lv.RTX_4X16: 1, lv.RTX_8X4: 0,
    lv.TX_8X8: 1, lv.RTX_8X16: 1, lv.RTX_8X32: 2, lv.RTX_16X4: 1,
    lv.RTX_16X8: 1, lv.TX_16X16: 2, lv.RTX_16X32: 1, lv.RTX_16X64: 2,
    lv.RTX_32X8: 2, lv.RTX_32X16: 1, lv.TX_32X32: 2, lv.RTX_32X64: 1,
    lv.RTX_64X16: 2, lv.RTX_64X32: 1, lv.TX_64X64: 2,
}


def inv_txfm_add(dst: np.ndarray, cf: np.ndarray, eob: int, tx: int,
                 txtp: int, bitdepth: int) -> None:
    """Add the inverse transform of `cf` (decoder rc layout) into
    dst (h, w) uint8/uint16 view. Reference itx_tmpl.c:44-121."""
    t_dim = lv.TXFM_INFO[tx]
    w, h = 4 * t_dim.w, 4 * t_dim.h
    shift = TX_SHIFT[tx]
    is_rect2 = (w * 2 == h) or (h * 2 == w)
    rnd = (1 << shift) >> 1
    bd_max = (1 << bitdepth) - 1
    has_dconly = txtp == lv.DCT_DCT

    if eob < has_dconly:
        dc = int(cf[0])
        if is_rect2:
            dc = (dc * 181 + 128) >> 8
        dc = (dc * 181 + 128) >> 8
        dc = (dc + rnd) >> shift
        dc = (dc * 181 + 128 + 2048) >> 12
        dst[:] = np.clip(dst.astype(np.int32) + dc, 0, bd_max)
        return

    if txtp == lv.WHT_WHT:
        assert w == 4 and h == 4
        dst[:] = np.clip(dst.astype(I64) + _wht_block(cf), 0, bd_max)
        return

    sh, sw = min(h, 32), min(w, 32)
    if bitdepth == 8:
        row_clip_min = col_clip_min = -(1 << 15)
    else:
        row_clip_min = -(bd_max + 1) << 7
        col_clip_min = -(bd_max + 1) << 5
    row_clip_max = ~row_clip_min
    col_clip_max = ~col_clip_min

    first_t, second_t = TX1D_TYPES[txtp]
    first_fn = _1D_FNS[(t_dim.lw + 2, first_t)]
    second_fn = _1D_FNS[(t_dim.lh + 2, second_t)]

    if second_t == IDENTITY and first_t != IDENTITY:
        last_nonzero_col = min(sh - 1, eob)
    elif first_t == IDENTITY and second_t != IDENTITY:
        last_nonzero_col = eob >> (t_dim.lw + 2)
    else:
        last_nonzero_col = int(tables.lastcol_from_eob(tx)[eob])
    assert last_nonzero_col < sh

    # rows: gather coeff[y + x*sh] for y <= last_nonzero_col
    n_rows = last_nonzero_col + 1
    cfm = cf.astype(I64).reshape(sw, sh)     # [x][y]
    rows_in = cfm[:, :n_rows].T.copy()       # (n_rows, sw)
    if is_rect2:
        rows_in = (rows_in * 181 + 128) >> 8
    rows_out = first_fn(rows_in, row_clip_min, row_clip_max)   # (n_rows, w)
    tmp = np.zeros((sh, w), I64)
    tmp[:n_rows] = rows_out
    tmp = np.clip((tmp + rnd) >> shift, col_clip_min, col_clip_max)

    # columns
    cols_out = second_fn(tmp.T.copy(), col_clip_min, col_clip_max)  # (w, h)
    res = cols_out.T  # (h, w)
    dst[:] = np.clip(dst.astype(I64) + ((res + 8) >> 4), 0, bd_max)


def precompute_residuals_plan(plan, bitdepth: int) -> None:
    """Residual pass for a whole frame, preferring the native C++
    engine (ops/itx_native.py over native/itxnat.cpp) which consumes
    the Stage-A record pools directly. DAV1D_TPU_ITX=numpy selects the
    numpy batch, as does a missing native engine."""
    import os
    if os.environ.get("DAV1D_TPU_ITX", "native") != "numpy":
        from . import itx_native
        if itx_native.available() and \
                itx_native.precompute_native(plan, bitdepth):
            return
    precompute_residuals(plan.coefs, bitdepth)


def precompute_residuals(coefs, bitdepth: int) -> None:
    """Batch pass over a frame's CoefBlock list: group by (tx, txtp)
    and run the 2-pass transforms with the block index folded into the
    batch dimension (SURVEY §7 stage-B batching; bit-exact because the
    1-D kernels map zero rows to zero rows). Stores (h, w) pre-shift
    residuals in cb.res; dc-only and WHT blocks keep the scalar path."""
    groups = {}
    for cb in coefs:
        if cb.eob < 1 or cb.txtp == lv.WHT_WHT:
            continue                     # dc-only / skip / lossless
        groups.setdefault((cb.tx, cb.txtp), []).append(cb)

    for (tx, txtp), blocks in groups.items():
        t_dim = lv.TXFM_INFO[tx]
        w, h = 4 * t_dim.w, 4 * t_dim.h
        shift = TX_SHIFT[tx]
        is_rect2 = (w * 2 == h) or (h * 2 == w)
        rnd = (1 << shift) >> 1
        bd_max = (1 << bitdepth) - 1
        sh, sw = min(h, 32), min(w, 32)
        if bitdepth == 8:
            row_clip_min = col_clip_min = -(1 << 15)
        else:
            row_clip_min = -(bd_max + 1) << 7
            col_clip_min = -(bd_max + 1) << 5
        row_clip_max = ~row_clip_min
        col_clip_max = ~col_clip_min
        first_t, second_t = TX1D_TYPES[txtp]
        first_fn = _1D_FNS[(t_dim.lw + 2, first_t)]
        second_fn = _1D_FNS[(t_dim.lh + 2, second_t)]

        if second_t == IDENTITY and first_t != IDENTITY:
            lastcol = [min(sh - 1, cb.eob) for cb in blocks]
        elif first_t == IDENTITY and second_t != IDENTITY:
            lastcol = [cb.eob >> (t_dim.lw + 2) for cb in blocks]
        else:
            lc_tbl = tables.lastcol_from_eob(tx)
            lastcol = [int(lc_tbl[cb.eob]) for cb in blocks]
        n_rows = max(lastcol) + 1
        B = len(blocks)

        cfm = np.stack([cb.cf for cb in blocks]).astype(I64)             .reshape(B, sw, sh)
        rows_in = np.ascontiguousarray(
            cfm[:, :, :n_rows].transpose(0, 2, 1)).reshape(B * n_rows, sw)
        if is_rect2:
            rows_in = (rows_in * 181 + 128) >> 8
        rows_out = first_fn(rows_in, row_clip_min, row_clip_max)             .reshape(B, n_rows, w)
        tmp = np.zeros((B, sh, w), I64)
        tmp[:, :n_rows] = rows_out
        tmp = np.clip((tmp + rnd) >> shift, col_clip_min, col_clip_max)
        cols_in = np.ascontiguousarray(
            tmp.transpose(0, 2, 1)).reshape(B * w, sh)
        cols_out = second_fn(cols_in, col_clip_min, col_clip_max)             .reshape(B, w, h)
        res = ((cols_out.transpose(0, 2, 1) + 8) >> 4).astype(np.int32)
        for i, cb in enumerate(blocks):
            cb.res = res[i]


def add_residual(dst, cb, bitdepth: int) -> None:
    """Add a coefficient block's residual into a dst pixel view (uint8
    or uint16)."""
    if cb.res is not None:
        v = dst.astype(np.int32)
        v += cb.res
        np.clip(v, 0, (1 << bitdepth) - 1, out=v)
        dst[:] = v.astype(dst.dtype)
        return
    tmp = dst.astype(np.uint16)
    inv_txfm_add(tmp, cb.cf, cb.eob, cb.tx, cb.txtp, bitdepth)
    dst[:] = tmp.astype(dst.dtype)


def _wht_block(cf: np.ndarray) -> np.ndarray:
    """Lossless 4x4 WHT residual (reference itx_tmpl.c:184-203):
    tmp rows gather coeff[y + x*4] >> 2, 1-D WHT per row then per column,
    output row-major (h, w)."""
    c = (cf.astype(I64).reshape(4, 4) >> 2)   # [x][y] layout
    rows = wht4(c.T.copy())                   # tmp rows (y, x)
    cols = wht4(rows.T.copy())                # per column x over y
    return cols.T                             # (y, x)
