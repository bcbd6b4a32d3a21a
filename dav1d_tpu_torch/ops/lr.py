"""Loop restoration on the device.

Port of dav1d_tpu's ops/lr.py (reference src/looprestoration_tmpl.c:
44-1270, lr_apply_tmpl.c:107-215): every (restoration unit x stripe)
work item of a frame's plane is one row of a dense batch. The host
builds per item the row table that bakes in the reference's
streaming-edge semantics (stripe-boundary rows redirected to the
pre-CDEF plane, top/bottom replication, the SGR row clamp). The plain
versions read columns from horizontally edge-padded sources, so each
item's column window is linear; the kernels clamp the columns of the
unpadded planes instead, which is the same edge replication. All
tables are int32. Two implementations of each filter:

- the plain torch version (`wiener_items_plain`, `sgr_items_plain`):
  gathers the (n, hmax+6, wmax+6) padded sources from [src; pre], runs
  the Wiener or SGR math over the batch (SGR in int64) and writes the
  results back under the per-item size mask; CPU tensors only.
  `wiener_frame_plain` / `sgr_frame_plain` run a frame's table through
  it plane by plane;
- the hand-written CUDA kernels csrc/lr_wiener.cu and csrc/lr_sgr.cu,
  each in one launch a frame over every plane's items of its filter
  (`wiener_frame_cuda`, `sgr_frame_cuda`; one block per item and tile
  of 64 output columns); every CUDA tensor.

`wiener_frame` and `sgr_frame` dispatch between the two;
`lr_planes_device` makes one `wiener_frame` and one `sgr_frame` call a
frame.
"""
from __future__ import annotations

import ctypes as ct

import numpy as np
import torch

from .cuda_build import count_launch, launch_stream
from .device import upload
from .restore_ref import (LR_HAVE_LEFT, LR_HAVE_RIGHT, LR_HAVE_TOP,
                          LR_HAVE_BOTTOM, _sgr_params_tbl)

# kernel launches per name (counted where the CUDA kernel is launched)
LAUNCHES = {"lr_wiener": 0, "lr_sgr": 0}
PAD = 3
LR_BS = 32


def _gather(CP, rowt, colbase, win_w):
    """(n, rows, win_w) windows: row table rows x linear column windows
    starting at colbase."""
    cols = colbase[:, None] + torch.arange(win_w, dtype=torch.int64,
                                           device=CP.device)
    return CP[rowt[:, :, None], cols[:, None, :]]


def _write_back(dst, vals, oy, ox, ohs, ows):
    """dst[oy+i, ox+j] = vals[:, i, j] for i < ohs, j < ows per item."""
    n, hmax, wmax = vals.shape
    dev = dst.device
    ar_h = torch.arange(hmax, dtype=torch.int64, device=dev)
    ar_w = torch.arange(wmax, dtype=torch.int64, device=dev)
    valid = ((ar_h[None, :, None] < ohs[:, None, None]) &
             (ar_w[None, None, :] < ows[:, None, None]))
    ridx = (oy[:, None, None] + ar_h[None, :, None]).expand(n, hmax, wmax)
    cidx = (ox[:, None, None] + ar_w[None, None, :]).expand(n, hmax, wmax)
    dst[ridx[valid], cidx[valid]] = vals[valid]


def _wiener_math(S, fhc, fvc, hmax, wmax, bd):
    """The Wiener filter of gathered (n, hmax + 6, wmax + 6) windows:
    (n, hmax, wmax) int32 outputs."""
    round_bits_h = 3 + (bd == 12) * 2
    clip_limit = 1 << (bd + 1 + 7 - round_bits_h)
    round_bits_v = 11 - (bd == 12) * 2
    round_offset = 1 << (bd + round_bits_v - 1)
    n = S.shape[0]
    hsum = torch.full((n, hmax + 6, wmax), 1 << (bd + 6), dtype=torch.int32,
                      device=S.device)
    for i in range(7):
        hsum = hsum + fhc[:, i, None, None] * S[:, :, i:i + wmax]
    hor = torch.clamp((hsum + (1 << (round_bits_h - 1))) >> round_bits_h,
                      0, clip_limit - 1)
    vsum = torch.full((n, hmax, wmax), -round_offset, dtype=torch.int32,
                      device=S.device)
    for i in range(7):
        vsum = vsum + fvc[:, i, None, None] * hor[:, i:i + hmax]
    return torch.clamp((vsum + (1 << (round_bits_v - 1))) >> round_bits_v,
                       0, (1 << bd) - 1)


def wiener_items_plain(src, pre, dst, rowt, colbase, fhc, fvc, oy, ox, ohs,
                       ows, hmax, wmax, bd):
    """Batched Wiener pass (dav1d_tpu lr._wiener_fn): gathers from
    [src; pre] (the pre-LR pixels) and writes into dst in place."""
    S = _gather(torch.cat([src, pre], dim=0), rowt, colbase, wmax + 6)
    _write_back(dst, _wiener_math(S, fhc, fvc, hmax, wmax, bd), oy, ox, ohs,
                ows)


def sgr_items_plain(src, pre, dst, rowt, colbase, s0, s1, w0, w1, oy, ox,
                    ohs, ows, hmax, wmax, bd, xbyx):
    """Batched self-guided restoration (dav1d_tpu lr._sgr_fn). The row
    table pre-clamps rows -3..hmax+2 to the reference's [-2, h+1], so
    box sums use direct shifts. s0/s1/w0/w1: (n,) int32 (0 = branch
    off). Writes into dst in place."""
    S = _gather(torch.cat([src, pre], dim=0), rowt, colbase, wmax + 6)
    _write_back(dst, _sgr_math(S, s0, s1, w0, w1, hmax, wmax, bd, xbyx),
                oy, ox, ohs, ows)


def _sgr_math(S, s0, s1, w0, w1, hmax, wmax, bd, xbyx):
    """The SGR filter of gathered (n, hmax + 6, wmax + 6) windows, the
    box sums direct: (n, hmax, wmax) int32 outputs."""
    bdm8 = bd - 8
    n = S.shape[0]
    S = S.to(torch.int64)
    src_px = S[:, 3:3 + hmax, PAD:PAD + wmax]

    def calc_ab(sumsq, ssum, s, nn, one_by_x):
        a = (sumsq + ((1 << (2 * bdm8)) >> 1)) >> (2 * bdm8)
        b = (ssum + ((1 << bdm8) >> 1)) >> bdm8
        p = torch.clamp(a * nn - b * b, min=0)
        z = (p * s.to(torch.int64)[:, None, None] + (1 << 19)) >> 20
        x = xbyx[torch.clamp(z, max=255)]
        A = (x * ssum * one_by_x + (1 << 11)) >> 12
        return A, x

    def box_cols(r):
        """Column box sums of width 2r+1 at output cols -1..wmax."""
        ssum = torch.zeros((n, S.shape[1], wmax + 2), dtype=torch.int64,
                           device=S.device)
        ssq = torch.zeros_like(ssum)
        for t in range(2 * r + 1):
            sl = S[:, :, PAD - 1 - r + t:PAD - 1 - r + t + wmax + 2]
            ssum = ssum + sl
            ssq = ssq + sl * sl
        return ssq, ssum

    # ---- box3: A/B at rows r = -1..hmax (stacked) ----
    ssq, ssum = box_cols(1)
    q = ssq[:, 1:hmax + 3] + ssq[:, 2:hmax + 4] + ssq[:, 3:hmax + 5]
    m = ssum[:, 1:hmax + 3] + ssum[:, 2:hmax + 4] + ssum[:, 3:hmax + 5]
    A, B = calc_ab(q, m, s1, 9, 455)     # (n, hmax+2, wmax+2)

    def win3(M):
        c = M[:, :, 1:wmax + 1]
        e = M[:, :, 0:wmax] + M[:, :, 2:wmax + 2]
        mid = c[:, 1:hmax + 1]
        emid = e[:, 1:hmax + 1]
        up, dn = c[:, 0:hmax], c[:, 2:hmax + 2]
        eup, edn = e[:, 0:hmax], e[:, 2:hmax + 2]
        return mid * 4 + emid * 4 + up * 4 + dn * 4 + (eup + edn) * 3

    t3 = (win3(A) - win3(B) * src_px + (1 << 8)) >> 9

    # ---- box5: A/B at odd stripe rows r = -1, 1, ..., hmax-1 ----
    ssq, ssum = box_cols(2)
    nj = hmax // 2 + 1
    q5 = None
    m5 = None
    for d in range(5):
        sl_q = ssq[:, d:d + 2 * (nj - 1) + 1:2]
        sl_m = ssum[:, d:d + 2 * (nj - 1) + 1:2]
        q5 = sl_q if q5 is None else q5 + sl_q
        m5 = sl_m if m5 is None else m5 + sl_m
    A5, B5 = calc_ab(q5, m5, s0, 25, 164)  # (n, nj, wmax+2); j=(r+1)/2

    def hwin(M, w_mid, w_edge):
        return (M[:, :, 1:wmax + 1] * w_mid +
                (M[:, :, 0:wmax] + M[:, :, 2:wmax + 2]) * w_edge)

    # even output rows r=2j use A5[j]+A5[j+1]; odd rows use A5[j+1]
    A_lo, A_hi = A5[:, :nj - 1], A5[:, 1:nj]
    B_lo, B_hi = B5[:, :nj - 1], B5[:, 1:nj]
    Pb_even = hwin(A_lo + A_hi, 6, 5)      # (n, hmax/2, wmax)
    Pa_even = hwin(B_lo + B_hi, 6, 5)
    Pb_odd = hwin(A_hi, 6, 5)
    Pa_odd = hwin(B_hi, 6, 5)
    src_even, src_odd = src_px[:, 0::2], src_px[:, 1::2]
    t5 = torch.zeros((n, hmax, wmax), dtype=torch.int64, device=S.device)
    t5[:, 0::2] = (Pb_even - Pa_even * src_even + (1 << 8)) >> 9
    t5[:, 1::2] = (Pb_odd - Pa_odd * src_odd + (1 << 7)) >> 8

    v = (w0.to(torch.int64)[:, None, None] * t5 +
         w1.to(torch.int64)[:, None, None] * t3)
    res = src_px + ((v + (1 << 10)) >> 11)
    return torch.clamp(res, 0, (1 << bd) - 1).to(torch.int32)


_LIBS = {}


def _set_sgr_table(lib):
    from .. import tables
    xbyx = np.asarray(tables.get("dav1d_sgr_x_by_x"))
    if xbyx.shape != (256,) or xbyx.min() < 0 or xbyx.max() > 255:
        raise ValueError("sgr_x_by_x: expected 256 entries in 0..255")
    xbyx = np.ascontiguousarray(xbyx, np.uint8)
    lib.lr_sgr_set_table.restype = ct.c_int
    lib.lr_sgr_set_table.argtypes = [ct.c_void_p]
    rc = lib.lr_sgr_set_table(xbyx.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"lr_sgr: table upload failed: CUDA error {rc}")


def _lib(name):
    from .cuda_build import load_library, per_device
    lib = _LIBS.get(name)
    if lib is None:
        lib = load_library(name)
        fn = getattr(lib, name)
        fn.restype = ct.c_int
        fn.argtypes = [ct.c_void_p, ct.c_void_p, ct.c_void_p]
        _LIBS[name] = lib
    if name == "lr_sgr":
        return per_device(lib, _set_sgr_table)
    return lib


# the columns of the kernels' item tables (int32, one row an item): the
# first six shared, then Wiener's taps or SGR's strengths and weights
_ITEM = ("plane", "colbase", "oy", "ox", "ohs", "ows")
WIENER_COLS = _ITEM + tuple(f"fh{i}" for i in range(7)) + \
    tuple(f"fv{i}" for i in range(7))
SGR_COLS = _ITEM + ("s0", "s1", "w0", "w1")
COLS = {"wiener": WIENER_COLS, "sgr": SGR_COLS}
LR_TW = 64              # output columns of a Wiener or SGR kernel block


def _frame_launch(kind, planes, items, rowt, blocks, bd):
    """One launch of csrc/lr_wiener.cu or csrc/lr_sgr.cu (kind "wiener"
    or "sgr"). planes: [(src, pre, dst, w, wmax)] per plane index of the
    item table (src and pre (Hp, Ws) and dst 2-D, int32; columns clamp
    to [0, w); wmax the widest item); items (n, len(COLS[kind])), rowt
    (n, rw) and blocks (nb, 2) (item_blocks'): int32, all contiguous
    on one CUDA device."""
    from .cuda_build import check_tensor
    name = "lr_" + kind
    dev = planes[0][0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors")
    if bd not in (8, 10, 12):
        raise ValueError(f"bitdepth {bd}")
    if not 1 <= len(planes) <= 3:
        raise ValueError(f"{len(planes)} planes, expected 1 to 3")
    ptrs, dims = [0] * 12, [0] * 20
    for p, (src, pre, dst, w, wmax) in enumerate(planes):
        check_tensor(src, f"src {p}", torch.int32, dev)
        check_tensor(pre, f"pre {p}", torch.int32, dev, src.shape)
        check_tensor(dst, f"dst {p}", torch.int32, dev)
        if not 0 < w <= src.shape[1] or wmax < 1:
            raise ValueError(f"plane {p}: width {w}, widest item {wmax}")
        ptrs[3 * p:3 * p + 3] = (src.data_ptr(), pre.data_ptr(),
                                 dst.data_ptr())
        dims[5 * p:5 * p + 5] = (*src.shape, dst.shape[1], w, wmax)
    n = items.shape[0] if items.dim() == 2 else -1
    check_tensor(items, "items", torch.int32, dev, (n, len(COLS[kind])))
    rw = rowt.shape[1] if rowt.dim() == 2 else -1
    check_tensor(rowt, "rowt", torch.int32, dev, (n, rw))
    nb = blocks.shape[0] if blocks.dim() == 2 else -1
    check_tensor(blocks, "blocks", torch.int32, dev, (nb, 2))
    ptrs[9:] = (items.data_ptr(), rowt.data_ptr(), blocks.data_ptr())
    dims[15:] = (len(planes), n, rw, nb, bd)
    rc = getattr(_lib(name), name)(
        (ct.c_void_p * len(ptrs))(*ptrs), (ct.c_int * len(dims))(*dims),
        launch_stream(dev))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    count_launch(LAUNCHES, name)


def item_blocks(items):
    """The Wiener or SGR kernel's block table of an item table (numpy):
    one (item, first output column) row per tile of LR_TW output columns
    of each item, int32."""
    ows = items[:, _ITEM.index("ows")].astype(np.int64)
    nt = -(-ows // LR_TW)
    first = np.repeat(np.cumsum(nt) - nt, nt)
    return np.stack([np.repeat(np.arange(len(items)), nt),
                     (np.arange(nt.sum()) - first) * LR_TW],
                    axis=1).astype(np.int32)


def frame_tables(kind, groups, sgrp):
    """The Wiener or SGR item table of a frame: groups, per plane index,
    (its items of that kind as _collect_items gives them, hmax, Hp (its
    rows)). Returns (items (n, len(COLS[kind])), rowt (n, max hmax +
    6)) int32 numpy: the columns of COLS[kind], colbase = ox - 3 in the
    unpadded plane, and each plane's row tables (item_tables') padded to
    the widest by their last entry."""
    rw = max(hmax for _, hmax, _ in groups) + 6
    items, rowts = [], []
    for p, (sel, hmax, Hp) in enumerate(groups):
        rowt, _, *par, oy, ox, ohs, ows = item_tables(kind, sel, sgrp, hmax,
                                                      Hp)
        items.append(np.column_stack([np.full(len(sel), p), ox - PAD, oy,
                                      ox, ohs, ows, *par]))
        rowts.append(np.pad(rowt, ((0, 0), (0, rw - rowt.shape[1])),
                            mode="edge"))
    return (np.concatenate(items).astype(np.int32),
            np.concatenate(rowts).astype(np.int32))


def check_frame(planes, tables, kind):
    """Raise unless `tables` (frame_tables(kind, ...)'s) fit `planes`
    ([(src, pre, dst, w, hmax)]): int32 2-D arrays of COLS[kind]
    columns and one row table an item, at least hmax + 6 wide, every
    item's plane index in the list, inside its plane's valid columns
    and at most its hmax rows. Returns the widest item of each plane."""
    items, rowt = tables
    for name, a in (("items", items), ("rowt", rowt)):
        if not isinstance(a, np.ndarray) or a.dtype != np.int32:
            raise TypeError(f"{name}: expected an int32 numpy array")
        if a.ndim != 2:
            raise ValueError(f"{name} of shape {a.shape}")
    if items.shape[1] != len(COLS[kind]) or rowt.shape[0] != len(items):
        raise ValueError(f"tables of shapes {items.shape}, {rowt.shape}")
    pl, ox, ohs, ows = (items[:, _ITEM.index(k)]
                        for k in ("plane", "ox", "ohs", "ows"))
    if len(items) and (pl.min() < 0 or pl.max() >= len(planes)):
        raise ValueError(f"plane index {int(pl.max())} past the "
                         f"{len(planes)} planes")
    wmax = []
    for p, (src, _, _, w, hmax) in enumerate(planes):
        sel = pl == p
        if not 0 < hmax <= 64 or rowt.shape[1] < hmax + 6 or \
                (sel.any() and (ox[sel].min() < 0 or
                                (ox + ows)[sel].max() > w or
                                ohs[sel].max() > hmax)) or \
                not 0 < w <= src.shape[1]:
            raise ValueError(f"plane {p}: items outside its {w} columns "
                             f"or {hmax} rows")
        wmax.append(max(1, int(ows[sel].max())) if sel.any() else 1)
    return wmax


def _frame_plain(kind, planes, tables, bd):
    """_frame_cuda's contract in plain torch: per plane of `planes`
    ([(src, pre, dst, w, hmax)]), its items of `tables` through
    plane_sources and wiener_items_plain / sgr_items_plain, into dst in
    place."""
    items, rowt = tables
    wmax = check_frame(planes, tables, kind)
    for p, (src, pre, dst, w, hmax) in enumerate(planes):
        sel = items[:, 0] == p
        if not sel.any():
            continue
        it = items[sel]
        T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
            src.device)
        curp, prep = plane_sources(src, pre, w, wmax[p])
        args = (curp, prep, dst, T(rowt[sel][:, :hmax + 6]),
                T(it[:, 1] + LR_BS))
        pos = [T(it[:, k]) for k in range(2, 6)]
        if kind == "wiener":
            wiener_items_plain(*args, T(it[:, 6:13]), T(it[:, 13:20]), *pos,
                               hmax, wmax[p], bd)
        else:
            from .device import device_tables
            sgr_items_plain(*args, *(T(it[:, k]) for k in range(6, 10)),
                            *pos, hmax, wmax[p], bd,
                            device_tables(src.device)["sgr_x_by_x"])


def _frame_cuda(kind, planes, tables, bd):
    """The Wiener or SGR pass of a frame's planes in one launch of
    csrc/lr_wiener.cu or csrc/lr_sgr.cu: planes [(src, pre, dst, w,
    hmax)], src and pre the unpadded pre-LR and pre-CDEF planes (Hp,
    Ws), dst the restored plane (src's shape; not src), w its valid
    columns; tables (frame_tables' host arrays) checked on the host,
    then the item, row and block tables cross in one upload. CUDA int32
    planes only. Launches on the current stream and does not
    synchronise."""
    wmax = check_frame(planes, tables, kind)
    dev = planes[0][0].device
    if dev.type != "cuda":
        raise ValueError(f"{kind}_frame_cuda needs CUDA tensors")
    for p, (src, _, dst, _, _) in enumerate(planes):
        if tuple(dst.shape) != tuple(src.shape):
            raise ValueError(f"plane {p}: dst {tuple(dst.shape)} and src "
                             f"{tuple(src.shape)}")
    items, rowt, blocks = upload_tables(
        [*tables, item_blocks(tables[0])], dev)
    _frame_launch(kind, [(s, q, d, w, m) for (s, q, d, w, _), m
                         in zip(planes, wmax)], items, rowt, blocks, bd)


def _frame(kind, planes, tables, bd):
    if planes[0][0].is_cuda:
        return _frame_cuda(kind, planes, tables, bd)
    from .mc import _cpu_only
    _cpu_only(planes[0][0])
    return _frame_plain(kind, planes, tables, bd)


def wiener_frame_plain(planes, tables, bd):
    """wiener_frame_cuda's contract in plain torch (_frame_plain)."""
    return _frame_plain("wiener", planes, tables, bd)


def wiener_frame_cuda(planes, tables, bd):
    """The Wiener pass of a frame's planes in one launch of
    csrc/lr_wiener.cu (_frame_cuda; tables: frame_tables("wiener",
    ...))."""
    return _frame_cuda("wiener", planes, tables, bd)


def wiener_frame(planes, tables, bd):
    """The Wiener pass of a frame (wiener_frame_cuda's contract): one
    launch of the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    return _frame("wiener", planes, tables, bd)


def sgr_frame_plain(planes, tables, bd):
    """sgr_frame_cuda's contract in plain torch (_frame_plain)."""
    return _frame_plain("sgr", planes, tables, bd)


def sgr_frame_cuda(planes, tables, bd):
    """The SGR pass of a frame's planes in one launch of csrc/lr_sgr.cu
    (_frame_cuda; tables: frame_tables("sgr", ...))."""
    return _frame_cuda("sgr", planes, tables, bd)


def sgr_frame(planes, tables, bd):
    """The SGR pass of a frame (sgr_frame_cuda's contract): one launch of
    the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    return _frame("sgr", planes, tables, bd)


def _collect_items(plan, plane, w, h, us_log2, ss_ver, ss_hor, sb_log2,
                   sgrp):
    """Enumerate (unit x stripe) work items for one plane (the loop
    structure of restore_ref.apply_lr / reference lr_apply_tmpl.c)."""
    f = plan.f
    us = 1 << us_log2
    max_us = us + (us >> 1)
    n_sbrows = (f.bh + f.sb_step - 1) // f.sb_step
    items = []
    for sby in range(n_sbrows):
        not_last = sby + 1 < n_sbrows
        next_row_y = (sby + 1) << sb_log2
        row_h = min(next_row_y - ((8 >> ss_ver) * not_last), h)
        offset = (8 >> ss_ver) * (sby > 0)
        y0 = (sby << sb_log2) - offset
        row_y = y0 + offset
        aligned = row_y & ~(us - 1)
        if aligned and aligned + (us >> 1) > h:
            aligned -= us
        unit_row = plan.lr_units[plane][(aligned << ss_ver) >> 6]
        x = 0
        while x < w:
            last = x + max_us > w
            unit_w = (w - x) if last else us
            u = unit_row[(x << ss_hor) >> 6]
            if u is not None and u["type"]:
                base = (LR_HAVE_LEFT if x > 0 else 0) | \
                       (0 if last else LR_HAVE_RIGHT)
                y = y0
                while y < row_h:
                    stripe_h = min((64 - 8 * (y == 0)) >> ss_ver,
                                   row_h - y)
                    e = base
                    if y > 0:
                        e |= LR_HAVE_TOP
                    if not (sby + 1 == n_sbrows and
                            y + stripe_h == row_h):
                        e |= LR_HAVE_BOTTOM
                    items.append((y, x, unit_w, stripe_h, e, u))
                    y += stripe_h
            x += unit_w
    return items


def _edge_pad(a, w, left, total):
    """Columns [0, w) of a, edge-replicated to `left` columns on the left
    and to `total` columns in all."""
    body = a[:, :w]
    lcol = body[:, :1].expand(-1, left)
    rcol = body[:, w - 1:w].expand(-1, total - w - left)
    return torch.cat([lcol, body, rcol], dim=1).contiguous()


def item_tables(kind, sel, sgrp, hmax, Hp):
    """The int32 tables of one plane's Wiener or SGR items (`sel`:
    _collect_items tuples of that kind) in the filters' argument order:
    rowt (n, hmax + 6), colbase, then fhc, fvc (n, 7) for Wiener or s0,
    s1, w0, w1 for SGR, then oy, ox, ohs, ows. Hp: the plane's rows."""
    oy = np.array([it[0] for it in sel], np.int64)
    ox = np.array([it[1] for it in sel], np.int64)
    ows = np.array([it[2] for it in sel], np.int64)
    ohs = np.array([it[3] for it in sel], np.int64)
    ev = np.array([it[4] for it in sel], np.int64)
    if kind == "wiener":
        fhc = np.zeros((len(sel), 7), np.int32)
        fvc = np.zeros((len(sel), 7), np.int32)
        for i, (_y, _x, _uw, _sh, _e, u) in enumerate(sel):
            fl = u["filter_h"]
            fhc[i] = (fl[0], fl[1], fl[2],
                      128 - 2 * (fl[0] + fl[1] + fl[2]),
                      fl[2], fl[1], fl[0])
            fl = u["filter_v"]
            fvc[i] = (fl[0], fl[1], fl[2],
                      128 - 2 * (fl[0] + fl[1] + fl[2]),
                      fl[2], fl[1], fl[0])
        bmin = np.where(ev & LR_HAVE_TOP, 4, 6)
        params = [fhc, fvc]
    else:
        idx = np.array([it[5]["type"] - 3 for it in sel])
        s0 = sgrp[idx, 0].astype(np.int32)
        s1 = sgrp[idx, 1].astype(np.int32)
        sw = np.array([it[5]["sgr_weights"] for it in sel], np.int32)
        w0 = np.where(s0 != 0, sw[:, 0], 0).astype(np.int32)
        w1 = np.where(s1 != 0, 128 - (sw[:, 0] + sw[:, 1]),
                      0).astype(np.int32)
        bmin = np.where(
            s0 != 0,
            np.where(ohs % 2, ohs + 1,
                     np.where(ev & LR_HAVE_TOP, 3, 5)),
            3)
        params = [s0, s1, w0, w1]

    # row tables, batched (the reference's stripe-edge rows + row
    # clamp: padded rows -3..hmax+2; SGR clamps to [-2, h+1], Wiener
    # replicates the tail)
    rr = np.arange(-3, hmax + 3)[None, :]
    if kind == "sgr":
        j = 3 + np.clip(rr, -2, ohs[:, None] + 1)
    else:
        j = np.minimum(3 + rr, ohs[:, None] + 5)
    have_top = (ev[:, None] & LR_HAVE_TOP) != 0
    use_b = (((ev & LR_HAVE_BOTTOM) != 0) &
             (ohs >= bmin))[:, None]
    yc = oy[:, None]
    hc = ohs[:, None]
    mid = yc + (j - 3)
    top_val = np.where(have_top,
                       np.where(j <= 1, yc - 2, yc - 1), yc)
    bot_val = np.where(use_b,
                       np.where(j == hc + 3, yc + hc,
                                yc + hc + 1),
                       yc + hc - 1)
    val = np.where(j < 3, top_val,
                   np.where(j < hc + 3, mid, bot_val))
    from_lpf = np.where(j < 3, have_top,
                        np.where(j < hc + 3, False, use_b))
    np.clip(val, 0, Hp - 1, out=val)
    rowt = val + np.where(from_lpf, Hp, 0)
    # column window bases into the edge-padded sources
    colbase = ox - PAD + LR_BS
    return [a.astype(np.int32) for a in
            [rowt, colbase, *params, oy, ox, ohs, ows]]


def plane_sources(cur, pre, w, wmax):
    """The horizontally edge-padded gather sources of a plane (its pre-LR
    and pre-CDEF planes, columns [0, w) valid): column windows are
    linear; LR_BS columns on the left cover the -3 left reach, the right
    pad the widest window tail."""
    Wpad = -(-(w + LR_BS + wmax + 8) // LR_BS) * LR_BS
    return _edge_pad(cur, w, LR_BS, Wpad), _edge_pad(pre, w, LR_BS, Wpad)


def upload_tables(tbl, device):
    """item_tables' arrays as int32 tensors on `device`: views of one
    buffer that crosses in a single host-to-device copy."""
    buf = upload(np.concatenate([a.reshape(-1) for a in tbl]), device)
    views, pos = [], 0
    for a in tbl:
        views.append(buf[pos:pos + a.size].view(a.shape))
        pos += a.size
    return views


def plane_items(plan):
    """The host's item walk of a frame (_collect_items per restored
    plane), split by filter: [(plane index, w (its valid columns),
    hmax, wmax, {"wiener": items, "sgr": items})]."""
    f = plan.f
    fh = f.frame_hdr
    rst = fh.restoration
    sgrp = _sgr_params_tbl()
    out = []
    for plane in range(3):
        if rst.type[plane] == 0 or (plane and f.layout == 0):
            continue
        ss_ver = 1 if (plane and f.layout == 1) else 0
        ss_hor = 1 if (plane and f.layout != 3) else 0
        w = (fh.width[1] + ss_hor) >> ss_hor
        h = (fh.height + ss_ver) >> ss_ver
        us_log2 = rst.unit_size[1 if plane else 0]
        sb_log2 = 6 - ss_ver + f.sb128
        items = _collect_items(plan, plane, w, h, us_log2, ss_ver,
                               ss_hor, sb_log2, sgrp)
        if items:
            out.append((plane, w, 64 >> ss_ver,
                        (1 << us_log2) + (1 << (us_log2 - 1)),
                        {k: [it for it in items
                             if (it[5]["type"] == 2) == (k == "wiener")]
                         for k in ("wiener", "sgr")}))
    return out


def lr_planes_device(planes, pre_cdef, plan, bd):
    """Loop restoration over int32 plane tensors. planes: full padded
    post-CDEF planes; pre_cdef: the post-deblock (lpf) planes. The
    Wiener items of every plane go in one wiener_frame call and the SGR
    items of every plane in one sgr_frame call, both reading the planes
    themselves. The inputs stay as they are; returns the restored plane
    list."""
    sgrp = _sgr_params_tbl()
    out = list(planes)
    groups = plane_items(plan)
    for plane, *_ in groups:
        out[plane] = planes[plane].clone()
    for kind, run in (("wiener", wiener_frame), ("sgr", sgr_frame)):
        sel = [(p, w, hmax, kinds[kind])
               for p, w, hmax, _, kinds in groups if kinds[kind]]
        if sel:
            run([(planes[p], pre_cdef[p][:planes[p].shape[0]], out[p], w,
                  hmax) for p, w, hmax, _ in sel],
                frame_tables(kind, [(items, hmax, planes[p].shape[0])
                                    for p, _, hmax, items in sel], sgrp),
                bd)
    return out
