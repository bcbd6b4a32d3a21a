"""Inverse transform + residual add on the device, from the frame's
coefficient pool (the residual pass of inter Stage B).

Port of the res / wht segments of dav1d_tpu's ops/mc_fused.py
`_mc_program`, whose math is ops/mc_jobs.py `res_tx_fn` and
`res_jobs_fn` (reference src/itx_tmpl.c:43-121). Two implementations:

- `itx_add_plain`: torch over each (tx, row kind, column kind) group,
  running the ops/itx_core.py butterflies on int64 tensors; used for
  CPU tensors only;
- the hand-written CUDA kernel csrc/itx_add.cu; used for every CUDA
  tensor.

Job rows (int32, one call per plane): [tx, ridx, cidx, py, px, cfoff].
ridx / cidx index `res_tx_kinds(tx)`; `job_rows` builds them from the
emitter's RES rows. WHT (lossless 4x4) jobs go in a call of their own
(`wht=True`), as dav1d_tpu's `wht` segment.

The kernel runs class-uniform blocks: `res_blocks` sorts a plane's jobs
by class (tx, ridx, cidx) and cuts each class into block rows [cls,
first, count] of at most `jobs_per_block(tx)` jobs. Reordering is exact
because the jobs of one pass never write the same pixel. The plain
version keeps int64 intermediates; the kernel runs int32 at bd 8 and
10, where no product can overflow (dav1d_tpu's `res` segment does the
same), and int64 at bd 12.
"""
from __future__ import annotations

import ctypes as ct
from functools import lru_cache

import numpy as np
import torch

from ..entropy import levels as lv
from . import itx_core
from .cuda_build import count_launch, cut_blocks, launch_stream
from .device import upload
from .itx_ref import TX1D_TYPES, TX_SHIFT

N_TX = len(lv.TXFM_INFO)
# coefficients a block keeps in the pool: min(w, 32) * min(h, 32)
CF_LEN = np.array([min(4 * t.w, 32) * min(4 * t.h, 32)
                   for t in lv.TXFM_INFO], np.int64)

# kernel launches per name (counted where the CUDA kernel is launched)
LAUNCHES = {"itx_add": 0}
# threads of a residual block (csrc/itx_add.cu THREADS)
BLOCK_THREADS = 128


@lru_cache(maxsize=None)
def res_tx_kinds(tx):
    """(row_kinds, col_kinds): the 1-D kinds available at this tx's
    row / column length, in itx_core order (DCT, ADST, FLIPADST,
    IDENTITY)."""
    t_dim = lv.TXFM_INFO[tx]
    lw2, lh2 = t_dim.lw + 2, t_dim.lh + 2
    return ([k for k in range(4) if (lw2, k) in itx_core.FNS],
            [k for k in range(4) if (lh2, k) in itx_core.FNS])


@lru_cache(maxsize=None)
def _txtp_kidx_map():
    """(N_TX, 17, 2) int32: txtp -> (ridx, cidx) per tx."""
    m = np.zeros((N_TX, 17, 2), np.int32)
    for tx in range(N_TX):
        rk, ck = res_tx_kinds(tx)
        for txtp, (ft, st) in TX1D_TYPES.items():
            if ft in rk and st in ck:
                m[tx, txtp] = (rk.index(ft), ck.index(st))
    return m


def job_rows(res, cfoff):
    """Emitter RES rows (n, 7) [plane, tx, txtp, py, px, off, tile] plus
    their pool offsets -> (rows (n, 6) int32, is_wht (n,) bool)."""
    kidx = _txtp_kidx_map()[res[:, 1], res[:, 2]]
    rows = np.stack([res[:, 1], kidx[:, 0], kidx[:, 1], res[:, 3],
                     res[:, 4], cfoff], axis=1).astype(np.int32)
    return rows, res[:, 2] == lv.WHT_WHT


def jobs_per_block(tx):
    """Jobs of transform size tx one kernel block runs: the block's
    threads over the larger of the row pass's rows (min(h, 32)) and the
    column pass's columns (w), as csrc/itx_add.cu itx_add_kernel."""
    t = lv.TXFM_INFO[tx]
    return BLOCK_THREADS // max(min(4 * t.h, 32), 4 * t.w)


_JPB = np.array([jobs_per_block(tx) for tx in range(N_TX)], np.int64)


def res_blocks(rows, group=None):
    """(rows sorted stably by class, block table) of (n, 6) residual
    rows. cls = tx << 4 | ridx << 2 | cidx; each class is cut into block
    rows [cls, first, count] (int32, (nb, 3)) of at most
    jobs_per_block(tx) jobs, the last one ragged. `group` (n,): a key
    sorted before the class (the plane), so that one call bins every
    plane; no block spans two groups, and each group's block rows are
    contiguous."""
    rows = np.asarray(rows, np.int32)
    cls = (rows[:, 0].astype(np.int64) << 4) | (rows[:, 1] << 2) | rows[:, 2]
    key = cls if group is None else cls + (np.asarray(group, np.int64) << 9)
    order = np.argsort(key, kind="stable")
    rows, key = rows[order], key[order]
    blk = cut_blocks(key, _JPB[(key >> 4) & 31])
    blk[:, 0] &= 511
    return np.ascontiguousarray(rows), blk


def _add(plane, py, px, res, px_max):
    """plane[py + i, px + j] = clip(plane + res[:, i, j]) inside the
    plane."""
    H, W = plane.shape
    ah = torch.arange(res.shape[1], device=plane.device)
    aw = torch.arange(res.shape[2], device=plane.device)
    rows, cols = py[:, None] + ah, px[:, None] + aw
    ok = (rows < H)[:, :, None] & (cols < W)[:, None, :]
    idx = (rows[:, :, None] * W + cols[:, None, :])[ok]
    flat = plane.view(-1)
    flat[idx] = torch.clamp(flat[idx].long() + res[ok], 0,
                            px_max).to(plane.dtype)


def _wht_plain(pool, jobs, plane, px_max):
    n = len(jobs)
    off = jobs[:, 5]
    cf = pool[off[:, None] + torch.arange(16, device=pool.device)].long()
    c4 = cf.reshape(n, 4, 4) >> 2                        # [x][y]
    rows = itx_core.wht4([c4[:, i, :] for i in range(4)])
    cols = itx_core.wht4([torch.stack(rows, 1)[:, :, i] for i in range(4)])
    _add(plane, jobs[:, 3], jobs[:, 4], torch.stack(cols, 1), px_max)


def residual(cf, tx, ridx, cidx, bd):
    """(n, h, w) residuals of n blocks of transform size tx and kinds
    (ridx, cidx) from their (n, sw * sh) x-major coefficients, computed
    in cf's integer dtype: rect2 scale, row transform clamped to the row
    range, (x + rnd) >> shift and the column clamp, column transform,
    (v + 8) >> 4."""
    n = len(cf)
    px_max = (1 << bd) - 1
    if bd == 8:
        row_min = col_min = -(1 << 15)
    else:
        row_min = -(px_max + 1) << 7
        col_min = -(px_max + 1) << 5
    row_max, col_max = ~row_min, ~col_min
    row_clip = lambda v: torch.clamp(v, row_min, row_max)
    col_clip = lambda v: torch.clamp(v, col_min, col_max)
    t_dim = lv.TXFM_INFO[tx]
    w, h = 4 * t_dim.w, 4 * t_dim.h
    sw, sh = min(w, 32), min(h, 32)
    shift = TX_SHIFT[tx]
    rk, ck = res_tx_kinds(tx)
    row_fn = itx_core.FNS[(t_dim.lw + 2, rk[ridx])]
    col_fn = itx_core.FNS[(t_dim.lh + 2, ck[cidx])]
    rows = cf.reshape(n, sw, sh).transpose(1, 2)         # (n, sh, sw)
    if w * 2 == h or h * 2 == w:
        rows = (rows * 181 + 128) >> 8
    tmp = torch.stack(row_fn([rows[:, :, i] for i in range(sw)],
                             row_clip), dim=2)           # (n, sh, w)
    tmp = col_clip((tmp + ((1 << shift) >> 1)) >> shift)
    res = torch.stack(col_fn([tmp[:, i, :] for i in range(sh)],
                             col_clip), dim=1)           # (n, h, w)
    return (res + 8) >> 4


def itx_add_plain(pool, jobs, plane, bd, wht=False):
    """Residual jobs (n, 6) added into `plane` in place, plain torch
    (int64 intermediates). pool: the frame's int32 coefficient pool."""
    if not len(jobs):
        return plane
    px_max = (1 << bd) - 1
    j = jobs.long()
    if wht:
        _wht_plain(pool, j, plane, px_max)
        return plane
    keys = torch.unique(j[:, :3], dim=0).tolist()
    for tx, ridx, cidx in keys:
        s = j[(j[:, 0] == tx) & (j[:, 1] == ridx) & (j[:, 2] == cidx)]
        cf = pool[s[:, 5, None] +
                  torch.arange(int(CF_LEN[tx]), device=pool.device)].long()
        _add(plane, s[:, 3], s[:, 4], residual(cf, tx, ridx, cidx, bd),
             px_max)
    return plane


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from .cuda_build import load_library
        lib = load_library("itx_add")
        lib.itx_add.restype = ct.c_int
        lib.itx_add.argtypes = [ct.c_void_p, ct.c_void_p, ct.c_int,
                                ct.c_void_p, ct.c_int, ct.c_void_p, ct.c_int,
                                ct.c_int, ct.c_int, ct.c_int, ct.c_void_p]
        lib.itx_jobs_per_block.restype = ct.c_int
        lib.itx_jobs_per_block.argtypes = [ct.c_int, ct.c_int]
        for tx, t in enumerate(lv.TXFM_INFO):
            if lib.itx_jobs_per_block(4 * t.w, 4 * t.h) != _JPB[tx]:
                raise RuntimeError("itx_add: jobs per block of the kernel "
                                   "and of res_blocks differ")
        _LIB = lib
    return _LIB


def itx_add_cuda(pool, jobs, plane, bd, wht=False, blocks=None):
    """The residual pass with csrc/itx_add.cu: same contract as
    itx_add_plain, CUDA tensors only. `blocks`: the res_blocks table of
    `jobs`, which must then be class-sorted; without it the jobs are
    sorted and binned here (a copy through the host). Launches on the
    current stream, does not synchronise."""
    from .cuda_build import check_tensor
    dev = plane.device
    if dev.type != "cuda":
        raise ValueError("itx_add_cuda needs CUDA tensors")
    if bd not in (8, 10, 12):
        raise ValueError(f"bitdepth {bd}")
    check_tensor(pool, "pool", torch.int32, dev, ndim=1)
    check_tensor(jobs, "jobs", torch.int32, dev, (len(jobs), 6))
    check_tensor(plane, "plane", torch.int32, dev)
    blk_ptr, n_blk = None, 0                # the WHT kernel takes none
    if not wht:
        if blocks is None:
            rows, blk = res_blocks(jobs.cpu().numpy())
            jobs = upload(rows, dev)
            blocks = upload(blk, dev)
        check_tensor(blocks, "blocks", torch.int32, dev, (len(blocks), 3))
        blk_ptr, n_blk = blocks.data_ptr(), len(blocks)
    rc = _lib().itx_add(pool.data_ptr(), jobs.data_ptr(), len(jobs),
                        blk_ptr, n_blk, plane.data_ptr(), plane.shape[0],
                        plane.shape[1], bd, int(wht),
                        launch_stream(dev))
    if rc != 0:
        raise RuntimeError(f"itx_add kernel launch failed: CUDA error {rc}")
    count_launch(LAUNCHES, "itx_add")
    return plane


def itx_add(pool, jobs, plane, bd, wht=False, blocks=None):
    """The residual pass: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (which needs no block table)."""
    if plane.is_cuda:
        return itx_add_cuda(pool, jobs, plane, bd, wht, blocks)
    if plane.device.type != "cpu":
        raise ValueError(f"unsupported device {plane.device}")
    return itx_add_plain(pool, jobs, plane, bd, wht)
