"""CDEF on the device.

Port of dav1d_tpu's ops/cdef.py (reference src/cdef_tmpl.c:37-305,
cdef_apply_tmpl.c:91-330). Two implementations:

- the plain torch version, kept term by term with dav1d_tpu's
  `_cdef_fn`: every 8x8 block's direction search is one batched
  projection of its 64 pixels onto 90 partial-sum bins
  (`find_dirs_plain`), and the constrained filter is whole-plane
  arithmetic under per-block direction/strength maps
  (`filter_plane_plain`, `cdef_frame_plain`, `cdef_planes_plain`). The
  projection runs as a float64 matrix product: exact, since every bin
  sums at most 8 values of magnitude <= 128 (integer matmul does not
  run on CUDA in torch, and fp32/TF32 would round). Used for CPU
  tensors only.
- the hand-written CUDA kernel csrc/cdef.cu: every plane of a frame in
  one launch, 64x64 luma tiles with a 2-pixel apron in shared memory,
  the direction search spread over the block's 8 warps, tiles outside
  the crop copied through (`cdef_cuda`); used for every CUDA tensor.

The per-8x8-block maps of a frame are one (6, nby, nbx) int32 array
(`MAPS` names its rows), uploaded in one copy.
"""
from __future__ import annotations

import ctypes as ct
from functools import lru_cache

import numpy as np
import torch

from .cdef_ref import cdef_dirs, FILL, UV_DIRS
from .cuda_build import count_launch, launch_stream
from .device import upload

# kernel launches per name (counted where the CUDA kernel is launched)
LAUNCHES = {"cdef": 0}
# rows of a frame's (6, nby, nbx) block maps
MAPS = ("y_pri", "y_sec", "uv_pri", "uv_sec", "y_apply", "uv_apply")

_DIV_TABLE = (840, 420, 280, 210, 168, 140, 120)


@lru_cache(maxsize=None)
def proj_matrix():
    """(64, 90) int32 matrix: flattened 8x8 block -> partial sums.
    Bin layout: hv[2][8], diag[2][15], alt[4][11]
    (reference cdef_tmpl.c:252-274)."""
    M = np.zeros((64, 2 * 8 + 2 * 15 + 4 * 11), np.int32)
    o_hv, o_diag, o_alt = 0, 16, 46
    for y in range(8):
        for x in range(8):
            i = y * 8 + x
            M[i, o_diag + y + x] += 1                       # diag[0]
            M[i, o_alt + 0 * 11 + y + (x >> 1)] += 1        # alt[0]
            M[i, o_hv + y] += 1                             # hv[0]
            M[i, o_alt + 1 * 11 + 3 + y - (x >> 1)] += 1    # alt[1]
            M[i, o_diag + 15 + 7 + y - x] += 1              # diag[1]
            M[i, o_alt + 2 * 11 + 3 - (y >> 1) + x] += 1    # alt[2]
            M[i, o_hv + 8 + x] += 1                         # hv[1]
            M[i, o_alt + 3 * 11 + (y >> 1) + x] += 1        # alt[3]
    return M


def _ulog2_capped(v, cap):
    """floor(log2(v)) for v>=1, 0 for v==0, capped — exact, integer."""
    out = torch.zeros(v.shape, dtype=torch.int32, device=v.device)
    for k in range(1, cap + 1):
        out = out + (v >= (1 << k)).to(torch.int32)
    return out


def _expand(m, bv, bh):
    return torch.repeat_interleave(torch.repeat_interleave(m, bv, dim=0),
                                   bh, dim=1)


def dir_costs_plain(y_plane, bd, proj):
    """The 8 direction costs of cdef_find_dir_c of every 8x8 block of a
    cropped luma plane (bh*4, bw*4) int32: (nby * nbx, 8) int64, blocks
    in raster order. proj: the (64, 90) float64 projection."""
    bdm8 = bd - 8
    H, W = y_plane.shape
    px = (y_plane >> bdm8) - 128
    B = px.reshape(H // 8, 8, W // 8, 8).permute(0, 2, 1, 3).reshape(-1, 64)
    P = torch.matmul(B.to(torch.float64), proj).to(torch.int64)
    hv = P[:, 0:16].reshape(-1, 2, 8)
    diag = P[:, 16:46].reshape(-1, 2, 15)
    alt = P[:, 46:90].reshape(-1, 4, 11)
    cost = [None] * 8
    cost[2] = torch.sum(hv[:, 0] ** 2, dim=1) * 105
    cost[6] = torch.sum(hv[:, 1] ** 2, dim=1) * 105
    for di in range(2):
        c = torch.zeros(diag.shape[0], dtype=torch.int64,
                        device=y_plane.device)
        for n in range(7):
            d = _DIV_TABLE[n]
            c = c + (diag[:, di, n] ** 2 + diag[:, di, 14 - n] ** 2) * d
        c = c + diag[:, di, 7] ** 2 * 105
        cost[0 if di == 0 else 4] = c
    for n in range(4):
        c = torch.zeros(alt.shape[0], dtype=torch.int64,
                        device=y_plane.device)
        for m in range(5):
            c = c + alt[:, n, 3 + m] ** 2
        c = c * 105
        for m in range(3):
            d = _DIV_TABLE[2 * m + 1]
            c = c + (alt[:, n, m] ** 2 + alt[:, n, 10 - m] ** 2) * d
        cost[n * 2 + 1] = c
    return torch.stack(cost, dim=1)


def find_dirs_plain(y_plane, bd, proj):
    """Per-8x8-block direction and variance of a cropped luma plane
    (bh*4, bw*4) int32. proj: the (64, 90) float64 projection."""
    H, W = y_plane.shape
    costs = dir_costs_plain(y_plane, bd, proj)
    # first maximum wins, like argmax
    best = torch.zeros(costs.shape[0], dtype=torch.int32,
                       device=y_plane.device)
    best_cost = costs[:, 0]
    for d in range(1, 8):
        gt = costs[:, d] > best_cost
        best = torch.where(gt, d, best)
        best_cost = torch.where(gt, costs[:, d], best_cost)
    alt_cost = torch.gather(costs, 1, (best ^ 4).to(torch.int64)[:, None])
    var = (best_cost - alt_cost[:, 0]) >> 10
    return best.reshape(H // 8, W // 8), var.reshape(H // 8, W // 8)


def filter_plane_plain(plane, pri, sec, dir_map, damp, valid_h, valid_w,
                       bsz_v, bsz_h, apply_map, bd):
    """plane: (nby*bsz_v, nbx*bsz_h) int32; pri/sec/dir/apply: (nby, nbx)
    int32 maps (strengths pre-<<bdm8)."""
    bdm8 = bd - 8
    dirs = cdef_dirs()
    H, W = plane.shape
    dev = plane.device
    SP = torch.full((H + 4, W + 4), FILL, dtype=torch.int32, device=dev)
    SP[2:2 + H, 2:2 + W] = plane
    SP[2 + valid_h:, :] = FILL
    SP[:, 2 + valid_w:] = FILL

    prix = _expand(pri, bsz_v, bsz_h)
    secx = _expand(sec, bsz_v, bsz_h)
    dirx = _expand(dir_map, bsz_v, bsz_h)
    px = plane

    def tap(dy, dx):
        return SP[2 + dy:2 + dy + H, 2 + dx:2 + dx + W]

    def dir_tap(base, k, sign):
        v = None
        for d in range(8):
            dy, dx = int(dirs[base + d, k, 0]), int(dirs[base + d, k, 1])
            t = tap(sign * dy, sign * dx)
            v = t if v is None else torch.where(dirx == d, t, v)
        return v

    pri_tap = 4 - ((prix >> bdm8) & 1)
    pri_shift = torch.clamp(
        damp - _ulog2_capped(torch.clamp(prix, min=1), 10), min=0)
    sec_shift = damp - _ulog2_capped(torch.clamp(secx, min=1), 10)

    def constrain(diff, threshold, shift):
        adiff = torch.abs(diff)
        v = torch.minimum(adiff,
                          torch.clamp(threshold - (adiff >> shift), min=0))
        return torch.where(diff < 0, -v, v)

    summ = torch.zeros((H, W), dtype=torch.int32, device=dev)
    mn = px
    mx = px
    have_minmax = (prix != 0) & (secx != 0)

    def upd_minmax(mn, mx, s):
        mn = torch.where(have_minmax & (s != FILL) & (s < mn), s, mn)
        mx = torch.where(have_minmax, torch.maximum(mx, s), mx)
        return mn, mx

    # primary taps (contribution auto-zero where pri == 0)
    ptap = pri_tap
    for k in range(2):
        for sign in (1, -1):
            s = dir_tap(2, k, sign)
            summ = summ + ptap * constrain(s - px, prix, pri_shift)
            mn, mx = upd_minmax(mn, mx, s)
        ptap = (ptap & 3) | 2
    # secondary taps
    for k in range(2):
        sec_tap = 2 - k
        for base in (4, 0):
            for sign in (1, -1):
                s = dir_tap(base, k, sign)
                summ = summ + sec_tap * constrain(s - px, secx, sec_shift)
                mn, mx = upd_minmax(mn, mx, s)

    res = px + ((summ - (summ < 0).to(torch.int32) + 8) >> 4)
    res = torch.where(have_minmax, torch.clamp(res, mn, mx), res)
    act = _expand(apply_map, bsz_v, bsz_h) != 0
    return torch.where(act & ((prix != 0) | (secx != 0)), res, plane)


def block_params_plain(y_plane, maps, layout, bd, proj):
    """Per 8x8 block of a cropped luma plane: the variance-adjusted luma
    primary strength, the luma direction and the chroma direction (each
    0 where its plane's primary strength is 0). maps: the (6, nby, nbx)
    block maps."""
    y_pri, uv_pri = maps[0], maps[2]
    dir_map, var = find_dirs_plain(y_plane, bd, proj)
    # strength adjust by variance (reference cdef_apply_tmpl.c:91-97)
    t = var >> 6
    i = _ulog2_capped(torch.clamp(t, max=1 << 12), 12)
    adj = (y_pri * (4 + i) + 8) >> 4
    adj = torch.where(var != 0, adj, 0)
    adj = torch.where(y_pri != 0, adj, 0)
    y_dir = torch.where(y_pri != 0, dir_map, 0)
    tbl = torch.tensor(UV_DIRS[1 if layout == 2 else 0], dtype=torch.int32,
                       device=y_plane.device)
    uv_dir = tbl[dir_map.to(torch.int64)]
    uv_dir = torch.where(uv_pri != 0, uv_dir, 0)
    return adj, y_dir, uv_dir


def cdef_frame_plain(y_plane, u_plane, v_plane, maps, layout, bd, damping,
                     has_chroma, proj):
    """Frame CDEF on cropped planes: y (bh*4, bw*4), u/v subsampled;
    maps: the (6, nby, nbx) block maps. Returns (y, u, v) filtered."""
    _, y_sec, uv_pri, uv_sec, y_apply, uv_apply = maps
    ss_ver = 1 if layout == 1 else 0
    ss_hor = 0 if layout == 3 else 1
    Hy, Wy = y_plane.shape
    adj, y_dir, uv_dir = block_params_plain(y_plane, maps, layout, bd, proj)
    y_out = filter_plane_plain(y_plane, adj, y_sec, y_dir, damping, Hy, Wy,
                               8, 8, y_apply, bd)
    if not has_chroma:
        return y_out, u_plane, v_plane
    ch, cw = Hy >> ss_ver, Wy >> ss_hor
    outs = [filter_plane_plain(p, uv_pri, uv_sec, uv_dir, damping - 1, ch,
                               cw, 8 >> ss_ver, 8 >> ss_hor, uv_apply, bd)
            for p in (u_plane, v_plane)]
    return (y_out, *outs)


def cdef_planes_plain(planes, maps, Hy, Wy, layout, bd, damping, proj):
    """cdef_cuda's contract in plain torch: the CDEF of the crop (Hy, Wy)
    of [y] or [y, u, v] full padded planes, the pixels outside it copied
    through, into new tensors."""
    y = planes[0]
    if len(planes) > 1:
        ss_ver, ss_hor = layout == 1, layout != 3
        ch, cw = Hy >> ss_ver, Wy >> ss_hor
        u, v = planes[1], planes[2]
        yo, uo, vo = cdef_frame_plain(y[:Hy, :Wy], u[:ch, :cw],
                                      v[:ch, :cw], maps, layout, bd,
                                      damping, True, proj)
        out = [y.clone(), u.clone(), v.clone()]
        out[0][:Hy, :Wy] = yo
        out[1][:ch, :cw] = uo
        out[2][:ch, :cw] = vo
        return out
    yo, _, _ = cdef_frame_plain(y[:Hy, :Wy], None, None, maps, layout, bd,
                                damping, False, proj)
    out = y.clone()
    out[:Hy, :Wy] = yo
    return [out]


_LIB = []


def _set_tables(lib):
    lib.cdef_set_tables.restype = ct.c_int
    lib.cdef_set_tables.argtypes = [ct.c_void_p, ct.c_void_p]
    dirs = np.ascontiguousarray(cdef_dirs(), np.int32)
    uv = np.ascontiguousarray(UV_DIRS, np.int32)
    if dirs.shape != (12, 2, 2) or uv.shape != (2, 8):
        raise ValueError(f"CDEF tables of shapes {dirs.shape}, {uv.shape}")
    rc = lib.cdef_set_tables(dirs.ctypes.data, uv.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"cdef: table upload failed: CUDA error {rc}")


def _lib():
    from .cuda_build import load_library, per_device
    if not _LIB:
        lib = load_library("cdef")
        lib.cdef_frame.restype = ct.c_int
        lib.cdef_frame.argtypes = [ct.c_void_p, ct.c_void_p, ct.c_int,
                                   ct.c_void_p]
        _LIB.append(lib)
    return per_device(_LIB[0], _set_tables)


def check_args(planes, maps, Hy, Wy, layout, bd):
    """Raise unless the arguments are ones csrc/cdef.cu takes: 1 or 3
    contiguous int32 planes on one CUDA device (u and v of one shape),
    a crop of whole 8x8 luma blocks inside them, rows of whole 16-byte
    vectors (widths multiples of 4, data 16-byte aligned: the kernel
    moves 4 pixels at a time), (6, Hy/8, Wy/8) int32 maps on that
    device, bd 8/10/12 and a layout 1..3 with chroma."""
    from .cuda_build import check_tensor
    if len(planes) not in (1, 3):
        raise ValueError(f"{len(planes)} planes, expected 1 or 3")
    if bd not in (8, 10, 12):
        raise ValueError(f"bitdepth {bd}")
    if len(planes) == 3 and layout not in (1, 2, 3):
        raise ValueError(f"layout {layout} with chroma planes")
    dev = planes[0].device
    if dev.type != "cuda":
        raise ValueError("cdef_cuda needs CUDA tensors")
    if Hy % 8 or Wy % 8 or Hy <= 0 or Wy <= 0:
        raise ValueError(f"crop {(Hy, Wy)} not whole 8x8 blocks")
    ss_ver, ss_hor = int(layout == 1), int(layout != 3)
    for i, p in enumerate(planes):
        check_tensor(p, f"plane {i}", torch.int32, dev)
        ch, cw = (Hy, Wy) if i == 0 else (Hy >> ss_ver, Wy >> ss_hor)
        if p.shape[0] < ch or p.shape[1] < cw:
            raise ValueError(f"plane {i} of shape {tuple(p.shape)} "
                             f"smaller than its crop {(ch, cw)}")
        if p.shape[1] % 4 or p.data_ptr() % 16:
            raise ValueError(f"plane {i}: rows not whole 16-byte vectors")
    if len(planes) == 3 and planes[1].shape != planes[2].shape:
        raise ValueError("u and v planes of different shapes")
    check_tensor(maps, "maps", torch.int32, dev,
                 (len(MAPS), Hy // 8, Wy // 8), ndim=3)


def cdef_cuda(planes, maps, Hy, Wy, layout, bd, damping):
    """cdef_planes_plain's contract with one launch of csrc/cdef.cu for
    every plane; CUDA tensors only, pixels in [0, 2^bd) (the kernel
    stages them as int16). Each output is a fresh tensor, written whole
    by the kernel. Launches on the current stream and does not
    synchronise."""
    check_args(planes, maps, Hy, Wy, layout, bd)
    outs = [torch.empty_like(p) for p in planes]
    ptrs = [0] * 7
    dims = [0] * 13
    for i, (p, o) in enumerate(zip(planes, outs)):
        ptrs[i], ptrs[3 + i] = p.data_ptr(), o.data_ptr()
        dims[2 * i:2 * i + 2] = p.shape
    ptrs[6] = maps.data_ptr()
    dims[6:] = (Hy, Wy, Hy // 8, Wy // 8, layout if len(planes) > 1 else 0,
                bd, damping)
    dev = planes[0].device
    rc = _lib().cdef_frame((ct.c_void_p * 7)(*ptrs),
                           (ct.c_int * 13)(*dims), len(planes),
                           launch_stream(dev))
    if rc != 0:
        raise RuntimeError(f"cdef kernel launch failed: CUDA error {rc}")
    count_launch(LAUNCHES, "cdef")
    return outs


def cdef_planes(planes, maps, Hy, Wy, layout, bd, damping):
    """CDEF of a frame's planes (cdef_cuda's contract): one launch of the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if planes[0].is_cuda:
        return cdef_cuda(planes, maps, Hy, Wy, layout, bd, damping)
    from .device import device_tables
    from .mc import _cpu_only
    _cpu_only(planes[0])
    return cdef_planes_plain(planes, maps, Hy, Wy, layout, bd, damping,
                             device_tables(planes[0].device)["cdef_proj"])


def _block_maps(plan, bd):
    """Host-side per-8x8-block parameter maps from the frame plan: one
    (6, nby, nbx) int32 array, rows in MAPS order."""
    f = plan.f
    cd = f.frame_hdr.cdef
    bdm8 = bd - 8
    nby, nbx = f.bh >> 1, f.bw >> 1

    # noskip at 8x8 granularity (reference cdef_apply_tmpl.c skip logic:
    # nsk row-pairs, block active if either 4x4 column has a noskip)
    b4_noskip = plan.b4_skip == 0
    nsk = b4_noskip[0::2, :].copy()
    nsk[:f.bh >> 1, :] |= b4_noskip[1::2, :]
    blk_nsk = nsk[:, 0::2].copy()
    if f.bw > 1:
        blk_nsk |= np.pad(nsk[:, 1::2], ((0, 0),
                                         (0, nbx - nsk[:, 1::2].shape[1])))

    by = np.arange(nby)[:, None]
    bx = np.arange(nbx)[None, :]
    idx = plan.cdef_idx[(by * 2) >> 4, (bx * 2) >> 4].astype(np.int32)
    valid = idx >= 0
    y_strength = np.asarray(list(cd.y_strength) + [0], np.int32)
    uv_strength = np.asarray(list(cd.uv_strength) + [0], np.int32)
    y_lvl = y_strength[np.where(valid, idx, len(y_strength) - 1)]
    uv_lvl = uv_strength[np.where(valid, idx, len(uv_strength) - 1)]

    y_pri = (y_lvl >> 2) << bdm8
    y_sec = y_lvl & 3
    y_sec += (y_sec == 3)
    y_sec <<= bdm8
    uv_pri = (uv_lvl >> 2) << bdm8
    uv_sec = uv_lvl & 3
    uv_sec += (uv_sec == 3)
    uv_sec <<= bdm8

    base = valid & blk_nsk & ((y_lvl != 0) | (uv_lvl != 0))
    y_apply = (base & (y_lvl != 0)).astype(np.int32)
    uv_apply = (base & (uv_lvl != 0)).astype(np.int32)
    return np.stack([y_pri, y_sec, uv_pri, uv_sec, y_apply,
                     uv_apply]).astype(np.int32)


def cdef_planes_device(planes, plan, bd):
    """CDEF over int32 plane tensors (full padded pictures); filtering
    covers the b4 grid region. The block maps cross to the device in one
    copy; on CUDA one kernel launch filters every plane. Returns new
    tensors; the inputs stay as they are (LR reads the pre-CDEF
    planes)."""
    f = plan.f
    maps = upload(_block_maps(plan, bd), planes[0].device)
    return cdef_planes(planes, maps, f.bh * 4, f.bw * 4, int(f.layout), bd,
                       f.frame_hdr.cdef.damping + (bd - 8))
