"""Deblocking filter on the device.

Port of dav1d_tpu's ops/lf.py (reference src/loopfilter_tmpl.c:37-162,
lf_apply_tmpl.c). AV1 bounds the filter width by the transform size on
both sides of an edge, so the edges of one directional pass never read
what another edge of the same pass writes: a whole pass is
data-parallel. A pass reads one plane and writes a copy of it.

Two implementations:

- `deblock_pass_plain`: one directional pass as whole-plane torch
  arithmetic (the plain version). For column edge x the p_i/q_i taps
  are the strided views plane[:, 4x-1-i] / plane[:, 4x+i];
  `filter_values` computes every candidate value and write mask at
  once. `deblock_frame_plain` runs it per plane, vertical then
  horizontal. Used for CPU tensors only.
- the hand-written CUDA kernel in csrc/deblock.cu: one launch filters
  every plane of a frame in both directions, tile by tile in shared
  memory (`deblock_frame_cuda`); used for every CUDA tensor.

Map convention: both passes take (cls, L) maps shaped (h4, w4) in plane
orientation. Vertical-pass entry (y, x) is the edge at column 4x for
rows 4y..4y+3; horizontal-pass entry (y, x) is the edge at row 4y for
columns 4x..4x+3. (dav1d_tpu's _plane_fn takes the horizontal maps
transposed; the tests transpose for it.)

Where random maps make edge writes overlap (real streams never do),
the edge nearer the plane's left/top edge wins, as in dav1d_tpu's
phase-select write-back; the kernel follows the same rule.
"""
from __future__ import annotations

import ctypes as ct

import numpy as np
import torch

from .cuda_build import count_launch, launch_stream
from .device import upload
from .lf_ref import build_lf_masks

PAD = 8

# kernel launches per name (counted where the CUDA kernel is launched)
LAUNCHES = {"deblock": 0}


def _edge_params(cls_grid, lvl, lvl_prev):
    """Resolve per-edge (cls, L) maps. L falls back to the neighbour
    side's level when the near side is 0 (reference lf_apply_tmpl.c
    level selection). E/I/H derive from L on the device."""
    L = np.where(lvl != 0, lvl, lvl_prev).astype(np.int32)
    active = (cls_grid >= 0) & (L > 0)
    cls = np.where(active, cls_grid, -1).astype(np.int8)
    return cls, L.astype(np.uint8)


def filter_values(col, cls4, E4, I4, H4, bd, luma):
    """Deblock edge-filter math (reference src/loopfilter_tmpl.c:37-162;
    dav1d_tpu ops/lf.py filter_values term by term): given a tap
    accessor col(o) -> int32 tensor of plane pixels at offset o from
    each edge (o=-1-i for p_i, o=i for q_i) and per-position int32
    maps (cls4 in {-1,0,1,2}; E4/I4/H4 already scaled by bitdepth),
    returns (vals, masks): dicts offset -> tensor, offsets -6..5
    (luma) / -2..1 (chroma)."""
    bdm8 = bd - 8
    F = 1 << bdm8
    px_max = (1 << bd) - 1
    lim = 128 << bdm8
    act = cls4 >= 0
    abs_ = torch.abs
    where = torch.where

    p0, p1, p2 = col(-1), col(-2), col(-3)
    q0, q1, q2 = col(0), col(1), col(2)
    fm = ((abs_(p1 - p0) <= I4) & (abs_(q1 - q0) <= I4) &
          (abs_(p0 - q0) * 2 + (abs_(p1 - q1) >> 1) <= E4))
    e6 = (abs_(p2 - p1) <= I4) & (abs_(q2 - q1) <= I4)
    if luma:
        p3, q3 = col(-4), col(3)
        e8 = (abs_(p3 - p2) <= I4) & (abs_(q3 - q2) <= I4)
        # luma classes: 0=wd4 1=wd8 2=wd16 (wd>4 adds e6, wd>6 e8)
        fm = fm & ((cls4 < 1) | (e6 & e8))
    else:
        fm = fm & ((cls4 < 1) | e6)
    fm = fm & act

    # narrow (wd4) filter, always computed
    hev = (abs_(p1 - p0) > H4) | (abs_(q1 - q0) > H4)
    fdiff = torch.clamp(p1 - q1, -lim, lim - 1)
    f = where(hev,
              torch.clamp(3 * (q0 - p0) + fdiff, -lim, lim - 1),
              torch.clamp(3 * (q0 - p0), -lim, lim - 1))
    f1 = torch.clamp(f + 4, max=lim - 1) >> 3
    f2 = torch.clamp(f + 3, max=lim - 1) >> 3
    f3 = (f1 + 1) >> 1
    vals = {
        -2: where(hev, p1, torch.clamp(p1 + f3, 0, px_max)),
        -1: torch.clamp(p0 + f2, 0, px_max),
        0: torch.clamp(q0 - f1, 0, px_max),
        1: where(hev, q1, torch.clamp(q1 - f3, 0, px_max)),
    }
    masks = {o: fm for o in vals}

    flat8in = ((abs_(p2 - p0) <= F) & (abs_(p1 - p0) <= F) &
               (abs_(q1 - q0) <= F) & (abs_(q2 - q0) <= F))
    if luma:
        flat8in = flat8in & (abs_(p3 - p0) <= F) & (abs_(q3 - q0) <= F)
        p6, p5, p4 = col(-7), col(-6), col(-5)
        q4, q5, q6 = col(4), col(5), col(6)
        flat8out = ((abs_(p6 - p0) <= F) & (abs_(p5 - p0) <= F) &
                    (abs_(p4 - p0) <= F) & (abs_(q4 - q0) <= F) &
                    (abs_(q5 - q0) <= F) & (abs_(q6 - q0) <= F))
        m16 = (cls4 >= 2) & flat8out & flat8in & fm
        m8 = (cls4 >= 1) & flat8in & ~m16 & fm
        v8 = {
            -3: (p3 + p3 + p3 + 2 * p2 + p1 + p0 + q0 + 4) >> 3,
            -2: (p3 + p3 + p2 + 2 * p1 + p0 + q0 + q1 + 4) >> 3,
            -1: (p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2 + 4) >> 3,
            0: (p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3 + 4) >> 3,
            1: (p1 + p0 + q0 + 2 * q1 + q2 + q3 + q3 + 4) >> 3,
            2: (p0 + q0 + q1 + 2 * q2 + q3 + q3 + q3 + 4) >> 3,
        }
        v16 = {
            -6: (p6 + p6 + p6 + p6 + p6 + p6 * 2 + p5 * 2 + p4 * 2 +
                 p3 + p2 + p1 + p0 + q0 + 8) >> 4,
            -5: (p6 + p6 + p6 + p6 + p6 + p5 * 2 + p4 * 2 + p3 * 2 +
                 p2 + p1 + p0 + q0 + q1 + 8) >> 4,
            -4: (p6 + p6 + p6 + p6 + p5 + p4 * 2 + p3 * 2 + p2 * 2 +
                 p1 + p0 + q0 + q1 + q2 + 8) >> 4,
            -3: (p6 + p6 + p6 + p5 + p4 + p3 * 2 + p2 * 2 + p1 * 2 +
                 p0 + q0 + q1 + q2 + q3 + 8) >> 4,
            -2: (p6 + p6 + p5 + p4 + p3 + p2 * 2 + p1 * 2 + p0 * 2 +
                 q0 + q1 + q2 + q3 + q4 + 8) >> 4,
            -1: (p6 + p5 + p4 + p3 + p2 + p1 * 2 + p0 * 2 + q0 * 2 +
                 q1 + q2 + q3 + q4 + q5 + 8) >> 4,
            0: (p5 + p4 + p3 + p2 + p1 + p0 * 2 + q0 * 2 + q1 * 2 +
                q2 + q3 + q4 + q5 + q6 + 8) >> 4,
            1: (p4 + p3 + p2 + p1 + p0 + q0 * 2 + q1 * 2 + q2 * 2 +
                q3 + q4 + q5 + q6 + q6 + 8) >> 4,
            2: (p3 + p2 + p1 + p0 + q0 + q1 * 2 + q2 * 2 + q3 * 2 +
                q4 + q5 + q6 + q6 + q6 + 8) >> 4,
            3: (p2 + p1 + p0 + q0 + q1 + q2 * 2 + q3 * 2 + q4 * 2 +
                q5 + q6 + q6 + q6 + q6 + 8) >> 4,
            4: (p1 + p0 + q0 + q1 + q2 + q3 * 2 + q4 * 2 + q5 * 2 +
                q6 + q6 + q6 + q6 + q6 + 8) >> 4,
            5: (p0 + q0 + q1 + q2 + q3 + q4 * 2 + q5 * 2 + q6 * 2 +
                q6 + q6 + q6 + q6 + q6 + 8) >> 4,
        }
        for o in range(-6, 6):
            v, mk = vals.get(o), masks.get(o)
            if o in v8:
                v = v8[o] if v is None else where(m8, v8[o], v)
                mk = m8 if mk is None else (mk | m8)
            v = v16[o] if v is None else where(m16, v16[o], v)
            mk = m16 if mk is None else (mk | m16)
            vals[o], masks[o] = v, mk
    else:
        m6 = (cls4 >= 1) & flat8in & fm
        v6 = {
            -2: (p2 + 2 * p2 + 2 * p1 + 2 * p0 + q0 + 4) >> 3,
            -1: (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
            0: (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3,
            1: (p0 + 2 * q0 + 2 * q1 + 2 * q2 + q2 + 4) >> 3,
        }
        for o, v in v6.items():
            vals[o] = where(m6, v, vals[o])
    return vals, masks


def _vertical_plain(plane, cls, L, lut_e, lut_i, bd, luma):
    """Plain vertical-edge pass on an (H, 4*w4) int32 plane."""
    bdm8 = bd - 8
    H, W = plane.shape
    wn = W // 4
    P = torch.zeros((H, W + 2 * PAD), dtype=torch.int32,
                    device=plane.device)
    P[:, PAD:PAD + W] = plane

    def col(o):
        return P[:, PAD + o:PAD + o + 4 * wn:4]

    Li = L.to(torch.int64)
    rep = lambda m: torch.repeat_interleave(m.to(torch.int32), 4, dim=0)
    cls4 = rep(cls)
    E4 = rep(lut_e[Li]) << bdm8
    I4 = rep(lut_i[Li]) << bdm8
    H4 = rep(Li >> 4) << bdm8
    vals, masks = filter_values(col, cls4, E4, I4, H4, bd, luma)
    out = P.clone()
    # ascending offset = the nearer-to-origin edge written last (wins)
    for o in sorted(vals):
        sl = slice(PAD + o, PAD + o + 4 * wn, 4)
        out[:, sl] = torch.where(masks[o], vals[o], out[:, sl])
    return out[:, PAD:PAD + W]


def deblock_pass_plain(plane, cls, L, lut_e, lut_i, bd, luma, vertical):
    """One directional pass, plain torch. plane (4*h4, 4*w4) int32;
    cls int8 / L uint8 (h4, w4) in plane orientation; lut_e/lut_i
    (64,) int32. Returns the filtered plane (a new tensor)."""
    if vertical:
        return _vertical_plain(plane, cls, L, lut_e, lut_i, bd, luma)
    return _vertical_plain(plane.t(), cls.t(), L.t(), lut_e, lut_i, bd,
                           luma).t().contiguous()


def deblock_frame_plain(entries, lut_e, lut_i, bd):
    """Deblock planes, plain torch: entries [(plane, luma, vmaps,
    hmaps)], each maps pair (cls, L); per plane the vertical pass, then
    the horizontal one, with deblock_pass_plain (the reference's
    cols-then-rows order). Returns the filtered planes."""
    return [deblock_pass_plain(
        deblock_pass_plain(plane, *vmaps, lut_e, lut_i, bd, luma, True),
        *hmaps, lut_e, lut_i, bd, luma, False)
        for plane, luma, vmaps, hmaps in entries]


_LIB = None
MAX_PLANES = 3          # planes one launch of csrc/deblock.cu takes


def _lib():
    global _LIB
    if _LIB is None:
        from .cuda_build import load_library
        lib = load_library("deblock")
        lib.deblock_frame.restype = ct.c_int
        lib.deblock_frame.argtypes = [
            ct.c_void_p, ct.c_void_p, ct.c_int, ct.c_void_p, ct.c_void_p,
            ct.c_int, ct.c_void_p]
        lib.deblock_blocks_per_sm.restype = ct.c_int
        lib.deblock_blocks_per_sm.argtypes = []
        _LIB = lib
    return _LIB


def deblock_frame_cuda(entries, lut_e, lut_i, bd):
    """deblock_frame_plain's contract with one launch of the CUDA kernel
    (csrc/deblock.cu) for every plane and both directions; CUDA tensors
    only, each plane 16-byte aligned (the kernel moves pixels 16 bytes
    at a time). Each output is a fresh tensor, written whole by the
    kernel. Launches on the current stream and does not synchronise."""
    from .cuda_build import check_tensor as check
    if not 1 <= len(entries) <= MAX_PLANES:
        raise ValueError(f"{len(entries)} planes, expected 1..3")
    if bd not in (8, 10, 12):
        raise ValueError(f"bitdepth {bd}")
    dev = entries[0][0].device
    if dev.type != "cuda":
        raise ValueError("deblock_frame_cuda needs CUDA tensors")
    check(lut_e, "lut_e", torch.int32, dev, (64,))
    check(lut_i, "lut_i", torch.int32, dev, (64,))
    ptrs, dims, outs = [], [], []
    for n, (plane, luma, vmaps, hmaps) in enumerate(entries):
        H, W = plane.shape
        if H % 4 or W % 4:
            raise ValueError(f"plane shape {(H, W)} not a multiple of 4")
        h4, w4 = H // 4, W // 4
        check(plane, f"plane {n}", torch.int32, dev, (H, W))
        if plane.data_ptr() % 16:
            raise ValueError(f"plane {n} is not 16-byte aligned")
        out = torch.empty_like(plane)
        ptrs += [plane.data_ptr(), out.data_ptr()]
        for d, (cls, L) in (("v", vmaps), ("h", hmaps)):
            check(cls, f"{d}cls {n}", torch.int8, dev, (h4, w4))
            check(L, f"{d}L {n}", torch.uint8, dev, (h4, w4))
            ptrs += [cls.data_ptr(), L.data_ptr()]
        dims += [h4, w4, int(bool(luma))]
        outs.append(out)
    rc = _lib().deblock_frame(
        (ct.c_void_p * len(ptrs))(*ptrs), (ct.c_int * len(dims))(*dims),
        len(entries), lut_e.data_ptr(), lut_i.data_ptr(), bd,
        launch_stream(dev))
    if rc != 0:
        raise RuntimeError(f"deblock kernel launch failed: CUDA error {rc}")
    count_launch(LAUNCHES, "deblock")
    return outs


def deblock_frame(entries, lut_e, lut_i, bd):
    """Deblock planes: the CUDA kernel (one launch) for CUDA tensors,
    the plain version for CPU tensors."""
    dev = entries[0][0].device
    if dev.type == "cuda":
        return deblock_frame_cuda(entries, lut_e, lut_i, bd)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return deblock_frame_plain(entries, lut_e, lut_i, bd)


def _pad_maps(maps, n4h, n4w):
    """Grow (cls, L) maps to the full padded-plane 4x4 grid; inactive
    positions get cls=-1 (pass-through)."""
    cls, L = maps
    out_cls = np.full((n4h, n4w), -1, np.int8)
    out_cls[:cls.shape[0], :cls.shape[1]] = cls
    out_l = np.zeros((n4h, n4w), np.uint8)
    out_l[:L.shape[0], :L.shape[1]] = L
    return out_cls, out_l


def frame_maps(plan, shapes):
    """The host side of a frame's deblock: [(plane index, luma, vmaps,
    hmaps)] with numpy (cls int8, L uint8) maps on each deblocked
    plane's full 4x4 grid (shapes: the planes' (H, W)). Edges near the
    frame boundary read the prediction overshoot in the padding (the
    reference filters its padded picture too), so the maps cover the
    full planes, padded by inactive entries."""
    lflf = plan.f.frame_hdr.loopfilter
    from .lf_native import build_lf_masks_native
    m = build_lf_masks_native(plan)
    if m is None:
        m = build_lf_masks(plan)
    out = []
    if lflf.level_y[0] or lflf.level_y[1]:
        ah, aw = shapes[0]
        fh4, fw4 = ah // 4, aw // 4
        lvl_v = m.lvl[:, :, 0].astype(np.int32)
        lvl_h = m.lvl[:, :, 1].astype(np.int32)
        yv = _edge_params(
            m.vcls_y, lvl_v,
            np.concatenate([lvl_v[:, :1], lvl_v[:, :-1]], axis=1))
        yv[0][:, 0] = -1
        yh = _edge_params(
            m.hcls_y, lvl_h,
            np.concatenate([lvl_h[:1], lvl_h[:-1]], axis=0))
        yh[0][0, :] = -1
        out.append((0, True, _pad_maps(yv, fh4, fw4),
                    _pad_maps(yh, fh4, fw4)))
    if len(shapes) > 1 and (lflf.level_u or lflf.level_v):
        ch4, cw4 = m.ch4, m.cw4
        ah, aw = shapes[1]
        fh4, fw4 = ah // 4, aw // 4
        for pl in range(2):
            lvl_v = m.lvl[:ch4, :cw4, 2 + pl].astype(np.int32)
            pv = _edge_params(
                m.vcls_uv, lvl_v,
                np.concatenate([lvl_v[:, :1], lvl_v[:, :-1]], axis=1))
            pv[0][:, 0] = -1
            ph = _edge_params(
                m.hcls_uv, lvl_v,
                np.concatenate([lvl_v[:1], lvl_v[:-1]], axis=0))
            ph[0][0, :] = -1
            out.append((1 + pl, False, _pad_maps(pv, fh4, fw4),
                        _pad_maps(ph, fh4, fw4)))
    return out


def upload_maps(maps, device):
    """frame_maps' numpy maps -> the same list with (cls int8, L uint8)
    tensors on `device`: views of one buffer that crosses to the device
    in a single host-to-device copy."""
    parts = [a.view(np.uint8).reshape(-1) for _, _, vm, hm in maps
             for a in (*vm, *hm)]
    buf = upload(np.concatenate(parts), device)
    out, pos = [], 0
    for pi, luma, vm, hm in maps:
        dev_maps = []
        for cls, L in (vm, hm):
            n = cls.size
            cls_d = buf[pos:pos + n].view(torch.int8).view(cls.shape)
            dev_maps.append((cls_d, buf[pos + n:pos + 2 * n].view(L.shape)))
            pos += 2 * n
        out.append((pi, luma, *dev_maps))
    return out


def deblock_planes_device(planes, plan, bd):
    """Deblock int32 plane tensors (all on one device). planes: [y] or
    [y, u, v] full padded picture planes. The maps of every deblocked
    plane cross to the device in one copy; on CUDA one kernel launch
    filters every plane in both directions. Returns a new list."""
    from ..utils import timing
    from .device import device_tables
    device = planes[0].device
    with timing.phase("deblock.masks"):
        maps = frame_maps(plan, [tuple(p.shape) for p in planes])
    out = list(planes)
    if not maps:
        return out
    with timing.phase("deblock.maps_upload"):
        maps = upload_maps(maps, device)
    sharpness = plan.f.frame_hdr.loopfilter.sharpness
    tb = device_tables(device)
    with timing.phase("deblock.launch"):
        got = deblock_frame(
            [(planes[pi], luma, vm, hm) for pi, luma, vm, hm in maps],
            tb["lf_lut_e"][sharpness].contiguous(),
            tb["lf_lut_i"][sharpness].contiguous(), bd)
    for (pi, *_), g in zip(maps, got):
        out[pi] = g
    return out
