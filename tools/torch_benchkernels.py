#!/usr/bin/env python3
"""Per-kernel device benchmark of the PyTorch/CUDA port: the checkasm
`--bench` analogue (dav1d_tpu's is tools/benchkernels.py). Times each
family's production kernel in isolation on one card, on seeded inputs
of ops/kernel_cases.py at 1080p shapes (8-bit 4:2:0; references and
planes of a 1920x1080 frame, the MC and residual jobs tiling it), and
prints one JSON line a kernel:

- us: the device time of one launch (chip_smoke.py `_launch_us`:
  torch.profiler, median of 5 launches; a trace without the kernel or
  below a one-element fill's time is retaken, after 3 the CUDA events'
  time of a call, an upper bound, named in `timer`);
- bound_us / bound_by: the least time the card could take for the same
  work, chip_smoke.py's `_*_work` bytes and int32 ops over 3.35 TB/s
  and 33.5 TOP/s, the larger;
- plain_ms: the plain torch version on the same CUDA tensors (the
  host clock around one synchronised call, after a warm-up);
- the work's shape, and the card's name and power limit
  (nvidia-smi --query-gpu=name,power.limit --format=csv,noheader).

Window origins are drawn as the kernel cases draw them, on and across
the frame's edges as often as inside it, so the MC rows are synthetic
frames, not a stream's (chip_smoke.py's kernel_real times s31's).

    python tools/torch_benchkernels.py [--out FILE] [family ...]
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np

FAMILIES = ("deblock", "mc_put", "mc_comp", "itx_add", "mc_warp", "mc_obmc",
            "cdef", "lr_wiener", "lr_sgr", "superres", "film_grain", "ipred")
BD = 8
H, W = 1080, 1920
# the cases' references: a 1080p frame's allocated and valid shapes
GEOMETRY = dict(ref_shape=(1152, W), frame=(H, W))
# put and compound block sizes a frame is tiled with (luma, 4:2:0)
PUT_TILES = [(8, 8), (16, 16), (8, 16), (16, 8), (4, 8), (8, 4), (32, 32),
             (16, 32), (32, 16), (4, 4), (4, 16), (16, 4)]
COMP_TILES = [(8, 8), (16, 16), (8, 16), (16, 8), (32, 32), (16, 32),
              (32, 16), (8, 32), (32, 8)]


def _fill(tiles, height, width, extra=()):
    """The longest cycle of `tiles` (plus `extra` per tile) that
    kernel_cases.pack lays out within height rows of width columns."""
    from dav1d_tpu_torch.ops import kernel_cases as kc
    sizes = [tiles[i % len(tiles)] for i in range(height * width // 64)]
    py, _, _ = kc.pack(sizes, width)
    n = int(np.argmax(py + np.array([h for h, _ in sizes]) > height))
    return [(*s, *extra) for s in sizes[:n or len(sizes)]]


class _Env:
    """What every family's builder uses: torch, the device, a numpy ->
    tensor copy, the device LUTs, chip_smoke's work counts and the
    kernel cases."""

    def __init__(self, torch, dev):
        import chip_smoke
        from dav1d_tpu_torch.ops import kernel_cases
        from dav1d_tpu_torch.ops.device import device_tables
        self.torch, self.dev, self.cs, self.kc = torch, dev, chip_smoke, \
            kernel_cases
        self.tb = device_tables(dev)

    def T(self, a):
        return self.torch.from_numpy(np.ascontiguousarray(a)).to(self.dev)

    def zeros(self, shape):
        return self.torch.zeros(shape, dtype=self.torch.int32,
                                device=self.dev)


def _deblock(e):
    from dav1d_tpu_torch.ops import lf
    from dav1d_tpu_torch.ops.lf_ref import calc_eih
    rng = np.random.default_rng(1)
    entries, shapes = [], []
    for luma, (h4, w4) in ((True, (272, 480)), (False, (136, 240)),
                           (False, (136, 240))):
        plane, maps = e.cs._lf_inputs(rng, h4, w4, BD)
        entries.append((e.T(plane), luma,
                        *[tuple(map(e.T, m)) for m in maps]))
        shapes.append((h4, w4))
    le, li = (e.T(np.asarray(a, np.int32)) for a in calc_eih(3))
    fused, _, ops = e.cs._deblock_frame_work(shapes)
    return (lambda: lf.deblock_frame_cuda(entries, le, li, BD),
            lambda: lf.deblock_frame_plain(entries, le, li, BD),
            (fused, ops), "4:2:0 1088x1920, both directions")


def _put(e):
    from dav1d_tpu_torch.ops import mc
    case = e.kc.put_case(BD, 2, width=W,
                         sizes=_fill(PUT_TILES, H, W, (False,)), **GEOMETRY)
    rows, blk = mc.put_blocks(case["jobs"])
    rows, blk, jobs = e.T(rows), e.T(blk), e.T(case["jobs"])
    refs = [e.T(r) for r in case["refs"]]
    plane = e.zeros(case["dst_shape"])
    rh, rw = case["rh"], case["rw"]
    return (lambda: mc.put_cuda(refs, rows, plane, rh, rw, BD, blocks=blk),
            lambda: mc.put_plain(refs, jobs, plane, rh, rw, BD,
                                 e.tb["mc_filter_banks"]),
            e.cs._put_work(case["jobs"], len(refs), case["refs"].shape[1:],
                           rh, rw),
            f"luma, {len(jobs)} jobs")


def _comp(e):
    from dav1d_tpu_torch.ops import mc
    case = e.kc.comp_case(BD, 3, 1, 1, width=W,
                          sizes=_fill(COMP_TILES, H, W), **GEOMETRY)
    rows, blk = mc.comp_blocks(case["jobs_y"])
    rows, blk, jobs = e.T(rows), e.T(blk), e.T(case["jobs_y"])
    refs = [e.T(r) for r in case["refs_y"]]
    plane, seg = e.zeros(case["dst_y"]), e.zeros(case["seg_shape"])
    rh, rw = case["bounds_y"]
    wl = (e.tb["mc_wedge_lut16"], e.tb["mc_wedge_lut32"])
    return (lambda: mc.comp_cuda(refs, rows, plane, seg, rh, rw, BD, *wl,
                                 True, 1, 1, blocks=blk),
            lambda: mc.comp_plain(refs, jobs, plane, seg, rh, rw, BD,
                                  e.tb["mc_filter_banks"], *wl, True, 1, 1),
            e.cs._comp_work(case["jobs_y"], len(refs),
                            case["refs_y"].shape[1:], rh, rw, True, 1, 1),
            f"luma, {len(jobs)} jobs, every combine mode")


def _itx(e):
    from dav1d_tpu_torch.ops import itx
    case = e.kc.itx_case(BD, 4, width=W, repeat=11)
    rows, blk = itx.res_blocks(case["jobs"])
    rows, blk, jobs = e.T(rows), e.T(blk), e.T(case["jobs"])
    pool, plane = e.T(case["pool"]), e.T(case["plane"])
    return (lambda: itx.itx_add_cuda(pool, rows, plane, BD, blocks=blk),
            lambda: itx.itx_add_plain(pool, jobs, plane, BD),
            e.cs._itx_work(case["jobs"], False),
            f"{len(jobs)} jobs of every size and kind pair, plane "
            f"{tuple(plane.shape)}")


def _lap_work(e, case, warp):
    """chip_smoke's work of a warp_case's or obmc_case's launch, summed
    over its planes (and OBMC's directions)."""
    work = [0, 0]
    for pi, p in enumerate(case["planes"]):
        shape, n = p["refs"].shape[1:], len(p["refs"])
        if warp:
            parts = [e.cs._warp_work(case["jobs"][case["jobs"][:, 0] == pi],
                                     n, shape, p["rh"], p["rw"])]
        else:
            parts = [e.cs._obmc_work(case[k][case[k][:, 1] == pi], n, shape,
                                     p["rh"], p["rw"], k == "top",
                                     p["plane"].shape)
                     for k in ("top", "left")]
        for b, o in parts:
            work[0] += b
            work[1] += o
    return tuple(work)


def _warp(e):
    from dav1d_tpu_torch.ops import mc_warp
    case = e.kc.warp_case(BD, 5, tiles=682, width=W, **GEOMETRY)
    planes, jobs = e.kc.case_planes(case, e.dev), e.T(case["jobs"])
    return (lambda: mc_warp.warp_cuda(planes, jobs, BD),
            lambda: mc_warp.warp_planes_plain(planes, jobs, BD,
                                              e.tb["mc_warp_filter"]),
            _lap_work(e, case, True), f"{len(jobs)} tiles, 3 planes")


def _obmc(e):
    from dav1d_tpu_torch.ops import mc_obmc
    case = e.kc.obmc_case(BD, 6, width=W, repeat=40, **GEOMETRY)
    planes = e.kc.case_planes(case, e.dev)
    top, left = e.T(case["top"]), e.T(case["left"])
    return (lambda: mc_obmc.obmc_cuda(planes, top, left, BD),
            lambda: mc_obmc.obmc_frame_plain(planes, top, left, BD,
                                             e.tb["mc_filter_banks"],
                                             e.tb["mc_obmc_masks"]),
            _lap_work(e, case, False),
            f"{len(top)} top + {len(left)} left laps, 3 planes")


def _cdef(e):
    from dav1d_tpu_torch.ops import cdef
    args = e.kc.cdef_args(e.kc.cdef_case(BD, 7, 1, (H, W, 1152, W)), e.dev)
    return (lambda: cdef.cdef_cuda(*args),
            lambda: e.cs._filter_plain(e.torch, "cdef", args),
            e.cs._cdef_work(e.torch, *args), "4:2:0 1152x1920")


def _lr(e, fam):
    kind = fam[3:]
    args = e.kc.frame_args(e.kc.frame_case(BD, 1, kind, w_y=W, repeat=4),
                           e.dev, kind)
    return (lambda: e.cs._filter_cuda(fam, args),
            lambda: e.cs._filter_plain(e.torch, fam, args),
            e.cs._lr_work(fam, args),
            f"4:2:0, {len(args[1][0])} {kind} items, luma "
            f"{tuple(args[0][0][0].shape)}")


def _superres(e):
    from dav1d_tpu_torch.ops import superres
    jobs = e.kc.superres_args(e.kc.superres_case(BD, 1, 960, W, H), e.dev)
    return (lambda: superres.resize_frame_cuda(jobs, BD),
            lambda: superres.resize_frame_plain(jobs, BD),
            e.cs._superres_work(jobs),
            "4:2:0 960 -> 1920 columns, planes and pre-CDEF")


def _grain(e):
    from dav1d_tpu_torch.ops import fg
    args = e.kc.grain_args(e.kc.grain_case(BD, 1, W, H), e.dev)
    return (lambda: fg.film_grain_cuda(*args),
            lambda: fg.film_grain_plain(*args),
            e.cs._grain_work(*args), "4:2:0 1920x1080, overlap")


def _ipred(e):
    from dav1d_tpu_torch.ops import ipred
    planes, tables, pool = e.kc.plan_args(
        e.kc.plan_case(BD, 1, 1, 3, 8, width=W), e.dev)
    host = {k: v.cpu().numpy() for k, v in tables.items()}
    a = (planes, tables, pool, BD, 1, 1)
    return (lambda: ipred.plan_cuda(*a), lambda: ipred.plan_plain(*a),
            e.cs._ipred_work(host, [tuple(p.shape) for p in planes], 1, 1),
            f"4:2:0 plan of {len(host['levels'])} levels, "
            f"{len(host['units'])} units, 1920 wide")


BUILDERS = {"deblock": _deblock, "mc_put": _put, "mc_comp": _comp,
            "itx_add": _itx, "mc_warp": _warp, "mc_obmc": _obmc,
            "cdef": _cdef, "lr_wiener": lambda e: _lr(e, "lr_wiener"),
            "lr_sgr": lambda e: _lr(e, "lr_sgr"), "superres": _superres,
            "film_grain": _grain, "ipred": _ipred}


def cases(torch, dev, families=FAMILIES):
    """{family: (fn, plain, (bytes, ops), shape)}: fn launches the
    family's kernel once on `dev`'s tensors, plain runs its plain torch
    version on them."""
    e = _Env(torch, dev)
    return {fam: BUILDERS[fam](e) for fam in families}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write the JSON lines here")
    ap.add_argument("families", nargs="*", default=FAMILIES)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_benchkernels.py needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    card = cs.smi()
    dev = torch.device("cuda")
    fill = cs._fill_us(torch)
    lines = []
    for fam, (fn, plain, work, shape) in cases(torch, dev,
                                               args.families).items():
        us, _, timer = cs._launch_us(torch, fn, cs.KERNEL_NAMES[fam][0],
                                     fill)
        plain()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        bound_ms, bound_by = cs._bound(*work)
        lines.append({"kernel": fam, "shape": shape, "us": us,
                      "timer": timer, "bound_us": bound_ms * 1e3,
                      "bound_by": bound_by, "bytes": work[0],
                      "ops": work[1], "plain_ms": plain_ms, "card": card})
        print(json.dumps(lines[-1]), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write("".join(json.dumps(ln) + "\n" for ln in lines))
    print(f"\n{'kernel':12s} {'us':>9s} {'bound us':>9s} {'plain ms':>9s}"
          f"  {card}")
    for ln in lines:
        print(f"{ln['kernel']:12s} {ln['us']:9.2f} {ln['bound_us']:9.2f} "
              f"{ln['plain_ms']:9.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
