"""Host cost of the inter upload's table step and of the deblock
wrapper on the s7 stream's first inter frame
(bench_streams/1920x1080_8b_flt_s7.ivf, its first 2 temporal units):

- ops/mc_fused.py `_plane_tables` (the per-plane split, and the class
  sort and block tables where the checkout has them), median of 50
  calls;
- with a GPU, ops/lf.py `deblock_planes_device` on that frame's planes:
  the host map build, the map uploads, the launches and their device
  work, synchronized before and after (what a frame's deblock holds the
  Stage-B thread), median of 20 calls;
- with a GPU, the wall ms of 3 decodes of all 8 frames through the
  public API (untimed stages, after the first decode), and their md5;
- where the checkout has them, the parts in one process, median of 20
  calls each: ops/mc.py `put_blocks` on the frame's puts (the put
  binning); ops/lf.py `frame_maps` (the host map build) and, with a
  GPU, `upload_maps` (every plane's maps in one copy) beside twelve
  copies of one map each (how the maps crossed before the one-launch
  deblock), each synchronized;
- the host parts of CDEF and loop restoration on that frame, median of
  20 calls each: ops/cdef.py `_block_maps` (the (6, nby, nbx) map pack)
  and, with a GPU, its upload; where the checkout has them, ops/lr.py
  `plane_items` (the Python item walk) and `item_tables` (the numpy
  row and parameter tables), with a GPU `upload_tables` and
  `plane_sources` (the edge-padded sources); and with a GPU the whole
  `cdef_planes_device` and `lr_planes_device` calls, synchronized (what a frame's CDEF and LR hold the Stage-B
  thread).

Without a GPU the stream decodes with device="cpu" and the numbers
that need one are left out. Prints one JSON line.

    python tools/torch_host_tables.py [checkout]

The checkout defaults to this one; give another (a `git archive` of
the parent, say) to compare the two on one host, in turns: parent,
change, change, parent.
"""
import json
import os
import sys
import time

root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                       os.path.dirname(os.path.dirname(
                           os.path.abspath(__file__))))
sys.path.insert(0, root)

import torch  # noqa: E402

from dav1d_tpu_torch.api import Decoder, Settings  # noqa: E402
from dav1d_tpu_torch.bitstream.ivf import IvfReader  # noqa: E402
from dav1d_tpu_torch.ops import cdef, lf, lr, mc_fused  # noqa: E402
from dav1d_tpu_torch.utils.muxers import Md5Muxer  # noqa: E402

PATH = os.path.join(root, "bench_streams", "1920x1080_8b_flt_s7.ivf")


def decode(device, n_tu=None):
    """Decode the stream's first n_tu temporal units (all with None);
    returns (wall ms, md5)."""
    data = open(PATH, "rb").read()
    mux = Md5Muxer()
    t0 = time.perf_counter()
    dec = Decoder(Settings(device=device))
    for i, fr in enumerate(IvfReader(data)):
        if n_tu is not None and i >= n_tu:
            break
        dec.send_data(fr.data)
        for pic in dec.pictures():
            mux.write_picture(pic)
    dec.close()
    return (time.perf_counter() - t0) * 1e3, mux.digest()


def median(xs):
    return sorted(xs)[len(xs) // 2]


def ms(fn, n=20, sync=False):
    """Median wall ms of n calls of fn (synchronized with sync)."""
    times = []
    for _ in range(n):
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if sync:
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return median(times) * 1e3


def filter_host_ms(filters, device):
    """Median ms of the host parts of the frame's CDEF and LR, and with
    a GPU of the whole calls (module docstring)."""
    cuda = device == "cuda"
    out = {}
    planes, plan, bd = filters["cdef"]
    out["cdef_block_maps_ms_median"] = ms(lambda: cdef._block_maps(plan, bd))
    if cuda:
        maps = cdef._block_maps(plan, bd)
        if isinstance(maps, tuple):         # a checkout of six maps
            out["cdef_maps_upload_ms_median"] = ms(
                lambda: [torch.from_numpy(m).to(device) for m in maps],
                sync=True)
        else:
            out["cdef_maps_upload_ms_median"] = ms(
                lambda: torch.from_numpy(maps).to(device), sync=True)
        out["cdef_planes_device_ms_median"] = ms(
            lambda: cdef.cdef_planes_device(planes, plan, bd), sync=True)
    cur, pre, plan, bd = filters["lr"]
    if hasattr(lr, "plane_items"):
        sgrp = lr._sgr_params_tbl()
        out["lr_plane_items_ms_median"] = ms(lambda: lr.plane_items(plan))
        jobs = [(kind, sel, hmax, cur[pi], pre[pi], w, wmax)
                for pi, w, hmax, wmax, kinds in lr.plane_items(plan)
                for kind, sel in kinds.items() if sel]

        def tables():
            return [lr.item_tables(k, sel, sgrp, hmax, c.shape[0])
                    for k, sel, hmax, c, _, _, _ in jobs]
        out["lr_item_tables_ms_median"] = ms(tables)
        if cuda:
            tbls = tables()
            out["lr_upload_tables_ms_median"] = ms(
                lambda: [lr.upload_tables(t, device) for t in tbls],
                sync=True)
            out["lr_plane_sources_ms_median"] = ms(
                lambda: [lr.plane_sources(c, p[:c.shape[0]], w, wmax)
                         for _, _, _, c, p, w, wmax in jobs], sync=True)
    if cuda:
        out["lr_planes_device_ms_median"] = ms(
            lambda: lr.lr_planes_device(cur, pre, plan, bd), sync=True)
    return out


def main():
    cuda = torch.cuda.is_available()
    device = "cuda" if cuda else "cpu"
    tables, deblocks, filters = [], [], {}
    orig = mc_fused._plane_tables, lf.deblock_planes_device
    orig_f = cdef.cdef_planes_device, lr.lr_planes_device

    def plane_tables(*args):
        tables.append(args)
        return orig[0](*args)

    def deblock_planes_device(planes, plan, bd):
        deblocks.append(([p.clone() for p in planes], plan, bd))
        return orig[1](planes, plan, bd)

    def cdef_planes_device(planes, plan, bd):
        filters["cdef"] = ([p.clone() for p in planes], plan, bd)
        return orig_f[0](planes, plan, bd)

    def lr_planes_device(planes, pre, plan, bd):
        filters["lr"] = ([p.clone() for p in planes],
                         [p.clone() for p in pre], plan, bd)
        return orig_f[1](planes, pre, plan, bd)

    mc_fused._plane_tables = plane_tables
    lf.deblock_planes_device = deblock_planes_device
    cdef.cdef_planes_device, lr.lr_planes_device = (cdef_planes_device,
                                                    lr_planes_device)
    try:
        decode(device, n_tu=2)
    finally:
        mc_fused._plane_tables, lf.deblock_planes_device = orig
        cdef.cdef_planes_device, lr.lr_planes_device = orig_f
    out = {"checkout": root, "device": device,
           "plane_tables_ms_median": ms(lambda: orig[0](*tables[0]), 50)}
    from dav1d_tpu_torch.ops import mc
    if hasattr(mc, "put_blocks"):
        puts = tables[0][0]["puts"]
        out["put_blocks_ms_median"] = ms(
            lambda: mc.put_blocks(puts, group=puts[:, 0]))
    if hasattr(lf, "upload_maps"):
        planes, plan, bd = deblocks[-1]
        shapes = [tuple(p.shape) for p in planes]
        maps = lf.frame_maps(plan, shapes)
        out["frame_maps_ms_median"] = ms(lambda: lf.frame_maps(plan, shapes))
        if cuda:
            out["upload_maps_ms_median"] = ms(
                lambda: lf.upload_maps(maps, device), sync=True)
            out["upload_per_map_ms_median"] = ms(
                lambda: [torch.from_numpy(a).to(device) for _, _, vm, hm in
                         maps for a in (*vm, *hm)], sync=True)
    out.update(filter_host_ms(filters, device))
    if cuda:
        planes, plan, bd = deblocks[-1]
        orig[1](planes, plan, bd)
        out["deblock_wrapper_ms_median"] = ms(
            lambda: orig[1](planes, plan, bd), sync=True)
        walls, md5s = zip(*[decode(device) for _ in range(3)])
        out.update({"s7_wall_ms": list(walls),
                    "s7_wall_ms_median": median(walls),
                    "s7_md5": sorted(set(md5s))})
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
