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
  deblock), each synchronized.

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
from dav1d_tpu_torch.ops import lf, mc_fused  # noqa: E402
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


def main():
    cuda = torch.cuda.is_available()
    device = "cuda" if cuda else "cpu"
    tables, deblocks = [], []
    orig = mc_fused._plane_tables, lf.deblock_planes_device

    def plane_tables(*args):
        tables.append(args)
        return orig[0](*args)

    def deblock_planes_device(planes, plan, bd):
        deblocks.append(([p.clone() for p in planes], plan, bd))
        return orig[1](planes, plan, bd)

    mc_fused._plane_tables = plane_tables
    lf.deblock_planes_device = deblock_planes_device
    try:
        decode(device, n_tu=2)
    finally:
        mc_fused._plane_tables, lf.deblock_planes_device = orig
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
