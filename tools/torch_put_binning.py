"""Device time of the put kernel (csrc/mc_put.cu) on the s7 stream's
frame-2 put tables (bench_streams/1920x1080_8b_flt_s7.ivf, the first 2
temporal units decoded on the GPU) under two block tables of the same
jobs, in one process:

- "put_blocks": the checkout's ops/mc.py put_blocks, as the decode sends
  it;
- "shape": every job binned by its tile shape alone, so that a job with
  amx = amy = 0 runs as a filtered job (its identity taps give the same
  pixels, tests/test_torch_mc.py::test_copy_premise).

The two differ where put_blocks gives integer-motion jobs copy classes
of their own. Both are checked against the plain put (torch.equal).
Rounds alternate put_blocks, shape, shape, put_blocks; each round's
time is the median device us (torch.profiler) of 5 launches on fresh
output planes. Prints one JSON line.

    python tools/torch_put_binning.py [checkout] [rounds]
"""
import json
import os
import sys

root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                       os.path.dirname(os.path.dirname(
                           os.path.abspath(__file__))))
ROUNDS = int(sys.argv[2]) if len(sys.argv) > 2 else 4
sys.path.insert(0, root)
os.chdir(root)

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402


def shape_blocks(mc, jobs):
    """put_blocks' table with the copy term of the class left out."""
    lh, lw = mc._log2m1(jobs, "put", 2)
    large = (lh > 4) | (lw > 4)
    cls = np.minimum(lh, 4) * 5 + np.minimum(lw, 4)
    return mc._tile_blocks(jobs, cls, large, 2 * mc.PUT_CLASSES, mc._PUT_CAP,
                           jobs[:, 0])


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = cs.smi()
    cs.phase_build()
    from dav1d_tpu_torch.ops import mc
    from dav1d_tpu_torch.ops.device import device_tables
    dev = torch.device("cuda")
    calls = []
    orig = mc.put_planes

    def put_planes(planes, jobs, bd, blocks=None):
        calls.append(([(r, torch.zeros_like(p), rh, rw)
                       for r, p, rh, rw in planes], jobs.clone(), bd))
        return orig(planes, jobs, bd, blocks)

    mc.put_planes = put_planes
    try:
        cs._decode(cs.STREAM_S7, timed=False, n_tu=2)
    finally:
        mc.put_planes = orig
    planes, jobs, bd = calls[-1]
    j = jobs.cpu().numpy()
    tables = {"put_blocks": mc.put_blocks(j, group=j[:, 0]),
              "shape": shape_blocks(mc, j)}
    want = [(r, p.clone(), rh, rw) for r, p, rh, rw in planes]
    mc.put_planes_plain(want, jobs, bd,
                        device_tables(dev)["mc_filter_banks"])
    runs = {}
    for name, (rows, blk) in tables.items():
        rows_d = torch.from_numpy(rows).to(dev)
        blk_d = torch.from_numpy(blk).to(dev)

        def fn(rows_d=rows_d, blk_d=blk_d):
            out = [(r, p.clone(), rh, rw) for r, p, rh, rw in planes]
            mc.put_planes_cuda(out, rows_d, bd, blk_d)
            return out
        for (_, got, _, _), (_, w, _, _) in zip(fn(), want):
            torch.cuda.synchronize()
            if not torch.equal(got, w):
                raise AssertionError(f"{name}: kernel != plain")
        runs[name] = fn

    def round_us(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        ts = sorted(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and "mc_put_kernel" in e.name)
        if not ts:
            raise RuntimeError("torch.profiler saw no mc_put kernel")
        return ts[len(ts) // 2]

    us = {k: [] for k in runs}
    for _ in range(ROUNDS):
        for name in ("put_blocks", "shape", "shape", "put_blocks"):
            us[name].append(round_us(runs[name]))
    print(json.dumps({
        "checkout": root, "card": card, "jobs": len(j),
        "copy_jobs": int(((j[:, 8] == 0) & (j[:, 9] == 0)).sum()),
        "blocks": {k: len(v[1]) for k, v in tables.items()},
        "device_us": us,
        "median_us": {k: sorted(v)[len(v) // 2] for k, v in us.items()}}),
        flush=True)


if __name__ == "__main__":
    main()
