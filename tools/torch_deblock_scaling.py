"""Device time of the deblock kernel (csrc/deblock.cu) against the
number of 64x64 tiles it runs, on one GPU: one luma plane of 1, 132,
264, 396, 528, 792 and 1056 tiles (64 rows, 64 x n columns; random
maps, the chip_smoke.py recipe, 75% of the positions active), each
launch timed by torch.profiler (median of 10). With as many tiles as
SMs each SM runs one block, so that launch reads a block's latency;
the occupancy query says how many blocks a SM holds at once. Prints one
JSON line.

    python tools/torch_deblock_scaling.py
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from dav1d_tpu_torch.ops import lf  # noqa: E402
from dav1d_tpu_torch.ops.lf_ref import calc_eih  # noqa: E402


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    dev = torch.device("cuda")
    e, i = calc_eih(3)
    lut_e = torch.from_numpy(e.astype(np.int32)).to(dev)
    lut_i = torch.from_numpy(i.astype(np.int32)).to(dev)
    out = {"card": cs.smi(), "sms": torch.cuda.get_device_properties(
        0).multi_processor_count,
        "blocks_per_sm": lf._lib().deblock_blocks_per_sm(), "launch_us": {}}
    for n in (1, 132, 264, 396, 528, 792, 1056):
        plane, maps = cs._lf_inputs(np.random.default_rng(n), 16, 16 * n, 8)
        ent = [(torch.from_numpy(plane).to(dev), True,
                *[tuple(torch.from_numpy(a).to(dev) for a in m)
                  for m in maps])]
        lf.deblock_frame_cuda(ent, lut_e, lut_i, 8)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                lf.deblock_frame_cuda(ent, lut_e, lut_i, 8)
            torch.cuda.synchronize()
        ts = sorted(ev.time_range.elapsed_us() for ev in prof.events()
                    if ev.device_type == torch.autograd.DeviceType.CUDA
                    and "deblock_" in ev.name)
        out["launch_us"][n] = ts[len(ts) // 2]
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
