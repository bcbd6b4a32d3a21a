"""Host time of the inter upload's table step, ops/mc_fused.py
`_plane_tables` (the per-plane split, and the class sort and block
tables where the checkout has them), on the tables of the s7 stream's
first inter frame (bench_streams/1920x1080_8b_flt_s7.ivf, decoded with
device="cpu"); prints one JSON line with the median of 50 calls.

    python tools/torch_host_tables.py [checkout]

The checkout defaults to this one; give another (a `git archive` of
the parent, say) to compare the two on one host.
"""
import json
import os
import sys
import time

root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                       os.path.dirname(os.path.dirname(
                           os.path.abspath(__file__))))
sys.path.insert(0, root)

from dav1d_tpu_torch.api import Decoder, Settings  # noqa: E402
from dav1d_tpu_torch.bitstream.ivf import IvfReader  # noqa: E402
from dav1d_tpu_torch.ops import mc_fused  # noqa: E402


def main():
    seen = []
    orig = mc_fused._plane_tables

    def spy(*args):
        seen.append(args)
        return orig(*args)

    mc_fused._plane_tables = spy
    try:
        dec = Decoder(Settings(device="cpu"))
        path = os.path.join(root, "bench_streams", "1920x1080_8b_flt_s7.ivf")
        for i, fr in enumerate(IvfReader(open(path, "rb").read())):
            if i >= 2:
                break
            dec.send_data(fr.data)
            list(dec.pictures())
    finally:
        mc_fused._plane_tables = orig
    args = seen[0]
    times = []
    for _ in range(50):
        t0 = time.perf_counter()
        orig(*args)
        times.append(time.perf_counter() - t0)
    print(json.dumps({"checkout": root, "plane_tables_ms_median":
                      sorted(times)[len(times) // 2] * 1e3}))


if __name__ == "__main__":
    main()
