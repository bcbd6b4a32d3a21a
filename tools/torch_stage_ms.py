"""Stage ms (utils.timing phases, each device stage ending in a
synchronize) of timed decodes of a stream through the public API of the
checkout at argv[1] (default: this one) on one GPU, by that checkout's
chip_smoke._decode: per stage, every one of 5 decodes after a warm-up
and their median; the stream md5 of each. Prints one JSON line with the
card's name and power limit. A stage's ms are summed over threads; in
_decode's drain-per-unit loop one frame is in flight, so the Stage-B
stages of two frames never overlap.

    python tools/torch_stage_ms.py [checkout] [stream]

The stream defaults to bench_streams/1920x1080_8b_flt_s7.ivf (~2k
host-replayed leftovers a frame). To compare two commits on one card,
unpack the other into a git-ignored directory and run them in turns in
one call: parent, change, change, parent.
"""
import json
import os
import statistics
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else HERE)
stream = sys.argv[2] if len(sys.argv) > 2 else \
    "bench_streams/1920x1080_8b_flt_s7.ivf"
sys.path.insert(0, root)
os.chdir(root)
import torch  # noqa: E402
import chip_smoke as cs  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("needs a CUDA device")
card = cs.smi()
cs._decode(stream, timed=False)                       # warm-up
runs = [cs._decode(stream, timed=True) for _ in range(5)]
stages = sorted({k for r in runs for k in r[3]})
print(json.dumps({
    "tool": "torch_stage_ms", "checkout": root, "stream": stream,
    "card": card, "md5s": [r[1] for r in runs],
    "stage_ms": {k: [r[3].get(k, 0.0) for r in runs] for k in stages},
    "stage_ms_median": {k: statistics.median(r[3].get(k, 0.0)
                                             for r in runs)
                        for k in stages},
    "synced_wall_ms": [r[2] for r in runs]}), flush=True)
