"""Run chip_smoke.py's build and kernel_real phases (every kernel's
device time on the tables and planes of frame 2 of the s7 stream, then
of the s31 stream) of the checkout at argv[1], or of this one, on one
GPU, then time the deblock of one synthetic 1080p 4:2:0 frame through
that checkout's ops/lf.py with this checkout's measuring code
(chip_smoke.deblock_frame_times: all device work, kernels alone,
wrapper and plain); prints their JSON lines.

To compare two commits on one card, unpack the other into a git-ignored
directory and run them in turns in one call:

    git archive <commit> | tar -x -C build/parent
    python tools/torch_kernel_real.py build/parent
    python tools/torch_kernel_real.py .
"""
import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else HERE)
sys.path.insert(0, root)
os.chdir(root)
import numpy as np  # noqa: E402
import torch  # noqa: E402
import chip_smoke as cs  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("needs a CUDA device")
card = cs.smi()
cs.phase_build()
cs.phase_kernel_real(torch, card)
# the s31 main path's kernels (a checkout from before super-res and film
# grain lists only those in KERNELS)
cs.phase_kernel_real(torch, card, cs.STREAM_1080P, cs.MD5S_S31,
                     getattr(cs, "MAIN_KERNELS", cs.KERNELS)[1:])

# the checkout's package is imported by now; this checkout's chip_smoke
# is loaded under another name for its measuring code only
from dav1d_tpu_torch.ops import lf  # noqa: E402
from dav1d_tpu_torch.ops.lf_ref import calc_eih  # noqa: E402
spec = importlib.util.spec_from_file_location(
    "chip_smoke_measure", os.path.join(HERE, "chip_smoke.py"))
cur = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cur)
dev = torch.device("cuda")
e, i = calc_eih(3)
lut_e = torch.from_numpy(e.astype(np.int32)).to(dev)
lut_i = torch.from_numpy(i.astype(np.int32)).to(dev)
entries = []
for seed, (h4, w4, luma) in zip((7, 8, 9), ((288, 480, True),
                                            (144, 240, False),
                                            (144, 240, False))):
    plane, maps = cur._lf_inputs(np.random.default_rng(seed), h4, w4, 8)
    entries.append((torch.from_numpy(plane).to(dev), luma,
                    *[tuple(torch.from_numpy(a).to(dev) for a in m)
                      for m in maps]))
if hasattr(lf, "deblock_frame_cuda"):
    def fn():
        return lf.deblock_frame_cuda(entries, lut_e, lut_i, 8)
else:
    # checkouts before the one-launch deblock: both passes per plane
    def fn():
        return [lf.deblock_plane(p, vm, hm, lut_e, lut_i, 8, luma)
                for p, luma, vm, hm in entries]


def plain():
    return [lf.deblock_pass_plain(lf.deblock_pass_plain(
        p, *vm, lut_e, lut_i, 8, luma, True), *hm, lut_e, lut_i, 8, luma,
        False) for p, luma, vm, hm in entries]


cur.emit({"phase": "deblock_frame_1080p", "checkout": root, "card": card,
          **cur.deblock_frame_times(torch, fn, plain)})
