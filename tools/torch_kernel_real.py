"""Run chip_smoke.py's build and kernel_real phases (the inter kernels'
device time on the s7 stream's frame-2 tables) of the checkout at
argv[1], or of this one, on one GPU; prints their JSON lines.

To compare two commits on one card, unpack the other into a git-ignored
directory and run them in turns in one call:

    git archive <commit> | tar -x -C build/parent
    python tools/torch_kernel_real.py build/parent
    python tools/torch_kernel_real.py .
"""
import os
import sys

root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ".")
sys.path.insert(0, root)
os.chdir(root)
import torch  # noqa: E402
import chip_smoke as cs  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("needs a CUDA device")
card = cs.smi()
cs.phase_build()
cs.phase_kernel_real(torch, card)
