"""Intra recon (`recon/intra.py` -> `native/intrarec.cpp`): the
`intra.frame_recon` phase, summed over threads, ms per picture
returned."""
from portbench.readers import phase_ms_per_pic


def read(ctx):
    return phase_ms_per_pic(ctx, ("intra.frame_recon",))
