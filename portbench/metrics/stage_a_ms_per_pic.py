"""Stage A (`entropy/`, `entropy/native.py` -> `native/tileparse.cpp`):
the `stage_a` phase, summed over threads, ms per picture returned."""
from portbench.readers import phase_ms_per_pic


def read(ctx):
    return phase_ms_per_pic(ctx, ("stage_a",))
