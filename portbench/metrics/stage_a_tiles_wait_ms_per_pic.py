"""Stage A's main thread waiting for the tile pool (`decoder.py`): the
`stage_a.tiles_wait` phase, ms per picture returned."""
from portbench.readers import phase_ms_per_pic


def read(ctx):
    return phase_ms_per_pic(ctx, ("stage_a.tiles_wait",))
