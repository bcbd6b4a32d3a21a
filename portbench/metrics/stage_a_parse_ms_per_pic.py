"""Stage A's native tile parse (`entropy/native_tile.py`
`NativeTileRun.run` -> `native/tileparse.cpp`, on the tile threads or
in the sequential walk): the `stage_a.tile_parse` phase, summed over
threads, ms per picture returned."""
from portbench.readers import phase_ms_per_pic


def read(ctx):
    return phase_ms_per_pic(ctx, ("stage_a.tile_parse",))
