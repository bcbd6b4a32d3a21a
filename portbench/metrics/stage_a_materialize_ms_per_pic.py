"""Stage A's materialize on the main thread (`entropy/native_tile.py`:
each tile's records into the FramePlan, one Python `Block` a block and
one `CoefBlock` a coefficient block on a frame that is not lazy): the
`stage_a.materialize` phase, ms per picture returned."""
from portbench.readers import phase_ms_per_pic


def read(ctx):
    return phase_ms_per_pic(ctx, ("stage_a.materialize",))
