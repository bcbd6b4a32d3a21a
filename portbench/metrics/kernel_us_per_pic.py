"""The kernels (`csrc/*.cu` via `ops/*`): torch.profiler's device time
of the port's kernels in the traced window, us per picture returned;
nothing when the trace holds none of them."""
from portbench.readers import kernel_seconds


def read(ctx):
    s = kernel_seconds(ctx)
    if s <= 0 or not ctx.pictures:
        return None
    return 1e6 * s / ctx.pictures
