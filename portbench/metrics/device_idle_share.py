"""The device: the share of the traced window in which no operation ran
on it (1 - the union of the profiler's device intervals / the window),
in %."""
from portbench import stats


def read(ctx):
    if not ctx.device_events:
        return None
    return stats.idle_share_pct([(a, b) for _, a, b in ctx.device_events],
                                ctx.lo, ctx.hi)
