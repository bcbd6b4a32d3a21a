"""The filter kernels (deblock, CDEF, Wiener, SGR): the least time of
the pictures returned, from their frame headers (`portbench/work.py`:
every filtered plane read and written once a pass at 3.35 TB/s), over
those kernels' device time in the traced window, in %."""
from portbench import stats, work
from portbench.devtrace import FILTER_KERNELS
from portbench.readers import kernel_seconds


def read(ctx):
    return stats.roofline_pct(
        work.filter_least_seconds(ctx.picture_records),
        kernel_seconds(ctx, FILTER_KERNELS))
