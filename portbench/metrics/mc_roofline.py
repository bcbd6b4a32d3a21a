"""The inter kernels (put, compound, warp, OBMC, residual): the least
time of the inter pictures returned, from their frame headers
(`portbench/mc_work.py`: every sample written once and read once from
a reference at 3.35 TB/s), over those kernels' device time in the
traced window, in %; nothing without an inter kernel in the trace."""
from portbench import mc_work, stats
from portbench.readers import kernel_seconds

MC_KERNELS = ("mc_put", "mc_comp", "mc_warp", "mc_obmc", "itx_add")


def read(ctx):
    return stats.roofline_pct(
        mc_work.inter_least_seconds(ctx.picture_records),
        kernel_seconds(ctx, MC_KERNELS))
