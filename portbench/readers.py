"""Helpers of the per-layer metrics' readers (metrics/<name>.py)."""
from __future__ import annotations

from .devtrace import kernel_of


def phase_ms_per_pic(ctx, labels):
    """The `utils.timing` phases `labels`, summed over threads, in ms per
    picture returned; None when none of them ran."""
    ran = [ctx.phases[k] for k in labels if k in ctx.phases]
    if not ran or not ctx.pictures:
        return None
    return 1e3 * sum(ran) / ctx.pictures


def kernel_seconds(ctx, kernels=None) -> float:
    """Device seconds of the port's kernels (or of those named) in the
    traced window."""
    total = 0.0
    for name, a, b in ctx.device_events:
        k = kernel_of(name)
        if k is not None and (kernels is None or k in kernels) and \
                b > ctx.lo and a < ctx.hi:
            total += min(b, ctx.hi) - max(a, ctx.lo)
    return total
