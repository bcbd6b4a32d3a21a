"""The least work of inter prediction, from frame headers alone.

The rule of `work.py`, for the MC and residual kernels: every sample of
every plane of an inter (frame type 1) or switch (3) picture written
once, and read once from a reference, at the picture's own sample size
(1 byte at 8 bits, 2 above). Nothing of the program's tables (job rows,
block tables, the coefficient pool) is read, so the share reads the
same work whatever implements it.

The floor leaves out work the kernels do: a compound block's second
reference, OBMC's neighbour predictions, a warp's or an 8-tap filter's
reach past the block, the residuals' coefficients. It counts samples
the MC kernels may never write: intra blocks of an inter picture, and
the leftover blocks that the host replays.
"""
from __future__ import annotations

from .work import PEAK_BYTES_PER_S, plane_pixels

INTER_FRAME_TYPES = (1, 3)


def inter_bytes(pic) -> int:
    """Bytes the inter prediction of one picture must move at least: 0
    for a key or intra-only picture."""
    if pic["frame_type"] not in INTER_FRAME_TYPES:
        return 0
    size = 1 if pic["bpc"] == 8 else 2
    return 2 * size * sum(plane_pixels(pic))


def inter_least_seconds(pics) -> float:
    return sum(inter_bytes(p) for p in pics) / PEAK_BYTES_PER_S
