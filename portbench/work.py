"""The least work of the in-loop filters, from frame headers alone.

A copy of the geometry of chip_smoke.py's `_filter_bounds` and
`_deblock_frame_work`, with the rule of a roofline: every pixel of a
filtered plane read once and written once by each pass, at the
picture's own sample size (1 byte at 8 bits, 2 above), and nothing of
the program's own tables (masks, maps, item lists), so that the share
reads the same work whatever implements it. The facts come from each
picture's record (reference/streams/*.json): its size, bit depth,
subsampling, and which planes each filter is on for.
"""
from __future__ import annotations

# NVIDIA H100 SXM, the data sheet's HBM3 rate at the full 700 W
PEAK_BYTES_PER_S = 3.35e12


def plane_pixels(pic) -> list:
    w, h = pic["w"], pic["h"]
    px = [w * h]
    if pic.get("planes", 3) == 3:
        cw = (w + pic["ss_hor"]) >> pic["ss_hor"]
        ch = (h + pic["ss_ver"]) >> pic["ss_ver"]
        px += [cw * ch, cw * ch]
    return px


def filter_bytes(pic) -> int:
    """Bytes the deblock, CDEF and loop-restoration passes of one
    picture must move at least: each plane a pass is on for, read once
    and written once."""
    size = 1 if pic["bpc"] == 8 else 2
    total = 0
    for pl, px in enumerate(plane_pixels(pic)):
        passes = (pic["deblock"][pl] + pic["cdef"][pl] +
                  (pic["lr"][pl] != 0))
        total += 2 * size * px * passes
    return total


def filter_least_seconds(pics) -> float:
    return sum(filter_bytes(p) for p in pics) / PEAK_BYTES_PER_S
