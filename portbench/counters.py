"""The program's counters (`dav1d_tpu_torch.utils.timing.count`) over
the traced window, for the per-layer metrics' readers."""
from __future__ import annotations

import sys


def window_count(name):
    """The counter `name` over the traced window (the recorder's period
    that the window closed, `timing.last()`), or None where the program
    has no such recorder or never added to that counter."""
    timing = sys.modules.get("dav1d_tpu_torch.utils.timing")
    last = getattr(timing, "last", None)
    if last is None:
        return None
    return last()["counters"].get(name)


def per_pic(ctx, name, scale=1.0):
    """window_count(name) * scale a picture returned, or None."""
    n = window_count(name)
    if n is None or not ctx.pictures:
        return None
    return n * scale / ctx.pictures
