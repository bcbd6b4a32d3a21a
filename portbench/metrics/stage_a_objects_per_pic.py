"""Stage A's object churn: the Python `Block` and `CoefBlock` objects
the program built (the `stage_a.objects` counter of
`dav1d_tpu_torch.utils.timing`, read from the traced window's period,
`last()`), a picture returned."""
import sys


def read(ctx):
    timing = sys.modules.get("dav1d_tpu_torch.utils.timing")
    last = getattr(timing, "last", None)
    if last is None or not ctx.pictures:
        return None
    n = last()["counters"].get("stage_a.objects")
    return None if n is None else n / ctx.pictures
