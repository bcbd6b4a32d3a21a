"""The output fetch (`ops/device.py`): the `filters.fetch_queue` and
`fetch` phases, summed over threads, ms per picture returned."""
from portbench.readers import phase_ms_per_pic


def read(ctx):
    return phase_ms_per_pic(ctx, ("filters.fetch_queue", "fetch"))
