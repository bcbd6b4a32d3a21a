"""API layer (`api.py`): the 90th percentile of a seek request's time,
from `Decoder(...)` to its picture returned, on the benchmark's clock;
p90 is the highest percentile with ten requests beyond it at ~100."""
from portbench import stats


def read(ctx):
    if len(ctx.latencies_s) < 10:
        return None
    return 1e3 * stats.percentile(ctx.latencies_s, 90)
