"""The frame pipeline as the caller feels it (`api.py` `get_picture`):
the caller blocked on the oldest frame's promise while Stage B runs on
its worker, the `api.wait` phase, ms per picture returned."""
from portbench.readers import phase_ms_per_pic


def read(ctx):
    return phase_ms_per_pic(ctx, ("api.wait",))
