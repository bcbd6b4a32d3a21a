"""The API session outside the decode (`api.py`): `Decoder(...)` and
`close()`, the `api.open` and `api.close` phases, ms per picture
returned."""
from portbench.readers import phase_ms_per_pic


def read(ctx):
    return phase_ms_per_pic(ctx, ("api.open", "api.close"))
