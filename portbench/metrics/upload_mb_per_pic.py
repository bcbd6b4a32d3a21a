"""The host-to-device copies of the decode path (`ops/device.py`
`upload`: planes, references, leftover rows, inter job tables, filter
maps and tables, grain tables): the counter `upload.bytes`, added once
a copy, in MB (1e6 bytes) a picture returned."""
from portbench.counters import per_pic


def read(ctx):
    return per_pic(ctx, "upload.bytes", 1e-6)
