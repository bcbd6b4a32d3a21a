"""Inter Stage B's leftover blocks (`recon/inter_device.py`: the blocks
the device passes leave to the host replay or the device leftover
route, intra and interintra blocks among them): the counter
`inter.leftover_blocks`, added once an inter frame, a picture
returned."""
from portbench.counters import per_pic


def read(ctx):
    return per_pic(ctx, "inter.leftover_blocks")
