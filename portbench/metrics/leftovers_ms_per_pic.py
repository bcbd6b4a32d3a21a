"""The leftovers' host route (`recon/inter_device.py`): the
`inter.fetch_region`, `inter.leftovers` and `inter.region_upload`
phases, summed over threads, ms per picture returned; nothing in a
window with no leftover."""
from portbench.readers import phase_ms_per_pic


def read(ctx):
    return phase_ms_per_pic(ctx, ("inter.fetch_region", "inter.leftovers",
                                  "inter.region_upload"))
