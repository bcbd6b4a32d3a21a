"""Inter Stage B on the host (`decoder.py` `_recon_and_finish_inner`'s
inter device branch: `recon/inter_device.py`, or the sharded
`recon/sharded_stageb.py`): the `inter.frame_recon` phase, its tables,
uploads, launches and leftovers, summed over threads, ms per picture
returned; nothing in a window with no inter frame."""
from portbench.readers import phase_ms_per_pic


def read(ctx):
    return phase_ms_per_pic(ctx, ("inter.frame_recon",))
