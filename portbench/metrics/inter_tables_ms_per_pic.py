"""Inter Stage B's host tables (`recon/inter_jobs_native.py`,
`ops/mc_fused.py`): the `inter.emit_jobs` and `inter.upload` phases,
summed over threads, ms per picture returned; nothing in a window with
no inter frame."""
from portbench.readers import phase_ms_per_pic


def read(ctx):
    return phase_ms_per_pic(ctx, ("inter.emit_jobs", "inter.upload"))
