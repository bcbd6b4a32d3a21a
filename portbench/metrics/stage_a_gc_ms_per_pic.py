"""CPython's cyclic GC inside Stage A: the program's GC pauses whose
innermost open phase was `stage_a` or a `stage_a.` child (the phases
`gc.stage_a` and `gc.stage_a.*` of `utils.timing`), summed over
threads, ms per picture returned."""
from portbench.readers import phase_ms_per_pic


def read(ctx):
    return phase_ms_per_pic(ctx, [k for k in ctx.phases
                                  if k == "gc.stage_a" or
                                  k.startswith("gc.stage_a.")])
