"""The in-loop filters' host side (`recon/filters.py`, `ops/lf.py`,
`ops/cdef.py`, `ops/lr.py`): the `filters.deblock`, `filters.cdef` and
`filters.lr` phases, summed over threads, ms per picture returned. With
its timers on the program synchronises inside them, so they hold the
filters' device time too."""
from portbench.readers import phase_ms_per_pic


def read(ctx):
    return phase_ms_per_pic(ctx, ("filters.deblock", "filters.cdef",
                                  "filters.lr"))
