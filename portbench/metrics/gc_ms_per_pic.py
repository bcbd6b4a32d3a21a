"""The host process's interpreter: seconds spent in CPython's cyclic
garbage collector in the window (`gc.callbacks`, on whatever thread
collected), ms per picture returned. A full collection walks every
live container object; the program's Stage A allocates enough of them
to start one about every keyframe."""


def read(ctx):
    if ctx.gc_s is None or not ctx.pictures:
        return None
    return 1e3 * ctx.gc_s / ctx.pictures
