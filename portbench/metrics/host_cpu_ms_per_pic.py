"""The host process (every host module): its CPU time over the window
(`time.process_time`, all threads) per picture returned."""


def read(ctx):
    if not ctx.pictures:
        return None
    return 1e3 * ctx.cpu_s / ctx.pictures
