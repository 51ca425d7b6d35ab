"""Share (%) of the traced decode window in which no kernel, copy or set
ran on the device: 1 - union of the device intervals / window."""


def read(ctx):
    if ctx.kind != "decode" or not ctx.trace.events:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
