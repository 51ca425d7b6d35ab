"""Device milliseconds a decode step in copy and cast kernels (the float32
weights' casts and the caches' casts to float32 among them), from the
trace."""


def read(ctx):
    if ctx.kind != "decode" or not ctx.trace.events:
        return None
    return 1e3 * ctx.trace.group_seconds("copy_cast") / ctx.steps
