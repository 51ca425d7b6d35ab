"""Device milliseconds a training step in copy and cast kernels (the
float32 weights' casts to the compute dtype among them), from the trace."""


def read(ctx):
    if ctx.kind != "train" or not ctx.trace.events:
        return None
    return 1e3 * ctx.trace.group_seconds("copy_cast") / ctx.steps
