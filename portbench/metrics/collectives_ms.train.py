"""Device milliseconds a training step in NCCL's kernels on rank 0, from
the trace: the experts' partial sums reduced over ``model``, tensor
parallelism's reductions and gathers, and the gradients' reductions.  An
NCCL kernel runs from its launch until every rank has joined, so the
wait for the slowest rank counts here too."""


def read(ctx):
    if ctx.kind != "train" or not ctx.trace.events:
        return None
    t = ctx.trace.group_seconds("collective")
    return 1e3 * t / ctx.steps if t > 0 else None
