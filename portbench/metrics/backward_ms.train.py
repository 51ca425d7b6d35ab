"""Device ms a training step under the ``backward`` spans (the
``torch.autograd.grad`` call of every microbatch) less the recompute
inside them (``lib/spans.py``)."""
from portbench.lib import spans


def read(ctx):
    if ctx.kind != "train":
        return None
    j = spans.join(ctx)
    if j is None:
        return None
    return j.ms("backward", "backward") - j.recompute_ms()
