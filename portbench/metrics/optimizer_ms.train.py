"""Device ms a training step under the ``optimizer`` span: the gradients'
mean, AdamW's update with its clip, and the gradient norm
(``lib/spans.py``)."""
from portbench.lib import spans


def read(ctx):
    if ctx.kind != "train":
        return None
    j = spans.join(ctx)
    return None if j is None else j.ms("optimizer", "optimizer")
