"""Device ms a training step under the ``forward`` spans (``lm.loss_fn``'s
forward of every microbatch: the embedding, the layers' first pass and
``head_loss``), from the program's spans joined with the trace
(``lib/spans.py``)."""
from portbench.lib import spans


def read(ctx):
    if ctx.kind != "train":
        return None
    j = spans.join(ctx)
    return None if j is None else j.ms("forward", "forward")
