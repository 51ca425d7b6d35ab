"""Device ms a training step under the layer spans (``layer.<kind>``) that
open while the backward runs: remat's recompute of each layer's forward
(``lib/spans.py``)."""
from portbench.lib import spans


def read(ctx):
    if ctx.kind != "train":
        return None
    j = spans.join(ctx)
    return None if j is None else j.recompute_ms()
