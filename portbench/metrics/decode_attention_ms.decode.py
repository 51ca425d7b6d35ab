"""Device ms a decode step under the ``decode_attention`` spans
(``kernels/ops.py:decode_attention``, the plain attention over the
caches with their float32 copies; ``lib/spans.py``)."""
from portbench.lib import spans


def read(ctx):
    if ctx.kind != "decode":
        return None
    j = spans.join(ctx)
    return None if j is None else j.ms("decode_attention", "decode")
