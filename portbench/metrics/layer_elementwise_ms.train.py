"""Device ms a training step in kernels that are neither a hand-written
kernel nor a matrix product (``trace.kernel_group`` ``other`` or
``copy_cast``) under a layer's span of any phase (``layer.<kind>``,
``layer.<kind>.backward``): the layers' elementwise work, forward,
recomputed and backward (``lib/spans.py``; the split by layer kind is in
its log line)."""
from portbench.lib import spans


def read(ctx):
    if ctx.kind != "train":
        return None
    j = spans.join(ctx)
    return None if j is None else j.layer_elementwise_ms()
