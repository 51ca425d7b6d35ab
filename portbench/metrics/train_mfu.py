"""The training step's model FLOPs (``work.train_flops_per_token``: 6 a
product weight, attention and the scans forward and backward, no
recompute) at the traced window's tokens/s, as a share (%) of one H100's
dense bf16 peak (989 TFLOP/s at 700 W)."""
from portbench.lib import work


def read(ctx):
    if ctx.kind != "train" or not ctx.trace.events:
        return None
    return 100.0 * ctx.flops_per_token * ctx.tokens_per_s / work.PEAK_BF16_FLOPS
