"""A decode step's model FLOPs (``work.decode_flops_per_token``: 2 a
product weight, attention over the window's keys, the scans' state
products) at the traced window's tokens/s, as a share (%) of one H100's
dense bf16 peak (989 TFLOP/s at 700 W)."""
from portbench.lib import work


def read(ctx):
    if ctx.kind != "decode" or not ctx.trace.events:
        return None
    return 100.0 * ctx.flops_per_token * ctx.tokens_per_s / work.PEAK_BF16_FLOPS
