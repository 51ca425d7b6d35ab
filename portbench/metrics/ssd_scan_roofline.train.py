"""The SSD kernels' share (%) of their roofline in training
(``work.roofline``: the bound of every traced launch, by the program's
counters, at the step's launch shape, over the kernels' device time)."""
from portbench.lib import work


def read(ctx):
    if ctx.kind != "train":
        return None
    return work.roofline(ctx, "ssd_scan")
