"""The flash-attention kernels' share (%) of their roofline where MLA
layers alone run them in training (``work.roofline`` at the MLA bound of
``layers/mla.py``: Q K^T at qk_nope + qk_rope, P V and dV at v_head_dim,
whatever the port pads V to; the bound of every traced launch, by the
program's counters, over the kernels' device time)."""
from portbench.lib import work


def read(ctx):
    if ctx.kind != "train":
        return None
    return work.roofline(ctx, "flash_attention", kinds=("mla",))
