"""k1_roofline: the least time the card could take for the K1 launches
of the traced slice (roofline/flash_attention_k1.py, from each launch's
shape, with only the pairs the window leaves visible) over the time those
launches took on the device (torch.profiler), in %. Nothing is read when
the profiled kernels and the launches the harness made differ in count
(roofline/share.py)."""

from roofline.share import kernel_share


def read(rec, ctx):
    return kernel_share(rec, ctx, "k1")
