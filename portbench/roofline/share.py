"""A hand-written kernel's share of its roofline in the traced slice: the
least time the card could take for the launches the slice made, over the
device time those launches took.

The architecture module names the kernel's device name by a pattern
(``kernels(cfg)``, which both drivers hand to the traced slice) and gives
the operations and bytes of each launch the slice drove
(``kernel_work(cfg, key, slice_rec)``, from ``rec["slice"]``). A metric
``metrics/<kernel>_roofline.py`` returns ``kernel_share(rec, ctx, key)``.
"""

from __future__ import annotations

from roofline.peaks import peaks


def bound_s(flops: float, nbytes: float, peaks: dict) -> float:
    """The least time the card could take: the larger of operations over
    the bf16 peak and bytes over the HBM peak."""
    return max(flops / peaks["bf16_flops"], nbytes / peaks["hbm_bytes_per_s"])


def kernel_share(rec: dict, ctx, key: str):
    """100 x the sum over the slice's launches of `key` of their least
    time, over the device time of the kernels that matched its pattern;
    None on the CPU, without a traced slice, or when the profiled kernels
    and the launches the architecture counts differ in number."""
    s = ctx.tracer.summary
    if not s or not rec.get("slice") or ctx.device.type != "cuda":
        return None
    events = s["kernels"].get(key, [])
    work = ctx.arch.kernel_work(ctx.cfg, key, rec["slice"])
    if not work or len(events) != len(work):
        return None
    pk = peaks(ctx.torch.cuda.get_device_name(ctx.device))
    least = sum(bound_s(flops, nbytes, pk) for flops, nbytes in work)
    took = sum(d for _, d in events)
    return 100.0 * least / took if took > 0 else None
