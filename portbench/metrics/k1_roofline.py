"""k1_roofline: the least time the card could take for the K1 launches
of the traced slice (roofline/flash_attention_k1.py, from each launch's
shape, with only the pairs the window leaves visible) over the time those
launches took on the device (torch.profiler), in %. Nothing is read when
the profiled kernels and the launches the harness made differ in count."""

from roofline.flash_attention_k1 import bound_s, launch_work
from roofline.peaks import peaks


def read(rec, ctx):
    s = ctx.tracer.summary
    launches = rec.get("k1_slice_launches")
    if not s or not launches or ctx.device.type != "cuda":
        return None
    events = s["kernels"].get("k1", [])
    if len(events) != len(launches):
        return None
    pk = peaks(ctx.torch.cuda.get_device_name(ctx.device))
    least = sum(bound_s(*launch_work(*shape), pk) for shape in launches)
    took = sum(d for _, d in events)
    return 100.0 * least / took if took > 0 else None
