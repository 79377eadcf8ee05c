"""prefill_device_pct: the device time of the kernels launched under
portbench.admit (the engine's _install: an admission's prefill into a
scratch and its row install), over the union of the device's busy time
in the traced slice, in %. Kernels are matched to their launches by
correlation id (pb_core/trace.py, span_device_s). Nothing is read on the
CPU, or when no kernel of the slice could be matched to a span."""


def read(rec, ctx):
    s = ctx.tracer.summary
    if not s or ctx.device.type != "cuda" or not s["busy_s"] or not s.get("span_device_s"):
        return None
    return 100.0 * s["span_device_s"].get("portbench.admit", 0.0) / s["busy_s"]
