"""device_idle_pct.serve: 1 - (union of the device's activity intervals / the slice's
length) over the traced slice after the window, in %."""


def read(rec, ctx):
    s = ctx.tracer.summary
    if not s or not s["window_s"] or not s["busy_s"]:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
