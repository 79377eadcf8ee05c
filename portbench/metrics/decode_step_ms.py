"""decode_step_ms: the median host time of a decode burst in the window
(ServingEngine._run_burst, wrapped from outside; it ends in the burst's
one device-to-host copy) over steps_per_sync."""

from pb_core.stats import median


def read(rec, ctx):
    bursts = rec.get("burst_ms")
    return median(bursts) / rec["steps_per_sync"] if bursts else None
