"""tpot_p90_ms: the 90th percentile, over every request submitted in the
window that finished, of (last token - first token) / (tokens - 1), from
the delivery times of its streaming callback."""

from pb_core.stats import percentile


def read(rec, ctx):
    return percentile(rec.get("tpot_ms", []), 0.9)
