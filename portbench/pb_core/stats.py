"""Order statistics the metrics share."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float | None:
    """The q-quantile (q in [0, 1]) by linear interpolation between order
    statistics; None for no values."""
    vals = sorted(values)
    if not vals:
        return None
    pos = q * (len(vals) - 1)
    lo, hi = math.floor(pos), math.ceil(pos)
    return vals[lo] + (vals[hi] - vals[lo]) * (pos - lo)


def median(values) -> float | None:
    return percentile(values, 0.5)
