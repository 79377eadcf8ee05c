"""Operations and bytes of one launch of K1, the port's causal flash
attention kernel (``csrc/flash_attention.cu``, ``flash_fwd_*<..., false>``),
from its shape.

Operations: QK^T and PV over the (query, key) pairs the mask leaves
visible, 2 + 2 FLOPs per pair and head lane. Bytes: q, k and v read once
and the output written once, as the kernel takes them (k and v already
expanded to the query heads). Copied from ``chip_smoke.py``'s
``causal_pairs`` / ``bound`` arithmetic, with the pair count in closed
form. The least time of a launch is ``roofline/share.py``'s.
"""

from __future__ import annotations

KERNEL_NAME = r"flash_fwd_(bf16|f32)<.*false>"


def causal_pairs(t: int, window: int = 0, sinks: int = 0) -> int:
    """(query, key) pairs a causal mask over t positions leaves visible,
    with a sliding window (each query sees its last `window` keys, itself
    included) and `sinks` first keys kept visible under the window."""
    if window <= 0 or window >= t:
        return t * (t + 1) // 2
    full = window * (window + 1) // 2 + (t - window) * window
    if sinks <= 0:
        return full
    # Query q (q >= window) has lo = q - window + 1 > 0 and sees
    # min(sinks, lo) sink keys left of its window.
    extra = 0
    for lo in range(1, t - window + 1):
        extra += min(sinks, lo)
    return full + extra


def launch_work(b: int, t: int, h: int, d: int, elem: int, window: int = 0,
                sinks: int = 0) -> tuple[float, float]:
    """(FLOPs, bytes) one launch over [b, t, h, d] needs."""
    flops = 4.0 * b * h * d * causal_pairs(t, window, sinks)
    nbytes = 4.0 * b * t * h * d * elem
    return flops, nbytes
