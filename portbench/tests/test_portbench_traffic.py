"""The traffic generator: repeatable by seed, stratified to the stated
distributions; at the midpoints the same sizes for every seed in another
order, jittered a point drawn inside each stratum."""

from __future__ import annotations

import math
from collections import Counter

import numpy as np
import pytest

from tiny import BENCH  # noqa: F401  (puts the benchmark on sys.path)

from pb_core import spec, traffic  # noqa: E402

MIXES = ("score-long", "serve-batch")


def _draw(mix_name, seed, n):
    mix = spec.mix(mix_name)
    if mix["driver"] == "closed_loop_score":
        return [d.size for d in traffic.documents(mix, seed, n, 32000)], mix
    return traffic.requests(mix, seed, n, 32000), mix


@pytest.mark.parametrize("mix_name", MIXES)
def test_same_seed_same_traffic(mix_name):
    a, _ = _draw(mix_name, 2**31 + 5, 96)
    b, _ = _draw(mix_name, 2**31 + 5, 96)
    if isinstance(a[0], dict):
        for x, y in zip(a, b):
            assert np.array_equal(x["prompt"], y["prompt"])
            assert x["max_new_tokens"] == y["max_new_tokens"]
    else:
        assert a == b


def test_midpoint_seeds_share_sizes_in_another_order():
    mix = spec.mix("serve-batch")
    n = int(mix["block"]) * 3
    a, _ = _draw("serve-batch", 11, n)
    b, _ = _draw("serve-batch", 2**33 + 7, n)
    key = lambda r: (r["prompt"].size, r["max_new_tokens"])  # noqa: E731
    assert Counter(r["prompt"].size for r in a) == Counter(r["prompt"].size for r in b)
    assert Counter(r["max_new_tokens"] for r in a) == Counter(r["max_new_tokens"] for r in b)
    assert [key(r) for r in a] != [key(r) for r in b]


def test_jittered_blocks_hold_one_length_per_stratum():
    """score-long: each block of 16 documents has one length in each of
    16 equal log-strata of 4096..16384, and lengths repeat across seeds,
    or match a warm-up length, only by chance."""
    mix = spec.mix("score-long")
    block = int(mix["block"])
    lo, hi = math.log(4096), math.log(16384)
    draws = {}
    for seed in (11, 2**31 + 7, 2**33 + 3):
        lengths, _ = _draw("score-long", seed, block * 8)
        for k in range(8):
            strata = sorted(int((math.log(t) - lo) / (hi - lo) * block)
                            for t in lengths[k * block:(k + 1) * block])
            assert strata == list(range(block)), (seed, k, strata)
        draws[seed] = lengths
        assert len(set(lengths) & set(mix["warm_up_tokens"])) < 4  # chance only
    a, b, _ = draws.values()
    assert len(set(a) & set(b)) < 8  # chance coincidences only
    # The mean follows the log-uniform's, (hi - lo) / (log hi - log lo).
    mean = sum(sum(v) for v in draws.values()) / (3 * block * 8)
    assert abs(mean / ((16384 - 4096) / (hi - lo)) - 1) < 0.03


def test_lognormal_follows_its_quantiles():
    spec_ = {"dist": "lognormal", "median": 512, "sigma": 0.8, "min": 32, "max": 3072}
    vals = traffic.block_values(spec_, 64, integer=False)
    assert vals == sorted(vals)
    med = (vals[31] + vals[32]) / 2
    assert abs(math.log(med / 512)) < 0.03
    # The 90th percentile of a lognormal is median * exp(1.2816 sigma).
    p90 = vals[int(0.9 * 64)]
    assert abs(math.log(p90 / (512 * math.exp(1.2816 * 0.8)))) < 0.06
    assert min(vals) >= 32 and max(vals) <= 3072


def test_loguniform_midpoints():
    lu = traffic.block_values({"dist": "loguniform", "min": 4096, "max": 16384}, 8,
                              integer=True)
    assert lu[0] > 4096 and lu[-1] < 16384
    ratios = [b / a for a, b in zip(lu, lu[1:])]
    assert max(ratios) / min(ratios) < 1.01  # even steps in log space
