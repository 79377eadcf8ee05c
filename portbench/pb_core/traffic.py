"""The one traffic generator. A mix is a data file (``traffic/<mix>.json``)
of parameters; this module turns it and a seed into requests.

Lengths are drawn stratified: a block of ``block`` requests holds one
value from each of ``block`` equal strata of the distribution, shuffled
by the seed. By default the value is the stratum's midpoint, so every
seed gets the same sizes in another order and never other work in a
window. A mix with ``"jitter": true`` draws each block's value at a point
inside each stratum from the seed instead: every block still holds one
value per stratum, but no two seeds share lengths, and no length of the
window is one that warm-up ran.

Distributions (``{"dist": ...}``):
- ``fixed``: ``value``;
- ``loguniform``: ``min``, ``max``;
- ``lognormal``: ``median``, ``sigma``, clipped to [``min``, ``max``].
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np

_NORMAL = NormalDist()


def quantile(spec: dict, u: float) -> float:
    """The distribution's value at quantile u in (0, 1), clipped."""
    kind = spec["dist"]
    if kind == "fixed":
        return float(spec["value"])
    if kind == "loguniform":
        lo, hi = math.log(spec["min"]), math.log(spec["max"])
        return math.exp(lo + u * (hi - lo))
    if kind == "lognormal":
        x = spec["median"] * math.exp(spec["sigma"] * _NORMAL.inv_cdf(u))
        return min(max(x, spec["min"]), spec["max"])
    raise ValueError(f"unknown distribution {kind!r}")


def block_values(spec: dict, block: int, *, integer: bool) -> list:
    """One block's values: the distribution at the midpoints of `block`
    equal strata."""
    vals = [quantile(spec, (j + 0.5) / block) for j in range(block)]
    return [int(round(v)) for v in vals] if integer else vals


def jittered_values(spec: dict, block: int, rng: np.random.Generator, *,
                    integer: bool) -> list:
    """One block's values: the distribution at a point drawn uniformly
    inside each of `block` equal strata."""
    u = np.clip(rng.random(block), 1e-9, 1.0 - 1e-9)
    vals = [quantile(spec, (j + float(x)) / block) for j, x in enumerate(u)]
    return [int(round(v)) for v in vals] if integer else vals


def stratified(spec: dict, n: int, block: int, rng: np.random.Generator, *,
               integer: bool, jitter: bool = False) -> list:
    """n draws: whole blocks of the stratified values (midpoints, or with
    `jitter` a point drawn inside each stratum), each shuffled."""
    base = block_values(spec, block, integer=integer)
    out: list = []
    while len(out) < n:
        if jitter:
            base = jittered_values(spec, block, rng, integer=integer)
        out.extend(base[i] for i in rng.permutation(block))
    return out[:n]


def rng_for(seed: int, stream: str) -> np.random.Generator:
    """An independent numpy stream for (seed, purpose)."""
    return np.random.default_rng([int(seed) & (2**63 - 1), int(seed) >> 63,
                                  sum(map(ord, stream)) * 1_000_003 + len(stream)])


def documents(mix: dict, seed: int, n: int, vocab: int) -> list:
    """Scoring documents: token arrays of the mix's lengths."""
    block = int(mix["block"])
    lengths = stratified(mix["document_tokens"], n, block,
                         rng_for(seed, "document_tokens"), integer=True,
                         jitter=bool(mix.get("jitter", False)))
    tok = rng_for(seed, "tokens")
    return [tok.integers(0, vocab, size=t, dtype=np.int64) for t in lengths]


def requests(mix: dict, seed: int, n: int, vocab: int) -> list:
    """Serving requests, all greedy: dicts of prompt and max_new_tokens."""
    block = int(mix["block"])
    prompts = stratified(mix["prompt_tokens"], n, block,
                         rng_for(seed, "prompt_tokens"), integer=True)
    outputs = stratified(mix["output_tokens"], n, block,
                         rng_for(seed, "output_tokens"), integer=True)
    tok = rng_for(seed, "tokens")
    return [{"prompt": tok.integers(0, vocab, size=prompts[i], dtype=np.int32),
             "max_new_tokens": outputs[i]} for i in range(n)]
