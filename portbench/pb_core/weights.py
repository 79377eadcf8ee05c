"""Seeded weights, made on the device in a few large calls, for any
weight layout.

A layout is a list of leaves ``(name, shape, fan_in)``; an architecture
module states its own (``arch/<name>.py`` and its reference). Every
layer's leaves are one flat buffer in the served dtype, filled by one
``normal_`` call from a generator seeded by (run seed, stream), then
scaled by fan_in**-0.5 in one call per run of equal fan-in. The same
functions hand the program its tensors (loaded into the port's module as
views) and the reference its own copy, layer by layer, so the reference
never reads anything the program made.
"""

from __future__ import annotations

import torch

_MASK64 = (1 << 64) - 1


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed for one stream of one run (splitmix64 of
    the pair), so that seeds past 32 bits and nearby seeds stay apart."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + (int(stream) + 1) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def filled(n: int, seed: int, stream: int, dtype, device) -> torch.Tensor:
    """`n` unit normals of stream `stream` of the run `seed`: one buffer,
    one ``normal_`` call."""
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, stream))
    buf = torch.empty(n, dtype=dtype, device=device)
    buf.normal_(generator=gen)
    return buf


def scaled_leaves(leaves, seed: int, stream: int, dtype, device) -> dict:
    """The leaves ``(name, shape, fan_in)`` as {name: view of one flat
    buffer of stream `stream`}, each scaled by its fan_in**-0.5."""
    buf = filled(sum(_numel(s) for _, s, _ in leaves), seed, stream, dtype, device)
    out, off = {}, 0
    # Runs of equal fan-in are scaled in one call each.
    run_start, run_fan = 0, None
    for name, shape, fan in leaves:
        if fan != run_fan:
            if run_fan is not None:
                buf[run_start:off].mul_(run_fan ** -0.5)
            run_start, run_fan = off, fan
        n = _numel(shape)
        out[name] = buf[off:off + n].view(shape)
        off += n
    buf[run_start:off].mul_(run_fan ** -0.5)
    return out
