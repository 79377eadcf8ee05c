"""Mesh shapes: the port's own copy of the JAX package's parallel/mesh.py
axis names, ``MeshSpec`` and ``best_mesh_shape``, and a one-card ``Mesh``.

Axis conventions (as in the reference):
  dp — data parallel: batch is split.
  sp — sequence/context parallel: sequence dimension split (ring attention,
       Ulysses).
  ep — expert parallel: MoE experts split.
  tp — tensor parallel: attention heads / MLP hidden split. Last =
       nearest-link axis (its collectives fire the most often per layer).

This slice lays the `sp` ranks of a mesh on ONE card: each rank's chunk is
a slice of the full tensor, and the ring and the all-to-all move chunks
between list entries instead of between cards. A mesh with dp, ep or tp > 1
needs ranks on separate cards and raises NotImplementedError.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from bee_code_interpreter_fs_tpu_torch.device import resolve_device

AXES = ("dp", "sp", "ep", "tp")


@dataclass(frozen=True)
class MeshSpec:
    """A logical mesh shape over named axes (order matters: nearest last)."""

    shape: tuple[int, ...]
    axes: tuple[str, ...] = AXES

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")

    @property
    def n_devices(self) -> int:
        return math.prod(self.shape)


def best_mesh_shape(
    n_devices: int,
    *,
    tp: int | None = None,
    sp: int | None = None,
    ep: int | None = None,
) -> MeshSpec:
    """Pick a (dp, sp, ep, tp) factorization of n_devices.

    Heuristic: tp gets the largest power-of-two factor <= 4 unless pinned;
    sp and ep default to 1 unless pinned; dp absorbs the rest. All axes must
    divide n_devices.
    """
    if n_devices < 1:
        raise ValueError("n_devices must be >= 1")
    if tp is None:
        tp = 1
        for cand in (4, 2):
            if n_devices % cand == 0:
                tp = cand
                break
    if n_devices % tp != 0:
        raise ValueError(f"tp={tp} does not divide n_devices={n_devices}")
    rest = n_devices // tp
    if sp is None:
        sp = 1
    if rest % sp != 0:
        raise ValueError(f"sp={sp} does not divide n_devices/tp={rest}")
    rest //= sp
    if ep is None:
        ep = 1
    if rest % ep != 0:
        raise ValueError(f"ep={ep} does not divide n_devices/(tp*sp)={rest}")
    dp = rest // ep
    return MeshSpec(shape=(dp, sp, ep, tp))


@dataclass(frozen=True)
class Mesh:
    """The `sp` ranks of a mesh, all on `device`. ``shape`` maps each axis
    name to its size, as a JAX mesh's does."""

    spec: MeshSpec
    device: torch.device

    def __post_init__(self):
        wide = {a: n for a, n in zip(self.spec.axes, self.spec.shape)
                if a != "sp" and n > 1}
        if wide:
            raise NotImplementedError(
                f"mesh axes {wide} > 1 place ranks on separate cards; they "
                "come with the distributed parallel slice of the port "
                "(torch.distributed)"
            )
        if any(n < 1 for n in self.spec.shape):
            raise ValueError(f"mesh axis sizes must be >= 1, got {self.spec.shape}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.spec.axes, self.spec.shape))

    @property
    def sp(self) -> int:
        return self.shape.get("sp", 1)


def make_mesh(spec: MeshSpec, device=None) -> Mesh:
    """A mesh whose sp ranks all live on `device` (the card unless the
    caller names the CPU)."""
    return Mesh(spec, resolve_device(device))


def sp_chunks(x, n: int) -> list:
    """The sp ranks' shards of a [b, t, ...] tensor: n contiguous sequence
    chunks (views) in rank order, the layout of P("dp", "sp", ...)."""
    t = x.shape[1]
    if t % n:
        raise ValueError(f"sequence length {t} does not divide over sp={n} ranks")
    return list(x.split(t // n, dim=1))
