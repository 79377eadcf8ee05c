"""``toy_moe`` without the contract's optional entries (``kernels``,
``kernel_work``): the harness gives their defaults."""

from __future__ import annotations

from pathlib import Path

from pb_core import spec

_toy = spec.arch({"arch": "toy_moe"}, (Path(__file__).resolve().parent.parent,))
globals().update({name: getattr(_toy, name) for name in spec.ARCH_CONTRACT})
