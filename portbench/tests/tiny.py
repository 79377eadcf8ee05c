"""Tiny sizes for running the harness on the CPU in tests: each cell's
configuration cut by its architecture module's ``tiny(conf)``, its mix
by ``tiny_cells/<cell>.json`` (short prompts and documents, a few slots).
Only the shapes change; every code path is the cell's own. ``CELLS`` is
every cell in ``BENCHMARK.json``."""

from __future__ import annotations

import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
TESTS = BENCH / "tests"
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

from pb_core import spec  # noqa: E402

CELLS = tuple(c["name"] for c in spec.load_benchmark()["workloads"])


def tiny_mix_path(cell: str, look_in=()) -> Path:
    for d in (*look_in, TESTS):
        path = Path(d) / "tiny_cells" / f"{cell}.json"
        if path.exists():
            return path
    return TESTS / "tiny_cells" / f"{cell}.json"


def conf_overrides(cell: str, bench=None, look_in=()) -> dict:
    bench = bench or spec.load_benchmark()
    conf = spec.config(bench, spec.by_name(bench["workloads"], cell, "workload")["config"])
    return spec.arch(conf, look_in).tiny(conf)


def run_tiny(cell: str, seed: int, *, seconds: float = 1.0, trace: bool = False,
             variant=None, bench=None, look_in=(), arch=None):
    """One run of the cell at the tiny size on the CPU:
    (result, check lines, other numbers, record). `bench` and `look_in`
    let a test run cells of its own (``pb_core/spec.py``); `arch` runs
    the cell's configuration through another architecture module."""
    import torch

    import run

    # Tiny ops on a shared CPU: one thread each, or thread hand-offs
    # outweigh the work.
    torch.set_num_threads(1)
    bench = bench or spec.load_benchmark()
    mix = json.loads(tiny_mix_path(cell, look_in).read_text())
    overrides = conf_overrides(cell, bench, look_in)
    if arch is not None:
        overrides["arch"] = arch
    return run.run_cell(bench, cell, seed, seconds, trace, device="cpu",
                        conf_overrides=overrides,
                        mix_overrides=mix, variant=variant, look_in=look_in)
