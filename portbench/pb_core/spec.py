"""``BENCHMARK.json`` and the data files it names, found by name:

- ``configs/<config>.json`` (the path the configuration entry gives);
- ``traffic/<mix>.json``: the mix's generator parameters, its driver
  (``drivers/<driver>.py``) and the engine settings of its cells;
- ``limits/<cell>.json``: the numbers the cell's check compares, each
  with its limit and the readings it was set from;
- ``metrics/<metric>.py``: one reader per metric.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"portbench: no {what} named {name!r} in BENCHMARK.json")


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def config(bench: dict, name: str) -> dict:
    return _json(ROOT / by_name(bench["configs"], name, "configuration")["file"])


def mix(name: str) -> dict:
    return _json(BENCH_DIR / "traffic" / f"{name}.json")


def limits(cell: str) -> dict:
    return _json(BENCH_DIR / "limits" / f"{cell}.json")["numbers"]


def _load(kind: str, name: str):
    path = BENCH_DIR / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(name: str):
    return _load("drivers", name)


def reader(metric: str):
    return _load("metrics", metric)


def metrics_of(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a cell reports: with --trace 0 its end-to-end metrics,
    with --trace 1 its per-layer metrics. A metric without a `workloads`
    list applies to every cell (end-to-end) or to every cell that reports
    the end-to-end metric it moves (per-layer)."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
