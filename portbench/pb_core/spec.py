"""``BENCHMARK.json`` and the data files it names, found by name:

- ``configs/<config>.json`` (the path the configuration entry gives),
  whose ``"arch"`` key names its architecture module, ``arch/<arch>.py``
  (the contract is in ``arch/__init__.py``);
- ``traffic/<mix>.json``: the mix's generator parameters, its driver
  (``drivers/<driver>.py``) and the engine settings of its cells;
- ``limits/<cell>.json``: the numbers the cell's check compares, each
  with its limit and the readings it was set from;
- ``metrics/<metric>.py``: one reader per metric.

``arch`` and ``limits`` take `look_in`: directories of the same layout
searched before the benchmark's own, so that a test can bring an
architecture and its cells without writing into the benchmark.
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


def _find(kind: str, file: str, look_in=()) -> Path:
    for d in (*look_in, BENCH_DIR):
        path = Path(d) / kind / file
        if path.exists():
            return path
    return BENCH_DIR / kind / file


def limits(cell: str, look_in=()) -> dict:
    return _json(_find("limits", f"{cell}.json", look_in))["numbers"]


# What an architecture module provides (arch/__init__.py), and the
# defaults of what it may leave out.
ARCH_CONTRACT = ("port_config", "build_params", "forward", "Reference", "score_flops",
                 "prefill_flops", "decode_flops", "tiny")


def _no_kernels(cfg) -> dict:
    return {}


def _no_kernel_work(cfg, key, slice_rec):
    return None


ARCH_DEFAULTS = {"kernels": _no_kernels, "kernel_work": _no_kernel_work}


def arch(conf: dict, look_in=()):
    """The architecture module the configuration file names by its
    ``"arch"`` key, with ``ARCH_DEFAULTS`` for the entries it leaves out."""
    if "arch" not in conf:
        raise SystemExit(f"portbench: configuration {conf.get('name')!r} has no \"arch\" "
                         "key: name its module in portbench/arch/")
    module = _load("arch", conf["arch"], look_in)
    missing = [n for n in ARCH_CONTRACT if not hasattr(module, n)]
    if missing:
        raise SystemExit(f"portbench: arch/{conf['arch']}.py lacks {', '.join(missing)}")
    for name, default in ARCH_DEFAULTS.items():
        if not hasattr(module, name):
            setattr(module, name, default)
    return module


def _load(kind: str, name: str, look_in=()):
    path = _find(kind, f"{name}.py", look_in)
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
