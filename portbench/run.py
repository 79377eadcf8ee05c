"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for. Everything a cell needs is found by name from ``BENCHMARK.json``
(``pb_core/spec.py``). The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
(and with ``--trace 1`` ``breakdown``), then ``checks``, the numbers the
check compared beside their limits, which also end standard error.

Exit codes: 2 without the cards the cell asks for, 3 if a JAX module is
loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
for p in (str(HERE), str(HERE.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)
# transformers, if anything imports it, must not load JAX through flax.
os.environ.setdefault("USE_FLAX", "0")

from pb_core import guard  # noqa: E402

guard.refuse_if_loaded("at start")

from pb_core import check, spec  # noqa: E402
from pb_core.trace import Tracer  # noqa: E402


class Context:
    """What a driver gets: the cell's data, its architecture module
    (``arch/<arch>.py``: the port's model, forward, reference, FLOP counts
    and the kernels it names), the device, the clock marks."""

    def __init__(self, torch, device, bench, cell, conf, seed, seconds, trace,
                 variant=None, conf_overrides=None, mix_overrides=None,
                 fp8_control=False, look_in=()):
        self.torch, self.device, self.cell = torch, device, cell
        self.conf = dict(conf, **(conf_overrides or {}))
        self.arch = spec.arch(self.conf, look_in)
        self.cfg = self.arch.port_config(self.conf)
        self.mix = dict(spec.mix(cell["traffic"]), **(mix_overrides or {}))
        self.seed, self.seconds = int(seed), float(seconds)
        self.tracer = Tracer(torch, bool(trace))
        self.variant = variant
        # Read the fp8 reference's numbers beside the program's (readings.py).
        self.fp8_control = fp8_control
        self.setup_s = None
        self.memory_peak_bytes = None
        self.reference_at = None

    def program_variant(self, params):
        if self.variant in (None, "bf16"):
            return params
        if self.variant == "int8":
            from bee_code_interpreter_fs_tpu_torch.models import quantize_params

            return quantize_params(params)
        raise ValueError(f"unknown variant {self.variant!r}")

    def setup_done(self, at=None) -> None:
        self.setup_s = (time.perf_counter() if at is None else at) - T_START

    def read_memory(self) -> None:
        t = self.torch
        if self.device.type == "cuda":
            t.cuda.synchronize()
            self.memory_peak_bytes = int(t.cuda.max_memory_allocated(self.device))
        else:
            self.memory_peak_bytes = 0

    def reference_started(self) -> None:
        self.reference_at = time.perf_counter()


def card_line() -> str:
    """The card's name and power limit, from nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown (nvidia-smi unavailable)"


def run_cell(bench, cell_name, seed, seconds, trace, *, device=None, variant=None,
             conf_overrides=None, mix_overrides=None, fp8_control=False, torch=None,
             look_in=()):
    """Run the cell once; returns (result, check lines, other numbers, the
    driver's record). `device`, `conf_overrides`, `mix_overrides` and
    `look_in` (more directories for ``arch/`` and ``limits/``) serve the
    CPU tests, which run the harness at a tiny size without a card."""
    if torch is None:
        import torch
    cell = spec.by_name(bench["workloads"], cell_name, "workload")
    conf = spec.config(bench, cell["config"])
    dev = torch.device(device or "cuda")
    ctx = Context(torch, dev, bench, cell, conf, seed, seconds, trace, variant,
                  conf_overrides, mix_overrides, fp8_control, look_in)
    rec = spec.driver(ctx.mix["driver"]).run(ctx)
    rec["setup_s"] = ctx.setup_s
    ref_s = time.perf_counter() - ctx.reference_at if ctx.reference_at else None

    metrics = {}
    for m in spec.metrics_of(bench, cell_name, trace):
        value = spec.reader(m["name"]).read(rec, ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    ok, shown = check.verdict(rec["numbers"], spec.limits(cell_name, look_in))
    answers_ok = rec["failed"] == 0 and rec["attempted"] > 0
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": int(cell["chips"]),
        "memory_peak_bytes": ctx.memory_peak_bytes,
    }
    result = {"correct": bool(ok and answers_ok), "attempted": rec["attempted"],
              "failed": rec["failed"], "metrics": metrics, "device": device_info}
    if trace and ctx.tracer.summary is not None:
        s = ctx.tracer.summary
        device_info["busy_s"] = s["busy_s"]
        device_info["window_s"] = s["window_s"]
        result["breakdown"] = {"device_ops": s["device_ops"], "idle_gaps": s["idle_gaps"]}
    info = {k: v for k, v in rec["numbers"].items() if k not in shown}
    info["reference_s"] = ref_s
    info["window_s"] = rec["window_s"]
    if "k1_launches_window" in rec:
        info["k1_launches_window"] = rec["k1_launches_window"]
    if trace and ctx.tracer.summary is not None:
        info["device_event_kinds"] = ctx.tracer.summary["device_event_kinds"]
        info["span_device_s"] = ctx.tracer.summary["span_device_s"]
    for key in ("stats_window", "slice"):
        if key in rec:
            info[key] = rec[key]
    if rec.get("queued"):
        q = rec["queued"]
        info["queue"] = {"first": q[0], "last": q[-1], "max": max(q),
                         "mean": sum(q) / len(q)}
    result["checks"] = shown
    lines = [f"check {name}: {v['value']} (limit {v['limit']})" for name, v in shown.items()]
    lines.append(f"check answers: {rec['attempted'] - rec['failed']} of "
                 f"{rec['attempted']} finished (limit: all)")
    return result, lines, info, rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = spec.load_benchmark()
    cell = spec.by_name(bench["workloads"], args.workload, "workload")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"portbench: card {card_line()}; {args.workload} seed {args.seed} "
          f"seconds {args.seconds} trace {args.trace}", flush=True)
    result, lines, info, _ = run_cell(bench, args.workload, args.seed, args.seconds,
                                      bool(args.trace), torch=torch)
    guard.refuse_if_loaded("after the window")
    print("portbench: " + json.dumps(info, default=float), flush=True)
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
