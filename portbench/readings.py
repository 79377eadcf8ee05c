"""The readings a cell's limits are set from: many seeds of the program,
and of its control, in one process.

    python3 portbench/readings.py --workload <cell> --seconds <s> \\
        --seeds <n,n,...> [--fp8-control] [--int8-seeds <n,n,...>]

Each seed is one whole run of the cell (``run.run_cell``: weights from the
seed, warm-up, a window of ``--seconds``, the check) at the cell's own
sizes; one process pays the import and the card's start-up once. With
``--fp8-control`` each run also reads every compared number for the
control, the reference computing its matmuls in fp8 over the same
prompts and tokens (``control_<number>``): the check has to refuse it.
``--int8-seeds`` runs the program with its int8 weights instead: the
score cell's control. Prints one JSON line per run and, last, each compared number's
readings. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import run  # noqa: E402
from pb_core import guard, spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--int8-seeds", default="")
    ap.add_argument("--out", default=None)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fp8-control", action="store_true",
                    help="also read each number for the reference computing its matmuls in fp8")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("portbench: readings need a CUDA device", file=sys.stderr)
        return 2
    bench = spec.load_benchmark()
    print(f"portbench: card {run.card_line()}", flush=True)
    rows = []
    plan = [(int(s), "bf16") for s in args.seeds.split(",") if s]
    plan += [(int(s), "int8") for s in args.int8_seeds.split(",") if s]
    for seed, variant in plan:
        result, lines, info, _ = run.run_cell(
            bench, args.workload, seed, args.seconds, bool(args.trace), variant=variant,
            fp8_control=args.fp8_control, torch=torch)
        row = {"seed": seed, "variant": variant, "correct": result["correct"],
               "attempted": result["attempted"], "failed": result["failed"],
               "breakdown": result.get("breakdown"),
               "numbers": {k: v["value"] for k, v in result["checks"].items()},
               "other": info, "metrics": {k: v["value"] for k, v in result["metrics"].items()},
               "memory_peak_bytes": result["device"]["memory_peak_bytes"]}
        rows.append(row)
        print(json.dumps(row, default=float), flush=True)
    guard.refuse_if_loaded("after the readings")
    summary = {}
    for name in rows[0]["numbers"] if rows else ():
        summary[name] = {
            "program": [r["numbers"][name] for r in rows if r["variant"] == "bf16"],
            "fp8_control": [r["other"][f"control_{name}"] for r in rows
                            if f"control_{name}" in r["other"]],
            "int8": [r["numbers"][name] for r in rows if r["variant"] == "int8"]}
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(r, default=float) for r in rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
