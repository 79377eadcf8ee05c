"""Tiny sizes for running the harness on the CPU in tests: the cells'
configurations cut to a few lanes and layers, their mixes to short
prompts and documents. Only the shapes change; every code path is the
cell's own."""

from __future__ import annotations

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

CONF = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, vocab_size=256)
WINDOW = {"mistral-7b": 16}
MIX = {
    "mistral-7b.score-long": {
        "document_tokens": {"dist": "loguniform", "min": 24, "max": 96},
        "warm_up_tokens": [24, 96], "documents_per_run": 2000},
    "mixtral-8x7b.serve-batch": {
        "prompt_tokens": {"dist": "lognormal", "median": 24, "sigma": 0.8, "min": 4, "max": 48},
        "output_tokens": {"dist": "lognormal", "median": 12, "sigma": 0.7, "min": 2, "max": 40},
        "drain_cap_s": 120, "engine": {"n_slots": 6, "max_len": 96, "steps_per_sync": 4},
        "clients": 6, "block": 6, "requests_per_run": 2000},
}
CELLS = tuple(MIX)


def conf_overrides(cell: str) -> dict:
    out = dict(CONF)
    config = cell.split(".")[0]
    if config in WINDOW:
        out["sliding_window"] = WINDOW[config]
    return out


def run_tiny(cell: str, seed: int, *, seconds: float = 1.0, trace: bool = False,
             variant=None):
    """One run of the cell at the tiny size on the CPU:
    (result, check lines, other numbers, record)."""
    import torch

    import run
    from pb_core import spec

    # Tiny ops on a shared CPU: one thread each, or thread hand-offs
    # outweigh the work.
    torch.set_num_threads(1)
    return run.run_cell(spec.load_benchmark(), cell, seed, seconds, trace,
                        device="cpu", conf_overrides=conf_overrides(cell),
                        mix_overrides=MIX[cell], variant=variant)
