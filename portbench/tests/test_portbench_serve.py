"""What the serving harness records of the engine's counters: the deltas
of ``engine.stats()`` between the window's two step ends
(``stats_window``) and over a traced slice (``EngineRun.since``), with a
stub in the port's engine's place."""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

import tiny  # noqa: F401  (puts the benchmark on sys.path)

from pb_core import spec  # noqa: E402
from pb_core.serve import EngineRun, stats_delta  # noqa: E402
from pb_core.trace import Tracer  # noqa: E402


class StubEngine:
    """Admits a prompt of 10 + k tokens on every third step k and runs one
    burst a step: the first eagerly, the rest replayed from a graph."""

    def __init__(self, params, cfg, device=None, seed=0, n_slots=4, steps_per_sync=2):
        self.n_slots, self.steps_per_sync = n_slots, steps_per_sync
        self.k = 0
        self.counts = {"graph_bursts": 0, "eager_bursts": 0}

    def _install(self, req, i):
        return 0, int(req.prompt.size)

    def _run_burst(self):
        self.counts["eager_bursts" if self.k == 0 else "graph_bursts"] += 1

    def step(self):
        if self.k % 3 == 0:
            self._install(types.SimpleNamespace(prompt=np.zeros(10 + self.k)), 0)
        self._run_burst()
        self.k += 1

    def stats(self):
        return {"queued": 2, "active_slots": 3, "occupied_slots": 3, "n_slots": self.n_slots,
                "results_pending": 0, **self.counts,
                "burst_graphs": int(self.counts["graph_bursts"] > 0)}


@pytest.fixture
def engine_run(monkeypatch):
    from bee_code_interpreter_fs_tpu_torch import models

    monkeypatch.setattr(models, "ServingEngine", StubEngine)
    ctx = types.SimpleNamespace(
        torch=torch, device=torch.device("cpu"), conf={}, seed=7, cfg=None,
        mix={"engine": {"n_slots": 4, "steps_per_sync": 2}},
        tracer=Tracer(torch, False), program_variant=lambda params: params,
        arch=types.SimpleNamespace(build_params=lambda conf, seed, dev, cfg: None,
                                   prefill_flops=lambda conf, n: 1.0,
                                   decode_flops=lambda conf, c: 1.0))
    return EngineRun(ctx)


def test_counters_land_in_the_window_and_the_slice(engine_run):
    er = engine_run
    t0 = er.step()  # step 0: an admission and the eager burst
    for _ in range(5):  # steps 1-5: the window, one admission (k = 3)
        t1 = er.step()
    mark = er.mark()
    for _ in range(3):  # steps 6-8: the slice, one admission (k = 6)
        er.step()
    sliced = er.since(mark)
    rec = er.window_record(t0, t1)

    assert rec["stats_window"] == {"queued": 0, "active_slots": 0, "occupied_slots": 0,
                                   "n_slots": 0, "results_pending": 0, "graph_bursts": 5,
                                   "eager_bursts": 0, "burst_graphs": 1}
    assert len(rec["burst_ms"]) == 5 and rec["occupancy"] == [0.75] * 5
    assert rec["queued"] == [2] * 5
    assert sliced == {"admits": [16], "bursts": [[3, 2]] * 3,
                      "stats": {"queued": 0, "active_slots": 0, "occupied_slots": 0,
                                "n_slots": 0, "results_pending": 0, "graph_bursts": 3,
                                "eager_bursts": 0, "burst_graphs": 0}}
    assert spec.reader("graph_burst_pct").read(rec, None) == 100.0


def test_stats_delta_keeps_numbers_only():
    assert stats_delta({"a": 1, "b": 2.5}, {"a": 4, "b": 3.0, "c": 2, "flag": True,
                                            "name": "x"}) == {"a": 3, "b": 0.5, "c": 2}
