"""What the serving drivers share: the port's ``ServingEngine`` built from
the cell's mix, the host-clock timings wrapped around it from outside,
per-request records from its streaming callbacks, and the check.

The engine's ``_run_burst`` (a burst of ``steps_per_sync`` decode steps
ending in its one device-to-host copy) and ``_install`` (admission:
prefill into a scratch and the row install) are wrapped on the instance,
as ``chip_smoke.py``'s ``drive_engine`` does. They are private names of
the port: if a later version renames them, the metrics that read them
(``decode_step_ms``, and ``mfu.serve``'s count of prefilled tokens) come
out empty or short rather than wrong. ``engine.stats()`` (host-only: it
syncs nothing) is read after every step and before every burst.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np

from pb_core import check, traffic


class Req:
    """One request's host-side record."""

    __slots__ = ("spec", "first_at", "last_at", "n",
                 "tokens", "deliveries", "counted")

    def __init__(self, spec: dict, counted: bool):
        self.spec = spec
        self.first_at = None
        self.last_at = None
        self.n = 0
        self.tokens: list = []
        self.deliveries: list = []  # (time, first generated index, count)
        self.counted = counted

    @property
    def done(self) -> bool:
        return self.n >= self.spec["max_new_tokens"]


class EngineRun:
    """The engine under one cell's mix, and what the window records."""

    def __init__(self, ctx):
        from bee_code_interpreter_fs_tpu_torch.models import ServingEngine

        self.ctx = ctx
        self.torch = ctx.torch
        mix, eng_kw = ctx.mix, dict(ctx.mix["engine"])
        params = ctx.program_variant(ctx.arch.build_params(ctx.conf, ctx.seed, ctx.device,
                                                           ctx.cfg))
        self.engine = ServingEngine(params, ctx.cfg, device=ctx.device,
                                    seed=ctx.seed, **eng_kw)
        self.n_slots = self.engine.n_slots
        self.steps_per_sync = self.engine.steps_per_sync
        self.bursts: list = []    # (start, end, active slots) host clock
        self.admits: list = []    # (start, end, prompt tokens)
        self.steps: list = []     # (end, engine.stats() after the step)
        self.reqs: list = []
        self._wrap()
        self.mix = mix

    def _wrap(self):
        eng, tracer = self.engine, self.ctx.tracer
        run_burst = getattr(eng, "_run_burst", None)
        install = getattr(eng, "_install", None)
        if run_burst is not None:
            def timed_burst(*a, **k):
                active = eng.stats()["active_slots"]
                with tracer.label("portbench.burst"):
                    t = time.perf_counter()
                    out = run_burst(*a, **k)  # ends in its device-to-host copy
                    self.bursts.append((t, time.perf_counter(), active))
                return out
            eng._run_burst = timed_burst
        if install is not None:
            def timed_install(req, i):
                with tracer.label("portbench.admit"):
                    t = time.perf_counter()
                    out = install(req, i)  # its first token reaches the host
                    self.admits.append((t, time.perf_counter(), int(req.prompt.size)))
                return out
            eng._install = timed_install

    # ------------------------------------------------------------ requests

    def submit(self, spec: dict, counted: bool) -> Req:
        r = Req(spec, counted)

        def on_token(new, r=r):
            now = time.perf_counter()
            if r.first_at is None:
                r.first_at = now
            r.last_at = now
            r.deliveries.append((now, r.n, len(new)))
            r.n += len(new)
            r.tokens.extend(new)

        self.engine.submit(spec["prompt"], spec["max_new_tokens"], on_token=on_token)
        self.reqs.append(r)
        return r

    def busy(self) -> bool:
        st = self.engine.stats()
        return st["queued"] > 0 or st["occupied_slots"] > 0

    def step(self) -> float:
        with self.ctx.tracer.label("portbench.step"):
            self.engine.step()
        end = time.perf_counter()
        self.steps.append((end, self.engine.stats()))
        return end

    def warm_up(self, specs: list) -> None:
        """Admit one request at each prefill bucket the mix can use, run
        its bursts, then drain."""
        eng, vocab = self.engine, self.ctx.cfg.vocab_size
        buckets = {}
        for spec in specs:
            buckets.setdefault(eng._bucket_len(spec["prompt"].size), spec["prompt"].size)
        rng = traffic.rng_for(self.ctx.seed, "warm")
        for n in sorted(buckets.values()):
            self.engine.submit(rng.integers(0, vocab, size=n, dtype=np.int32),
                               2 * self.steps_per_sync + 1)
        self.engine.run()
        self.bursts.clear()
        self.admits.clear()
        self.steps.clear()
        if self.ctx.device.type == "cuda":
            self.torch.cuda.synchronize()

    # ------------------------------------------------------------ window

    def mark(self):
        """Where the records stand now, for `since`."""
        return len(self.admits), len(self.bursts), self.engine.stats()

    def since(self, mark) -> dict:
        """What the engine drove since `mark`: each admission's prompt
        tokens, each burst's active slots (before it) and steps, and the
        deltas of ``engine.stats()``."""
        n_admits, n_bursts, before = mark
        return {"admits": [n for _, _, n in self.admits[n_admits:]],
                "bursts": [[a, self.steps_per_sync] for _, _, a in self.bursts[n_bursts:]],
                "stats": stats_delta(before, self.engine.stats())}

    def window_record(self, t0: float, t1: float) -> dict:
        """Counts and samples of the window [t0, t1] (both step ends)."""
        conf, arch = self.ctx.conf, self.ctx.arch
        counted = [r for r in self.reqs if r.counted]
        out_tokens, flops = 0, 0.0
        for r in self.reqs:
            plen = int(r.spec["prompt"].size)
            for at, j0, k in r.deliveries:
                if t0 < at <= t1:
                    out_tokens += k
                    for j in range(max(j0, 1), j0 + k):
                        flops += arch.decode_flops(conf, plen + j)
        for s, e, n in self.admits:
            if t0 < e <= t1:
                flops += arch.prefill_flops(conf, n)
        tpot = [(r.last_at - r.first_at) * 1e3 / (r.n - 1)
                for r in counted if r.done and r.n > 1]
        in_win = lambda e: t0 < e <= t1  # noqa: E731
        at = {e: st for e, st in self.steps}
        return {
            "window_s": t1 - t0,
            "attempted": len(counted),
            "failed": sum(not r.done for r in counted),
            "output_tokens": out_tokens,
            "model_flops": flops,
            "tpot_ms": tpot,
            "burst_ms": [(e - s) * 1e3 for s, e, _ in self.bursts if in_win(e)],
            "occupancy": [st["active_slots"] / self.n_slots for e, st in self.steps
                          if in_win(e)],
            "queued": [st["queued"] for e, st in self.steps if in_win(e)],
            "steps_per_sync": self.steps_per_sync,
            "stats_window": stats_delta(at[t0], at[t1]),
        }

    def drain(self, until_done, cap_s: float) -> None:
        """Step until every request in `until_done` has all its tokens, or
        `cap_s` seconds have passed."""
        stop = time.perf_counter() + cap_s
        while any(not r.done for r in until_done) and time.perf_counter() < stop:
            if not self.busy():
                break
            self.step()

    # ------------------------------------------------------------ check

    def finish(self, rec: dict) -> dict:
        """Free the program, then hold a seeded sample of the finished
        requests to the reference."""
        ctx, torch = self.ctx, self.torch
        ctx.read_memory()
        done = [r for r in self.reqs if r.counted and r.done]
        k = int(self.mix["check"]["requests"])
        pairs = [{"prompt": done[i].spec["prompt"],
                  "tokens": np.asarray(done[i].tokens, np.int64)}
                 for i in check.sample(done, k, ctx.seed, lambda r: r.spec["prompt"].size + r.n)]
        del self.engine, done
        gc.collect()
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        ctx.reference_started()
        ref_cls = ctx.arch.Reference
        control = (ref_cls(ctx.conf, ctx.seed, ctx.device, matmul_fp8=True)
                   if ctx.fp8_control else None)
        numbers = check.served_gaps(ref_cls(ctx.conf, ctx.seed, ctx.device), pairs, control)
        numbers["requests_compared"] = len(pairs)
        rec["numbers"] = numbers
        return rec


def stats_delta(before: dict, after: dict) -> dict:
    """after - before, for each number of ``engine.stats()``."""
    return {k: v - before.get(k, 0) for k, v in after.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)}


def residual_budgets(specs: list, seed: int) -> list:
    """Remaining output budgets for requests already under way when a
    closed loop is in its steady state: request c of n keeps the
    fraction (c + 1/2) / n of its length, in seeded order."""
    n = len(specs)
    order = traffic.rng_for(seed, "residual").permutation(n)
    return [max(1, math.ceil(s["max_new_tokens"] * (order[c] + 0.5) / n))
            for c, s in enumerate(specs)]
