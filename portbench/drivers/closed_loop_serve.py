"""Closed loop: ``clients`` clients, each submitting its next request to the
port's ``ServingEngine`` as soon as its last one has all its tokens (at
the end of the scheduler step that delivered them).

Set-up brings the loop to its steady state at once: every client's first
request is one already under way, with a residual output budget
(``pb_core.serve.residual_budgets``), all admitted by the first step. The
window opens at the end of that step and closes at the end of the first
step past ``--seconds``. Requests submitted in the window are followed to
their end after it (up to ``drain_cap_s``); clients go on through a traced
slice after the window, then stop.
"""

from __future__ import annotations

import time

from pb_core import traffic
from pb_core.serve import EngineRun, residual_budgets


def run(ctx) -> dict:
    mix = ctx.mix
    er = EngineRun(ctx)
    n_clients = int(mix["clients"])
    n = int(mix["requests_per_run"])
    specs = traffic.requests(mix, ctx.seed, n, ctx.cfg.vocab_size)
    with ctx.torch.inference_mode():
        er.warm_up(specs)
    first = specs[:n_clients]
    budgets = residual_budgets(first, ctx.seed)
    clients = [er.submit(dict(s, max_new_tokens=b), counted=False)
               for s, b in zip(first, budgets)]
    idx = n_clients
    t0 = None
    counted = []

    def loop_until(done, submit: bool):
        nonlocal idx
        while True:
            end = er.step()
            if submit:
                for c, r in enumerate(clients):
                    if r.done:
                        if idx >= n:
                            raise RuntimeError(f"the mix's {n} requests ran out "
                                               "before the window closed")
                        in_window = t0 is not None and end < t0 + ctx.seconds
                        clients[c] = er.submit(specs[idx], counted=in_window)
                        if in_window:
                            counted.append(clients[c])
                        idx += 1
            if done(end):
                return end

    with ctx.torch.inference_mode():
        t0 = loop_until(lambda end: True, submit=False)
        # Clients whose first request ended in the first step submit now.
        for c, r in enumerate(clients):
            if r.done:
                clients[c] = er.submit(specs[idx], counted=True)
                counted.append(clients[c])
                idx += 1
        ctx.setup_done()
        t1 = loop_until(lambda end: end >= t0 + ctx.seconds, submit=True)
        if ctx.tracer.enabled:
            trace_until = time.perf_counter() + float(mix.get("trace_seconds", 3))
            with ctx.tracer.slice():
                loop_until(lambda end: end >= trace_until, submit=True)
        er.drain(counted, float(mix["drain_cap_s"]))
    return er.finish(er.window_record(t0, t1))
