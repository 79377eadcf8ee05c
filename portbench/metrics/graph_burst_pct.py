"""graph_burst_pct: the share of the window's decode bursts that the
engine replayed from a CUDA graph, in %: the deltas of
ServingEngine.stats()["graph_bursts"] and ["eager_bursts"] between the
window's two step ends (rec["stats_window"])."""


def read(rec, ctx):
    st = rec.get("stats_window", {})
    if "graph_bursts" not in st or "eager_bursts" not in st:
        return None
    bursts = st["graph_bursts"] + st["eager_bursts"]
    return 100.0 * st["graph_bursts"] / bursts if bursts > 0 else None
