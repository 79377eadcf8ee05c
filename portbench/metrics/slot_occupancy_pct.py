"""slot_occupancy_pct: the mean over the window's scheduler steps of
ServingEngine.stats()["active_slots"] / n_slots after the step, in %."""


def read(rec, ctx):
    occ = rec.get("occupancy")
    return 100.0 * sum(occ) / len(occ) if occ else None
