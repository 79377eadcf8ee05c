"""Ring-schedule collectives over the per-rank chunks of a one-card mesh.

Counterpart of the JAX package's parallel/collectives.py. A rank's shard is
an entry of a list indexed by rank; moving it to another rank moves the
list entry (no copy). ``ring_all_reduce`` and ``reduce_scatter_sum`` need
ranks on separate cards and come with the distributed slice.
"""

from __future__ import annotations


def ring_permute(chunks: list, *, shift: int = 1) -> list:
    """Send each rank's chunk to the next rank on the ring: rank i's chunk
    moves to rank (i + shift) % n (the reference's perm i -> (i + shift) %
    n)."""
    n = len(chunks)
    return [chunks[(j - shift) % n] for j in range(n)]
