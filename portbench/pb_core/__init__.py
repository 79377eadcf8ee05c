"""The benchmark's own machinery: what every cell shares.

Nothing here imports JAX, the JAX package, or (at import time) the port:
the harness imports the port only once the guard has run (``guard.py``).
"""
