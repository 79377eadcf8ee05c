"""The check that no JAX module is loaded in the benchmark's process.

Module names are compared by their top-level name (the part before the
first dot) as a whole: the port's package name begins with the JAX
package's, so a prefix test would flag the port itself.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "bee_code_interpreter_fs_tpu"})


def forbidden_loaded(modules=None) -> list[str]:
    """Sorted top-level names in `modules` (default: sys.modules) that are
    forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".", 1)[0] for name in names} & FORBIDDEN)


def refuse_if_loaded(when: str) -> None:
    """Exit with code 3, naming what was found on stderr, if a forbidden
    module is loaded."""
    found = forbidden_loaded()
    if found:
        print(f"portbench: forbidden modules loaded {when}: {', '.join(found)}",
              file=sys.stderr, flush=True)
        sys.exit(3)
