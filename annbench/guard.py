"""The check that no JAX module is loaded in the benchmark's process.

The port, ``parlayann_tpu_torch``, begins with the JAX package's name, so
modules are compared by their top-level name (the part before the first
dot), whole.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "parlayann_tpu"})


def forbidden_loaded(modules=None) -> list[str]:
    """Sorted top-level names of loaded modules that the benchmark must not
    load (``modules``: names to look at, default ``sys.modules``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)


def require_clean(when: str) -> None:
    """Exit with code 3, naming what was found on standard error, if a
    forbidden module is loaded."""
    found = forbidden_loaded()
    if found:
        print(f"annbench: {when}: forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr, flush=True)
        raise SystemExit(3)
