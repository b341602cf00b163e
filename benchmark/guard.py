"""The import check: no JAX, and no reference package, in a benchmark process.

Module names are compared by their top-level name, the part before the
first dot, whole: the port `aten_tpu_torch` begins with the JAX package's
name `aten_tpu` but is not it.
"""
from __future__ import annotations

import sys

# never in a benchmark process: JAX, the JAX package, and its bench and check scripts
FORBIDDEN = ("jax", "jaxlib", "flax", "aten_tpu", "bench", "chip_smoke")
# never in the plain reference, besides FORBIDDEN
PROGRAM = "aten_tpu_torch"


class ForbiddenImport(RuntimeError):
    """A forbidden module was loaded in a benchmark process."""


def top_levels(names):
    return {name.split(".", 1)[0] for name in names}


def forbidden_loaded(names=None, forbidden=FORBIDDEN):
    """The forbidden top-level names among `names` (default sys.modules)."""
    tops = top_levels(sys.modules if names is None else names)
    return sorted(tops & set(forbidden))


def check(forbidden=FORBIDDEN):
    """Raise ForbiddenImport, naming them, if forbidden modules are loaded."""
    found = forbidden_loaded(forbidden=forbidden)
    if found:
        raise ForbiddenImport(f"forbidden modules loaded in this process: {found}")


def check_reference():
    """Raise ForbiddenImport if a module of the plain reference holds a
    module, function or class of the program or of a forbidden package:
    the program is loaded in a run's process, so the reference is held to
    what its own namespaces refer to."""
    bad = set()
    for name, mod in list(sys.modules.items()):
        if not name.startswith("benchmark.reference") or mod is None:
            continue
        for value in vars(mod).values():
            owner = getattr(value, "__name__", None) if isinstance(value, type(sys)) else \
                getattr(value, "__module__", None)
            if isinstance(owner, str) and owner.split(".", 1)[0] in FORBIDDEN + (PROGRAM,):
                bad.add(f"{name} -> {owner}")
    if bad:
        raise ForbiddenImport(f"the reference refers to the program or JAX: {sorted(bad)}")
