"""Where the port's native code is built, and the lock around building it.

Native libraries (the BVH builder, the CUDA traversal kernel) are built
from the repository's sources at first use into `build/aten_tpu_torch/`
of the checkout, which git ignores.  Several processes (pytest workers,
a script and its children) may ask at once, so each build runs under an
exclusive `fcntl` lock on a file beside its output; the lock is released
when the holder exits, even if it is killed.
"""
from __future__ import annotations

import contextlib
import fcntl
import os

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "aten_tpu_torch")


@contextlib.contextmanager
def build_lock(name: str):
    """Hold an exclusive lock named `name` inside BUILD_DIR."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, name + ".lock")
    with open(path, "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)

