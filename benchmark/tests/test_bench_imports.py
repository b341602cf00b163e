"""No module of the benchmark loads JAX or the JAX package aten_tpu, and
the plain reference loads nothing of the program (aten_tpu_torch either).
Names are compared by their top-level part, whole: aten_tpu_torch begins
with aten_tpu but is not it."""
import json
import os
import subprocess
import sys

from bench_cells import ROOT

from benchmark import guard

_PROBE = """
import importlib, json, pkgutil, sys
sys.path.insert(0, {root!r})
import benchmark
names = {names!r}
for n in names:
    importlib.import_module(n)
print(json.dumps(sorted(sys.modules)))
"""


def _loaded(names):
    out = subprocess.run([sys.executable, "-c", _PROBE.format(root=ROOT, names=names)],
                         capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def _benchmark_modules(sub=""):
    base = os.path.join(ROOT, "benchmark", sub)
    pkg = "benchmark" + ("." + sub if sub else "")
    return [f"{pkg}.{f[:-3]}" for f in sorted(os.listdir(base))
            if f.endswith(".py") and f != "__init__.py"]


def test_reference_loads_no_program_and_no_jax():
    loaded = _loaded(_benchmark_modules("reference"))
    assert not guard.forbidden_loaded(loaded, guard.FORBIDDEN + (guard.PROGRAM,)), \
        guard.top_levels(loaded)


def test_benchmark_loads_no_jax():
    names = _benchmark_modules() + _benchmark_modules("entries") + [
        "aten_tpu_torch.integrator.pathtracer", "aten_tpu_torch.parallel.mesh",
        "aten_tpu_torch.scene.scene", "aten_tpu_torch.ops.traverse_cuda"]
    loaded = _loaded(names)
    assert "aten_tpu_torch" in guard.top_levels(loaded)
    assert not guard.forbidden_loaded(loaded), sorted(guard.top_levels(loaded))


def test_top_level_names_compare_whole():
    assert guard.forbidden_loaded(["aten_tpu_torch", "aten_tpu_torch.scene"]) == []
    assert guard.forbidden_loaded(["aten_tpu.scene.scene"]) == ["aten_tpu"]
    assert guard.forbidden_loaded(["jaxlib.xla_client", "numpy"]) == ["jaxlib"]
    assert guard.forbidden_loaded(["jaxtyping"]) == []
    assert guard.forbidden_loaded(["chip_smoke", "benchmark.harness"]) == ["chip_smoke"]


def test_reference_namespaces_hold_no_program():
    import benchmark.reference.pathtrace  # noqa: F401
    import benchmark.reference.train  # noqa: F401

    guard.check_reference()
