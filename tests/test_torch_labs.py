"""aten_tpu_torch's microbenchmarks L2 and L3 against the reference labs.

The reference's tools/chase_lab.py and tools/launch_lab.py are loaded by
file path (tools/ is not a package) with their STEPS set to 64, and
their Pallas kernels run in TPU interpret mode on the CPU.  The port's
plain versions (what `run` computes for CPU tensors) must equal every
variant's output bit for bit: the outputs are small integers added to
x, so any difference is a wrong count, not rounding.
"""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from aten_tpu_torch.tools import chase_lab, launch_lab
from aten_tpu_torch.utils import spans

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 64


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_REF = {}


def _ref(name):
    if name not in _REF:
        mod = _load(name)
        if hasattr(mod, "STEPS"):
            mod.STEPS = STEPS
        _REF[name] = mod
    return _REF[name]


def _x(kind):
    """The reference's x (ones), or a seeded one in [0.25, 0.35) that
    makes the vote variants' flags vary from step to step."""
    if kind == "ones":
        return np.ones((8, 128), np.float32)
    return np.random.default_rng(5).uniform(0.25, 0.35, (8, 128)).astype(np.float32)


def test_chase_table_matches_reference():
    ref = np.asarray(_ref("chase_lab").build_chain(0))
    got = chase_lab.build_chain(0)
    assert got.dtype == ref.dtype and got.shape == (chase_lab.K, chase_lab.LANES)
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("variant", chase_lab.VARIANTS)
def test_chase_variants_match_reference(variant):
    ref = _ref("chase_lab")
    rows = chase_lab.build_chain(0)
    for kind in ("ones", "random"):
        x = _x(kind)
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(ref.run(jnp.asarray(rows), jnp.asarray(x), variant))
        got = chase_lab.run(torch.from_numpy(rows), torch.from_numpy(x), variant,
                            steps=STEPS).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32),
                                      err_msg=f"{variant} x={kind}")
        plain = chase_lab.run_plain(torch.from_numpy(rows), torch.from_numpy(x), variant,
                                    steps=STEPS).numpy()
        np.testing.assert_array_equal(got, plain)


def test_chase_vote_flags_vary():
    """On the seeded x the vote variants count some steps and not
    others, so the bitwise check above tests the flags themselves."""
    rows = torch.from_numpy(chase_lab.build_chain(0))
    x = torch.from_numpy(_x("random"))
    base = float(chase_lab.run_plain(rows, x, "chase", STEPS)[0, 0] - x[0, 0])
    for variant in ("reduce", "vec2scalar", "red_kd", "red_11"):
        acc = float(chase_lab.run_plain(rows, x, variant, STEPS)[0, 0] - x[0, 0]) - base
        assert 0 < acc < STEPS, (variant, acc)


def test_chase_lab_rejects_bad_arguments():
    spans.reset()
    rows = torch.from_numpy(chase_lab.build_chain(0))
    x = torch.ones((8, 128))
    with pytest.raises(ValueError, match="variant"):
        chase_lab.run(rows, x, "smt8")
    with pytest.raises(ValueError, match="rows"):
        chase_lab.run(rows[:100], x, "chase")
    with pytest.raises(ValueError, match="x"):
        chase_lab.run(rows, x.double(), "chase")
    with pytest.raises(ValueError, match="unsupported device"):
        chase_lab.run(rows.to("meta"), x.to("meta"), "chase")
    assert not [k for k in spans.counters() if k.startswith("launch.")]


@pytest.mark.parametrize("steps,nlaunch,grid", [(1, 1, 1), (1, 4, 1), (1, 1, 64),
                                                (STEPS, 2, 3), (1024, 1, 1)])
def test_launch_lab_matches_reference(steps, nlaunch, grid):
    spans.reset()
    ref = _ref("launch_lab")
    x = _x("random")
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ref.run(jnp.asarray(x), steps, nlaunch, grid))
    got = launch_lab.run(torch.from_numpy(x), steps, nlaunch, grid).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert not [k for k in spans.counters() if k.startswith("launch.")]


def test_launch_lab_rejects_bad_arguments():
    x = torch.ones((8, 128))
    with pytest.raises(ValueError, match="nlaunch"):
        launch_lab.run(x, 1, 0, 1)
    with pytest.raises(ValueError, match="x"):
        launch_lab.run(torch.ones((4, 128)), 1, 1, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        launch_lab.run(x.to("meta"), 1, 1, 1)
    assert launch_lab.lcg(1) == 12345 & 1023
