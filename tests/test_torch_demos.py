"""Run every demo of the PyTorch port as a subprocess on the CPU (the
counterpart of ``tests/test_demos.py``, reference
``doc/demo/test_demos.py:23-36``).

Each demo holds its own asserts and, at its end, asserts that ``jax``
never entered ``sys.modules``.  The simple example and the nonlinear heat
equation run in tier-1; the three plasticity and hyperelasticity demos,
and the von Mises demo on 2 gloo ranks against 1 (``final_displacement``
within 1e-12 relative, as ``tests/test_demos.py:52-63``), are ``slow``, as
their JAX twins are.
"""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMOS = os.path.join(REPO, "demos_torch")


def _run(demo, *args):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, os.path.join(DEMOS, demo), "--device", "cpu", *args],
                       capture_output=True, text=True, timeout=1200, env=env, cwd=REPO)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    return r.stdout


@pytest.mark.parametrize("demo,args", [
    ("demo_simple_example.py", []),
    ("demo_nonlinear_heat.py", []),
])
def test_demo_runs(demo, args):
    assert " OK" in _run(demo, *args)


@pytest.mark.parametrize("demo,args", [
    ("demo_plasticity_von_mises.py", ["--small", "--no-plot"]),
    ("demo_plasticity_mohr_coulomb.py", ["--small", "--no-plot"]),
    ("demo_hyperelasticity.py", ["--small", "--no-plot"]),
])
@pytest.mark.slow
def test_slow_demo_runs(demo, args):
    assert "demo OK" in _run(demo, *args)


def _final_displacement(out):
    for line in out.splitlines():
        if line.startswith("final_displacement="):
            return float(line.split("=", 1)[1])
    raise AssertionError(f"no final_displacement line in:\n{out[-2000:]}")


@pytest.mark.slow
def test_von_mises_demo_two_ranks_parity():
    """The whole demo with every form cell-sharded over 2 gloo ranks,
    against one process."""
    single = _final_displacement(_run("demo_plasticity_von_mises.py", "--small", "--no-plot"))
    sharded = _final_displacement(_run("demo_plasticity_von_mises.py", "--small", "--no-plot",
                                       "--ranks", "2"))
    assert abs(single - sharded) <= 1e-12 * max(1.0, abs(single)), (single, sharded)
