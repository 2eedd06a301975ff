"""Contracts the GPU needs from the solver path: every contraction of state
states ``Precision.HIGHEST`` (the GPU would otherwise be free to run f32
dots in TF32), and the solver path imports and steps without SymPy."""

import os
import pathlib
import subprocess
import sys

import jax
import jax.extend
import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import bench  # noqa: E402


def _jaxprs(jaxpr):
    """``jaxpr`` and every sub-jaxpr reachable from its equations."""
    yield jaxpr
    for eqn in jaxpr.eqns:
        for value in eqn.params.values():
            for v in value if isinstance(value, (tuple, list)) else (value,):
                if isinstance(v, jax.extend.core.ClosedJaxpr):
                    yield from _jaxprs(v.jaxpr)
                elif isinstance(v, jax.extend.core.Jaxpr):
                    yield from _jaxprs(v)


def _dot_precisions(fn, *args):
    closed = jax.make_jaxpr(fn)(*args)
    return [
        eqn.params["precision"]
        for jp in _jaxprs(closed.jaxpr)
        for eqn in jp.eqns
        if eqn.primitive.name == "dot_general"
    ]


def _cell(name):
    if name == "euler":
        solver, Q = bench.euler_setup((4, 4, 4))
        return solver.step, Q
    if name == "limited":
        limited, Q = bench.limited_setup((4, 4, 4), capacity=8)
        return limited.step, Q
    solver, Q, _ = bench.ck_setup((4, 2, 2))
    return solver.step, Q


@pytest.mark.parametrize("cell", ["euler", "limited", "ck"])
def test_every_dot_in_a_step_is_highest(cell):
    step, Q = _cell(cell)
    precisions = _dot_precisions(step, Q, np.float32(1e-3))
    assert precisions, "expected contractions in the step"
    highest = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
    assert all(p == highest for p in precisions), set(precisions)


def test_z4_einsums_are_highest():
    from exahype_jax.models.z4 import make_z4_solver

    solver = make_z4_solver(dim=3, order=1, grid_shape=(2, 2, 2), dx=0.5)
    Q = np.zeros(solver.state_shape, np.float32)
    precisions = _dot_precisions(lambda q: solver.step(q, 1e-3), Q)
    assert precisions
    highest = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
    assert all(p == highest for p in precisions), set(precisions)


def test_solver_path_runs_without_sympy():
    code = """
import sys
sys.modules["sympy"] = None
import numpy as np
import bench
import exahype_jax.models.limiter, exahype_jax.parallel.shard
import exahype_jax.models.aderdg_triton, exahype_jax.utils.roofline
solver, Q = bench.euler_setup((2, 2, 2))
out = solver.step(Q, np.float32(1e-3))
assert np.isfinite(np.asarray(out)).all()
assert "sympy" not in {m.split(".")[0] for m in sys.modules if sys.modules[m]}
print("ok")
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


def test_former_package_name_is_an_alias():
    """Imports under the package's former name (the one-file alias package
    beside ``exahype_jax``) give the very same module and class objects."""
    (old,) = [p.parent.name for p in ROOT.glob("exahype_*/__init__.py")
              if p.parent.name != "exahype_jax"]
    code = f"""
import warnings
warnings.simplefilter("error", DeprecationWarning)
try:
    import {old}
except DeprecationWarning:
    pass
else:
    raise SystemExit("expected a DeprecationWarning")
warnings.simplefilter("ignore", DeprecationWarning)
import {old}.models.aderdg
from {old}.models.limiter import LimitedADERDG
import exahype_jax, exahype_jax.models.aderdg, exahype_jax.models.limiter
assert {old} is exahype_jax
assert {old}.models.aderdg is exahype_jax.models.aderdg
assert LimitedADERDG is exahype_jax.models.limiter.LimitedADERDG
assert exahype_jax.models.aderdg.__spec__.name == "exahype_jax.models.aderdg"
print("ok")
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")
