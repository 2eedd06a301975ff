"""The GPU run-time helpers (``utils/gpu.py``, ``utils/roofline.py``), the
entry scripts' refusal to run without a GPU, and the tests marked ``gpu``
that ``chip_smoke.py`` calls on the card."""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from exahype_jax.utils import gpu, roofline

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _cpu_env(**extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **extra)
    env.pop("XLA_FLAGS", None)
    return env


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_entry_scripts_refuse_the_cpu(script, tmp_path):
    out = subprocess.run(
        [sys.executable, str(ROOT / script)], cwd=tmp_path, env=_cpu_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=_cpu_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert out.stdout == ""


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        gpu.require_gpu()


def test_unknown_device_kind_raises():
    with pytest.raises(KeyError, match="no peak rates"):
        roofline.peaks_for(jax.devices()[0].device_kind)
    assert roofline.peaks_for("NVIDIA H100 80GB HBM3")["f32_flops"] == 67e12


@pytest.mark.parametrize("preset", [None, "/some/cache"])
def test_compile_cache_dir_rule(preset, monkeypatch):
    if preset is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert gpu.compile_cache_dir() == ROOT / ".jax_cache"
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", preset)
        assert gpu.compile_cache_dir() is None
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()


# ------------------------------------------------------------ on the card


@pytest.mark.gpu
def test_contractions_keep_f32_accuracy_on_gpu(gpu_device):
    """``_apply`` at HIGHEST precision: TF32 (≈1e-3) would fail this."""
    from exahype_jax.models.aderdg import _apply
    from exahype_jax.models.dg import DGOperators

    D = np.asarray(DGOperators(3).D)
    x = np.random.default_rng(0).standard_normal((4, 4, 4, 5, 4096))
    want = np.moveaxis(np.tensordot(D, x, axes=([1], [1])), 0, 1)
    got = jax.jit(lambda v: _apply(D, v, 1))(
        jax.device_put(jnp.asarray(x, jnp.float32), gpu_device)
    )
    err = np.max(np.abs(np.asarray(got, np.float64) - want)) / np.max(np.abs(want))
    assert err < 1e-6, err


@pytest.mark.gpu
def test_peak_table_knows_this_card(gpu_device):
    assert roofline.peaks_for(gpu_device.device_kind)["hbm_bytes_per_s"] > 0


# ------------------------------------------------------------- bench helpers


def _noisy_flat_euler():
    """p3 3-D Euler at rest (ρ = 1, p = 1) with white noise of 1e-8."""
    sys.path.insert(0, str(ROOT))
    import bench

    solver, _ = bench.euler_setup((4, 4, 4), np.float64)
    shape = list(solver.state_shape)
    shape[solver.var_axis] = 1
    rest = np.concatenate(
        [np.ones(shape), np.zeros(shape), np.zeros(shape), np.zeros(shape),
         np.full(shape, 2.5)], axis=solver.var_axis)
    noise = 1e-8 * np.random.default_rng(0).standard_normal(rest.shape)
    return bench, solver, rest, rest + noise


@pytest.mark.parametrize("which", ["bench", "default"])
def test_bench_time_step_is_stable_in_3d(which):
    """The cells' ``stable_dt`` keeps rounding-level noise on a flat state
    at its level; ``cfl_dt``'s default constant, which bounds only the
    largest per-axis Courant number, lets it grow ~1.6x per step in 3-D."""
    bench, solver, rest, Q = _noisy_flat_euler()
    dt = bench.stable_dt(solver, Q) if which == "bench" else float(solver.cfl_dt(Q))
    run = jax.jit(lambda q: jax.lax.fori_loop(
        0, 40, lambda _, x: solver.step(x, dt), q))
    growth = float(np.max(np.abs(np.asarray(run(Q)) - rest))) / 1e-8
    if which == "bench":
        assert growth < 10, growth
    else:
        assert not growth < 1e3, growth
