"""Auxiliary-subsystem tests: profiling/cost model, checkpointing, driver
(failure detection + recovery), logging metrics."""

import logging
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from exahype_jax.models import build_rusanov_kernel, euler
from exahype_jax.parallel import GridSolver, PatchGrid
from exahype_jax.parallel.driver import DriverConfig, TimeLoopDriver
from exahype_jax.utils.checkpoint import CheckpointManager
from exahype_jax.utils.config import KernelConfig
from exahype_jax.utils.profiling import estimate_cost, time_fn


def test_cost_model_scales_with_patches():
    kb1 = build_rusanov_kernel(n_patches=1)
    kb8 = build_rusanov_kernel(n_patches=8)
    c1, c8 = estimate_cost(kb1), estimate_cost(kb8)
    assert c8.flops == 8 * c1.flops
    assert c8.bytes_total == 8 * c1.bytes_total
    assert c1.flops > 0 and c1.arithmetic_intensity > 0
    assert c1.roofline_seconds(67e12, 3.35e12) > 0


def test_time_fn_runs():
    kb = build_rusanov_kernel()
    from exahype_jax.backends.jax_backend import JAXPrinter

    fn = JAXPrinter(kb).jit(donate_input=False)
    rng = np.random.default_rng(0)
    Q = rng.uniform(1.0, 2.0, size=kb.item_shape("Q"))
    Q[..., 3] += 5.0
    sec = time_fn(fn, Q, 0.001, iters=2, warmup=1)
    assert sec > 0


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    state = {"step": 10, "t": 0.5, "dt": 0.01, "Q": np.arange(12.0).reshape(3, 4)}
    mgr.save(10, state)
    mgr.save(20, {**state, "step": 20})
    mgr.save(30, {**state, "step": 30})
    assert mgr.steps() == [20, 30]  # gc kept the newest two
    restored = mgr.restore()
    assert int(restored["step"]) == 30
    np.testing.assert_array_equal(restored["Q"], state["Q"])
    assert mgr.restore(20) is not None


def make_solver(gx=2, gy=2):
    cfg = KernelConfig(
        dim=2, patch_size=4, halo_size=1, n_real=5, n_aux=5, n_patches=gx * gy
    )
    grid = PatchGrid(config=cfg, grid_shape=(gx, gy))
    kb = build_rusanov_kernel(
        dim=2, patch_size=4, halo_size=1, n_real=5, n_aux=5, n_patches=gx * gy
    )
    return GridSolver(grid, kb, dx=0.1)


def euler_state(grid, seed=0):
    rng = np.random.default_rng(seed)
    Q = rng.uniform(0.1, 1.0, size=grid.state_shape)
    Q[..., 0] += 1.0
    Q[..., 3] += 5.0
    Q[..., 4] += 5.0
    return Q


def test_driver_runs_and_checkpoints(tmp_path, caplog):
    solver = make_solver()
    driver = TimeLoopDriver(
        solver,
        DriverConfig(
            chunk_steps=2,
            checkpoint_every=1,
            checkpoint_dir=str(tmp_path / "ck"),
            log_metrics=True,
        ),
    )
    Q0 = euler_state(solver.grid)
    with caplog.at_level(logging.INFO, logger="exahype_jax.driver"):
        Q, t, stats = driver.run(Q0, n_steps=5, dt=1e-3)
    assert stats["steps"] == 5
    assert t == pytest.approx(5e-3)
    assert driver.ckpt.latest_step() is not None
    assert any("dof_per_sec" in r.message for r in caplog.records)

    # Resume: a new driver picks up from the checkpoint.
    driver2 = TimeLoopDriver(
        solver,
        DriverConfig(
            chunk_steps=2, checkpoint_every=1, checkpoint_dir=str(tmp_path / "ck")
        ),
    )
    Qr, tr, start, dt_r = driver2.resume_or_init(Q0, 1e-3)
    assert start > 0
    assert dt_r == pytest.approx(1e-3)  # checkpointed dt wins on resume


def test_driver_failure_detection_without_checkpoint():
    solver = make_solver()
    driver = TimeLoopDriver(solver, DriverConfig(chunk_steps=2, log_metrics=False))
    Q0 = euler_state(solver.grid)
    Q0[0, 0, 2, 2, 0] = 0.0  # zero density -> 1/rho = inf
    with pytest.raises(FloatingPointError):
        driver.run(Q0, n_steps=4, dt=1e-3)


def test_driver_elastic_recovery(tmp_path, caplog):
    """A non-finite state rolls back to the last checkpoint with reduced dt."""
    solver = make_solver()
    config = DriverConfig(
        chunk_steps=1,
        checkpoint_every=1,
        checkpoint_dir=str(tmp_path / "ck"),
        max_recoveries=3,
        log_metrics=False,
    )
    driver = TimeLoopDriver(solver, config)
    Q0 = euler_state(solver.grid)

    # Prime a good checkpoint at step 1, then poison the state so the next
    # chunk goes non-finite and the driver must roll back.
    Q, t, stats = driver.run(Q0, n_steps=1, dt=1e-3)
    bad = np.asarray(Q).copy()
    bad[0, 0, 2, 2, 0] = np.inf

    class PoisonOnce:
        """Wrap the chunk fn: first call returns the poisoned state."""

        def __init__(self, inner):
            self.inner = inner
            self.fired = False

        def __call__(self, Q, dt):
            Qn, t_inc = self.inner(Q, dt)
            if not self.fired:
                self.fired = True
                return jnp.asarray(bad), t_inc
            return Qn, t_inc

    driver._chunk_fns[1] = PoisonOnce(driver._chunk_fn(1))
    with caplog.at_level(logging.WARNING, logger="exahype_jax.driver"):
        Q2, t2, stats2 = driver.run(np.asarray(Q), n_steps=3, dt=1e-3)
    assert stats2["recoveries"] == 1
    assert np.isfinite(np.asarray(Q2)).all()
    assert any("rolled back" in r.message for r in caplog.records)


def test_output_writers(tmp_path):
    from exahype_jax.utils.output import assemble_global, write_npz, write_vtk

    cfg = KernelConfig(dim=2, patch_size=3, halo_size=1, n_real=2, n_aux=0, n_patches=4)
    grid = PatchGrid(config=cfg, grid_shape=(2, 2))
    rng = np.random.default_rng(0)
    Q = rng.normal(size=grid.state_shape)

    glob = assemble_global(grid, Q)
    assert glob.shape == (6, 6, 2)
    # Spot-check patch (1,0) interior cell (0,0) lands at global (3, 0).
    np.testing.assert_array_equal(glob[3, 0], Q[1, 0, 1, 1])

    npz = write_npz(tmp_path / "out.npz", grid, Q, var_names=["rho", "E"])
    loaded = np.load(npz)
    np.testing.assert_array_equal(loaded["rho"], glob[..., 0])

    vtk = write_vtk(tmp_path / "out.vtk", grid, Q, var_names=["rho", "E"], dx=0.1)
    text = vtk.read_text()
    assert "DATASET STRUCTURED_POINTS" in text
    assert "DIMENSIONS 6 6 1" in text
    assert "SCALARS rho double 1" in text
    # First VTK value is global (0,0) of rho (x-fastest ordering).
    first = float(text.split("LOOKUP_TABLE default\n")[1].split("\n")[0])
    assert first == glob[0, 0, 0]


def test_aderdg_output_writers(tmp_path):
    """Cell means are exact quadrature integrals; the polynomial resample
    reproduces a polynomial of the scheme's degree exactly; the VTK file
    round-trips values in x-fastest order."""
    import jax.numpy as jnp

    from exahype_jax.models.aderdg import ADERDGSolver, wrap_var_last
    from exahype_jax.utils.output import (
        aderdg_cell_means,
        aderdg_resample,
        write_vtk_aderdg,
    )

    order, cells = 2, 3
    solver = ADERDGSolver(
        dim=2, order=order, n_vars=2, grid_shape=(cells, cells),
        flux_fn=lambda Q, d, va: jnp.zeros_like(Q),
        max_eigenvalue_fn=lambda Q, d, va: jnp.zeros(
            Q.shape[:va] + Q.shape[va + 1:], Q.dtype
        ),
        dx=1.0 / cells,
    )
    coords = solver.nodes_meshgrid()
    no_var = solver.state_shape[:2] + solver.state_shape[3:]
    X = np.broadcast_to(np.squeeze(coords[0], solver.var_axis), no_var)
    Y = np.broadcast_to(np.squeeze(coords[1], solver.var_axis), no_var)
    # degree-2 polynomial: exactly representable AND exactly integrable
    f0 = X * X + 2.0 * Y
    f1 = X * Y
    u = jnp.asarray(np.stack([f0, f1], axis=solver.var_axis))

    means = aderdg_cell_means(solver, u)
    assert means.shape == (cells, cells, 2)
    # exact integral of x²+2y over cell (i,j) / cell volume
    dx = 1.0 / cells
    i, j = 1, 2
    lo_x, lo_y = i * dx, j * dx
    exact = ((lo_x + dx) ** 3 - lo_x**3) / (3 * dx) + 2 * (lo_y + dx / 2)
    np.testing.assert_allclose(means[i, j, 0], exact, rtol=1e-13)

    s = 4
    res = aderdg_resample(solver, u, s)
    assert res.shape == (cells * s, cells * s, 2)
    xs = (np.arange(cells * s) + 0.5) / (cells * s)
    Xs, Ys = np.meshgrid(xs, xs, indexing="ij")
    np.testing.assert_allclose(res[..., 0], Xs**2 + 2 * Ys, atol=1e-13)
    np.testing.assert_allclose(res[..., 1], Xs * Ys, atol=1e-13)

    vtk = write_vtk_aderdg(tmp_path / "dg.vtk", solver, u,
                           var_names=["a", "b"], points_per_cell=s)
    text = vtk.read_text()
    assert f"DIMENSIONS {cells * s} {cells * s} 1" in text
    first = float(text.split("LOOKUP_TABLE default\n")[1].split("\n")[0])
    np.testing.assert_allclose(first, res[0, 0, 0])
    # means variant too
    vtk1 = write_vtk_aderdg(tmp_path / "dg1.vtk", solver, u)
    assert f"DIMENSIONS {cells} {cells} 1" in vtk1.read_text()


def test_driver_with_sharding(tmp_path):
    """TimeLoopDriver compiled with explicit shardings over the CPU mesh."""
    from exahype_jax.parallel import make_mesh, shard_state, state_sharding

    solver = make_solver(gx=8, gy=2)
    mesh = make_mesh(8)
    sharding = state_sharding(mesh, solver.grid)
    driver = TimeLoopDriver(
        solver, DriverConfig(chunk_steps=2, log_metrics=False), sharding=sharding
    )
    Q0 = shard_state(jnp.asarray(euler_state(solver.grid, seed=4)), mesh, solver.grid)
    Q, t, stats = driver.run(Q0, n_steps=4, dt=1e-3)
    assert stats["steps"] == 4
    assert np.isfinite(np.asarray(Q)).all()


def test_driver_global_observables(caplog):
    """The ExaHyPE2 global-observables hook: per-chunk on-device reductions
    logged on the metrics line and returned as a history in the stats."""
    obs = {
        "total_rho": lambda Q: jnp.sum(Q[..., 0]),
        "max_rho": lambda Q: jnp.max(Q[..., 0]),
    }
    solver = make_solver()
    driver = TimeLoopDriver(
        solver, DriverConfig(chunk_steps=2, observables=obs)
    )
    Q0 = euler_state(solver.grid)
    with caplog.at_level(logging.INFO, logger="exahype_jax.driver"):
        Q, t, stats = driver.run(Q0, n_steps=5, dt=1e-3)
    hist = stats["observables"]
    assert [h["step"] for h in hist] == [2, 4, 5]  # one entry per chunk
    # The last entry is the reduction of the returned state, exactly.
    np.testing.assert_allclose(
        hist[-1]["total_rho"], float(np.sum(np.asarray(Q)[..., 0])), rtol=1e-15
    )
    np.testing.assert_allclose(
        hist[-1]["max_rho"], float(np.max(np.asarray(Q)[..., 0])), rtol=1e-15
    )
    assert any('"observables"' in r.message for r in caplog.records)


def test_driver_global_observables_sharded_match():
    """Observables jitted under the mesh sharding equal the unsharded run's
    (the reduction lowers to a collective, not a host gather)."""
    from exahype_jax.parallel import make_mesh, shard_state, state_sharding

    obs = {"total_rho": lambda Q: jnp.sum(Q[..., 0])}
    solver = make_solver(gx=8, gy=2)
    Q0 = jnp.asarray(euler_state(solver.grid, seed=4))

    plain = TimeLoopDriver(
        solver, DriverConfig(chunk_steps=2, log_metrics=False, observables=obs)
    )
    _, _, stats_plain = plain.run(Q0, n_steps=4, dt=1e-3)

    mesh = make_mesh(8)
    sharding = state_sharding(mesh, solver.grid)
    sharded = TimeLoopDriver(
        solver,
        DriverConfig(chunk_steps=2, log_metrics=False, observables=obs),
        sharding=sharding,
    )
    Qs = shard_state(Q0, mesh, solver.grid)
    _, _, stats_sharded = sharded.run(Qs, n_steps=4, dt=1e-3)
    for a, b in zip(stats_plain["observables"], stats_sharded["observables"]):
        np.testing.assert_allclose(a["total_rho"], b["total_rho"], rtol=1e-12)


def test_limited_driver_conservation_observables():
    """Round 4 (VERDICT item 7): the gathered limiter's conservation /
    overflow trade is MEASURED in the production driver metrics —
    ``LimitedADERDG.driver_observables`` records the conserved integrals
    and the capacity demand/overflow per chunk, so a run's drift
    decomposes into policy-engaged vs clean chunks."""
    import jax

    from exahype_jax.models.aderdg import ADERDGSolver, euler_physics
    from exahype_jax.models.limiter import LimitedADERDG, euler_admissible

    flux, eig = euler_physics(dim=2, n_real=4)
    solver = ADERDGSolver(
        dim=2, order=2, n_vars=4, grid_shape=(8, 8), flux_fn=flux,
        max_eigenvalue_fn=eig, dx=1.0 / 8,
    )
    coords = solver.nodes_meshgrid()
    no_var = (
        solver.state_shape[: solver.var_axis]
        + solver.state_shape[solver.var_axis + 1 :]
    )
    x = np.broadcast_to(np.squeeze(coords[0], solver.var_axis), no_var)
    rho = np.where(x < 0.5, 1.0, 0.125)
    p = np.where(x < 0.5, 1.0, 0.1)
    Q0 = jnp.asarray(np.stack(
        [rho, np.zeros_like(rho), np.zeros_like(rho), p / 0.4],
        axis=solver.var_axis,
    ))
    dt = 1e-3
    limited = LimitedADERDG(
        solver, admissible=euler_admissible(dim=2),
        troubled_capacity=16, troubled_granularity="row",
    )
    driver = TimeLoopDriver(
        limited,
        DriverConfig(
            chunk_steps=2, log_metrics=False,
            observables=limited.driver_observables(dt, conserved_vars=(0, 3)),
        ),
    )
    Q, t, stats = driver.run(Q0, n_steps=4, dt=dt)
    hist = stats["observables"]
    assert len(hist) == 2
    for h in hist:
        assert {"total_q0", "total_q3", "capacity_demand",
                "capacity_overflow"} <= set(h)
    # The shock engages the limiter but fits the capacity: demand > 0,
    # overflow == 0, and mass conserves to rounding across the run.
    assert hist[-1]["capacity_demand"] > 0
    assert hist[-1]["capacity_overflow"] == 0
    m0 = float(np.asarray(solver.total_mass(Q0))[0])
    np.testing.assert_allclose(hist[-1]["total_q0"], m0, rtol=1e-12)

    # A deliberately undersized capacity makes the overflow measurable.
    tiny = LimitedADERDG(
        solver, admissible=euler_admissible(dim=2),
        troubled_capacity=2, troubled_granularity="row",
    )
    d, cap = jax.jit(lambda q: tiny.capacity_usage(q, dt))(Q0)
    obs = tiny.driver_observables(dt)
    assert float(obs["capacity_overflow"](Q0)) == float(
        np.maximum(np.asarray(d) - 2, 0)
    ) > 0


def test_code_printer_here_and_file(tmp_path, capsys):
    from exahype_jax.backends.cpp_backend import CPPPrinter

    kb = build_rusanov_kernel()
    printer = CPPPrinter(kb)
    printer.here()
    assert "time_step" in capsys.readouterr().out
    printer.file(str(tmp_path / "k.cpp"))
    assert (tmp_path / "k.cpp").read_text() == printer.code


def test_system_integration_flow(tmp_path):
    """End-to-end production flow: grid solver -> driver with checkpoints
    -> resume -> VTK/NPZ output of the final state."""
    from exahype_jax.utils.output import write_npz, write_vtk

    cfg = KernelConfig(
        dim=2, patch_size=4, halo_size=1, n_real=5, n_aux=5, n_patches=4
    )
    grid = PatchGrid(config=cfg, grid_shape=(2, 2))
    kb = build_rusanov_kernel(
        dim=2, patch_size=4, halo_size=1, n_real=5, n_aux=5, n_patches=4
    )
    solver = GridSolver(grid, kb, dx=0.1)
    driver = TimeLoopDriver(
        solver,
        DriverConfig(
            chunk_steps=2,
            checkpoint_every=1,
            checkpoint_dir=str(tmp_path / "ck"),
            log_metrics=False,
        ),
    )
    rng = np.random.default_rng(0)
    aos = rng.uniform(0.1, 1.0, size=(4, 6, 6, 10))
    aos[..., 0] += 1.0
    aos[..., 3] += 5.0
    aos[..., 4] += 5.0
    Q0 = grid.from_batched(jnp.asarray(aos))

    Q, t, _ = driver.run(Q0, n_steps=4, dt=1e-3)

    # Resume continues from the checkpoint, not from scratch.
    driver2 = TimeLoopDriver(
        solver,
        DriverConfig(
            chunk_steps=2, checkpoint_every=1, checkpoint_dir=str(tmp_path / "ck"),
            log_metrics=False,
        ),
    )
    Q2, t2, stats2 = driver2.run(Q0, n_steps=6, dt=1e-3)
    assert stats2["steps"] == 2  # resumed at step 4

    vtk = write_vtk(tmp_path / "final.vtk", grid, Q2, dx=0.1)
    npz = write_npz(tmp_path / "final.npz", grid, Q2)
    assert vtk.exists() and npz.exists()
    assert "STRUCTURED_POINTS" in vtk.read_text()[:200]


def test_driver_drives_aderdg_solver():
    """TimeLoopDriver works with the ADER-DG solver's run() convention,
    including checkpoint + resume."""
    import jax.numpy as jnp

    from exahype_jax.models.aderdg import ADERDGSolver

    def flux(Q, axis, va):
        return (1.0 if axis == 0 else 0.5) * Q

    def eig(Q, axis, va):
        shape = Q.shape[:va] + Q.shape[va + 1 :]
        return jnp.full(shape, 1.0, Q.dtype)

    solver = ADERDGSolver(
        dim=2, order=2, n_vars=1, grid_shape=(4, 4), flux_fn=flux,
        max_eigenvalue_fn=eig, dx=0.25,
    )
    rng = np.random.default_rng(0)
    Q0 = jnp.asarray(rng.random(solver.state_shape))
    ref = np.asarray(solver.run(Q0, 12, 1e-3))

    driver = TimeLoopDriver(
        solver, DriverConfig(chunk_steps=4, log_metrics=False)
    )
    Q, t, stats = driver.run(Q0, 12, 1e-3)
    np.testing.assert_allclose(np.asarray(Q), ref, rtol=0, atol=1e-14)
    assert abs(t - 0.012) < 1e-12 and stats["steps"] == 12

    with tempfile.TemporaryDirectory() as d:
        cfg = DriverConfig(
            chunk_steps=4, checkpoint_every=1, checkpoint_dir=d,
            log_metrics=False,
        )
        TimeLoopDriver(solver, cfg).run(Q0, 8, 1e-3)
        # resume picks up at step 8 and finishes the remaining 4
        Q2, t2, stats2 = TimeLoopDriver(solver, cfg).run(Q0, 12, 1e-3)
        np.testing.assert_allclose(np.asarray(Q2), ref, rtol=0, atol=1e-13)
        assert stats2["steps"] == 4


def test_driver_drives_fused_aderdg():
    """TimeLoopDriver also accepts the fused-kernel ADER-DG solver."""
    import jax.numpy as jnp

    from exahype_jax.models.aderdg import ADERDGSolver
    from exahype_jax.models.aderdg_triton import TritonADERDG

    def flux(Q, axis, va):
        return 0.5 * Q

    def eig(Q, axis, va):
        shape = Q.shape[:va] + Q.shape[va + 1 :]
        return jnp.full(shape, 0.5, Q.dtype)

    solver = ADERDGSolver(
        dim=2, order=2, n_vars=1, grid_shape=(4, 128), flux_fn=flux,
        max_eigenvalue_fn=eig, dx=0.25,
    )
    fused = TritonADERDG(solver, interpret=True)
    rng = np.random.default_rng(0)
    Q0 = jnp.asarray(rng.random(solver.state_shape))
    ref = np.asarray(fused.run(Q0, 6, 1e-3))
    driver = TimeLoopDriver(fused, DriverConfig(chunk_steps=3, log_metrics=False))
    Q, t, stats = driver.run(Q0, 6, 1e-3)
    np.testing.assert_allclose(np.asarray(Q), ref, rtol=0, atol=1e-14)
    assert stats["steps"] == 6


def test_checkpoint_roundtrip_sharded_state():
    """Checkpointing a GSPMD-sharded state and restoring preserves values
    (restore is host-side; re-placement is the caller's job)."""
    import tempfile as _tf

    from exahype_jax.parallel import make_mesh
    from jax.sharding import NamedSharding, PartitionSpec

    mesh = make_mesh(8)
    sharding = NamedSharding(mesh, PartitionSpec("patches"))
    rng = np.random.default_rng(0)
    Q = jax.device_put(jnp.asarray(rng.random((16, 4, 4, 5))), sharding)

    with _tf.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(3, {"step": 3, "t": 0.3, "dt": 1e-3, "Q": Q})
        state = mgr.restore()
        assert int(state["step"]) == 3
        np.testing.assert_array_equal(np.asarray(state["Q"]), np.asarray(Q))
        # re-place on the mesh and keep computing
        Q2 = jax.device_put(jnp.asarray(state["Q"]), sharding)
        np.testing.assert_array_equal(np.asarray(Q2 * 2.0), np.asarray(Q) * 2.0)


def test_resume_uses_checkpointed_dt(tmp_path):
    """A recovery-reduced dt must survive a process restart: resume_or_init
    prefers the checkpointed dt over the caller's (round-1 advisory)."""
    solver = make_solver()
    driver = TimeLoopDriver(
        solver,
        DriverConfig(
            chunk_steps=2, checkpoint_every=1, checkpoint_dir=str(tmp_path / "ck"),
            log_metrics=False,
        ),
    )
    Q = jnp.zeros(solver.grid.state_shape)
    driver.ckpt.save(4, {"step": 4, "t": 0.1, "dt": 5e-4, "Q": Q})
    _, _, step, dt = driver.resume_or_init(Q, 1e-3)
    assert step == 4
    assert dt == pytest.approx(5e-4)


def test_aderdg_cost_model():
    from exahype_jax.models.aderdg import ADERDGSolver, euler_physics
    from exahype_jax.utils.roofline import aderdg_step_cost

    flux, eig = euler_physics(dim=3, n_real=5)
    s1 = ADERDGSolver(dim=3, order=3, n_vars=5, grid_shape=(8, 8, 8),
                      flux_fn=flux, max_eigenvalue_fn=eig, dx=0.125)
    s2 = ADERDGSolver(dim=3, order=3, n_vars=5, grid_shape=(16, 8, 8),
                      flux_fn=flux, max_eigenvalue_fn=eig, dx=0.125)
    c1, c2 = aderdg_step_cost(s1), aderdg_step_cost(s2)
    assert c2.flops == 2 * c1.flops  # linear in cells
    assert c2.bytes_total == 2 * c1.bytes_total
    # Compute-bound on an H100: AI above the f32 ridge point
    # 67e12 / 3.35e12 = 20 flops/byte.
    assert c1.arithmetic_intensity > 20
    assert c1.roofline_seconds(67e12, 3.35e12) > 0
    # ~0.3 MFLOP per cell for p3 Euler (sanity window).
    per_cell = c1.flops / 512
    assert 0.15e6 < per_cell < 0.6e6, per_cell


def test_adaptive_driver_checkpoint_resume(tmp_path, caplog):
    """AdaptiveTimeLoopDriver: an interrupted adaptive tree-AMR run resumes
    from the checkpointed composite state (coarse + fine + mask) and ends
    bitwise-identical to the uninterrupted run; metrics emitted."""
    import logging

    import jax.numpy as jnp

    from exahype_jax.models import hyperbolic
    from exahype_jax.models.fv import build_fv_rusanov_kernel
    from exahype_jax.parallel import GridSolver, PatchGrid
    from exahype_jax.parallel.driver import AdaptiveTimeLoopDriver, DriverConfig
    from exahype_jax.parallel.pool import DynamicPoolRefinement
    from exahype_jax.utils.config import KernelConfig
    from exahype_jax.utils.output import disassemble_global

    gx = gy = 6
    cfg = KernelConfig(
        dim=2, patch_size=4, halo_size=1, n_real=1, n_aux=0, n_patches=gx * gy
    )
    grid = PatchGrid(config=cfg, grid_shape=(gx, gy))
    flux, eig = hyperbolic.advection((1.0, 0.3))
    kb = build_fv_rusanov_kernel(
        dim=2, patch_size=4, halo_size=1, n_real=1, n_aux=0,
        n_patches=gx * gy, flux_impl=flux, eigenvalue_impl=eig,
    )
    solver = GridSolver(grid, kb, dx=1.0 / (gx * 4), kernel_dt="lambda")

    n = gx * 4
    x = (np.arange(n) + 0.5) / n
    X, Y = np.meshgrid(x, x, indexing="ij")
    u0 = np.exp(-(((X - 0.25) ** 2 + (Y - 0.4) ** 2) / 0.08**2))
    Q0 = disassemble_global(
        grid, jnp.zeros(grid.state_shape), jnp.asarray(u0[..., None])
    )

    def make_driver(ckpt_dir):
        dyn = DynamicPoolRefinement(solver, capacity=6, factor=2)
        return AdaptiveTimeLoopDriver(
            dyn,
            DriverConfig(
                checkpoint_every=1, checkpoint_dir=str(ckpt_dir),
                log_metrics=True,
            ),
        )

    # Uninterrupted reference (no checkpointing needed for the reference).
    ref_driver = make_driver(tmp_path / "ref")
    with caplog.at_level(logging.INFO, logger="exahype_jax.driver"):
        c_ref, f_ref, info_ref = ref_driver.run(
            Q0, n_chunks=6, chunk_steps=5, dt=2e-3
        )
    assert any("n_refined" in r.message for r in caplog.records)
    assert len({tuple(map(tuple, m)) for m in info_ref["masks"]}) > 1

    # Interrupted run: 3 chunks, then a NEW driver resumes to 6.
    part = make_driver(tmp_path / "ck")
    part.run(Q0, n_chunks=3, chunk_steps=5, dt=2e-3)
    resumed = make_driver(tmp_path / "ck")
    c2, f2, info2 = resumed.run(Q0, n_chunks=6, chunk_steps=5, dt=2e-3)
    np.testing.assert_array_equal(np.asarray(c2), np.asarray(c_ref))
    np.testing.assert_array_equal(np.asarray(f2), np.asarray(f_ref))


def test_adaptive_driver_global_observables(caplog):
    """Composite-state observables on the adaptive tree-AMR driver:
    ``fn(coarse, fine, tables)`` evaluated per chunk without retracing."""
    import logging

    import jax.numpy as jnp

    from exahype_jax.models import hyperbolic
    from exahype_jax.models.fv import build_fv_rusanov_kernel
    from exahype_jax.parallel import GridSolver, PatchGrid
    from exahype_jax.parallel.driver import AdaptiveTimeLoopDriver, DriverConfig
    from exahype_jax.parallel.pool import DynamicPoolRefinement
    from exahype_jax.utils.config import KernelConfig
    from exahype_jax.utils.output import disassemble_global

    gx = gy = 6
    cfg = KernelConfig(
        dim=2, patch_size=4, halo_size=1, n_real=1, n_aux=0, n_patches=gx * gy
    )
    grid = PatchGrid(config=cfg, grid_shape=(gx, gy))
    flux, eig = hyperbolic.advection((1.0, 0.3))
    kb = build_fv_rusanov_kernel(
        dim=2, patch_size=4, halo_size=1, n_real=1, n_aux=0,
        n_patches=gx * gy, flux_impl=flux, eigenvalue_impl=eig,
    )
    solver = GridSolver(grid, kb, dx=1.0 / (gx * 4), kernel_dt="lambda")

    n = gx * 4
    x = (np.arange(n) + 0.5) / n
    X, Y = np.meshgrid(x, x, indexing="ij")
    u0 = np.exp(-(((X - 0.25) ** 2 + (Y - 0.4) ** 2) / 0.08**2))
    Q0 = disassemble_global(
        grid, jnp.zeros(grid.state_shape), jnp.asarray(u0[..., None])
    )

    dyn = DynamicPoolRefinement(solver, capacity=6, factor=2)
    driver = AdaptiveTimeLoopDriver(
        dyn,
        DriverConfig(
            observables={"max_u": lambda c, f, tb: jnp.max(c)},
        ),
    )
    with caplog.at_level(logging.INFO, logger="exahype_jax.driver"):
        coarse, fine, info = driver.run(Q0, n_chunks=4, chunk_steps=5, dt=2e-3)
    hist = info["observables"]
    assert [h["chunk"] for h in hist] == [1, 2, 3, 4]
    np.testing.assert_allclose(
        hist[-1]["max_u"], float(jnp.max(coarse)), rtol=1e-15
    )
    assert any('"observables"' in r.message for r in caplog.records)


def test_adaptive_driver_overlap_regrid_matches_when_stationary():
    """DriverConfig(overlap_regrid=True): table construction runs under
    the device chunk with a one-chunk pattern lag — bitwise equal to the
    sequential driver when the criterion pattern is stationary."""
    import jax.numpy as jnp

    from exahype_jax.models import hyperbolic
    from exahype_jax.models.fv import build_fv_rusanov_kernel
    from exahype_jax.parallel import GridSolver, PatchGrid
    from exahype_jax.parallel.driver import AdaptiveTimeLoopDriver, DriverConfig
    from exahype_jax.parallel.pool import DynamicPoolRefinement
    from exahype_jax.utils.config import KernelConfig
    from exahype_jax.utils.output import disassemble_global

    gx = gy = 6
    cfg = KernelConfig(
        dim=2, patch_size=4, halo_size=1, n_real=1, n_aux=0, n_patches=gx * gy
    )
    grid = PatchGrid(config=cfg, grid_shape=(gx, gy))
    flux, eig = hyperbolic.advection((0.0, 0.0))  # stationary pattern
    kb = build_fv_rusanov_kernel(
        dim=2, patch_size=4, halo_size=1, n_real=1, n_aux=0,
        n_patches=gx * gy, flux_impl=flux, eigenvalue_impl=eig,
    )
    solver = GridSolver(grid, kb, dx=1.0 / (gx * 4), kernel_dt="lambda")
    n = gx * 4
    x = (np.arange(n) + 0.5) / n
    X, Y = np.meshgrid(x, x, indexing="ij")
    u0 = np.exp(-(((X - 0.5) ** 2 + (Y - 0.5) ** 2) / 0.08**2))
    Q0 = disassemble_global(
        grid, jnp.zeros(grid.state_shape), jnp.asarray(u0[..., None])
    )

    def make(overlap):
        dyn = DynamicPoolRefinement(solver, capacity=6, factor=2)
        drv = AdaptiveTimeLoopDriver(
            dyn,
            DriverConfig(log_metrics=False, overlap_regrid=overlap),
        )
        return drv.run(Q0, n_chunks=4, chunk_steps=5, dt=2e-3)

    c1, f1, i1 = make(False)
    c2, f2, i2 = make(True)
    np.testing.assert_array_equal(np.asarray(c2), np.asarray(c1))
    np.testing.assert_array_equal(np.asarray(f2), np.asarray(f1))
    for a, b in zip(i1["masks"], i2["masks"]):
        np.testing.assert_array_equal(a, b)


def test_export_step_new_families_roundtrip():
    """The serving path covers the round-3 families: a viscous
    Navier–Stokes step and a curved-GRMHD step export to StableHLO and
    reproduce the live step."""
    import jax.numpy as jnp
    import numpy as np

    from exahype_jax.models import euler, grmhd_cfc
    from exahype_jax.models import navier_stokes as ns
    from exahype_jax.models.aderdg import ADERDGSolver, wrap_var_last
    from exahype_jax.utils.serialize import export_step, load_step

    f, e, vf, ve = ns.navier_stokes(dim=2, mu=0.02)
    solver = ADERDGSolver(
        dim=2, order=2, n_vars=4, grid_shape=(4, 4),
        flux_fn=wrap_var_last(f), max_eigenvalue_fn=wrap_var_last(e),
        visc_flux_fn=ns.wrap_visc_var_last(vf),
        visc_eigenvalue_fn=wrap_var_last(ve), dx=0.25,
    )
    rng = np.random.default_rng(0)
    no_var = solver.state_shape[:2] + solver.state_shape[3:]
    rho = 1.0 + 0.2 * rng.random(no_var)
    m = 0.2 * rng.standard_normal(no_var + (2,))
    p = 1.0 + 0.2 * rng.random(no_var)
    E = p / (euler.GAMMA - 1) + 0.5 * (m**2).sum(-1) / rho
    Q = jnp.asarray(np.moveaxis(
        np.concatenate([rho[..., None], m, E[..., None]], -1), -1,
        solver.var_axis,
    ))
    dt = jnp.asarray(1e-3, jnp.float64)
    blob = export_step(solver.step, solver.state_shape, dtype=jnp.float64)
    np.testing.assert_allclose(
        np.asarray(load_step(blob)(Q, dt)), np.asarray(solver.step(Q, dt)),
        rtol=0, atol=1e-13,
    )

    flux, eig = grmhd_cfc.grmhd_cfc(dim=2, iters=6)
    gsolver = ADERDGSolver(
        dim=2, order=2, n_vars=grmhd_cfc.n_vars(2), grid_shape=(4, 4),
        flux_fn=wrap_var_last(flux), max_eigenvalue_fn=wrap_var_last(eig),
        dx=0.25, source_fn=grmhd_cfc.grmhd_cfc_source(2, iters=6),
        dissipation_mask=grmhd_cfc.grmhd_cfc_dissipation_mask(2),
    )
    no_var = gsolver.state_shape[:2] + gsolver.state_shape[3:]
    rho = 1.0 + 0.1 * rng.random(no_var)
    pg = 0.5 + 0.1 * rng.random(no_var)
    v = 0.1 * rng.standard_normal(no_var + (3,))
    B = 0.2 * rng.standard_normal(no_var + (3,))
    alpha = 0.9 + 0.05 * rng.random(no_var)
    psi = 1.0 + 0.05 * rng.random(no_var)
    z2 = np.zeros(no_var + (2,))
    Qg = jnp.asarray(np.moveaxis(np.asarray(grmhd_cfc.pack_state(
        jnp.asarray(rho), jnp.asarray(v), jnp.asarray(pg), jnp.asarray(B),
        jnp.asarray(alpha), jnp.asarray(psi), z2, z2,
    )), -1, gsolver.var_axis))
    blob = export_step(gsolver.step, gsolver.state_shape, dtype=jnp.float64)
    np.testing.assert_allclose(
        np.asarray(load_step(blob)(Qg, dt)), np.asarray(gsolver.step(Qg, dt)),
        rtol=0, atol=1e-12,
    )


def test_export_step_roundtrip(tmp_path):
    """AOT serving artifact: the ADER-DG step exports to StableHLO bytes,
    reloads in a context with no solver object, and reproduces the live
    step bitwise; the FV grid solver step round-trips through a file."""
    import jax.numpy as jnp
    import numpy as np

    from exahype_jax.models.aderdg import ADERDGSolver, wrap_var_last
    from exahype_jax.models import hyperbolic
    from exahype_jax.utils.serialize import export_step, load_step, save_step

    flux, eig = hyperbolic.advection((1.0, 0.4))
    solver = ADERDGSolver(
        dim=2, order=2, n_vars=1, grid_shape=(4, 4),
        flux_fn=wrap_var_last(flux), max_eigenvalue_fn=wrap_var_last(eig),
        dx=0.25,
    )
    blob = export_step(solver.step, solver.state_shape, dtype=jnp.float64)
    assert len(bytes(blob)) > 1000

    rng = np.random.default_rng(0)
    Q = jnp.asarray(rng.normal(size=solver.state_shape))
    dt = jnp.asarray(1e-3, jnp.float64)
    live = np.asarray(solver.step(Q, dt))
    served = np.asarray(load_step(blob)(Q, dt))
    # The deserialized StableHLO may fuse differently than the live jit:
    # allow ulp-level drift.
    np.testing.assert_allclose(served, live, rtol=0, atol=1e-13)

    # File round trip on the FV grid solver.
    from exahype_jax.models.fv import build_fv_rusanov_kernel
    from exahype_jax.parallel import GridSolver, PatchGrid
    from exahype_jax.utils.config import KernelConfig

    cfg = KernelConfig(
        dim=2, patch_size=4, halo_size=1, n_real=1, n_aux=0, n_patches=4
    )
    grid = PatchGrid(config=cfg, grid_shape=(2, 2))
    kb = build_fv_rusanov_kernel(
        dim=2, patch_size=4, halo_size=1, n_real=1, n_aux=0, n_patches=4,
        flux_impl=flux, eigenvalue_impl=eig,
    )
    gsolver = GridSolver(grid, kb, dx=0.125, kernel_dt="lambda")
    path = tmp_path / "fv_step.shlo"
    n = save_step(path, gsolver.step, grid.state_shape, dtype=jnp.float64)
    assert path.stat().st_size == n
    Qg = jnp.asarray(rng.normal(size=grid.state_shape))
    np.testing.assert_allclose(
        np.asarray(load_step(path)(Qg, dt)),
        np.asarray(gsolver.step(Qg, dt)),
        rtol=0, atol=1e-13,
    )


def test_export_limited_production_step(tmp_path):
    """The PRODUCTION configuration serves too: the row-gathered limited
    step (detection + compaction + gathered FV + matching) exports to a
    StableHLO artifact and the deserialized program matches the live jit."""
    import jax.numpy as jnp

    from exahype_jax.models.aderdg import ADERDGSolver, euler_physics
    from exahype_jax.models.limiter import LimitedADERDG, euler_admissible
    from exahype_jax.utils.serialize import export_step, load_step, save_step

    flux, eig = euler_physics(dim=2, n_real=4)
    solver = ADERDGSolver(
        dim=2, order=2, n_vars=4, grid_shape=(8, 8),
        flux_fn=flux, max_eigenvalue_fn=eig, dx=1.0 / 8,
    )
    lim = LimitedADERDG(
        solver, admissible=euler_admissible(dim=2), troubled_capacity=8,
        troubled_granularity="row",
    )
    path = tmp_path / "limited.shlo"
    n = save_step(path, lim.step, solver.state_shape, dtype=jnp.float64)
    assert n > 0
    rng = np.random.default_rng(0)
    no_var = (
        solver.state_shape[: solver.var_axis]
        + solver.state_shape[solver.var_axis + 1 :]
    )
    rho = 1.0 + 0.2 * rng.random(no_var)
    Q = jnp.asarray(
        np.stack(
            [rho, 0.3 * rho, 0.1 * rho, 5.0 + 0.5 * rho],
            axis=solver.var_axis,
        )
    )
    restored = load_step(path)
    got = np.asarray(restored(Q, jnp.float64(2e-3)))
    want = np.asarray(jax.jit(lim.step)(Q, jnp.float64(2e-3)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_write_seismograms(tmp_path):
    import numpy as np

    from exahype_jax.utils.output import write_seismograms

    T, R, V = 7, 3, 2
    vals = np.arange(T * R * V, dtype=float).reshape(T, R, V)
    p = write_seismograms(
        tmp_path / "seis.npz",
        times=np.linspace(0, 1, T),
        positions=np.zeros((R, 2)),
        values=vals,
        var_names=["vx", "vy"],
        dt=0.1,
    )
    with np.load(p) as f:
        np.testing.assert_array_equal(f["vx"], vals[..., 0])
        assert f["times"].shape == (T,) and f["positions"].shape == (R, 2)
        assert float(f["dt"]) == 0.1
    import pytest

    with pytest.raises(ValueError):
        write_seismograms(
            tmp_path / "bad.npz", [0], np.zeros((R, 2)), vals, ["only-one"]
        )
