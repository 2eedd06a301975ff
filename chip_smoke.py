"""Smoke test of the ADER-DG main path on the GPU, in one JAX process.

    python chip_smoke.py          # one card: phases 1-7
    python chip_smoke.py --four   # four cards: the sharded step only

Phases (any failure exits non-zero; the last line is a JSON object only
when every phase passed):

1. device: the default JAX backend must be a GPU;
2. euler: ``ADERDGSolver`` p3 3-D Euler at 64³ cells stepped through the
   fused cell stage (``TritonADERDG``), compile time, ``memory_analysis()``,
   step time, finiteness and mass drift;
3. limited: ``LimitedADERDG`` (row-gathered subcell fallback, candidate
   from the fused cell stage) on the same grid with a planar Sod shock,
   troubled-row demand against capacity, finiteness and admissibility;
3b. candidates: the same 35 limited steps from the fused and the XLA
   candidate in f32 and from the XLA one in float64, every step's demand
   within capacity, mass drift, and each f32 run against the float64 one;
4. ck: heterogeneous elasticity on Cauchy–Kovalewski kernels at 32×16×16
   cells, frozen material slots, energy ratio;
5. reference: each of 2-4 at 16³ cells, f32 on the card through the path
   of 2-4 against the plain solver in float64 (on the CPU backend when JAX
   exposes it, else on the card);
6. kernels: the fused cell stage against ``ADERDGSolver.cell_stage`` at
   64³, both f32 on the card;
7. the tests marked ``gpu``, called in this process.

``--four`` runs only the sharded step (``make_sharded_xla_aderdg_step``
with the XLA and with the fused cell stage, and the GSPMD path) and the
limited step with the sharded fused candidate (``ShardedADERDG``) on a 1-D
mesh of four cards at 256×64×64 cells, each against the same state
stepped on card 0 alone.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent

#: Tolerances of phase 5 (f32 on the card vs float64): relative L∞ for the
#: unlimited and CK runs, relative L1 for the limited run (a limiter flag can
#: flip at a threshold and move one cell's update by O(1)).
TOL_EULER = 1e-5
TOL_CK = 1e-5
TOL_LIMITED_L1 = 1e-4
#: Relative mass drift of the limited cell over its 35 steps (phase 3b),
#: summed in float64 on the host: f32 rounding, and float64 rounding.
TOL_MASS_F32 = 1e-5
TOL_MASS_F64 = 1e-12
#: Tolerance of phase 6: the fused cell stage against the XLA cell stage,
#: both f32 (summation order differs; relative L∞ over every output).
TOL_KERNEL = 1e-5
REF_GRID = (16, 16, 16)
REF_STEPS = 5
#: The --four phase: grid axis 0 sharded over four cards, and its tolerance
#: (relative L∞ against one card; the fused cell stage differs from XLA's
#: in summation order).
FOUR_GRID = (256, 64, 64)
TOL_FOUR = 1e-5


def log(*args):
    print(*args, flush=True)


def _load_repo():
    """Import the package and the bench helpers from this checkout only."""
    sys.path.insert(0, str(HERE))
    import exahype_jax

    pkg = pathlib.Path(exahype_jax.__file__).resolve().parent
    if pkg.parent != HERE:
        raise SystemExit(f"exahype_jax imported from {pkg}, not from {HERE}")
    import bench

    return bench


def phase_device():
    import jax

    from exahype_jax.utils.gpu import card_info, require_gpu

    devices = require_gpu()
    d = devices[0]
    log(f"[device] platform={d.platform} kind={d.device_kind} "
        f"count={len(devices)}")
    log(f"[device] nvidia-smi name, power.limit: {card_info()}")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devices)}


def _memory(compiled):
    m = compiled.memory_analysis()
    if m is None:
        return "n/a"
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "alias_size_in_bytes",
              "generated_code_size_in_bytes")
    return ", ".join(f"{f}={getattr(m, f)}" for f in fields if hasattr(m, f))


def phase_euler(bench):
    import numpy as np

    from exahype_jax.models.aderdg_triton import TritonADERDG

    solver, Q = bench.euler_setup()
    check = bench.euler_integrity(solver)
    mass0 = float(check(Q)[1])
    dt = bench.stable_dt(solver, Q)
    fused = TritonADERDG(solver)
    Q, compile_s, step_s, compiled = bench.time_cell(fused.step, Q, dt)
    finite, mass1 = (np.asarray(v) for v in check(Q))
    log(f"[euler] grid={solver.grid_shape} dofs={solver.dofs()} dt={dt:.6g} "
        f"fused cell stage block_cells={fused.block_cells}")
    log(f"[euler] compile_s={compile_s:.3f} step_s={step_s:.6f} "
        f"dof_updates_per_s={solver.dofs() / step_s:.6g}")
    log(f"[euler] memory_analysis: {_memory(compiled)}")
    log(f"[euler] finite={bool(finite)} "
        f"mass_drift_rel={abs(float(mass1) - mass0) / abs(mass0):.3e}")
    if not bool(finite):
        raise AssertionError("euler: non-finite state")


def phase_limited(bench):
    import jax
    import jax.numpy as jnp
    import numpy as np

    limited, Q = bench.limited_setup()
    sol = limited.solver
    dt = bench.stable_dt(sol, Q)
    usage = jax.jit(limited.capacity_usage)
    demand0, capacity = (int(v) for v in usage(Q, jnp.asarray(dt, Q.dtype)))
    check = bench.limited_integrity(limited)
    mass0 = float(check(Q)[3])
    Q, compile_s, step_s, compiled = bench.time_cell(limited.step, Q, dt)
    demand1, _ = (int(v) for v in usage(Q, jnp.asarray(dt, Q.dtype)))
    finite, adm, rho_min, mass1 = (np.asarray(v) for v in check(Q))
    log(f"[limited] grid={sol.grid_shape} dt={dt:.6g} "
        f"rows_demand first={demand0} last={demand1} capacity={capacity}")
    log(f"[limited] compile_s={compile_s:.3f} step_s={step_s:.6f} "
        f"dof_updates_per_s={sol.dofs() / step_s:.6g}")
    log(f"[limited] memory_analysis: {_memory(compiled)}")
    log(f"[limited] finite={bool(finite)} admissible={bool(adm)} "
        f"rho_min={float(rho_min):.6g} "
        f"mass_drift_rel={abs(float(mass1) - mass0) / abs(mass0):.3e}")
    if not (bool(finite) and bool(adm)):
        raise AssertionError("limited: non-finite or inadmissible state")
    if max(demand0, demand1) > capacity:
        raise AssertionError("limited: troubled rows exceed the capacity")


def _host_mass(solver, q):
    """Quadrature integral of the density, summed on the host in float64."""
    import numpy as np

    rho = np.take(np.asarray(q, np.float64), 0, axis=solver.var_axis)
    w = np.asarray(solver.ops.weights, np.float64)
    for d in reversed(range(solver.dim)):
        rho = np.tensordot(w, rho, axes=(0, solver.node_axis(d)))
    return float(rho.sum())


def phase_candidates(bench):
    """The limited cell's 35 steps (one warm-up dispatch and the timed
    rounds of phase 3) from each candidate path: the fused cell stage and
    the XLA one in f32, and the XLA one in float64, all on the card.  Every
    step's troubled-row demand must stay within the capacity (else the
    overflow policy, which is not conservative, engages), each run must
    conserve mass, and each f32 run must agree with the float64 one."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    steps = (bench.ROUNDS + 1) * bench.CHUNK
    runs = {}
    for name, dtype, fused in (("xla_f64", np.float64, False),
                               ("fused_f32", np.float32, True),
                               ("xla_f32", np.float32, False)):
        with jax.enable_x64(dtype == np.float64):
            limited, Q = bench.limited_setup(dtype=dtype, fused=fused)
            sol = limited.solver
            dt = jnp.asarray(bench.stable_dt(sol, Q), dtype)
            step = jax.jit(lambda q, dt, lim=limited: (
                lim.step(q, dt), lim.capacity_usage(q, dt)[0]))
            mass0 = _host_mass(sol, Q)
            t0 = time.perf_counter()
            demand = []
            for _ in range(steps):
                Q, d = step(Q, dt)
                demand.append(int(d))
            finite, adm, _, _ = (bool(v) for v in
                                 bench.limited_integrity(limited)(Q))
            drift = abs(_host_mass(sol, Q) - mass0) / abs(mass0)
            runs[name] = np.asarray(Q, np.float64)
        capacity = limited.troubled_capacity
        tol_mass = TOL_MASS_F64 if dtype == np.float64 else TOL_MASS_F32
        ok = (finite and adm and max(demand) <= capacity
              and drift <= tol_mass)
        log(f"[candidates] {name}: rows_demand max={max(demand)} "
            f"capacity={capacity} per_step={demand}")
        log(f"[candidates] {name}: finite={finite} admissible={adm} "
            f"mass_drift_rel={drift:.3e} tol={tol_mass:g} "
            f"{time.perf_counter() - t0:.1f}s incl. compile "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"candidates: {name} run failed its checks")
    ref = runs["xla_f64"]
    for name in ("fused_f32", "xla_f32"):
        err = float(np.sum(np.abs(runs[name] - ref)) / np.sum(np.abs(ref)))
        ok = err <= TOL_LIMITED_L1
        log(f"[candidates] {name} vs xla_f64 after {steps} steps: "
            f"rel_l1={err:.3e} tol={TOL_LIMITED_L1:g} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"candidates: {name} differs from float64")


def phase_ck(bench):
    import numpy as np

    solver, Q, mats = bench.ck_setup()
    dt = bench.stable_dt(solver, Q)
    check = bench.ck_integrity(solver, mats)
    e0 = float(check(Q)[2])
    Q, compile_s, step_s, compiled = bench.time_cell(solver.step, Q, dt)
    finite, frozen, e1 = (np.asarray(v) for v in check(Q))
    dof = int(np.prod(solver.grid_shape)) * solver.n_nodes**3 * 9
    log(f"[ck] grid={solver.grid_shape} dt={dt:.6g}")
    log(f"[ck] compile_s={compile_s:.3f} step_s={step_s:.6f} "
        f"dof_updates_per_s={dof / step_s:.6g}")
    log(f"[ck] memory_analysis: {_memory(compiled)}")
    log(f"[ck] finite={bool(finite)} materials_frozen={bool(frozen)} "
        f"energy_ratio={float(e1) / e0:.9f}")
    if not (bool(finite) and bool(frozen)):
        raise AssertionError("ck: non-finite state or material slots moved")


def _reference_device():
    """The CPU device when this process exposes one, else the card."""
    import jax

    try:
        return jax.devices("cpu")[0]
    except RuntimeError:
        return jax.devices()[0]


def _run(step, Q, dt, device, dtype):
    import jax
    import jax.numpy as jnp

    q = jax.device_put(jnp.asarray(Q, dtype), device)
    dtv = jax.device_put(jnp.asarray(dt, dtype), device)
    run = jax.jit(lambda q, dt: jax.lax.fori_loop(
        0, REF_STEPS, lambda _, x: step(x, dt), q))
    out = run(q, dtv)
    if out.dtype != dtype:
        raise AssertionError(f"expected a {dtype} result, got {out.dtype}")
    return out


def phase_reference(bench):
    import jax
    import numpy as np

    ref_dev = _reference_device()
    gpu = jax.devices()[0]
    log(f"[reference] grid={REF_GRID} steps={REF_STEPS} "
        f"f32 on {gpu.device_kind} vs float64 on {ref_dev.platform}")
    from exahype_jax.models.aderdg_triton import TritonADERDG

    with jax.enable_x64(True):
        solver, Q = bench.euler_setup(REF_GRID, np.float64)
        cases = [("euler", TritonADERDG(solver).step, solver.step, Q,
                  bench.stable_dt(solver, Q), TOL_EULER, "linf", None)]
        limited, Q = bench.limited_setup(REF_GRID, np.float64, capacity=256)
        plain, _ = bench.limited_setup(REF_GRID, np.float64, capacity=256,
                                       fused=False)
        cases.append(("limited", limited.step, plain.step, Q,
                      bench.stable_dt(limited.solver, Q), TOL_LIMITED_L1, "l1",
                      None))
        solver, Q, _ = bench.ck_setup(REF_GRID, np.float64)
        # Compare the nine evolved wave variables (the frozen material slots
        # would dominate a norm of the whole state).
        cases.append(("ck", solver.step, solver.step, Q,
                      bench.stable_dt(solver, Q), TOL_CK, "linf",
                      (solver.var_axis, slice(0, 9))))
    failed = []
    for name, step, ref_step, Q, dt, tol, norm, part in cases:
        Q = np.asarray(Q)
        got = np.asarray(_run(step, Q, dt, gpu, np.float32), np.float64)
        with jax.enable_x64(True):
            want = np.asarray(_run(ref_step, Q, dt, ref_dev, np.float64))
        if part is not None:
            axis, sl = part
            got = got[(slice(None),) * axis + (sl,)]
            want = want[(slice(None),) * axis + (sl,)]
        if norm == "linf":
            err = np.max(np.abs(got - want)) / np.max(np.abs(want))
        else:
            err = np.sum(np.abs(got - want)) / np.sum(np.abs(want))
        ok = bool(np.isfinite(got).all()) and err <= tol
        log(f"[reference] {name}: rel_{norm}={err:.3e} tol={tol:g} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(name)
    if failed:
        raise AssertionError(f"reference comparison failed: {failed}")


def phase_kernels(bench):
    """The fused cell stage against the plain XLA cell stage at 64³, both
    f32 on the card (contractions at HIGHEST precision)."""
    import jax
    import jax.numpy as jnp

    from exahype_jax.models.aderdg_triton import TritonADERDG

    solver, Q = bench.euler_setup()
    dt = jnp.asarray(bench.stable_dt(solver, Q), Q.dtype)
    fused = TritonADERDG(solver)
    got = jax.jit(fused.cell_stage)(Q, dt)
    want = jax.jit(solver.cell_stage)(Q, dt)
    errs = [float(jnp.max(jnp.abs(a - b)) / jnp.max(jnp.abs(b)))
            for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want))]
    err = max(errs)
    ok = err <= TOL_KERNEL and all(
        bool(jnp.isfinite(a).all()) for a in jax.tree.leaves(got))
    log(f"[kernels] fused cell stage vs ADERDGSolver.cell_stage at "
        f"{solver.grid_shape}, f32 HIGHEST: max rel_linf={err:.3e} "
        f"over {len(errs)} arrays, tol={TOL_KERNEL:g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("fused cell stage differs from the reference")


def phase_gpu_tests():
    """Call the tests marked ``gpu`` in this process (a second JAX process
    could not take the card while this one holds it)."""
    import inspect

    import jax

    n = 0
    for path in sorted((HERE / "tests").glob("test_*.py")):
        spec = importlib.util.spec_from_file_location(f"_chip_{path.stem}", path)
        source = path.read_text()
        if "pytest.mark.gpu" not in source:
            continue
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        for name, fn in sorted(vars(mod).items()):
            marks = [m.name for m in getattr(fn, "pytestmark", [])]
            if not name.startswith("test_") or "gpu" not in marks:
                continue
            params = inspect.signature(fn).parameters
            kwargs = {"gpu_device": jax.devices()[0]} if "gpu_device" in params else {}
            fn(**kwargs)
            n += 1
            log(f"[gpu-tests] {path.name}::{name} passed")
    if n == 0:
        raise AssertionError("no tests marked gpu were found")
    log(f"[gpu-tests] {n} passed")


def phase_four():
    """Sharded ADER-DG step on four cards against one card."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from exahype_jax.models.aderdg_triton import TritonADERDG
    from exahype_jax.parallel.mesh import make_mesh, state_sharding
    from exahype_jax.parallel.shard import (
        ShardedADERDG,
        make_sharded_xla_aderdg_step,
    )

    devices = jax.devices()
    if len(devices) < 4:
        raise SystemExit(f"--four needs 4 GPUs, found {len(devices)}")
    import bench

    grid = FOUR_GRID
    steps = 5
    tol = TOL_FOUR
    solver, Q = bench.euler_setup(grid)
    dt = jnp.asarray(bench.stable_dt(solver, Q), Q.dtype)
    mesh = make_mesh(4)

    def stepper(step):
        return jax.jit(lambda q, dt: jax.lax.fori_loop(
            0, steps, lambda _, x: step(x, dt), q))

    t0 = time.perf_counter()
    ref = stepper(solver.step)(jax.device_put(Q, devices[0]), dt)
    ref = np.asarray(ref)
    log(f"[four] single card: grid={grid} steps={steps} "
        f"{time.perf_counter() - t0:.1f}s incl. compile")
    scale = np.max(np.abs(ref))

    shard_step, sharding = make_sharded_xla_aderdg_step(solver, mesh)
    fused_step, _ = make_sharded_xla_aderdg_step(
        solver, mesh, cell_stage=lambda s: TritonADERDG(s).cell_stage)
    gspmd = state_sharding(mesh, solver)
    failed = []
    for name, step, shd in (("shard_map xla", shard_step, sharding),
                            ("shard_map fused", fused_step, sharding),
                            ("gspmd xla", solver.step, gspmd)):
        t0 = time.perf_counter()
        out = stepper(step)(jax.device_put(Q, shd), dt)
        out.block_until_ready()
        n_dev = len(out.sharding.device_set)
        err = float(np.max(np.abs(np.asarray(out) - ref)) / scale)
        ok = n_dev == 4 and err <= tol and bool(np.isfinite(np.asarray(out)).all())
        log(f"[four] {name}: devices={n_dev} rel_linf_vs_one_card={err:.3e} "
            f"tol={tol:g} {time.perf_counter() - t0:.1f}s incl. compile "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(name)

    # The limited run on four cards: the fused candidate under shard_map
    # (ShardedADERDG), detection/fallback/matching partitioned by GSPMD.
    limited, Q = bench.limited_setup(grid)
    dt = jnp.asarray(bench.stable_dt(limited.solver, Q), Q.dtype)
    t0 = time.perf_counter()
    ref = np.asarray(stepper(limited.step)(jax.device_put(Q, devices[0]), dt),
                     np.float64)
    log(f"[four] limited single card: {time.perf_counter() - t0:.1f}s "
        "incl. compile")
    accel = ShardedADERDG(limited.solver, mesh,
                          cell_stage=lambda s: TritonADERDG(s).cell_stage)
    sharded = dataclasses.replace(limited, accelerator=accel)
    t0 = time.perf_counter()
    out = stepper(sharded.step)(jax.device_put(Q, accel.sharding), dt)
    out.block_until_ready()
    n_dev = len(out.sharding.device_set)
    got = np.asarray(out, np.float64)
    err = float(np.sum(np.abs(got - ref)) / np.sum(np.abs(ref)))
    ok = n_dev == 4 and err <= TOL_LIMITED_L1 and bool(np.isfinite(got).all())
    log(f"[four] limited shard_map fused: devices={n_dev} "
        f"rel_l1_vs_one_card={err:.3e} tol={TOL_LIMITED_L1:g} "
        f"{time.perf_counter() - t0:.1f}s incl. compile "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failed.append("limited shard_map fused")
    if failed:
        raise AssertionError(f"sharded step differs from one card: {failed}")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the four-card sharded step")
    args = parser.parse_args()
    bench = _load_repo()
    from exahype_jax.utils.gpu import use_compile_cache

    device = phase_device()
    use_compile_cache()
    if args.four:
        phase_four()
    else:
        for phase in (phase_euler, phase_limited, phase_candidates, phase_ck,
                      phase_reference):
            t0 = time.perf_counter()
            phase(bench)
            log(f"[{phase.__name__[6:]}] phase seconds "
                f"{time.perf_counter() - t0:.1f}")
        phase_kernels(bench)
        phase_gpu_tests()
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
