"""Fused GPU cell stage against the plain XLA step, on the card.

    python scripts/cell_stage_probe.py [--grid 64] [--block-cells 1 2]

p3 3-D Euler (the bench's entropy wave).  For each block size: compile the
fused cell stage, compare it with ``ADERDGSolver.cell_stage`` at the full
grid (relative L∞ of the volume-updated state and of every face array),
then time the full step both ways in turns (XLA, fused, fused, XLA), each
window ending in ``block_until_ready``.  Also times XLA's cell stage alone,
so the step splits into cell stage and face stage.  Prints the card's name
and power limit first.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import bench  # noqa: E402
from exahype_jax.models.aderdg_triton import TritonADERDG  # noqa: E402
from exahype_jax.utils.gpu import card_info, require_gpu, use_compile_cache  # noqa: E402


def max_rel_err(got, want):
    """Largest relative L∞ error over matching leaves."""
    pairs = zip(jax.tree.leaves(got), jax.tree.leaves(want))
    return max(float(jnp.max(jnp.abs(a - b)) / jnp.max(jnp.abs(b)))
               for a, b in pairs)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--grid", type=int, default=64)
    parser.add_argument("--block-cells", type=int, nargs="+", default=[1])
    parser.add_argument("--rounds", type=int, default=4)
    args = parser.parse_args()
    require_gpu()
    use_compile_cache()
    print(f"card: {card_info()}  device_kind: {jax.devices()[0].device_kind}",
          flush=True)
    solver, Q = bench.euler_setup((args.grid,) * 3)
    dt = jnp.asarray(bench.stable_dt(solver, Q), Q.dtype)
    want = jax.jit(solver.cell_stage)(Q, dt)
    steps = {"xla step": solver.step,
             "xla cell stage": lambda q, dt: solver.cell_stage(q, dt)[0]}
    for bc in args.block_cells:
        fused = TritonADERDG(solver, block_cells=bc)
        t0 = time.perf_counter()
        got = jax.jit(fused.cell_stage)(Q, dt)
        jax.block_until_ready(got)
        print(f"[fused bc={bc}] cell stage compile+run "
              f"{time.perf_counter() - t0:.1f}s, max rel_linf vs XLA "
              f"{max_rel_err(got, want):.2e}", flush=True)
        steps[f"fused step bc={bc}"] = fused.step
    compiled = {}
    for name, step in steps.items():
        _, compile_s, _, fn = bench.time_cell(step, jnp.array(Q), dt, rounds=1)
        compiled[name] = fn
        print(f"[{name}] compile {compile_s:.1f}s", flush=True)
    for name in list(compiled) + list(reversed(compiled)):
        fn = compiled[name]
        q = fn(jnp.array(Q), dt)
        q.block_until_ready()
        t0 = time.perf_counter()
        for _ in range(args.rounds):
            q = fn(q, dt)
        q.block_until_ready()
        step_s = (time.perf_counter() - t0) / (args.rounds * bench.CHUNK)
        print(f"[{name}] step_s={step_s:.6f} "
              f"dof_updates_per_s={solver.dofs() / step_s:.6g}", flush=True)


if __name__ == "__main__":
    main()
