"""Time-loop driver: chunked integration with checkpointing, failure
detection, and metrics.

The production harness around :class:`GridSolver` — the subsystems the
reference delegates to Peano (SURVEY.md §5): the solver's ``lax.scan`` chunk
runs entirely on device; between chunks the driver (host side)

- checkpoints ``{step, t, dt, Q}`` (orbax-backed, resumable),
- detects non-finite states (failure detection) and either aborts or rolls
  back to the last checkpoint with a reduced dt (elastic recovery),
- emits JSON-line metrics (steps/sec, DOF/sec, sim time) through standard
  logging,
- evaluates user-defined **global observables** (the ExaHyPE2 reduction
  hook: total mass, max density, constraint norms, ...) as one bundled
  on-device dispatch per chunk, logging them and returning the history
  (``DriverConfig.observables``).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
from typing import Optional

import jax
import jax.numpy as jnp

from exahype_jax.parallel.solver import GridSolver
from exahype_jax.utils.checkpoint import CheckpointManager

logger = logging.getLogger("exahype_jax.driver")


@dataclasses.dataclass
class DriverConfig:
    chunk_steps: int = 10  # scan length per device dispatch
    checkpoint_every: int = 0  # chunks between checkpoints; 0 = off
    checkpoint_dir: Optional[str] = None
    max_recoveries: int = 2  # rollback attempts on non-finite state
    recovery_dt_factor: float = 0.5
    log_metrics: bool = True
    #: Global observables (the ExaHyPE2 "global observables" reduction
    #: hook): ``{name: fn(Q) -> scalar}`` user reductions — total mass,
    #: max density, constraint norms, ...  All observables of a chunk are
    #: jitted into ONE bundled dispatch (under the run's sharding, so on a
    #: mesh each reduction lowers to an XLA collective, not a host
    #: gather), evaluated on the post-chunk state, logged on the JSON
    #: metrics line, and returned as a per-chunk history in the run stats.
    #: On :class:`AdaptiveTimeLoopDriver` the contract is the composite
    #: state: ``fn(coarse, fine, tables) -> scalar``.
    observables: Optional[dict] = None
    #: (AdaptiveTimeLoopDriver) build the NEXT chunk's refinement tables
    #: on the host WHILE the current chunk runs on device, scoring the
    #: criterion from the chunk's input state — takes host re-gridding
    #: off the critical path at the cost of a one-chunk pattern lag
    #: (size the criterion's ``rel_threshold`` buffer to cover
    #: ``chunk_steps`` of front motion).
    overlap_regrid: bool = False


class TimeLoopDriver:
    """Drives any solver exposing ``run(Q, n_steps, dt=...)`` — a
    :class:`GridSolver` (returns ``(Q, t_inc)``) or an
    :class:`~exahype_jax.models.aderdg.ADERDGSolver` /
    :class:`~exahype_jax.models.aderdg_triton.TritonADERDG`
    (returns ``Q``; elapsed time is ``n·dt``)."""

    def __init__(
        self,
        solver,
        config: DriverConfig = DriverConfig(),
        sharding=None,
    ):
        self.solver = solver
        self.config = config
        self.ckpt = (
            CheckpointManager(config.checkpoint_dir)
            if config.checkpoint_every and config.checkpoint_dir
            else None
        )
        self._jit_kwargs = {}
        if sharding is not None:
            self._jit_kwargs = {
                "in_shardings": (sharding, None),
                "out_shardings": (sharding, None),
            }
        # Jitted chunk runners keyed by chunk length (the tail chunk of a
        # run that isn't a multiple of chunk_steps compiles once, not per
        # call).
        self._chunk_fns: dict[int, callable] = {}
        self._obs_fn = None
        if config.observables:
            names = tuple(config.observables)
            fns = tuple(config.observables.values())
            obs_jit_kwargs = {}
            if sharding is not None:
                obs_jit_kwargs = {"in_shardings": (sharding,)}
            self._obs_fn = jax.jit(
                lambda Q: {n: f(Q) for n, f in zip(names, fns)},
                **obs_jit_kwargs,
            )

    def _chunk_fn(self, n_steps: int):
        fn = self._chunk_fns.get(n_steps)
        if fn is None:
            fn = jax.jit(
                lambda Q, dt: self._normalize(
                    self.solver.run(Q, n_steps, dt=dt), n_steps, dt
                ),
                **self._jit_kwargs,
            )
            self._chunk_fns[n_steps] = fn
        return fn

    @staticmethod
    def _normalize(res, n_steps, dt):
        """(Q, t_inc) regardless of the solver's run() return convention."""
        if isinstance(res, tuple):
            return res
        return res, n_steps * dt

    def _dofs(self) -> int:
        grid = getattr(self.solver, "grid", None)
        if grid is not None:
            return grid.config.dofs()
        if hasattr(self.solver, "dofs"):
            return self.solver.dofs()
        # Wrappers (LimitedADERDG, accelerators) expose the base solver.
        return self.solver.solver.dofs()

    def resume_or_init(self, Q0, dt: Optional[float] = None):
        """Restore the latest checkpoint if one exists, else start fresh.

        Returns ``(Q, t, step, dt)``: the checkpointed dt (possibly reduced
        by a past non-finite recovery) wins over the caller's — otherwise a
        restart would silently revert to the dt that blew up.
        """
        if self.ckpt is not None:
            state = self.ckpt.restore()
            if state is not None:
                logger.info("resuming from step %d", int(state["step"]))
                ckpt_dt = state.get("dt")
                return (
                    jnp.asarray(state["Q"]),
                    float(state["t"]),
                    int(state["step"]),
                    float(ckpt_dt) if ckpt_dt is not None else dt,
                )
        return jnp.asarray(Q0), 0.0, 0, dt

    def run(self, Q0, n_steps: int, dt: float):
        """Integrate ``n_steps`` with fixed dt; returns (Q, t, stats dict)."""
        cfg = self.config
        Q, t, start_step, dt = self.resume_or_init(Q0, dt)
        step = start_step
        recoveries = 0
        chunks_done = 0
        dof = self._dofs()
        obs_history: list[dict] = []
        wall0 = time.perf_counter()

        while step < n_steps:
            chunk = min(cfg.chunk_steps, n_steps - step)
            Qn, t_inc = self._chunk_fn(chunk)(Q, dt)
            Qn.block_until_ready()

            if not bool(jnp.isfinite(Qn).all()):
                # Failure detection + elastic recovery.
                recoveries += 1
                if recoveries > cfg.max_recoveries or self.ckpt is None:
                    raise FloatingPointError(
                        f"non-finite state at step {step + chunk}; "
                        f"no recovery possible"
                    )
                state = self.ckpt.restore()
                if state is None:
                    raise FloatingPointError(
                        f"non-finite state at step {step + chunk}; "
                        "no checkpoint to roll back to"
                    )
                Q = jnp.asarray(state["Q"])
                t = float(state["t"])
                step = int(state["step"])
                dt = dt * cfg.recovery_dt_factor
                # Drop the rolled-back trajectory's observables so the
                # history describes only the final trajectory (mirrors the
                # adaptive driver's trim below).
                obs_history[:] = [h for h in obs_history if h["step"] <= step]
                logger.warning(
                    "non-finite state: rolled back to step %d, dt -> %g", step, dt
                )
                continue

            Q = Qn
            t += float(t_inc)
            step += chunk
            chunks_done += 1

            obs = None
            if self._obs_fn is not None:
                obs = {
                    k: float(v) for k, v in self._obs_fn(Q).items()
                }
                obs_history.append({"step": step, "t": t, **obs})

            if self.ckpt is not None and chunks_done % cfg.checkpoint_every == 0:
                self.ckpt.save(step, {"step": step, "t": t, "dt": dt, "Q": Q})

            if cfg.log_metrics:
                elapsed = time.perf_counter() - wall0
                done = step - start_step
                record = {
                    "step": step,
                    "t": t,
                    "steps_per_sec": done / elapsed if elapsed else None,
                    "dof_per_sec": dof * done / elapsed if elapsed else None,
                }
                if obs is not None:
                    record["observables"] = obs
                logger.info("%s", json.dumps(record))

        stats = {
            "steps": step - start_step,
            "recoveries": recoveries,
            "wall_seconds": time.perf_counter() - wall0,
        }
        if self._obs_fn is not None:
            stats["observables"] = obs_history
        return Q, t, stats


class AdaptiveTimeLoopDriver:
    """The driver subsystems around a criteria-driven tree-AMR run
    (:class:`~exahype_jax.parallel.pool.DynamicPoolRefinement` or
    :class:`~exahype_jax.models.aderdg_pool.DynamicADERDGPool` — both share
    the ``pick_mask`` / ``pool`` / ``_chunk_fn`` surface):

    - chunked integration with re-gridding between chunks (the standard
      adaptivity-between-compiled-chunks recipe),
    - checkpoint/resume of the COMPOSITE state including the refinement
      mask (tables are rebuilt from the mask on restore; the compiled
      chunk is pattern-independent, so resuming never retraces),
    - non-finite detection with rollback to the last checkpoint and
      reduced dt,
    - JSON-line metrics per chunk.
    """

    def __init__(self, dyn, config: DriverConfig = DriverConfig()):
        self.dyn = dyn
        self.config = config
        self.ckpt = (
            CheckpointManager(config.checkpoint_dir)
            if config.checkpoint_every and config.checkpoint_dir
            else None
        )
        # Global observables over the COMPOSITE state:
        # ``{name: fn(coarse, fine, tables) -> scalar}`` (tables so a
        # reduction can mask covered coarse cells, e.g. composite mass).
        # One bundled jitted dispatch per chunk, pattern-independent —
        # re-gridding never retraces it.
        self._obs_fn = None
        if config.observables:
            names = tuple(config.observables)
            fns = tuple(config.observables.values())
            self._obs_fn = jax.jit(
                lambda c, f, tb: {n: g(c, f, tb) for n, g in zip(names, fns)}
            )

    def _metrics(self, chunk_idx, t, chunk_steps, n_refined, wall0,
                 chunks_done, obs=None):
        if not self.config.log_metrics:
            return
        elapsed = time.perf_counter() - wall0
        record = {
            "chunk": chunk_idx,
            "t": t,
            "n_refined": n_refined,
            "steps_per_sec": (
                chunks_done * chunk_steps / elapsed if elapsed else None
            ),
        }
        if obs is not None:
            record["observables"] = obs
        logger.info("%s", json.dumps(record))

    def run(self, Q0, n_chunks: int, chunk_steps: int, dt: float):
        """Returns ``(coarse_Q, fine_Q, info)``; ``info`` carries the
        per-chunk masks, recovery count, and final tables."""
        import numpy as np

        cfg = self.config
        dyn = self.dyn
        coarse = jnp.asarray(Q0)
        chunk_idx, t = 0, 0.0
        tables = None
        fine = None
        recoveries = 0
        masks = []

        if self.ckpt is not None:
            state = self.ckpt.restore()
            if state is not None:
                coarse = jnp.asarray(state["coarse"])
                fine = jnp.asarray(state["fine"])
                mask = np.asarray(state["mask"], bool)
                tables = dyn.pool.build_tables(mask)
                chunk_idx = int(state["chunk"])
                t = float(state["t"])
                dt = float(state.get("dt", dt))
                logger.info("resuming from chunk %d", chunk_idx)

        fn = dyn._chunk_fn(chunk_steps)
        wall0 = time.perf_counter()
        chunks_done = 0
        obs_history: list[dict] = []
        base_chunk = chunk_idx  # masks[i] belongs to chunk base_chunk + i
        overlap = getattr(cfg, "overlap_regrid", False)
        pending = None  # (mask, tables) prebuilt for the NEXT chunk
        while chunk_idx < n_chunks:
            if pending is not None:
                mask, new_tables = pending
                pending = None
            else:
                mask = dyn.pick_mask(coarse)
                new_tables = dyn.pool.build_tables(mask)
            if tables is None:
                fine = dyn.pool.init_pool(coarse, new_tables)
            else:
                fine = dyn.pool.regrid(coarse, fine, tables, new_tables)
            tables = new_tables

            scores_dev = (
                dyn._score_fn()(coarse)
                if overlap and chunk_idx + 1 < n_chunks
                else None
            )
            new_coarse, new_fine = fn(coarse, fine, tables, dt)
            if scores_dev is not None:
                # Host-side table construction for the NEXT chunk runs
                # UNDER the chunk's device dispatch: the scores came from
                # this chunk's INPUT state (one-chunk pattern lag — the
                # standard regrid-with-margin trade; keep rel_threshold's
                # buffer wide enough to cover chunk_steps of front
                # motion).  Discarded on rollback.
                next_mask = dyn._mask_from_scores(
                    np.asarray(scores_dev)
                )
                pending = (next_mask, dyn.pool.build_tables(next_mask))
            new_coarse.block_until_ready()
            if not bool(jnp.isfinite(new_coarse).all()):
                recoveries += 1
                if recoveries > cfg.max_recoveries or self.ckpt is None:
                    raise FloatingPointError(
                        f"non-finite state in chunk {chunk_idx}; no recovery"
                    )
                state = self.ckpt.restore()
                if state is None:
                    raise FloatingPointError(
                        f"non-finite state in chunk {chunk_idx}; "
                        "no checkpoint to roll back to"
                    )
                coarse = jnp.asarray(state["coarse"])
                fine = jnp.asarray(state["fine"])
                tables = dyn.pool.build_tables(np.asarray(state["mask"], bool))
                chunk_idx = int(state["chunk"])
                t = float(state["t"])
                dt = dt * cfg.recovery_dt_factor
                pending = None  # prebuilt tables belong to the failed path
                # Drop the rolled-back trajectory's masks so masks[i] keeps
                # meaning "the refinement set of chunk base_chunk + i".
                del masks[max(chunk_idx - base_chunk, 0):]
                del obs_history[max(chunk_idx - base_chunk, 0):]
                logger.warning(
                    "non-finite state: rolled back to chunk %d, dt -> %g",
                    chunk_idx, dt,
                )
                continue

            coarse, fine = new_coarse, new_fine
            masks.append(mask)
            t += chunk_steps * dt
            chunk_idx += 1
            chunks_done += 1

            obs = None
            if self._obs_fn is not None:
                obs = {
                    k: float(v)
                    for k, v in self._obs_fn(coarse, fine, tables).items()
                }
                obs_history.append({"chunk": chunk_idx, "t": t, **obs})

            if self.ckpt is not None and chunk_idx % cfg.checkpoint_every == 0:
                self.ckpt.save(
                    chunk_idx,
                    {
                        "chunk": chunk_idx,
                        "t": t,
                        "dt": dt,
                        "coarse": coarse,
                        "fine": fine,
                        "mask": np.asarray(mask),
                    },
                )
            self._metrics(
                chunk_idx, t, chunk_steps, int(np.asarray(mask).sum()),
                wall0, chunks_done, obs,
            )

        info = {
            "masks": masks,
            "tables": tables,
            "recoveries": recoveries,
            "t": t,
        }
        if self._obs_fn is not None:
            info["observables"] = obs_history
        return coarse, fine, info
