"""Roofline accounting: device peaks and analytic step costs.

SymPy-free, so the benchmark and the solver path can import it without the
DSL.  A roofline share is the least time the device could take (the larger
of operations over peak FLOP/s and bytes over peak bytes/s) divided by the
measured time; the peaks come from :data:`PEAKS`, keyed by JAX's
``device_kind``.  A device that is not in the table is an error, never a
default.
"""

from __future__ import annotations

import dataclasses
import math

#: Published peaks per device kind.  Source: NVIDIA H100 Tensor Core GPU data
#: sheet, SXM5 part, dense rates at the 700 W board limit.  The ADER-DG
#: kernels are elementwise and tiny contractions at f32 ``HIGHEST``
#: precision, so the compute ceiling is the f32 rate outside the tensor cores.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "f32_flops": 67e12,
        "hbm_bytes_per_s": 3.35e12,
        "source": "NVIDIA H100 data sheet (SXM5): 67 TFLOP/s f32 (non-tensor), "
        "3.35 TB/s HBM3",
    },
}


def peaks_for(device_kind: str) -> dict:
    """Peak table entry for ``device_kind`` (``jax.devices()[0].device_kind``)."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no peak rates recorded for device kind {device_kind!r}; add it "
            "to exahype_jax.utils.roofline.PEAKS with its source"
        ) from None


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """Analytical per-time-step cost of a kernel."""

    flops: int
    bytes_read: int
    bytes_written: int
    dof_updates: int

    @property
    def bytes_total(self) -> int:
        return self.bytes_read + self.bytes_written

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / max(self.bytes_total, 1)

    def roofline_seconds(self, peak_flops: float, peak_bytes_per_s: float) -> float:
        """Lower-bound step time for the given peak rates."""
        return max(self.flops / peak_flops, self.bytes_total / peak_bytes_per_s)


def aderdg_step_cost(
    solver,
    flux_flops: int = 22,
    eig_flops: int = 12,
    itemsize: int = 4,
) -> KernelCost:
    """Analytical per-step cost of an :class:`ADERDGSolver` step.

    Counts the dominant terms (1 mult + 1 add = 2 flops):

    - Picard predictor, ``K`` iterations: per direction, flux evaluation
      over all ``S = n^(d+1)`` space-time points plus the ``D`` contraction
      (``2n`` flops per point-var) plus rhs accumulation; the ``K1inv``
      solve per iteration.  Iteration 0 (all time slices equal) is
      credited.
    - Time averages, volume integral, face extrapolations, Rusanov solves.

    Bytes: the least a step must move — ``u`` in and ``new`` out once, plus
    the four face arrays per direction written by the cell-local stage and
    read back by the face stage.  Space-time intermediates are assumed to
    stay on chip, so the byte count is a floor, not XLA's traffic.
    """
    n = solver.n_nodes
    V = solver.n_vars
    d = solver.dim
    K = solver.picard_iters
    cells = int(math.prod(solver.grid_shape))
    S = n ** (d + 1)
    C = n**d
    F = n ** (d - 1)

    per_iter = d * (S * flux_flops + S * V * 2 * n + 2 * S * V) + S * V * (
        2 * n + 1
    )
    iter0_saving = d * ((S - S // n) * flux_flops + (S - S // n) * V * 2 * n)
    predictor = K * per_iter - iter0_saving
    averages = S * V * 2 + d * (S * flux_flops + S * V * 2)
    volume = d * C * V * 2 * n
    faces = d * (4 * F * V * 2 * n + 2 * F * eig_flops + F * V * 5 + 2 * C * V * 2)
    flops = cells * (predictor + averages + volume + faces)

    per_cell = C * V * 2 + d * 2 * (4 * F * V)
    bytes_total = cells * itemsize * per_cell
    return KernelCost(
        flops=int(flops),
        bytes_read=bytes_total // 2,
        bytes_written=bytes_total - bytes_total // 2,
        dof_updates=solver.dofs(),
    )
