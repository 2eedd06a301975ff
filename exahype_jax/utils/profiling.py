"""Profiling and performance-analysis utilities.

The reference only *hooks into* external timing infrastructure (Peano's
``tarch/timing/{Measurement,Watch}.h`` includes and a ``Measurement&`` kernel
parameter, ``CPPPrinter.py:344-345``, ``examples/kernel-generator.py:9``).
Here the equivalents are first-class:

- :func:`time_fn` — wall-clock a jitted kernel with warmup + block_until_ready;
- :func:`trace` — context manager around ``jax.profiler`` for TensorBoard
  traces of the compiled kernel;
- :func:`estimate_cost` — an analytical roofline model (a
  :class:`~exahype_jax.utils.roofline.KernelCost`) computed from the kernel
  spec itself (bytes moved and flops per statement,
  using the same bounds module the backends compile), so specs can be
  perf-triaged before ever running.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

import sympy
from sympy.core.function import AppliedUndef

from exahype_jax.frontend.bounds import DEFAULT_POLICY, Policy, statement_ranges
from exahype_jax.frontend.kernel_builder import KernelBuilder
from exahype_jax.frontend.statements import StatementKind
from exahype_jax.utils.roofline import KernelCost


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2) -> float:
    """Median-free simple timing: seconds per call after warmup."""
    import jax

    out = None
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``jax.profiler`` trace viewable in TensorBoard/Perfetto."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def _expr_flops(expr, fn_flops: dict[str, int]) -> int:
    """Count scalar flops in an expression tree (calls via ``fn_flops``)."""
    if expr is None or expr.is_Number or isinstance(expr, (sympy.Symbol, sympy.Idx)):
        return 0
    if isinstance(expr, sympy.Indexed):
        return 0
    if isinstance(expr, AppliedUndef):
        inner = sum(_expr_flops(a, fn_flops) for a in expr.args)
        return inner + fn_flops.get(type(expr).__name__, 10)
    if isinstance(expr, (sympy.Add, sympy.Mul)):
        return (len(expr.args) - 1) + sum(_expr_flops(a, fn_flops) for a in expr.args)
    if isinstance(expr, sympy.Pow):
        return 1 + _expr_flops(expr.base, fn_flops)
    return 1 + sum(_expr_flops(a, fn_flops) for a in expr.args)


def _expr_reads(expr, itemsize: int, vb: int, kernel: KernelBuilder) -> int:
    """Bytes read per loop point by the expression's array accesses."""
    reads = 0
    if expr is None:
        return 0
    for access in expr.atoms(sympy.Indexed):
        name = str(access.base.label)
        struct = kernel.item_struct.get(name, 0)
        # Pointer args inside calls read the full struct slice; elementwise
        # reads touch one element per var iteration (approximated as 1).
        reads += itemsize
        del struct
    return reads


def estimate_cost(
    kernel: KernelBuilder,
    itemsize: int = 4,
    policy: Policy = DEFAULT_POLICY,
    fn_flops: Optional[dict[str, int]] = None,
) -> KernelCost:
    """Walk the statement list and sum loop-trip-count × per-point cost."""
    fn_flops = fn_flops or {}
    cfg = kernel.config
    flops = 0
    bytes_read = 0
    bytes_written = 0
    last_lhs = kernel.LHS[-1] if kernel.LHS else None
    for stmt in kernel.statements:
        if stmt.kind is StatementKind.CONST_ASSIGN:
            continue
        ranges = statement_ranges(
            cfg,
            stmt,
            kernel.item_struct,
            policy=policy,
            is_last_lhs=(last_lhs is not None and stmt.lhs == last_lhs),
        )
        trips = 1
        for lo, hi in ranges:
            trips *= hi - lo
        flops += trips * (
            _expr_flops(stmt.lhs, fn_flops) + _expr_flops(stmt.rhs, fn_flops)
        )
        bytes_read += trips * _expr_reads(stmt.rhs, itemsize, ranges[-1][1], kernel)
        bytes_written += trips * itemsize
    return KernelCost(
        flops=flops,
        bytes_read=bytes_read,
        bytes_written=bytes_written,
        dof_updates=cfg.dofs(),
    )
