"""Spec-level dataflow diagnostics: uninitialized-read analysis.

Both reference printers emit kernels that read array elements no statement
ever wrote (SURVEY.md §7; ``frontend/bounds.py`` docstring) — under the C
backend those are uninitialized-heap reads.  This pass catches that class
statically: it walks the statement list under a bounds policy, tracks the
written region of every item as a per-axis bounding box, and reports each
read whose region is not covered.

The region tracking is a per-axis interval join (bounding boxes), so it can
under-report reads of genuinely disjoint written regions as covered — it is
a diagnostic, not a proof.  For the kernel shapes this DSL produces
(monotone halo-trimmed regions) it is exact.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import sympy
from sympy.core.function import AppliedUndef

from exahype_jax.frontend.bounds import DEFAULT_POLICY, Policy, statement_ranges
from exahype_jax.frontend.kernel_builder import KernelBuilder
from exahype_jax.frontend.statements import StatementKind


@dataclasses.dataclass(frozen=True)
class UninitializedRead:
    statement_index: int
    item: str
    axis: int  # spatial axis (1-based level)
    read_range: tuple[int, int]
    written_range: Optional[tuple[int, int]]

    def __str__(self) -> str:
        have = (
            f"written [{self.written_range[0]},{self.written_range[1]})"
            if self.written_range
            else "never written"
        )
        return (
            f"statement #{self.statement_index}: reads {self.item} over "
            f"[{self.read_range[0]},{self.read_range[1]}) on spatial axis "
            f"{self.axis}, but it is {have}"
        )


def _offset_of(idx_expr) -> int:
    if isinstance(idx_expr, (sympy.Symbol, sympy.Idx)):
        return 0
    syms = list(idx_expr.free_symbols)
    off = sympy.simplify(idx_expr - syms[0])
    return int(off)


def check_initialized_reads(
    kb: KernelBuilder, policy: Policy = DEFAULT_POLICY, assume_zeroed: bool = False
) -> list[UninitializedRead]:
    """Report reads of temp-array regions that no earlier statement wrote.

    ``assume_zeroed=True`` treats zero-initialized temps as fully written
    (the JAX backend's semantics — deterministic zeros); the default
    models the reference's C semantics where such reads are uninitialized
    memory.
    """
    if assume_zeroed:
        return []
    cfg = kb.config
    inputs = set(kb.inputs)
    written: dict[str, list[Optional[tuple[int, int]]]] = {}
    findings: list[UninitializedRead] = []
    last_lhs = kb.LHS[-1] if kb.LHS else None

    def record_write(name: str, spatial, offsets):
        boxes = written.setdefault(name, [None] * cfg.dim)
        for ax in range(cfg.dim):
            lo, hi = spatial[ax]
            lo, hi = lo + offsets[ax], hi + offsets[ax]
            cur = boxes[ax]
            boxes[ax] = (lo, hi) if cur is None else (min(cur[0], lo), max(cur[1], hi))

    def access_offsets(access: sympy.Indexed):
        return [
            _offset_of(access.indices[1 + ax]) for ax in range(cfg.dim)
        ]

    for si, stmt in enumerate(kb.statements):
        if stmt.kind is StatementKind.CONST_ASSIGN:
            continue
        ranges = statement_ranges(
            cfg,
            stmt,
            kb.item_struct,
            policy=policy,
            is_last_lhs=(last_lhs is not None and stmt.lhs == last_lhs),
        )
        spatial = ranges[1 : 1 + cfg.dim]

        # Reads: every Indexed in the RHS, plus non-out call args in the LHS.
        reads: list[sympy.Indexed] = []
        writes: list[sympy.Indexed] = []
        if isinstance(stmt.lhs, AppliedUndef):
            typed = kb.functions.get(type(stmt.lhs).__name__)
            for pos, arg in enumerate(stmt.lhs.args):
                if not isinstance(arg, sympy.Indexed):
                    continue
                if typed is not None and typed.out_param == pos:
                    writes.append(arg)
                else:
                    reads.append(arg)
        else:
            writes.append(stmt.lhs)
        if stmt.rhs is not None:
            reads.extend(stmt.rhs.atoms(sympy.Indexed))

        for access in reads:
            name = str(access.base.label)
            if name in inputs:
                continue  # kernel inputs arrive initialized
            offsets = access_offsets(access)
            boxes = written.get(name)
            for ax in range(cfg.dim):
                lo, hi = spatial[ax]
                lo, hi = lo + offsets[ax], hi + offsets[ax]
                box = None if boxes is None else boxes[ax]
                if box is None or lo < box[0] or hi > box[1]:
                    findings.append(
                        UninitializedRead(
                            statement_index=si,
                            item=name,
                            axis=ax + 1,
                            read_range=(lo, hi),
                            written_range=box,
                        )
                    )
                    break  # one finding per access

        for access in writes:
            record_write(str(access.base.label), spatial, access_offsets(access))

    return findings
