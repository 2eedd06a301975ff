"""IR passes and the pass registry.

The reference's ``exahype-opt`` registers two lowering passes that DO NOT
EXIST in its repository — ``exahype-to-standard`` and ``for-to-parallel``
are dangling imports (``exahype/tools/exahype-opt:10-11,19-22``; SURVEY.md
§1 path B).  This module provides working equivalents:

- ``spec-to-loops``: lower a populated :class:`KernelBuilder` spec into
  Loop IR — the exact statement × bounds structure the JAX and C++ backends
  execute (the analogue of lowering to standard dialects);
- ``kernel-to-loops``: lower structural Kernel IR (path B) into Loop IR,
  giving the reference's dangling ``exahype-to-standard`` real semantics:
  each flux is produced by a pointwise external call over its halo-trimmed
  region, then the patch accumulates ``scale * flux[x + offset]`` terms;
- ``for-to-parallel``: mark outermost ``patch`` loops parallel (the analogue
  of ``scf.for`` → ``scf.parallel``; the JAX backend realizes this as the
  batched leading axis, the C++ backend as an OpenMP pragma).
"""

from __future__ import annotations

from typing import Callable

import sympy

from exahype_jax.frontend.bounds import DEFAULT_POLICY, Policy, statement_ranges
from exahype_jax.frontend.kernel_builder import KernelBuilder
from exahype_jax.frontend.statements import StatementKind
from exahype_jax.ir import kernel_ir, loop_ir
from exahype_jax.utils.errors import VerifyError


def spec_to_loops(
    kb: KernelBuilder, function_name: str = "time_step", policy: Policy = DEFAULT_POLICY
) -> loop_ir.LoopFunction:
    """Lower a KernelBuilder spec to Loop IR (per-statement loop nests)."""
    params = [(n, "memref<f64>" if t.endswith("*") else "f64") for n, t in zip(kb.inputs, kb.input_types)]
    allocs = [
        loop_ir.Alloc(name, tuple(kb.item_shape(name))) for name in kb.temp_items()
    ]
    body: list = []
    last_lhs = kb.LHS[-1] if kb.LHS else None
    for stmt in kb.statements:
        if stmt.kind is StatementKind.CONST_ASSIGN:
            body.append(loop_ir.ConstAssign(str(stmt.lhs), float(stmt.rhs)))
            continue
        ranges = statement_ranges(
            kb.config,
            stmt,
            kb.item_struct,
            policy=policy,
            is_last_lhs=(last_lhs is not None and stmt.lhs == last_lhs),
        )
        leaf = loop_ir.Statement(lhs=stmt.lhs, rhs=stmt.rhs)
        node: loop_ir.Loop | loop_ir.Statement = leaf
        for (lo, hi), idx in zip(reversed(ranges), reversed(kb.config.index_names)):
            node = loop_ir.Loop(index=idx, lo=lo, hi=hi, body=[node])
        body.append(node)
    fn = loop_ir.LoopFunction(
        name=function_name, params=params, allocs=allocs, body=body
    )
    fn.verify()
    return fn


def kernel_to_loops(
    kernel: kernel_ir.Kernel, function_name: str = "kernel"
) -> loop_ir.LoopFunction:
    """Lower structural Kernel IR to Loop IR (fix of the reference's dangling
    ``exahype-to-standard``)."""
    kernel.verify()
    allocs: list[loop_ir.Alloc] = []
    body: list = []
    params: list[tuple[str, str]] = []
    seen_params: set[str] = set()

    def spatial_syms(ndim: int):
        return [sympy.Idx(n) for n in ("i", "j", "k")[:ndim]]

    for stencil in kernel.stencils:
        patch = stencil.patch
        ndim = len(patch.shape)
        idxs = spatial_syms(ndim)
        if patch.name not in seen_params:
            params.append((patch.name, f"memref<{patch.dtype.value}>"))
            seen_params.add(patch.name)
        patch_base = sympy.IndexedBase(patch.name, real=True)

        # 1. Produce each flux via its external call over the trimmed region.
        for flux in stencil.fluxes:
            allocs.append(loop_ir.Alloc(flux.name, tuple(flux.shape)))
            fbase = sympy.IndexedBase(flux.name, real=True)
            fn = sympy.Function(flux.call.func)
            leaf = loop_ir.Statement(
                lhs=fbase[tuple(idxs)], rhs=fn(patch_base[tuple(idxs)])
            )
            node: loop_ir.Loop | loop_ir.Statement = leaf
            for d in reversed(range(ndim)):
                h = flux.halo[d] if d < len(flux.halo) else 0
                node = loop_ir.Loop(
                    index=str(idxs[d]), lo=h, hi=patch.shape[d] - h, body=[node]
                )
            body.append(node)

        # 2. Accumulate stencil terms: patch += scale * flux[x + offset].
        for fi, flux in enumerate(stencil.fluxes):
            fbase = sympy.IndexedBase(flux.name, real=True)
            terms = stencil.offsets(fi)
            scales = stencil.scales[fi] if stencil.scales else [1.0] * len(terms)
            if len(scales) != len(terms):
                raise VerifyError(
                    f"stencil row {fi}: {len(scales)} scale(s) for "
                    f"{len(terms)} term(s)"
                )
            rhs = patch_base[tuple(idxs)]
            max_off = [0] * ndim
            for (term_flux, offs), scale in zip(terms, scales):
                shifted = tuple(
                    idx + off for idx, off in zip(idxs, offs[:ndim])
                )
                src = stencil.fluxes[term_flux]
                rhs = rhs + sympy.Float(scale) * sympy.IndexedBase(
                    src.name, real=True
                )[shifted]
                for d in range(ndim):
                    max_off[d] = max(max_off[d], abs(offs[d]) if d < len(offs) else 0)
            leaf = loop_ir.Statement(lhs=patch_base[tuple(idxs)], rhs=rhs)
            node = leaf
            for d in reversed(range(ndim)):
                node = loop_ir.Loop(
                    index=str(idxs[d]),
                    lo=max_off[d],
                    hi=patch.shape[d] - max_off[d],
                    body=[node],
                )
            body.append(node)

    fn = loop_ir.LoopFunction(
        name=function_name, params=params, allocs=allocs, body=body
    )
    fn.verify()
    return fn


def for_to_parallel(fn: loop_ir.LoopFunction) -> loop_ir.LoopFunction:
    """Mark top-level ``patch`` loops parallel (patches are independent —
    the 'batched stateless' property)."""
    for node in fn.body:
        if isinstance(node, loop_ir.Loop) and node.index == "patch":
            node.parallel = True
    return fn


#: CLI-facing registry (name -> pass over Loop IR).
LOOP_PASSES: dict[str, Callable[[loop_ir.LoopFunction], loop_ir.LoopFunction]] = {
    "for-to-parallel": for_to_parallel,
}
