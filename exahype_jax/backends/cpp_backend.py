"""C++ backend: emit a native nested-loop kernel from a kernel spec.

Parity component for the reference's ``CPPPrinter``
(``exahype/printers/CPPPrinter.py:47-354``): the same artifact shape — a
``void time_step(double* Q, double dt)`` function of nested loops over
``patch, i, j[, k], var`` with AoS stride linearization, temp-array
allocation, literal const lines, directional-const assignments, and optional
ExaHyPE2/Peano include block + parent-qualified member access — but
generated from the tree-based front end with the single authoritative bounds
module, and with the reference's emission bugs fixed:

- temporaries are zero-initialized (``new double[n]()``; the reference's
  plain ``new`` leaves them uninitialized yet reads them,
  ``Unit test/test.cpp:4-7`` vs loops 6-7);
- the kernel signature is coherent (first item + runtime scalars; the
  current reference emits ``time_step(double* dt)``, see SURVEY.md §7);
- expression text is produced by a real code printer with placeholder
  substitution, not string splitting on brackets (``CPPPrinter.py:204-276``);
- loop bounds follow the 'golden' policy that the reference's own
  correctness harness validates.

The emitted function is ``extern "C"`` so differential tests can load it via
ctypes (see :mod:`exahype_jax.backends.cpp_runtime`).
"""

from __future__ import annotations

import math
from typing import Optional

import sympy
from sympy.core.function import AppliedUndef

from exahype_jax.backends.base import CodePrinter
from exahype_jax.frontend.bounds import DEFAULT_POLICY, Policy, statement_ranges
from exahype_jax.frontend.kernel_builder import KernelBuilder
from exahype_jax.frontend.statements import Statement, StatementKind
from exahype_jax.utils.errors import LoweringError

#: The reference's ExaHyPE2/Peano include block (``CPPPrinter.py:321-347``),
#: emitted only in exahype2 mode for downstream-framework parity.
EXAHYPE2_INCLUDES = [
    "exahype2/UserInterface.h",
    "observers/CreateGrid.h",
    "observers/CreateGridAndConvergeLoadBalancing.h",
    "observers/CreateGridButPostponeRefinement.h",
    "observers/InitGrid.h",
    "observers/PlotSolution.h",
    "observers/TimeStep.h",
    "peano4/peano.h",
    "repositories/DataRepository.h",
    "repositories/SolverRepository.h",
    "repositories/StepRepository.h",
    "tarch/accelerator/accelerator.h",
    "tarch/accelerator/Device.h",
    "tarch/logging/CommandLineLogger.h",
    "tarch/logging/Log.h",
    "tarch/logging/LogFilter.h",
    "tarch/logging/Statistics.h",
    "tarch/multicore/Core.h",
    "tarch/multicore/multicore.h",
    "tarch/multicore/otter.h",
    "tarch/NonCriticalAssertions.h",
    "tarch/timing/Measurement.h",
    "tarch/timing/Watch.h",
    "tasks/FVRusanovSolverEnclaveTask.h",
    "toolbox/loadbalancing/loadbalancing.h",
]


class CPPPrinter(CodePrinter):
    """Emit C++ for a kernel spec.

    ``extern_c=True`` (default) wraps the function for ctypes loading;
    ``exahype2=True`` additionally emits the Peano include block and applies
    parent qualification / ``member[patch]`` rewriting for specs written
    against the ExaHyPE2 ``CellData`` runtime
    (``examples/kernel-generator.py``).
    """

    def __init__(
        self,
        kernel: KernelBuilder,
        function_name: str = "time_step",
        policy: Policy = DEFAULT_POLICY,
        extern_c: bool = True,
        exahype2: bool = False,
        parallel_patches: bool = False,
        header: Optional[str] = None,
    ):
        super().__init__(kernel, function_name=function_name)
        self.policy = policy
        self.extern_c = extern_c
        self.exahype2 = exahype2
        #: Header with the external physics prototypes, included at the top
        #: (the reference's ``file(..., header='Functions.h')`` convention,
        #: ``examples/Batched_stateless.py:37``).
        self.header = header
        #: Emit ``#pragma omp parallel for`` on the patch loop — the
        #: shared-memory analogue of the reference's planned-but-missing
        #: ``for-to-parallel`` pass (``exahype/tools/exahype-opt:22``).
        self.parallel_patches = parallel_patches
        self._emit()

    # ------------------------------------------------------------------ emit

    def _emit(self) -> None:
        kb = self._kernel
        lines: list[str] = []
        sig_params = []
        for name, ctype in zip(kb.inputs, kb.input_types):
            sig_params.append(f"{ctype} {name}")
        linkage = 'extern "C" ' if self.extern_c else ""
        lines.append(f"{linkage}void {self.functionName()}({', '.join(sig_params)}) {{")

        for lit in kb.literals:
            lines.append(f"\t{lit}")
        if kb.literals:
            lines.append("")

        # Temp arrays, zero-initialized.
        for name in kb.temp_items():
            n = math.prod(kb.item_shape(name))
            lines.append(f"\tdouble *{name} = new double[{n}]();")
        for name in kb.directional_consts:
            lines.append(f"\tdouble {name};")
        lines.append("")

        last_lhs = kb.LHS[-1] if kb.LHS else None
        for stmt in kb.statements:
            if stmt.kind is StatementKind.CONST_ASSIGN:
                lines.append(f"\t{stmt.lhs} = {self._render(stmt.rhs, vb=1)};")
            else:
                lines.extend(self._emit_loop(stmt, last_lhs))

        lines.append("")
        for name in kb.temp_items():
            lines.append(f"\tdelete[] {name};")
        lines.append("}")

        prefix = "#include <cmath>\n"
        if self.header:
            prefix += f'#include "{self.header}"\n'
        prefix += "\n"
        if self.exahype2:
            prefix += "".join(f'#include "{inc}"\n' for inc in EXAHYPE2_INCLUDES) + "\n"
        self.code = prefix + "\n".join(lines) + "\n"

    def _emit_loop(self, stmt: Statement, last_lhs) -> list[str]:
        kb = self._kernel
        cfg = kb.config
        ranges = statement_ranges(
            cfg,
            stmt,
            kb.item_struct,
            policy=self.policy,
            is_last_lhs=(last_lhs is not None and stmt.lhs == last_lhs),
        )
        names = cfg.index_names
        vb = ranges[-1][1]
        collapse_var = vb == 1

        lines: list[str] = []
        depth = 1
        for level, ((lo, hi), idx) in enumerate(zip(ranges, names)):
            if idx == "var" and collapse_var:
                continue
            indent = "\t" * depth
            if level == 0 and self.parallel_patches:
                lines.append(f"{indent}#pragma omp parallel for")
            lines.append(
                f"{indent}for (int {idx} = {lo}; {idx} < {hi}; {idx}++) {{"
            )
            depth += 1
        indent = "\t" * depth

        if isinstance(stmt.lhs, AppliedUndef):
            lines.append(f"{indent}{self._render(stmt.lhs, vb)};")
        else:
            lhs_txt = self._access_text(stmt.lhs, vb)
            lines.append(f"{indent}{lhs_txt} = {self._render(stmt.rhs, vb)};")

        for _ in range(depth - 1, 0, -1):
            lines.append("\t" * _ + "}")
        return lines

    # ------------------------------------------------------------ expression
    #
    # A small precedence-aware C printer.  Crucially, Add and Mul operands
    # are emitted in exactly ``as_ordered_terms()`` / ``as_ordered_factors()``
    # order — the same fold order the JAX backend and the NumPy oracle use —
    # so all three backends agree bitwise, not just to rounding.

    _PREC_ADD = 10
    _PREC_MUL = 20
    _PREC_ATOM = 100

    def _render(self, expr, vb: int, prec: int = 0) -> str:
        if expr is None:
            raise LoweringError("missing RHS")
        if expr.is_Number:
            return self._number_text(expr)
        if isinstance(expr, sympy.Indexed):
            return self._access_text(expr, vb)
        if isinstance(expr, AppliedUndef):
            return self._call_text(expr, vb)
        if isinstance(expr, (sympy.Symbol, sympy.Idx)):
            return self._qualify(str(expr))
        if isinstance(expr, sympy.Add):
            terms = expr.as_ordered_terms()
            out = self._render(terms[0], vb, self._PREC_ADD)
            for t in terms[1:]:
                if t.could_extract_minus_sign():
                    out += " - " + self._render(-t, vb, self._PREC_MUL)
                else:
                    out += " + " + self._render(t, vb, self._PREC_MUL)
            return f"({out})" if prec > self._PREC_ADD else out
        if isinstance(expr, sympy.Mul):
            factors = expr.as_ordered_factors()
            parts = []
            sign = ""
            for i, f in enumerate(factors):
                if i == 0 and f == sympy.Integer(-1):
                    sign = "-"
                    continue
                parts.append(self._render(f, vb, self._PREC_MUL + 1))
            out = sign + "*".join(parts)
            return f"({out})" if prec > self._PREC_MUL or sign else out
        if isinstance(expr, sympy.Pow):
            base = expr.base
            e = expr.exp
            # Exact forms shared with the other backends: x**-1 == 1.0/x,
            # x**2 == x*x (libm pow() is not ulp-consistent across them).
            if e == sympy.Integer(-1):
                return f"(1.0/{self._render(base, vb, self._PREC_ATOM)})"
            if e == sympy.Integer(2):
                b = self._render(base, vb, self._PREC_ATOM)
                return f"({b}*{b})"
            if e == sympy.Rational(1, 2):
                return f"sqrt({self._render(base, vb)})"
            if e == sympy.Rational(-1, 2):
                return f"(1.0/sqrt({self._render(base, vb)}))"
            return (
                f"pow({self._render(base, vb)}, {self._render(e, vb)})"
            )
        if isinstance(expr, (sympy.Max, sympy.Min)):
            fn = "fmax" if isinstance(expr, sympy.Max) else "fmin"
            args = [self._render(a, vb) for a in expr.args]
            out = args[0]
            for a in args[1:]:
                out = f"{fn}({out}, {a})"
            return out
        if isinstance(expr, sympy.Abs):
            return f"fabs({self._render(expr.args[0], vb)})"
        if isinstance(expr, sympy.FiniteSet):
            # Brace-initializer argument (the reference's ``{i,j}`` volume
            # index convention, ``examples/kernel-generator.py:34``).
            inner = ", ".join(self._render(a, vb) for a in expr.args)
            return f"{{{inner}}}"
        raise LoweringError(
            f"C printer cannot render {type(expr).__name__}: {expr}"
        )

    @staticmethod
    def _number_text(num: sympy.Basic) -> str:
        if num.is_Integer:
            return str(int(num))
        if num.is_Rational:
            return f"({num.p}.0/{num.q}.0)"
        return sympy.ccode(num)

    def _call_text(self, call: AppliedUndef, vb: int) -> str:
        kb = self._kernel
        fname = type(call).__name__
        args = []
        for a in call.args:
            if isinstance(a, sympy.Indexed):
                args.append(f"&{self._access_text(a, vb)}")
            else:
                args.append(self._render(a, vb))
        return f"{self._qualify(fname)}({', '.join(args)})"

    def _qualify(self, name: str) -> str:
        """Parent qualification (``CPPPrinter.py:182-201``): ``Data.member``
        or ``ns::member`` when the parent string ends with ':'."""
        parent = self._kernel.parents.get(name)
        if parent is None:
            return name
        if parent.endswith(":"):
            return f"{parent}{name}"
        return f"{parent}.{name}"

    def _access_text(self, access: sympy.Indexed, vb: int) -> str:
        """AoS stride linearization (``CPPPrinter.py:247-276`` equivalent).

        Items with a parent use the ExaHyPE2 ``CellData`` convention — the
        member is an array of per-patch pointers, so the patch index becomes
        its own subscript: ``member[patch][<per-patch linear index>]`` (what
        the reference's post-pass ``parse()`` rewrites textually,
        ``CPPPrinter.py:278-316``).
        """
        kb = self._kernel
        cfg = kb.config
        name = str(access.base.label)
        if name not in kb.item_struct:
            raise LoweringError(f"unknown item {name!r}")
        shape = kb.item_shape(name)
        parented = name in kb.parents

        def row_major_strides(dims):
            strides, acc = [], 1
            for s in reversed(dims):
                strides.insert(0, acc)
                acc *= s
            return strides

        if parented:
            strides = [None] + row_major_strides(shape[1:])  # patch handled apart
        else:
            strides = row_major_strides(shape)

        terms = []
        patch_txt = None
        for pos, (idx_expr, stride) in enumerate(zip(access.indices, strides)):
            idx_name = str(next(iter(idx_expr.free_symbols)))
            if parented and pos == 0:
                patch_txt = str(idx_expr)
                continue
            if idx_name == "var" and vb == 1 and len(access.indices) == len(shape):
                continue  # collapsed var loop: index value is 0
            idx_txt = (
                str(idx_expr)
                if isinstance(idx_expr, (sympy.Symbol, sympy.Idx))
                else f"({sympy.ccode(idx_expr)})"
            )
            terms.append(idx_txt if stride == 1 else f"{stride}*{idx_txt}")
        linear = " + ".join(terms) if terms else "0"
        if parented:
            return f"{name}[{patch_txt}][{linear}]"
        return f"{self._qualify(name)}[{linear}]"
