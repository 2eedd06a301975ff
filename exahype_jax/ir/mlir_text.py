"""Parser + verifier for the standard-dialect MLIR subset the repo emits.

The reference's MLIR path produces a machine-validated ``builtin.ModuleOp``
through xDSL — op invariants are checked on construction
(``/root/reference/exahype/SymPyToMLIR.py:1282-1299``; ``verify()`` calls
e.g. ``/root/reference/exahype/dialects/exahype.py:123-124``).  The repo's
``MLIRPrinter`` emits text directly, so this module supplies the missing
machine check: a strict recursive-descent parser over the emitted subset
(``builtin.module`` / ``func.func`` / ``scf.for`` / ``scf.parallel`` /
``arith`` / ``math`` / ``memref`` / ``func.call``) plus an SSA + type
verifier:

- every SSA use is dominated by its definition (constants hoisted to
  function entry, sibling-region definitions invisible);
- no redefinition within a visible scope;
- full operand/result typing: f64/i64/index arithmetic, ``memref`` loads
  and stores match the element type and rank, ``memref.cast`` only erases
  to ``memref<*xf64>``, call-site signatures equal the external
  declaration's (typed from ``TypedFunction``, incl. i64 returns);
- structural rules: regions balance, ``func.return`` terminates the
  function, ``scf.parallel`` bodies terminate with ``scf.reduce``.

``parse_and_verify(text)`` raises :class:`VerifyError` naming the line, and
returns a :class:`ModuleSummary` for golden assertions.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

from exahype_jax.utils.errors import VerifyError

SSA = r"%[A-Za-z0-9_.]+"
_MODULE = re.compile(r"^builtin\.module \{$")
_FUNC = re.compile(r"^func\.func @([A-Za-z0-9_:]+)\((.*)\) \{$")
_DECL = re.compile(r"^func\.func private @([A-Za-z0-9_:]+)\((.*)\) -> (.+)$")
_CONST = re.compile(rf"^({SSA}) = arith\.constant (\S+) : (index|i64|f64)$")
_BINF = re.compile(
    rf"^({SSA}) = arith\.(addf|subf|mulf|divf|maximumf|minimumf) "
    rf"({SSA}), ({SSA}) : f64$"
)
_BINI = re.compile(rf"^({SSA}) = arith\.(addi|subi|muli) ({SSA}), ({SSA}) : index$")
_FPTOSI = re.compile(rf"^({SSA}) = arith\.fptosi ({SSA}) : f64 to i64$")
_SITOFP = re.compile(rf"^({SSA}) = arith\.sitofp ({SSA}) : i64 to f64$")
_MATH1 = re.compile(rf"^({SSA}) = math\.(sqrt|absf) ({SSA}) : f64$")
_MATH2 = re.compile(rf"^({SSA}) = math\.powf ({SSA}), ({SSA}) : f64$")
_ALLOC = re.compile(rf"^({SSA}) = memref\.alloc\(\) : (memref<[^>]*>)$")
_LOAD = re.compile(
    rf"^({SSA}) = memref\.load ({SSA})\[(.*)\] : (memref<[^>]*>)$"
)
_STORE = re.compile(rf"^memref\.store ({SSA}), ({SSA})\[(.*)\] : (memref<[^>]*>)$")
_CAST = re.compile(
    rf"^({SSA}) = memref\.cast ({SSA}) : (memref<[^>]*>) to (memref<\*xf64>)$"
)
_DEALLOC = re.compile(rf"^memref\.dealloc ({SSA}) : (memref<[^>]*>)$")
_CALL = re.compile(
    rf"^(?:({SSA}) = )?func\.call @([A-Za-z0-9_:]+)\((.*?)\) : \((.*?)\) -> (.+)$"
)
_FOR = re.compile(rf"^scf\.for ({SSA}) = ({SSA}) to ({SSA}) step ({SSA}) \{{$")
_PARALLEL = re.compile(
    rf"^scf\.parallel \(({SSA})\) = \(({SSA})\) to \(({SSA})\) "
    rf"step \(({SSA})\) \{{$"
)


@dataclasses.dataclass
class ExternDecl:
    name: str
    params: tuple[str, ...]
    ret: Optional[str]  # None == ()


@dataclasses.dataclass
class ModuleSummary:
    """What the verifier saw — for golden assertions in tests."""

    func_name: str
    args: tuple[tuple[str, str], ...]
    externs: dict[str, ExternDecl]
    n_ops: int = 0
    n_for: int = 0
    n_parallel: int = 0
    n_load: int = 0
    n_store: int = 0
    n_call: int = 0
    n_alloc: int = 0
    n_dealloc: int = 0


def _memref_dims(ty: str) -> Optional[tuple[int, ...]]:
    """Shape of a ranked memref type, None for the unranked form."""
    inner = ty[len("memref<") : -1]
    if inner == "*xf64":
        return None
    parts = inner.split("x")
    if parts[-1] != "f64":
        raise VerifyError(f"unsupported memref element type in {ty!r}")
    try:
        return tuple(int(p) for p in parts[:-1])
    except ValueError as err:
        raise VerifyError(f"bad memref shape in {ty!r}") from err


class _Verifier:
    def __init__(self, lines: list[str]):
        self.lines = lines
        self.pos = 0
        self.scopes: list[dict[str, str]] = []
        self.summary: Optional[ModuleSummary] = None
        self.externs: dict[str, ExternDecl] = {}
        self.called: dict[str, tuple] = {}

    # ------------------------------------------------------------- utilities

    def err(self, msg: str) -> VerifyError:
        n = self.pos  # already advanced past the offending line
        return VerifyError(f"line {n}: {msg}\n  >> {self.lines[n - 1].strip()}")

    def next_line(self) -> str:
        if self.pos >= len(self.lines):
            raise VerifyError("unexpected end of module (unbalanced regions?)")
        line = self.lines[self.pos].strip()
        self.pos += 1
        if not line:
            return self.next_line()
        return line

    def define(self, ssa: str, ty: str) -> None:
        for scope in self.scopes:
            if ssa in scope:
                raise self.err(f"redefinition of {ssa}")
        self.scopes[-1][ssa] = ty

    def use(self, ssa: str) -> str:
        for scope in reversed(self.scopes):
            if ssa in scope:
                return scope[ssa]
        raise self.err(f"use of undefined value {ssa}")

    def expect(self, ssa: str, ty: str) -> None:
        got = self.use(ssa)
        if got != ty:
            raise self.err(f"{ssa} has type {got}, expected {ty}")

    @staticmethod
    def _split(csv: str) -> list[str]:
        """Split a comma-separated list at top level (no nested commas occur
        in this subset's types)."""
        return [p.strip() for p in csv.split(",") if p.strip()]

    # ----------------------------------------------------------------- parse

    def run(self) -> ModuleSummary:
        # Pre-scan external declarations (flushed at module end in the
        # emission, cf. SymPyToMLIR.py:1296-1297) so calls verify forward.
        for line in self.lines:
            m = _DECL.match(line.strip())
            if m:
                name, params, ret = m.groups()
                if name in self.externs:
                    raise VerifyError(f"duplicate declaration of @{name}")
                self.externs[name] = ExternDecl(
                    name,
                    tuple(self._split(params)),
                    None if ret.strip() == "()" else ret.strip(),
                )

        line = self.next_line()
        if not _MODULE.match(line):
            raise self.err("expected 'builtin.module {'")
        m = _FUNC.match(self.next_line())
        if not m:
            raise self.err("expected 'func.func @name(...) {'")
        fname, argspec = m.groups()
        args = []
        for part in self._split(argspec):
            am = re.match(rf"^({SSA}): (.+)$", part)
            if not am:
                raise self.err(f"bad function argument {part!r}")
            args.append((am.group(1), am.group(2)))
        self.summary = ModuleSummary(
            func_name=fname, args=tuple(args), externs=self.externs
        )
        self.scopes.append({})
        for ssa, ty in args:
            if ty == "f64":
                pass
            elif ty.startswith("memref<") and ty.endswith(">"):
                _memref_dims(ty)  # validates shape + element type
            else:
                raise self.err(f"unsupported argument type {ty!r}")
            self.define(ssa, ty)
        self.verify_block(terminator="func.return")
        # Trailing extern decls + the module's closing brace.
        while True:
            line = self.next_line()
            if _DECL.match(line):
                continue
            if line == "}":
                break
            raise self.err("expected extern declarations or '}' after function")
        if self.pos != len(self.lines) and any(
            l.strip() for l in self.lines[self.pos :]
        ):
            self.pos += 1
            raise self.err("trailing content after module")
        for name in self.called:
            if name not in self.externs:
                raise VerifyError(f"call to undeclared function @{name}")
        return self.summary

    def verify_block(self, terminator: str) -> None:
        """Verify ops until the region's '}' (preceded by ``terminator`` if
        one is required)."""
        s = self.summary
        terminated = False
        while True:
            line = self.next_line()
            if line == "}":
                if terminator and not terminated:
                    raise self.err(
                        f"region closed without terminator {terminator!r}"
                    )
                return
            if terminated:
                raise self.err("operation after region terminator")
            if terminator and line == terminator:
                terminated = True
                continue
            s.n_ops += 1

            m = _CONST.match(line)
            if m:
                ssa, val, ty = m.groups()
                try:
                    int(val) if ty in ("index", "i64") else float(val)
                except ValueError:
                    raise self.err(f"bad {ty} literal {val!r}")
                self.define(ssa, ty)
                continue
            m = _BINF.match(line)
            if m:
                ssa, _, a, b = m.groups()
                self.expect(a, "f64")
                self.expect(b, "f64")
                self.define(ssa, "f64")
                continue
            m = _BINI.match(line)
            if m:
                ssa, _, a, b = m.groups()
                self.expect(a, "index")
                self.expect(b, "index")
                self.define(ssa, "index")
                continue
            m = _FPTOSI.match(line)
            if m:
                ssa, a = m.groups()
                self.expect(a, "f64")
                self.define(ssa, "i64")
                continue
            m = _SITOFP.match(line)
            if m:
                ssa, a = m.groups()
                self.expect(a, "i64")
                self.define(ssa, "f64")
                continue
            m = _MATH1.match(line)
            if m:
                ssa, _, a = m.groups()
                self.expect(a, "f64")
                self.define(ssa, "f64")
                continue
            m = _MATH2.match(line)
            if m:
                ssa, a, b = m.groups()
                self.expect(a, "f64")
                self.expect(b, "f64")
                self.define(ssa, "f64")
                continue
            m = _ALLOC.match(line)
            if m:
                ssa, ty = m.groups()
                if _memref_dims(ty) is None:
                    raise self.err("cannot alloc an unranked memref")
                self.define(ssa, ty)
                s.n_alloc += 1
                continue
            m = _LOAD.match(line)
            if m:
                ssa, base, idxs, ty = m.groups()
                self._check_access(base, idxs, ty)
                self.define(ssa, "f64")
                s.n_load += 1
                continue
            m = _STORE.match(line)
            if m:
                val, base, idxs, ty = m.groups()
                self.expect(val, "f64")
                self._check_access(base, idxs, ty)
                s.n_store += 1
                continue
            m = _CAST.match(line)
            if m:
                ssa, src, from_ty, to_ty = m.groups()
                self.expect(src, from_ty)
                if _memref_dims(from_ty) is None:
                    raise self.err("memref.cast source must be ranked")
                self.define(ssa, to_ty)
                continue
            m = _DEALLOC.match(line)
            if m:
                ssa, ty = m.groups()
                self.expect(ssa, ty)
                s.n_dealloc += 1
                continue
            m = _CALL.match(line)
            if m:
                res, name, argcsv, sigcsv, retstr = m.groups()
                arg_ssas = self._split(argcsv)
                sig = self._split(sigcsv)
                ret = None if retstr.strip() == "()" else retstr.strip()
                if len(arg_ssas) != len(sig):
                    raise self.err(
                        f"call @{name}: {len(arg_ssas)} args vs "
                        f"{len(sig)} signature types"
                    )
                for a, ty in zip(arg_ssas, sig):
                    self.expect(a, ty)
                decl = self.externs.get(name)
                if decl is not None and (
                    tuple(sig) != decl.params or ret != decl.ret
                ):
                    raise self.err(
                        f"call @{name} signature ({', '.join(sig)}) -> "
                        f"{ret or '()'} does not match declaration "
                        f"({', '.join(decl.params)}) -> {decl.ret or '()'}"
                    )
                self.called[name] = tuple(sig)
                if res is not None:
                    if ret is None:
                        raise self.err(f"call @{name} binds a result but returns ()")
                    self.define(res, ret)
                s.n_call += 1
                continue
            m = _FOR.match(line)
            if m:
                iv, lo, hi, st = m.groups()
                for b in (lo, hi, st):
                    self.expect(b, "index")
                self.scopes.append({})
                self.define(iv, "index")
                s.n_for += 1
                self.verify_block(terminator="")
                self.scopes.pop()
                continue
            m = _PARALLEL.match(line)
            if m:
                iv, lo, hi, st = m.groups()
                for b in (lo, hi, st):
                    self.expect(b, "index")
                self.scopes.append({})
                self.define(iv, "index")
                s.n_parallel += 1
                self.verify_block(terminator="scf.reduce")
                self.scopes.pop()
                continue
            raise self.err(f"unrecognized operation")

    def _check_access(self, base: str, idxcsv: str, ty: str) -> None:
        got = self.use(base)
        if got != ty:
            raise self.err(f"{base} has type {got}, access annotated {ty}")
        dims = _memref_dims(ty)
        if dims is None:
            raise self.err("cannot load/store through an unranked memref")
        idxs = self._split(idxcsv)
        if len(idxs) != len(dims):
            raise self.err(
                f"{len(idxs)} indices into rank-{len(dims)} memref {base}"
            )
        for i in idxs:
            self.expect(i, "index")


def parse_and_verify(text: str) -> ModuleSummary:
    """Parse + verify an emitted MLIR module; raises VerifyError."""
    return _Verifier(text.splitlines()).run()
