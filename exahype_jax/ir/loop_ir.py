"""Loop IR — the standard-dialect analogue (path A's lowered form).

Where the reference lowers SymPy statement lists through ``SymPyToMLIR`` into
xDSL ``func``/``scf``/``memref`` text (``exahype/SymPyToMLIR.py:1282-1299``),
this framework's loop-level IR is a small typed tree: a function of
allocations, flat constant assignments, and (optionally parallel) loop nests
whose leaves are SymPy assignment/call statements.  It has a verifier, a
stable textual form, and a parser; the ``exahype-opt`` CLI and the lowering
passes (:mod:`exahype_jax.ir.passes`) operate on it.

The JAX/C++ backends consume the same (statements × bounds) data this IR is
built from, so Loop IR is the inspectable, golden-testable rendering of
exactly what they execute.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional, Union

import sympy

from exahype_jax.utils.errors import VerifyError


@dataclasses.dataclass
class ConstAssign:
    name: str
    value: float

    def verify(self) -> None:
        if not self.name:
            raise VerifyError("const assign requires a name")


@dataclasses.dataclass
class Statement:
    """A loop-leaf statement: ``lhs = rhs``, or a bare call when rhs is None."""

    lhs: sympy.Basic
    rhs: Optional[sympy.Basic]

    def verify(self) -> None:
        if self.lhs is None:
            raise VerifyError("statement requires an lhs")


@dataclasses.dataclass
class Loop:
    index: str
    lo: int
    hi: int
    body: list[Union["Loop", Statement]]
    parallel: bool = False

    def verify(self) -> None:
        if self.hi < self.lo:
            raise VerifyError(f"loop {self.index}: empty/negative range [{self.lo},{self.hi})")
        for node in self.body:
            node.verify()


@dataclasses.dataclass
class Alloc:
    name: str
    shape: tuple[int, ...]

    def verify(self) -> None:
        if any(s < 1 for s in self.shape):
            raise VerifyError(f"alloc {self.name}: invalid shape {self.shape}")


@dataclasses.dataclass
class LoopFunction:
    name: str
    params: list[tuple[str, str]]  # (name, type-string), e.g. ("Q", "memref<f64>")
    allocs: list[Alloc]
    body: list[Union[ConstAssign, Loop]]

    def verify(self) -> None:
        if not self.name:
            raise VerifyError("function requires a name")
        for a in self.allocs:
            a.verify()
        for node in self.body:
            node.verify()

    def walk_loops(self):
        def rec(nodes):
            for n in nodes:
                if isinstance(n, Loop):
                    yield n
                    yield from rec(n.body)

        yield from rec(self.body)


# ------------------------------------------------------------------ printing


def print_function(fn: LoopFunction) -> str:
    out = []
    params = ", ".join(f"{n}: {t}" for n, t in fn.params)
    out.append(f"loop.func @{fn.name}({params}) {{")
    for a in fn.allocs:
        out.append(f"  loop.alloc {a.name} : [{', '.join(map(str, a.shape))}]")

    def emit(node, depth):
        pad = "  " * depth
        if isinstance(node, ConstAssign):
            out.append(f"{pad}{node.name} = {node.value}")
        elif isinstance(node, Loop):
            op = "loop.parallel" if node.parallel else "loop.for"
            out.append(f"{pad}{op} {node.index} = {node.lo} to {node.hi} {{")
            for child in node.body:
                emit(child, depth + 1)
            out.append(f"{pad}}}")
        elif isinstance(node, Statement):
            if node.rhs is None:
                out.append(f"{pad}{node.lhs}")
            else:
                out.append(f"{pad}{node.lhs} = {node.rhs}")
        else:
            raise VerifyError(f"unprintable node {node!r}")

    for node in fn.body:
        emit(node, 1)
    for a in fn.allocs:
        out.append(f"  loop.dealloc {a.name}")
    out.append("}")
    return "\n".join(out) + "\n"


# ------------------------------------------------------------------- parsing

_IDENT = r"[A-Za-z_][A-Za-z0-9_]*"


def _stmt_locals(text: str) -> dict:
    """Build a sympify namespace: ``name[`` -> IndexedBase, ``name(`` ->
    Function, everything else -> Symbol."""
    ns: dict = {}
    for m in re.finditer(rf"({_IDENT})\s*([\[\(])?", text):
        name, bracket = m.group(1), m.group(2)
        if name in ns:
            continue
        if bracket == "[":
            ns[name] = sympy.IndexedBase(name, real=True)
        elif bracket == "(":
            ns[name] = sympy.Function(name)
    for m in re.finditer(_IDENT, text):
        ns.setdefault(m.group(0), sympy.Symbol(m.group(0)))
    return ns


def _parse_stmt(line: str) -> Statement:
    # Split on a top-level ' = ' (never inside brackets in this IR).
    depth = 0
    split_at = None
    for i, ch in enumerate(line):
        if ch in "([":
            depth += 1
        elif ch in ")]":
            depth -= 1
        elif ch == "=" and depth == 0:
            split_at = i
            break
    ns = _stmt_locals(line)
    if split_at is None:
        return Statement(lhs=sympy.sympify(line, locals=ns), rhs=None)
    lhs = sympy.sympify(line[:split_at].strip(), locals=ns)
    rhs = sympy.sympify(line[split_at + 1 :].strip(), locals=ns)
    return Statement(lhs=lhs, rhs=rhs)


def parse_function(text: str) -> LoopFunction:
    lines = [ln.rstrip() for ln in text.splitlines() if ln.strip()]
    header = re.match(
        rf"\s*loop\.func\s+@({_IDENT})\((.*)\)\s*{{\s*$", lines[0]
    )
    if not header:
        raise VerifyError(f"bad loop.func header: {lines[0]!r}")
    name = header.group(1)
    params = []
    if header.group(2).strip():
        for part in header.group(2).split(","):
            pname, ptype = part.split(":")
            params.append((pname.strip(), ptype.strip()))

    allocs: list[Alloc] = []
    body: list = []
    stack: list[list] = [body]

    for ln in lines[1:]:
        s = ln.strip()
        if s == "}":
            if len(stack) > 1:
                stack.pop()
            continue
        m = re.match(rf"loop\.alloc\s+({_IDENT})\s*:\s*\[(.*)\]$", s)
        if m:
            shape = tuple(int(x) for x in m.group(2).split(","))
            allocs.append(Alloc(m.group(1), shape))
            continue
        if re.match(rf"loop\.dealloc\s+{_IDENT}$", s):
            continue
        m = re.match(
            rf"(loop\.for|loop\.parallel)\s+({_IDENT})\s*=\s*(-?\d+)\s+to\s+(-?\d+)\s*{{$",
            s,
        )
        if m:
            loop = Loop(
                index=m.group(2),
                lo=int(m.group(3)),
                hi=int(m.group(4)),
                body=[],
                parallel=m.group(1) == "loop.parallel",
            )
            stack[-1].append(loop)
            stack.append(loop.body)
            continue
        m = re.match(rf"({_IDENT})\s*=\s*(-?\d+\.?\d*)$", s)
        if m and len(stack) == 1:
            body.append(ConstAssign(m.group(1), float(m.group(2))))
            continue
        stack[-1].append(_parse_stmt(s))

    fn = LoopFunction(name=name, params=params, allocs=allocs, body=body)
    fn.verify()
    return fn
