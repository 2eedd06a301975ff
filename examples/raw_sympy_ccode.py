"""Raw-SymPy C-code emission — the pre-DSL layer of the pipeline.

Parity target: the reference's two earliest experiments,
``examples/sympy_test.py`` (one ``ccode`` statement with ``assign_to``) and
``examples/full_sympy_test.py:22-46`` (the whole Rusanov update written by
hand as ``IndexedBase`` expressions and dumped through ``sympy.ccode``).
Those scripts demonstrate the substrate the DSL was later built on: SymPy
alone can already print legal C for each statement body — what it cannot do
is derive loop nests, halo-trimmed bounds, strides, or run the kernel.

This example reproduces that capability from scratch — the statement list is
generated programmatically per direction instead of hand-unrolled — and then
shows the hand-off: the same statements expressed through ``KernelBuilder``
come back with loops, bounds, and an executable JAX lowering attached.
"""

from __future__ import annotations

import sympy as sp
from sympy.printing.c import ccode


def raw_statements(dim: int = 2, patch: int = 4, halo: int = 1, n_patches: int = 1):
    """The Rusanov patch update as bare (lhs, rhs) SymPy pairs.

    No DSL: indices, shapes, and directional variants are spelled out by
    hand, exactly the way the pre-DSL experiments worked.
    """
    names = "ijk"[:dim]
    idx = sp.symbols(f"patch {' '.join(names)}", cls=sp.Idx)
    patch_sym, space = idx[0], list(idx[1:])
    full = [n_patches] + [patch + 2 * halo] * dim

    Q = sp.IndexedBase("Q", shape=tuple(full))
    Q_copy = sp.IndexedBase("Q_copy", shape=tuple(full))
    flux = [sp.IndexedBase(f"tmp_flux_{n}", shape=tuple(full)) for n in names]
    eig = [sp.IndexedBase(f"tmp_eig_{n}", shape=tuple(full)) for n in names]
    Flux = sp.Function("Flux")
    MaxEig = sp.Function("maxEigenvalue")
    dt = sp.Symbol("dt")

    at = lambda base: base[(patch_sym, *space)]

    def shifted(base, d, off):
        ix = list(space)
        ix[d] = ix[d] + off
        return base[(patch_sym, *ix)]

    stmts = [(at(Q_copy), at(Q))]
    for d in range(dim):
        stmts.append((at(flux[d]), Flux(at(Q_copy), d)))
        stmts.append((at(eig[d]), MaxEig(at(Q_copy), d)))
    for d in range(dim):
        stmts.append(
            (at(Q_copy), at(Q_copy) + sp.Rational(1, 2) * (shifted(flux[d], d, -1) - shifted(flux[d], d, +1)))
        )
        dissipation = -sp.Max(shifted(eig[d], d, -1), at(eig[d])) * (at(Q) - shifted(Q, d, -1)) + sp.Max(
            shifted(eig[d], d, +1), at(eig[d])
        ) * (at(Q) - shifted(Q, d, +1))
        stmts.append((at(Q_copy), at(Q_copy) + sp.Rational(1, 2) * dt * dissipation))
    stmts.append((at(Q), at(Q_copy)))
    return stmts


def main():
    # --- Stage 1: the one-statement demo (cf. reference sympy_test.py). ---
    patch_s, i, j = sp.symbols("patch i j", cls=sp.Idx)
    tmp = sp.IndexedBase("tmp_x", shape=(1, 4, 4))
    Qc = sp.IndexedBase("Qcopy", shape=(1, 4, 4))
    stmt = ccode(
        sp.Function("X_max_eigenvalues")(Qc[patch_s, i, j]),
        assign_to=tmp[patch_s, i, j],
        contract=False,
        allow_unknown_functions=True,
    )
    print("single statement:", stmt)

    # --- Stage 2: the full update, statement bodies only. ---
    print("\nfull Rusanov update (statement bodies, no loops):")
    for lhs, rhs in raw_statements(dim=2):
        print(" ", ccode(rhs, assign_to=lhs, contract=False, allow_unknown_functions=True))

    # --- Stage 3: what the DSL adds on top of the same SymPy substrate. ---
    from exahype_jax import KernelBuilder
    from exahype_jax.backends.cpp_backend import CPPPrinter

    kb = KernelBuilder(dim=2, patch_size=4, halo_size=1, n_real=5, n_aux=5)
    Q = kb.item("Q")
    Q_copy = kb.item("Q_copy")
    kb.single(Q_copy[0], Q[0])
    code = CPPPrinter(kb, "time_step").code
    print("\nthe DSL derives the loops and bounds the raw layer cannot:")
    print("\n".join(line for line in code.splitlines() if "for" in line or "Q_copy[" in line))


if __name__ == "__main__":
    main()
