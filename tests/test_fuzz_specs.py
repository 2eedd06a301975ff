"""Differential fuzzing: random kernel specs through every executable path.

The compiler's core claim is that all backends implement the same
semantics.  Beyond the hand-written cases, this generates seeded random
specs — random config, item set, statement sequences with directional
sweeps and stencil offsets — and checks

    JAX backend  ==  NumPy oracle  ==  generated C++ (via ctypes)

element-for-element.  Pure-arithmetic specs (no external functions) so the
native leg needs no physics objects.
"""

import random

import numpy as np
import pytest
import sympy

from exahype_jax import KernelBuilder
from exahype_jax.backends.cpp_backend import CPPPrinter
from exahype_jax.backends.cpp_runtime import compile_kernel
from exahype_jax.backends.jax_backend import JAXPrinter
from exahype_jax.backends.numpy_oracle import run_oracle


def random_spec(rng: random.Random) -> KernelBuilder:
    dim = rng.choice([2, 3])
    patch = rng.choice([3, 4])
    halo = rng.choice([1, 2])
    n_real = rng.choice([1, 2, 3])
    n_aux = rng.choice([0, 2])
    kb = KernelBuilder(
        dim=dim, patch_size=patch, halo_size=halo, n_real=n_real, n_aux=n_aux
    )
    Q = kb.item("Q")
    work = kb.item("W")
    scalar_field = kb.item("S", struct=False)
    dwork = kb.directional_item("D", struct=rng.random() < 0.5)
    dt = kb.const("dt")
    kb.directional_const("nrm", list(range(dim)))
    nrm = kb.all_items["nrm"]

    atoms = [Q, work]

    def centered_expr():
        terms = []
        for _ in range(rng.randint(1, 3)):
            base = rng.choice(atoms)
            coeff = rng.choice([1.0, 0.5, -0.25, 2.0])
            term = coeff * base[0]
            if rng.random() < 0.3:
                term = term * dt
            terms.append(term)
        expr = terms[0]
        for t in terms[1:]:
            expr = expr + t
        if rng.random() < 0.3:
            expr = expr + rng.choice([0.125, -1.0, 3.0])
        return expr

    def directional_expr(target):
        # Stencil offsets only on arrays OTHER than the write target: a
        # self-referencing stencil is order-dependent and the vectorized
        # backends reject it (see Statement.self_referencing_stencil).
        off = rng.choice([-1, 1]) * rng.randint(1, halo)
        base = rng.choice([a for a in atoms if a is not target])
        expr = target[0] + 0.5 * (base[off] - base[-off])
        if rng.random() < 0.4:
            expr = expr + dt * dwork[0]
        if rng.random() < 0.3:
            expr = expr + nrm * scalar_field[0]
        return expr

    # 1. initialize work arrays
    kb.single(work[0], centered_expr())
    kb.single(scalar_field[0], Q[0] if rng.random() < 0.5 else work[0])
    # 2. a directional fill of the directional item
    kb.directional(dwork[0], centered_expr())
    # 3. one or two directional sweeps with offsets
    for _ in range(rng.randint(1, 2)):
        kb.directional(work[0], directional_expr(work))
    # 4. write-back
    kb.single(Q[0], work[0])
    return kb


@pytest.mark.parametrize("seed", range(12))
def test_fuzzed_spec_triple_differential(seed, tmp_path):
    rng = random.Random(1000 + seed)
    kb = random_spec(rng)

    np_rng = np.random.default_rng(seed)
    Q0 = np_rng.normal(size=kb.item_shape("Q"))
    dt = float(np_rng.uniform(0.001, 0.1))

    want = run_oracle(kb, Q0, dt)
    got_jax = np.asarray(JAXPrinter(kb).build()(Q0, dt))
    np.testing.assert_allclose(got_jax, want, rtol=0, atol=1e-12, err_msg=f"seed {seed}")

    native = compile_kernel(kb, CPPPrinter(kb).code, workdir=tmp_path)
    got_cpp = native(Q0.reshape(-1), dt).reshape(kb.item_shape("Q"))
    np.testing.assert_array_equal(got_cpp, want, err_msg=f"seed {seed}")


def test_self_referencing_stencil_rejected():
    """The vectorized backends refuse Gauss-Seidel-order statements (the
    fuzzer found silent Jacobi/Gauss-Seidel divergence before this guard)."""
    from exahype_jax.utils.errors import LoweringError

    kb = KernelBuilder(dim=2, patch_size=4, halo_size=1, n_real=2, n_aux=0)
    Q = kb.item("Q")
    W = kb.item("W")
    kb.single(W[0], Q[0])
    kb.directional(W[0], W[0] + 0.5 * (W[-1] - W[1]))
    kb.single(Q[0], W[0])
    Q0 = np.zeros(kb.item_shape("Q"))
    with pytest.raises(LoweringError, match="shifted index"):
        JAXPrinter(kb).build()(Q0)


def test_pointer_call_in_var_loop_rejected():
    """Struct-pointer call args inside a var loop (vb>1) diverge between the
    C ABI and the traced backends — rejected with a clear error."""
    import sympy
    from sympy.codegen.ast import real

    from exahype_jax.utils.errors import LoweringError

    kb = KernelBuilder(dim=2, patch_size=4, halo_size=1, n_real=3, n_aux=0)
    Q = kb.item("Q")
    W = kb.item("W")
    fn = kb.function("probe", parameter_types=[Q], return_type=real,
                     jax_impl=lambda q: q[0])
    # struct=True forces a var loop of n_real while 'probe' takes a pointer.
    kb.single(W[0], fn(Q[0]) + Q[0], struct=True)
    kb.single(Q[0], W[0])
    Q0 = np.zeros(kb.item_shape("Q"))
    with pytest.raises(LoweringError, match="struct pointer"):
        JAXPrinter(kb).build()(Q0)
