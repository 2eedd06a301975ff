"""C++ backend tests: emission, native compilation, and the full native
differential harness (generated C++ vs JAX backend vs NumPy oracle).

This is the rebuild of the reference's ``Unit test/correctness_test.cpp``
pattern — generated kernel vs independent implementation on identical
sine-initialized inputs, element-compared — but automated in pytest with
the local toolchain instead of a SLURM job against a Peano checkout.
"""

import numpy as np
import pytest

from exahype_jax.backends.cpp_backend import CPPPrinter
from exahype_jax.backends.cpp_runtime import compile_kernel, euler_sources
from exahype_jax.backends.jax_backend import JAXPrinter
from exahype_jax.backends.numpy_oracle import run_oracle
from exahype_jax.models import euler_numpy
from exahype_jax.models.rusanov import build_rusanov_kernel


def sine_init(shape):
    n = int(np.prod(shape))
    return np.sin(3.141 * np.arange(n) / n).reshape(shape)


def positive_init(shape, seed=0):
    rng = np.random.default_rng(seed)
    Q = rng.uniform(0.1, 1.0, size=shape)
    Q[..., 0] += 1.0
    Q[..., 3] += 5.0
    if Q.shape[-1] > 4:
        Q[..., 4] += 5.0
    return Q


def test_emission_structure():
    kb = build_rusanov_kernel()
    code = CPPPrinter(kb, header="euler.h").code
    assert 'extern "C" void time_step(double* Q, double dt)' in code
    assert "int dim = 2;" in code
    assert "double *Q_copy = new double[360]();" in code
    assert "double *tmp_flux_x = new double[180]();" in code
    assert "double *tmp_eigen_y = new double[36]();" in code
    assert "double normal;" in code
    assert "normal = 0;" in code or "normal = 0.0;" in code
    assert "delete[] Q_copy;" in code
    assert code.count("for (int patch = 0; patch < 1; patch++)") == 10
    # Golden bounds on the copy loop: full extents, full struct.
    assert "for (int var = 0; var < 10; var++)" in code
    assert "for (int i = 1; i < 5; i++)" in code
    assert '#include "euler.h"' in code


def test_exahype2_include_block():
    kb = build_rusanov_kernel()
    code = CPPPrinter(kb, exahype2=True).code
    assert '#include "peano4/peano.h"' in code
    assert '#include "tarch/multicore/multicore.h"' in code


def test_parallel_patches_pragma():
    kb = build_rusanov_kernel()
    code = CPPPrinter(kb, parallel_patches=True).code
    assert "#pragma omp parallel for" in code


@pytest.mark.parametrize("init", [sine_init, positive_init])
def test_native_differential_vs_oracle_2d(init):
    kb = build_rusanov_kernel(dim=2, patch_size=4, halo_size=1, n_real=5, n_aux=5)
    code = CPPPrinter(kb, header="euler.h").code
    native = compile_kernel(
        kb, code, extra_sources=euler_sources(), defines={"EXA_DIM": 2, "EXA_NREAL": 5}
    )
    Q0 = init(kb.item_shape("Q"))
    got = native(Q0.reshape(-1), 0.01).reshape(kb.item_shape("Q"))
    want = run_oracle(kb, Q0, 0.01, np_impls=euler_numpy.impls(dim=2, n_real=5))
    # Bitwise: the C++ and the oracle implement identical arithmetic.
    np.testing.assert_array_equal(got, want)


def test_native_vs_jax_2d():
    kb = build_rusanov_kernel(dim=2, patch_size=4, halo_size=1, n_real=5, n_aux=5)
    code = CPPPrinter(kb, header="euler.h").code
    native = compile_kernel(
        kb, code, extra_sources=euler_sources(), defines={"EXA_DIM": 2, "EXA_NREAL": 5}
    )
    Q0 = positive_init(kb.item_shape("Q"), seed=3)
    got_native = native(Q0.reshape(-1), 0.02).reshape(kb.item_shape("Q"))
    got_jax = np.asarray(JAXPrinter(kb).build()(Q0, 0.02))
    np.testing.assert_allclose(got_jax, got_native, rtol=0, atol=1e-13)


def test_native_vs_jax_3d():
    kb = build_rusanov_kernel(dim=3, patch_size=3, halo_size=1, n_real=5, n_aux=0)
    code = CPPPrinter(kb, header="euler.h").code
    native = compile_kernel(
        kb, code, extra_sources=euler_sources(), defines={"EXA_DIM": 3, "EXA_NREAL": 5}
    )
    shape = kb.item_shape("Q")
    rng = np.random.default_rng(5)
    Q0 = rng.uniform(0.1, 1.0, size=shape)
    Q0[..., 0] += 1.0
    Q0[..., 4] += 5.0
    got_native = native(Q0.reshape(-1), 0.01).reshape(shape)
    got_jax = np.asarray(JAXPrinter(kb).build()(Q0, 0.01))
    np.testing.assert_allclose(got_jax, got_native, rtol=0, atol=1e-13)
