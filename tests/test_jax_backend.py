"""Differential correctness: JAX backend vs the NumPy oracle.

This reproduces the reference's correctness methodology
(``Unit test/correctness_test.cpp:176-221``): identical sine-initialized
inputs run through (a) the generated kernel and (b) an independent
interpreter, then element-wise compared.  Tolerance target per BASELINE.md:
1e-12 (we assert far tighter since both paths are f64).
"""

import numpy as np
import pytest

from exahype_jax.backends.jax_backend import JAXPrinter
from exahype_jax.backends.numpy_oracle import run_oracle
from exahype_jax.models import euler_numpy
from exahype_jax.models.rusanov import build_rusanov_kernel


def sine_init(shape):
    """Q[i] = sin(3.141 * i / N) over the flat AoS index space
    (``Unit test/correctness_test.cpp:102-106``)."""
    n = int(np.prod(shape))
    flat = np.sin(3.141 * np.arange(n) / n)
    return flat.reshape(shape)


def positive_random_init(shape, seed=0):
    """Random states with positive density/pressure for Euler physics."""
    rng = np.random.default_rng(seed)
    Q = rng.uniform(0.1, 1.0, size=shape)
    Q[..., 0] += 1.0  # density well away from zero
    Q[..., 3] += 5.0  # generous total energy -> positive pressure
    if Q.shape[-1] > 4:
        Q[..., 4] += 5.0
    return Q


@pytest.mark.parametrize("init", [sine_init, positive_random_init])
def test_rusanov_2d_jax_matches_oracle(init):
    kb = build_rusanov_kernel(dim=2, patch_size=4, halo_size=1, n_real=5, n_aux=5)
    Q0 = init(kb.item_shape("Q"))
    dt = 0.01

    got = np.asarray(JAXPrinter(kb).build()(Q0, dt))
    want = run_oracle(kb, Q0, dt, np_impls=euler_numpy.impls(dim=2, n_real=5))

    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)


def test_rusanov_2d_multi_patch():
    kb = build_rusanov_kernel(
        dim=2, patch_size=4, halo_size=1, n_real=5, n_aux=5, n_patches=3
    )
    Q0 = positive_random_init(kb.item_shape("Q"), seed=7)
    got = np.asarray(JAXPrinter(kb).build()(Q0, 0.02))
    want = run_oracle(kb, Q0, 0.02, np_impls=euler_numpy.impls(dim=2, n_real=5))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)


def test_rusanov_3d_jax_matches_oracle():
    kb = build_rusanov_kernel(dim=3, patch_size=3, halo_size=1, n_real=5, n_aux=0)
    shape = kb.item_shape("Q")
    rng = np.random.default_rng(3)
    Q0 = rng.uniform(0.1, 1.0, size=shape)
    Q0[..., 0] += 1.0
    Q0[..., 4] += 5.0
    got = np.asarray(JAXPrinter(kb).build()(Q0, 0.01))
    want = run_oracle(kb, Q0, 0.01, np_impls=euler_numpy.impls(dim=3, n_real=5))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)


def test_halo_untouched_by_writeback():
    """Only the interior of Q is written back (golden kernel loop 10)."""
    kb = build_rusanov_kernel()
    Q0 = positive_random_init(kb.item_shape("Q"), seed=1)
    out = np.asarray(JAXPrinter(kb).build()(Q0, 0.01))
    h = kb.config.halo_size
    # halo ring identical to input
    assert np.array_equal(out[:, :h, :, :], Q0[:, :h, :, :])
    assert np.array_equal(out[:, -h:, :, :], Q0[:, -h:, :, :])
    assert np.array_equal(out[:, :, :h, :], Q0[:, :, :h, :])
    assert np.array_equal(out[:, :, -h:, :], Q0[:, :, -h:, :])
    # interior actually changed
    assert not np.array_equal(out[:, h:-h, h:-h, :5], Q0[:, h:-h, h:-h, :5])


def test_jit_and_donation():
    import jax

    kb = build_rusanov_kernel()
    Q0 = positive_random_init(kb.item_shape("Q"), seed=2)
    printer = JAXPrinter(kb)
    eager = np.asarray(printer.build()(Q0, 0.01))
    jitted = printer.jit(donate_input=False)
    np.testing.assert_allclose(np.asarray(jitted(Q0, 0.01)), eager, atol=0)


def test_jaxpr_text_renders():
    kb = build_rusanov_kernel()
    text = JAXPrinter(kb).jaxpr_text
    assert "lambda" in text and len(text) > 100


def test_per_cell_and_vectorized_physics_agree():
    """Both jax_impl contracts (per-cell vmapped, batch-native) must produce
    identical kernels."""
    Q0 = positive_random_init((2, 6, 6, 10), seed=11)
    out_v = np.asarray(
        JAXPrinter(build_rusanov_kernel(n_patches=2, vectorized=True)).build()(Q0, 0.01)
    )
    out_c = np.asarray(
        JAXPrinter(build_rusanov_kernel(n_patches=2, vectorized=False)).build()(Q0, 0.01)
    )
    np.testing.assert_allclose(out_v, out_c, rtol=0, atol=1e-14)


def test_parent_consts_via_params():
    """ExaHyPE2-style parent-qualified members resolve through params= on the
    JAX backend (arrays for parented items, scalars for parented consts)."""
    import sympy

    from exahype_jax import KernelBuilder

    kb = KernelBuilder(dim=2, patch_size=4, halo_size=1, n_real=2, n_aux=0)
    Data = kb.item("patchData", in_type="::exahype2::CellData&")
    Q = kb.item("QOut", parent=Data)
    Qc = kb.item("QIn", parent=Data)
    dt = kb.const("dt", parent=Data)
    kb.single(Qc[0], Q[0])
    kb.directional(Qc[0], Qc[0] + dt * (Q[-1] - Q[1]))
    kb.single(Q[0], Qc[0])

    import jax.numpy as jnp

    fn = JAXPrinter(kb).build()
    rng = np.random.default_rng(0)
    # 'patchData' is the declared primary input but carries no data of its
    # own; the member arrays come through params.
    qout = rng.normal(size=kb.item_shape("QOut"))
    dummy = np.zeros(kb.item_shape("patchData"))
    out_env = fn(
        dummy,
        params={"QOut": jnp.asarray(qout), "QIn": jnp.zeros_like(qout), "dt": 0.01},
    )
    # The primary returned unchanged; the real check is that lowering with
    # parent-qualified symbols traces without error and is finite.
    assert np.isfinite(np.asarray(out_env)).all()
