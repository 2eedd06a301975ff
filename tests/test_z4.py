"""First-order Z4 (dynamic spacetime GR): differential-oracle + AwA tests.

The tensor algebra in ``models/z4.py`` is verified against a fully
INDEPENDENT implementation: analytic metric fields differentiated with
nested ``jax.jacfwd`` — Christoffels from autodiff of γ(x), Ricci from
autodiff of the Christoffel function, covariant derivatives from autodiff
of the field functions.  No first-order D/A variables appear anywhere in
the oracle; on consistent data (D = ½∂γ, A = ∂lnα exactly, also built by
autodiff) the two must agree to rounding.  Then the standard
Apples-with-Apples anchors: flat-space stationarity, gauge-wave
convergence at the scheme order, robust stability, ADM constraint
monitoring.  (Reference parity: the downstream ExaHyPE astrophysics
family's flagship is a first-order Z4-family system run as pure NCP +
source by ADER-DG; the reference repo itself bundles only Euler,
``Unit test/Functions.cpp:9-62``.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from exahype_jax.models import z4
from exahype_jax.models.z4 import (
    N_VARS,
    adm_constraints,
    flat_state_values,
    gauge_wave_state,
    gauge_wave_values,
    inv3,
    make_z4_solver,
    pack,
    solver_constraints,
    sym_to_mat,
    z4_rhs,
    z4_system,
)

# ---------------------------------------------------------------- fields
# A smooth random analytic spacetime-slice family (NOT a solution — the
# RHS evaluation must be exact for ANY field configuration).


def _trig(coef, x):
    # coef: [n, 7] rows of (amplitude, kx, ky, kz, phase-ish extras)
    a, kx, ky, kz, p = coef[:, 0], coef[:, 1], coef[:, 2], coef[:, 3], coef[:, 4]
    return jnp.sum(a * jnp.sin(kx * x[0] + ky * x[1] + kz * x[2] + p))


def _make_fields(seed=0, eps=0.08):
    rng = np.random.default_rng(seed)

    def coefs():
        c = rng.uniform(-1.0, 1.0, size=(2, 5))
        c[:, 0] *= eps
        c[:, 1:4] = rng.integers(-2, 3, size=(2, 3))  # periodic-ish modes
        return jnp.asarray(c)

    c_al = coefs()
    c_g = [[coefs() for _ in range(3)] for _ in range(3)]
    c_K = [[coefs() for _ in range(3)] for _ in range(3)]
    c_th = coefs()
    c_Z = [coefs() for _ in range(3)]

    def alpha(x):
        return 1.0 + _trig(c_al, x)

    def gam(x):
        rows = []
        for i in range(3):
            row = []
            for j in range(3):
                ii, jj = min(i, j), max(i, j)
                row.append(
                    (1.0 if i == j else 0.0) + _trig(c_g[ii][jj], x)
                )
            rows.append(jnp.stack(row))
        return jnp.stack(rows)

    def K(x):
        rows = []
        for i in range(3):
            row = []
            for j in range(3):
                ii, jj = min(i, j), max(i, j)
                row.append(_trig(c_K[ii][jj], x))
            rows.append(jnp.stack(row))
        return jnp.stack(rows)

    def theta(x):
        return _trig(c_th, x)

    def Z(x):
        return jnp.stack([_trig(c_Z[i], x) for i in range(3)])

    return alpha, gam, K, theta, Z


def _first_order_state(alpha, gam, K, theta, Z):
    """x → the 38-component first-order state, all derivatives by autodiff."""

    def state(x):
        A = jax.jacfwd(lambda y: jnp.log(alpha(y)))(x)  # A_k = ∂_k ln α
        dg = jax.jacfwd(gam)(x)  # [i, j, k] = ∂_k γ_ij
        D = 0.5 * jnp.transpose(dg, (2, 0, 1))  # D_kij
        return pack(
            alpha(x), gam(x), K(x), theta(x), Z(x), A, D
        )

    return state


def _oracle_rhs(alpha, gam, K, theta, Z, *, slicing, f, m, kappa1, kappa2):
    """x → ∂_t Q computed with ONLY autodiff of the analytic fields
    (second-order formulation; independent of models/z4.py's algebra)."""

    def gi_fn(x):
        return jnp.linalg.inv(gam(x))

    def christoffel(x):
        gi = gi_fn(x)
        dg = jax.jacfwd(gam)(x)  # ∂_k γ_ij at [i, j, k]
        # Γ^k_ij = ½ γ^kl (∂_i γ_jl + ∂_j γ_il − ∂_l γ_ij)
        t = (
            jnp.einsum("jli->lij", dg)
            + jnp.einsum("ilj->lij", dg)
            - jnp.einsum("ijl->lij", dg)
        )
        return 0.5 * jnp.einsum("kl,lij->kij", gi, t)

    def ricci(x):
        dG = jax.jacfwd(christoffel)(x)  # ∂_l Γ^k_ij at [k, i, j, l]
        G = christoffel(x)
        return (
            jnp.einsum("kijk->ij", dG)
            - jnp.einsum("kkji->ij", dG)
            + jnp.einsum("kkl,lij->ij", G, G)
            - jnp.einsum("kli,lkj->ij", G, G)
        )

    def g_of(al):
        return f if slicing == "harmonic" else 2.0 / al

    def rhs(x):
        al = alpha(x)
        g = gam(x)
        gi = gi_fn(x)
        Km = K(x)
        th = theta(x)
        Zv = Z(x)
        G = christoffel(x)
        R = ricci(x)
        R = 0.5 * (R + R.T)

        dal = jax.jacfwd(alpha)(x)
        hess_al = jax.jacfwd(jax.jacfwd(alpha))(x)
        covdd_al = 0.5 * (hess_al + hess_al.T) - jnp.einsum(
            "kij,k->ij", G, dal
        )
        dZ = jax.jacfwd(Z)(x)  # [i, k] = ∂_k Z_i
        covZ = dZ.T - jnp.einsum("kij,k->ij", G, Zv)  # ∇_i Z_j
        trK = jnp.einsum("ij,ij->", gi, Km)
        Kup = gi @ Km @ gi
        K2 = jnp.einsum("ij,ij->", Km, Kup)
        KK = Km @ gi @ Km
        Kmix = jnp.einsum("jl,il->ij", gi, Km)  # K_i^j

        def trK_fn(y):
            return jnp.einsum(
                "ij,ij->", jnp.linalg.inv(gam(y)), K(y)
            )

        dtrK = jax.jacfwd(trK_fn)(x)
        dK = jax.jacfwd(K)(x)  # [i, j, k] = ∂_k K_ij
        divKi = (
            jnp.einsum("jl,ilj->i", gi, dK)
            - jnp.einsum("jl,mji,ml->i", gi, G, Km)
            - jnp.einsum("jl,mjl,im->i", gi, G, Km)
        )
        dth = jax.jacfwd(theta)(x)
        Rs = jnp.einsum("ij,ij->", gi, R)
        divZ = jnp.einsum("ij,ij->", gi, covZ)
        Zup = gi @ Zv

        r_al = -(al**2) * g_of(al) * (trK - m * th)
        r_g = -2.0 * al * Km
        r_K = (
            -covdd_al
            + al
            * (R + covZ + covZ.T - 2.0 * KK + (trK - 2.0 * th) * Km)
            - kappa1 * (1.0 + kappa2) * al * th * g
        )
        r_th = (
            0.5 * al * (Rs + 2.0 * divZ + (trK - 2.0 * th) * trK - K2)
            - Zup @ dal
            - kappa1 * (2.0 + kappa2) * al * th
        )
        r_Z = (
            al * (divKi - dtrK + dth - 2.0 * (Kmix @ Zv))
            - th * dal
            - kappa1 * al * Zv
        )

        def gauge_scalar(y):
            a = alpha(y)
            return (
                a
                * g_of(a)
                * (
                    jnp.einsum("ij,ij->", jnp.linalg.inv(gam(y)), K(y))
                    - m * theta(y)
                )
            )

        r_A = -jax.jacfwd(gauge_scalar)(x)

        def aK(y):
            return alpha(y) * K(y)

        daK = jax.jacfwd(aK)(x)  # [i, j, k] = ∂_k (αK_ij)
        r_D = -jnp.transpose(daK, (2, 0, 1))
        return pack(r_al, r_g, r_K, r_th, r_Z, r_A, r_D)

    return rhs


@pytest.mark.parametrize(
    "slicing,f,kappa1,kappa2",
    [("harmonic", 1.0, 0.0, 0.0), ("harmonic", 0.75, 0.4, 0.1),
     ("1+log", 1.0, 0.2, 0.0)],
)
def test_rhs_matches_autodiff_oracle(slicing, f, kappa1, kappa2):
    """Every one of the 38 RHS components of the D/A-substituted
    first-order algebra equals the independent second-order autodiff
    oracle on random smooth fields."""
    m = 2.0
    alpha, gam, K, theta, Z = _make_fields(seed=3)
    state = _first_order_state(alpha, gam, K, theta, Z)
    oracle = _oracle_rhs(
        alpha, gam, K, theta, Z,
        slicing=slicing, f=f, m=m, kappa1=kappa1, kappa2=kappa2,
    )
    rng = np.random.default_rng(7)
    pts = jnp.asarray(rng.uniform(0.0, 1.0, size=(6, 3)))

    q = jax.vmap(state)(pts)  # [6, 38]
    dq3 = jax.vmap(jax.jacfwd(state))(pts)  # [6, 38, 3]
    dq3 = jnp.swapaxes(dq3, -1, -2)  # [6, 3, 38]
    got = z4_rhs(
        q, dq3, slicing=slicing, f=f, m=m, kappa1=kappa1, kappa2=kappa2
    )
    want = jax.vmap(oracle)(pts)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=0, atol=1e-11
    )


def test_flat_space_is_stationary():
    v = jnp.asarray(flat_state_values())[None, :]
    dq3 = jnp.zeros((1, 3, N_VARS))
    rhs = z4_rhs(v, dq3, kappa1=0.5, kappa2=0.3)
    np.testing.assert_allclose(np.asarray(rhs), 0.0, atol=1e-15)


def test_ncp_source_split_is_exact():
    """source − Σ_d ncp_d reproduces the full RHS (affinity check through
    the solver-contract callbacks, var axis in a non-trivial position)."""
    alpha, gam, K, theta, Z = _make_fields(seed=11)
    state = _first_order_state(alpha, gam, K, theta, Z)
    rng = np.random.default_rng(1)
    pts = jnp.asarray(rng.uniform(0.0, 1.0, size=(4, 3)))
    q = jax.vmap(state)(pts)
    dq3 = jnp.swapaxes(jax.vmap(jax.jacfwd(state))(pts), -1, -2)

    kw = dict(slicing="harmonic", f=1.0, m=2.0, kappa1=0.3, kappa2=0.2)
    flux, eig, ncp, source = z4_system(**kw)
    Qv = jnp.moveaxis(q, -1, 0)  # var axis FIRST
    total = source(Qv, 0)
    for d in range(3):
        total = total - ncp(Qv, jnp.moveaxis(dq3[:, d, :], -1, 0), d, 0)
    want = z4_rhs(q, dq3, **kw)
    np.testing.assert_allclose(
        np.asarray(jnp.moveaxis(total, 0, -1)), np.asarray(want), atol=1e-12
    )
    assert np.all(np.asarray(flux(Qv, 0, 0)) == 0.0)
    lam = np.asarray(eig(Qv, 0, 0))
    assert lam.shape == (4,) and np.all(lam > 0.9)  # ~ α√γ^xx near flat


def test_gauge_wave_transport_identity():
    """On the exact gauge wave every field depends on (x − t), so the full
    RHS must equal −∂_x Q — a dynamic end-to-end check of the NCP+source
    algebra on real initial data (autodiff x-derivative of a jnp
    re-implementation of the exact solution)."""
    a, L = 0.05, 1.0
    k = 2.0 * np.pi / L

    def qx(x):
        s, c = jnp.sin(k * x), jnp.cos(k * x)
        H = 1.0 - a * s
        dH = -a * k * c
        al = jnp.sqrt(H)
        out = jnp.zeros(N_VARS, dtype=x.dtype)
        out = out.at[0].set(al)
        out = out.at[1].set(H)
        out = out.at[4].set(1.0)
        out = out.at[6].set(1.0)
        out = out.at[7].set(dH / (2.0 * al))
        out = out.at[17].set(dH / (2.0 * H))
        out = out.at[20].set(0.5 * dH)
        return out

    xs = jnp.asarray(np.linspace(0.05, 0.95, 9))
    q = jax.vmap(qx)(xs)
    # numeric consistency with the numpy initial-data builder
    np.testing.assert_allclose(
        np.asarray(q), gauge_wave_values(np.asarray(xs), 0.0, a, L),
        atol=1e-14,
    )
    dqdx = jax.vmap(jax.jacfwd(qx))(xs)  # [n, 38]
    dq3 = jnp.zeros((xs.shape[0], 3, N_VARS)).at[:, 0, :].set(dqdx)
    rhs = z4_rhs(q, dq3, slicing="harmonic", f=1.0, m=2.0)
    np.testing.assert_allclose(
        np.asarray(rhs), np.asarray(-dqdx), atol=1e-11
    )


def _l2_error(solver, u, u_exact):
    w = solver.ops.weights
    err2 = np.asarray((u - u_exact) ** 2)
    for d in reversed(range(solver.dim)):
        err2 = np.tensordot(w, err2, axes=([0], [solver.node_axis(d)]))
    return float(np.sqrt(err2.sum() * solver.dx**solver.dim))


def test_gauge_wave_convergence():
    """The evolved gauge wave converges to the exact translated solution
    at better than the scheme order (ADER-DG p2 → ≥ 3rd order)."""
    t_end = 0.08
    errors = []
    for cells in (4, 8):
        solver = make_z4_solver(
            dim=2, order=2, grid_shape=(cells, 2), dx=1.0 / cells
        )
        Q0 = gauge_wave_state(solver, t=0.0, amplitude=0.01)
        n_steps = 4 * cells
        Q = solver.run(Q0, n_steps, dt=t_end / n_steps)
        exact = gauge_wave_state(solver, t=t_end, amplitude=0.01)
        errors.append(_l2_error(solver, Q, exact))
    rate = np.log2(errors[0] / errors[1])
    assert rate > 2.5, f"gauge-wave rate {rate:.2f}, errors {errors}"


def test_gauge_wave_constraints_preserved_to_rounding():
    """ADM constraints on evolved gauge-wave data stay at ROUNDING level.

    For the gauge wave the constraints vanish algebraically for ANY
    single-component (γ_xx, K_xx, A_x, D_xxx) nodal data — rank-1 K makes
    K² − K_ij K^ij cancel identically, and a metric varying along one axis
    keeps R_ij ≡ 0 term by term — so truncation error cannot show up in
    (H, M) unless the evolution breaks that sparsity structure.  The
    meaningful check is therefore machine-eps preservation (a convergence
    ratio here would compare noise with noise)."""
    t_end = 0.05
    for cells in (4, 8):
        solver = make_z4_solver(
            dim=2, order=2, grid_shape=(cells, 2), dx=1.0 / cells
        )
        Q0 = gauge_wave_state(solver, amplitude=0.01)
        n_steps = 2 * cells
        Q = solver.run(Q0, n_steps, dt=t_end / n_steps)
        H, M = solver_constraints(solver, Q)
        worst = max(float(jnp.abs(H).max()), float(jnp.abs(M).max()))
        assert worst < 1e-12, f"constraint sparsity broken at {cells}: {worst}"


def test_robust_stability():
    """AwA robust stability: flat space + random noise stays bounded over
    an evolution, with and without constraint damping."""

    def run(kappa1):
        solver = make_z4_solver(
            dim=2, order=2, grid_shape=(4, 4), dx=0.25,
            kappa1=kappa1, kappa2=0.0,
        )
        rng = np.random.default_rng(0)
        noise = 1e-6 * rng.standard_normal(solver.state_shape)
        Q0 = z4.z4_flat_state(solver) + jnp.asarray(noise)
        Q = solver.run(Q0, 40, dt=2e-3)
        return float(jnp.abs(Q - z4.z4_flat_state(solver)).max())

    assert run(kappa1=0.0) < 1e-4, "noise blew up undamped"
    assert run(kappa1=1.0) < 1e-4, "noise blew up damped"


def test_theta_damping_is_exact_exponential():
    """κ₁ damping at the sharpest anchor: a uniform Θ perturbation on flat
    space obeys ∂_t Θ = −κ₁(2+κ₂) α Θ with every other right-hand-side
    term O(Θ²) (random-noise norm comparisons are mushy — the evolution
    re-feeds Θ/Z from the ADM-violating part of the noise — but THIS mode
    is a closed ODE).  The evolved Θ must match Θ₀·exp(−κ₁(2+κ₂)t) to
    the feedback order."""
    kappa1, kappa2, t_end = 1.5, 0.5, 0.3
    solver = make_z4_solver(
        dim=2, order=2, grid_shape=(4, 2), dx=0.25,
        kappa1=kappa1, kappa2=kappa2,
    )
    theta0 = 1e-6
    qv = jnp.moveaxis(z4.z4_flat_state(solver), solver.var_axis, -1)
    Q0 = jnp.moveaxis(qv.at[..., 13].set(theta0), -1, solver.var_axis)
    n_steps = 60
    Q = solver.run(Q0, n_steps, dt=t_end / n_steps)
    th = jnp.moveaxis(Q, solver.var_axis, -1)[..., 13]
    want = theta0 * np.exp(-kappa1 * (2.0 + kappa2) * t_end)
    np.testing.assert_allclose(
        np.asarray(th), want, rtol=1e-4,
        err_msg="uniform-Θ mode does not decay at the κ₁(2+κ₂) rate",
    )


def test_constraint_monitor_flat_and_exact_data():
    """solver_constraints: identically zero on flat space; at the
    interpolation level on exact gauge-wave data."""
    solver = make_z4_solver(dim=2, order=3, grid_shape=(6, 2), dx=1.0 / 6)
    H, M = solver_constraints(solver, z4.z4_flat_state(solver))
    np.testing.assert_allclose(np.asarray(H), 0.0, atol=1e-13)
    np.testing.assert_allclose(np.asarray(M), 0.0, atol=1e-13)
    Qw = gauge_wave_state(solver, amplitude=0.01)
    Hw, Mw = solver_constraints(solver, Qw)
    assert float(jnp.abs(Hw).max()) < 5e-3
    assert float(jnp.abs(Mw).max()) < 5e-3


def test_adm_constraints_vanish_on_constraint_satisfying_data():
    """adm_constraints is itself validated: on a time-symmetric conformally
    flat slice (K = 0, γ = ψ⁴δ with ∇²ψ = 0 — here the exact harmonic
    ψ = 1 + c·x for which flat-Laplacian harmonicity gives H = R = 0 ...
    actually use ψ linear ⇒ R ≠ 0; instead verify H against the known
    closed form R = −8ψ⁻⁵∇²ψ for conformally flat γ = ψ⁴δ."""

    def psi(x):
        return 1.0 + 0.1 * jnp.sin(x[0]) * jnp.sin(x[1]) * jnp.sin(x[2])

    def state(x):
        p = psi(x)
        al = jnp.ones(())
        g = p**4 * jnp.eye(3)
        K = jnp.zeros((3, 3))
        A = jnp.zeros(3)
        dg = jax.jacfwd(lambda y: psi(y) ** 4 * jnp.eye(3))(x)
        D = 0.5 * jnp.transpose(dg, (2, 0, 1))
        return pack(
            al, g, K, jnp.zeros(()), jnp.zeros(3), A, D
        )

    rng = np.random.default_rng(2)
    pts = jnp.asarray(rng.uniform(0.2, 0.8, size=(5, 3)))
    q = jax.vmap(state)(pts)
    dq3 = jnp.swapaxes(jax.vmap(jax.jacfwd(state))(pts), -1, -2)
    H, M = adm_constraints(q, dq3)

    def lap_psi(x):
        return jnp.trace(jax.jacfwd(jax.jacfwd(psi))(x))

    want_H = jax.vmap(
        lambda x: -8.0 * psi(x) ** -5 * lap_psi(x)
    )(pts)
    np.testing.assert_allclose(np.asarray(H), np.asarray(want_H), atol=1e-11)
    np.testing.assert_allclose(np.asarray(M), 0.0, atol=1e-12)


def test_inv3_and_sym_round_trip():
    rng = np.random.default_rng(4)
    s = jnp.asarray(rng.standard_normal((7, 6)))
    m = sym_to_mat(s)
    assert np.allclose(np.asarray(m), np.asarray(jnp.swapaxes(m, -1, -2)))
    spd = m @ jnp.swapaxes(m, -1, -2) + 3.0 * jnp.eye(3)
    inv, det = inv3(spd)
    np.testing.assert_allclose(
        np.asarray(inv @ spd), np.broadcast_to(np.eye(3), (7, 3, 3)),
        atol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(det), np.linalg.det(np.asarray(spd)), rtol=1e-12
    )


# ------------------------------------------------- production-stack tests


def _noisy_gauge_wave(solver, seed=3, eps=1e-4):
    rng = np.random.default_rng(seed)
    Q0 = gauge_wave_state(solver, amplitude=0.01)
    return Q0 + eps * jnp.asarray(rng.standard_normal(solver.state_shape))


def test_z4_sharded_matches_single_device():
    """GSPMD-sharded Z4 step (grid axis 0 over the 8-device mesh) matches
    the single-device step to 1e-12 — the Einstein equations partition
    through the same collective machinery as every matter model."""
    from jax.sharding import NamedSharding, PartitionSpec

    from exahype_jax.parallel import make_mesh

    solver = make_z4_solver(dim=2, order=2, grid_shape=(8, 2), dx=0.125)
    Q0 = _noisy_gauge_wave(solver, seed=5)
    dt = 1e-3
    ref = np.asarray(jax.jit(lambda q: solver.step(q, dt))(Q0))

    mesh = make_mesh(8)
    spec = [None] * len(solver.state_shape)
    spec[solver.grid_axis(0)] = "patches"
    sharding = NamedSharding(mesh, PartitionSpec(*spec))
    qs = jax.device_put(Q0, sharding)
    got = np.asarray(
        jax.jit(lambda q: solver.step(q, dt),
                in_shardings=(sharding,), out_shardings=sharding)(qs)
    )
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


# ------------------------------------------------------------ shift sector

from exahype_jax.models.z4 import (  # noqa: E402
    _AL,
    _BB,
    _BETA,
    _G,
    _K,
    _TH,
    _Z,
    N_VARS_SHIFT,
    make_z4_shift_solver,
    moving_gauge_wave_state,
    pack_shift,
    unpack,
    unpack_shift,
    z4_shift_rhs,
    z4_shift_system,
)


def _make_shift_fields(seed=0, eps=0.08):
    rng = np.random.default_rng(seed + 100)

    def coefs():
        c = rng.uniform(-1.0, 1.0, size=(2, 5))
        c[:, 0] *= eps
        c[:, 1:4] = rng.integers(-2, 3, size=(2, 3))
        return jnp.asarray(c)

    c_b = [coefs() for _ in range(3)]
    c_bb = [coefs() for _ in range(3)]

    def beta(x):
        return jnp.stack([_trig(c_b[i], x) for i in range(3)])

    def bvec(x):
        return jnp.stack([_trig(c_bb[i], x) for i in range(3)])

    return beta, bvec


def _first_order_shift_state(alpha, gam, K, theta, Z, beta, bvec):
    """x → the 53-component shifted state, reductions by autodiff."""

    def state(x):
        A = jax.jacfwd(lambda y: jnp.log(alpha(y)))(x)
        dg = jax.jacfwd(gam)(x)
        D = 0.5 * jnp.transpose(dg, (2, 0, 1))
        B = jax.jacfwd(beta)(x).T  # [k, i] = ∂_k β^i
        return pack_shift(
            (alpha(x), gam(x), K(x), theta(x), Z(x), A, D),
            beta(x), bvec(x), B,
        )

    return state


def _oracle_shift_rhs(alpha, gam, K, theta, Z, beta, bvec, *,
                      slicing, f, m, kappa1, kappa2, shift, f_b, eta):
    """x → ∂_t Q (53 vars) with ONLY autodiff of the analytic fields.

    The zero-shift parts reuse `_oracle_rhs`'s construction; the shift
    terms are independent autodiff Lie derivatives, and the reductions
    A_k, D_kij are obtained by differentiating the FULL primary
    right-hand sides (∂_t ln α, ∂_t γ_ij) — no first-order variables
    appear anywhere."""
    base = _oracle_rhs(alpha, gam, K, theta, Z, slicing=slicing, f=f,
                       m=m, kappa1=kappa1, kappa2=kappa2)

    def g_of(al):
        return f if slicing == "harmonic" else 2.0 / al

    def dt_ln_alpha(x):
        al = alpha(x)
        trK = jnp.einsum("ij,ij->", jnp.linalg.inv(gam(x)), K(x))
        dal = jax.jacfwd(alpha)(x)
        return -al * g_of(al) * (trK - m * theta(x)) + (
            beta(x) @ dal / al
        )

    def dt_gamma(x):
        dg = jax.jacfwd(gam)(x)  # [i, j, k]
        dbeta = jax.jacfwd(beta)(x)  # [i, k] = ∂_k β^i
        lie = (
            jnp.einsum("k,ijk->ij", beta(x), dg)
            + jnp.einsum("kj,ki->ij", gam(x), dbeta)
            + jnp.einsum("ik,kj->ij", gam(x), dbeta)
        )
        return -2.0 * alpha(x) * K(x) + lie

    def rhs(x):
        # base(x) is the packed zero-shift RHS; slice out its parts.
        r = base(x)
        r_al = r[_AL]
        r_g = sym_to_mat(r[_G])
        r_K = sym_to_mat(r[_K])
        r_th = r[_TH]
        r_Z = r[_Z]

        dal = jax.jacfwd(alpha)(x)
        dK = jax.jacfwd(K)(x)  # [i, j, k]
        dth = jax.jacfwd(theta)(x)
        dZ = jax.jacfwd(Z)(x)  # [i, k]
        dbeta = jax.jacfwd(beta)(x)  # [i, k] = ∂_k β^i
        bv = beta(x)

        r_al = r_al + bv @ dal
        r_g = dt_gamma(x) + 2.0 * alpha(x) * K(x) + r_g  # add Lie part only
        r_K = (
            r_K
            + jnp.einsum("k,ijk->ij", bv, dK)
            + jnp.einsum("kj,ki->ij", K(x), dbeta)
            + jnp.einsum("ik,kj->ij", K(x), dbeta)
        )
        r_th = r_th + bv @ dth
        r_Z = r_Z + jnp.einsum("k,ik->i", bv, dZ) + jnp.einsum(
            "k,ik->i", Z(x), dbeta.T
        )
        r_A = jax.jacfwd(dt_ln_alpha)(x)
        ddtg = jax.jacfwd(dt_gamma)(x)  # [i, j, k] = ∂_k (∂_t γ_ij)
        r_D = 0.5 * jnp.transpose(ddtg, (2, 0, 1))

        if shift == "frozen":
            r_beta = jnp.zeros(3)
            r_b = jnp.zeros(3)
            r_B = jnp.zeros((3, 3))
        else:
            r_beta = f_b * bvec(x)

            def Gamma_of_x(y):
                gi = jnp.linalg.inv(gam(y))
                dg = jax.jacfwd(gam)(y)
                D = 0.5 * jnp.transpose(dg, (2, 0, 1))
                Glow = (
                    jnp.einsum("ijl->lij", D)
                    + jnp.einsum("jil->lij", D)
                    - D
                )
                return jnp.einsum("il,jk,ljk->i", gi, gi, Glow)

            # ∂_t Γ^i by the chain rule along the true (∂_t γ, ∂_t D):
            # ∂_t D = ½ ∂_x(∂_t γ) from the full primary RHS.
            def gD(y):
                dgy = jax.jacfwd(gam)(y)
                return gam(y), 0.5 * jnp.transpose(dgy, (2, 0, 1))

            dt_D = 0.5 * jnp.transpose(jax.jacfwd(dt_gamma)(x), (2, 0, 1))

            def Gamma_of(gg, DD):
                gi = jnp.linalg.inv(gg)
                Glow = (
                    jnp.einsum("ijl->lij", DD)
                    + jnp.einsum("jil->lij", DD)
                    - DD
                )
                return jnp.einsum("il,jk,ljk->i", gi, gi, Glow)

            _, dtGam = jax.jvp(
                Gamma_of, gD(x), (dt_gamma(x), dt_D)
            )
            r_b = dtGam - eta * bvec(x)
            r_B = f_b * jax.jacfwd(bvec)(x).T  # [k, i] = ∂_k b^i
        return pack_shift(
            (r_al, r_g, r_K, r_th, r_Z, r_A, r_D), r_beta, r_b, r_B
        )

    return rhs


@pytest.mark.parametrize(
    "shift,kappa1", [("frozen", 0.0), ("frozen", 0.4), ("gamma_driver", 0.2)]
)
def test_shift_rhs_matches_autodiff_oracle(shift, kappa1):
    """Every one of the 53 RHS components of the shifted first-order
    algebra equals the independent autodiff oracle on random smooth
    fields (Lie terms, differentiated gauge terms, and the Gamma-driver
    chain rule included)."""
    slicing, f, m, kappa2, f_b, eta = "harmonic", 1.0, 2.0, 0.1, 0.75, 1.3
    alpha, gam, K, theta, Z = _make_fields(seed=5)
    beta, bvec = _make_shift_fields(seed=5)
    state = _first_order_shift_state(alpha, gam, K, theta, Z, beta, bvec)
    oracle = _oracle_shift_rhs(
        alpha, gam, K, theta, Z, beta, bvec, slicing=slicing, f=f, m=m,
        kappa1=kappa1, kappa2=kappa2, shift=shift, f_b=f_b, eta=eta,
    )
    rng = np.random.default_rng(11)
    pts = jnp.asarray(rng.uniform(0.0, 1.0, size=(5, 3)))
    q = jax.vmap(state)(pts)
    dq3 = jnp.swapaxes(jax.vmap(jax.jacfwd(state))(pts), -1, -2)
    got = z4_shift_rhs(
        q, dq3, slicing=slicing, f=f, m=m, kappa1=kappa1, kappa2=kappa2,
        shift=shift, f_b=f_b, eta=eta,
    )
    want = jax.vmap(oracle)(pts)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=0, atol=1e-11
    )


def test_shift_zero_reduction():
    """With β = b = B = 0 the 53-variable RHS reduces exactly to the
    validated 38-variable zero-shift RHS (identical core code path)."""
    alpha, gam, K, theta, Z = _make_fields(seed=6)
    state38 = _first_order_state(alpha, gam, K, theta, Z)
    rng = np.random.default_rng(3)
    pts = jnp.asarray(rng.uniform(0.0, 1.0, size=(4, 3)))
    q38 = jax.vmap(state38)(pts)
    dq38 = jnp.swapaxes(jax.vmap(jax.jacfwd(state38))(pts), -1, -2)
    pad = jnp.zeros(q38.shape[:-1] + (N_VARS_SHIFT - N_VARS,))
    q53 = jnp.concatenate([q38, pad], -1)
    dq53 = jnp.concatenate(
        [dq38, jnp.zeros(dq38.shape[:-1] + (N_VARS_SHIFT - N_VARS,))], -1
    )
    kw = dict(slicing="1+log", f=1.0, m=2.0, kappa1=0.3, kappa2=0.1)
    got = z4_shift_rhs(q53, dq53, shift="gamma_driver", **kw)
    want38 = z4_rhs(q38, dq38, **kw)
    np.testing.assert_allclose(
        np.asarray(got[..., :N_VARS]), np.asarray(want38), rtol=0, atol=0
    )
    # β stays zero; the driver's b picks up ∂_t Γ (nonzero on curved data).
    np.testing.assert_allclose(np.asarray(got[..., _BETA]), 0.0, atol=0)
    np.testing.assert_allclose(np.asarray(got[..., _BB]), 0.0, atol=0)


def test_shift_ncp_source_split_is_exact():
    """source − Σ_d B_d·∂_d Q reconstructs the full 53-var RHS exactly."""
    alpha, gam, K, theta, Z = _make_fields(seed=8)
    beta, bvec = _make_shift_fields(seed=8)
    state = _first_order_shift_state(alpha, gam, K, theta, Z, beta, bvec)
    flux, eig, ncp, source = z4_shift_system(shift="gamma_driver",
                                             kappa1=0.2, eta=0.7)
    rng = np.random.default_rng(4)
    pts = jnp.asarray(rng.uniform(0.0, 1.0, size=(4, 3)))
    q = jax.vmap(state)(pts)
    dq3 = jnp.swapaxes(jax.vmap(jax.jacfwd(state))(pts), -1, -2)
    want = z4_shift_rhs(q, dq3, shift="gamma_driver", kappa1=0.2, eta=0.7)
    got = source(q, va=1)
    for d in range(3):
        got = got - ncp(q, dq3[..., d, :], axis=d, va=1)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=0, atol=1e-11
    )


def test_flat_space_with_constant_shift_is_stationary():
    """Minkowski seen from uniformly-moving coordinates (γ = δ, α = 1,
    β = const) is stationary to rounding for BOTH shift modes."""
    for mode in ("frozen", "gamma_driver"):
        solver = make_z4_shift_solver(
            dim=2, order=2, grid_shape=(4, 2), dx=0.25, shift=mode,
        )
        qv = jnp.moveaxis(
            jnp.broadcast_to(
                jnp.concatenate(
                    [jnp.asarray(flat_state_values()),
                     jnp.asarray([0.3, -0.2, 0.1]),  # β
                     jnp.zeros(12)]
                ),
                solver.state_shape[: solver.var_axis]
                + solver.state_shape[solver.var_axis + 1 :]
                + (N_VARS_SHIFT,),
            ),
            -1, solver.var_axis,
        )
        out = solver.run(qv, 10, dt=5e-3)
        np.testing.assert_allclose(
            np.asarray(out), np.asarray(qv), rtol=0, atol=1e-13,
            err_msg=f"shifted flat space not stationary ({mode})",
        )


def test_moving_gauge_wave_convergence():
    """The gauge wave in moving coordinates (constant β^x = v — every
    shift/Lie term exercised) converges to the exact solution at better
    than the scheme order."""
    t_end, v = 0.08, 0.2
    errors = []
    for cells in (4, 8):
        solver = make_z4_shift_solver(
            dim=2, order=2, grid_shape=(cells, 2), dx=1.0 / cells,
            shift="frozen",
        )
        Q0 = moving_gauge_wave_state(solver, t=0.0, v=v)
        n_steps = 4 * cells
        Q = solver.run(Q0, n_steps, dt=t_end / n_steps)
        exact = moving_gauge_wave_state(solver, t=t_end, v=v)
        errors.append(_l2_error(solver, Q, exact))
    rate = np.log2(errors[0] / errors[1])
    assert rate > 2.5, f"moving gauge-wave rate {rate:.2f}, errors {errors}"


def test_gamma_driver_robust_stability():
    """Flat space + noise with the full Gamma-driver gauge active stays
    bounded (the driver adds the β/b/B sector to the AwA robust test)."""
    solver = make_z4_shift_solver(
        dim=2, order=2, grid_shape=(4, 4), dx=0.25,
        shift="gamma_driver", kappa1=0.5, eta=2.0,
    )
    rng = np.random.default_rng(1)
    noise = 1e-6 * rng.standard_normal(solver.state_shape)
    base = jnp.moveaxis(
        jnp.broadcast_to(
            jnp.concatenate(
                [jnp.asarray(flat_state_values()), jnp.zeros(15)]
            ),
            solver.state_shape[: solver.var_axis]
            + solver.state_shape[solver.var_axis + 1 :]
            + (N_VARS_SHIFT,),
        ),
        -1, solver.var_axis,
    )
    Q0 = base + jnp.asarray(noise)
    Q = solver.run(Q0, 40, dt=2e-3)
    assert float(jnp.abs(Q - base).max()) < 1e-4, "driver run blew up"


def test_fused_rhs_hook_matches_per_axis_path():
    """The rhs_all_fn performance hook (one tensor-algebra evaluation per
    Picard iteration instead of source + 2·dim NCP evaluations) is the
    identical algebra by affinity: full steps agree to rounding for both
    the 38-var and the 53-var (gamma-driver) systems."""
    solver_f = make_z4_solver(dim=2, order=2, grid_shape=(4, 2), dx=0.25,
                              kappa1=0.3, fused_rhs=True)
    solver_u = make_z4_solver(dim=2, order=2, grid_shape=(4, 2), dx=0.25,
                              kappa1=0.3, fused_rhs=False)
    assert solver_f.rhs_all_fn is not None and solver_u.rhs_all_fn is None
    Q0 = _noisy_gauge_wave(solver_f)
    a = np.asarray(solver_f.step(Q0, 1e-3))
    b = np.asarray(solver_u.step(Q0, 1e-3))
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-11)

    sf = make_z4_shift_solver(dim=2, order=2, grid_shape=(4, 2), dx=0.25,
                              shift="gamma_driver", fused_rhs=True)
    su = make_z4_shift_solver(dim=2, order=2, grid_shape=(4, 2), dx=0.25,
                              shift="gamma_driver", fused_rhs=False)
    Qs = moving_gauge_wave_state(sf, v=0.2)
    a = np.asarray(sf.step(Qs, 1e-3))
    b = np.asarray(su.step(Qs, 1e-3))
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-11)


def test_soa_rhs_matches_einsum_rhs():
    """The component-unrolled (SoA) twin reproduces the
    validated einsum RHS to rounding for every parameter family."""
    from exahype_jax.models.z4 import z4_rhs_soa

    rng = np.random.default_rng(12)
    q = rng.standard_normal((4, 5, N_VARS)) * 0.1
    q[..., 0] += 1.0
    q[..., 1] += 1.0
    q[..., 4] += 1.0
    q[..., 6] += 1.0
    dq3 = jnp.asarray(rng.standard_normal((4, 5, 3, N_VARS)) * 0.1)
    q = jnp.asarray(q)
    for kw in (dict(), dict(slicing="1+log", kappa1=0.3, kappa2=0.2),
               dict(f=0.7, m=1.5, kappa1=0.1)):
        a = np.asarray(z4_rhs(q, dq3, **kw))
        b = np.asarray(z4_rhs_soa(q, dq3, **kw))
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-13)


def test_shift_soa_rhs_matches_einsum_rhs():
    """The 53-variable SoA twin reproduces the einsum shift RHS to
    rounding — frozen and Gamma-driver modes (the driver's ∂_t Γ is an
    explicit chain rule vs the einsum path's jvp: same linear map, so
    agreement is rounding-level, not bitwise)."""
    from exahype_jax.models.z4 import z4_shift_rhs_soa

    rng = np.random.default_rng(21)
    q = rng.standard_normal((3, 4, N_VARS_SHIFT)) * 0.1
    q[..., 0] += 1.0
    q[..., 1] += 1.0
    q[..., 4] += 1.0
    q[..., 6] += 1.0
    dq3 = jnp.asarray(
        rng.standard_normal((3, 4, 3, N_VARS_SHIFT)) * 0.1
    )
    q = jnp.asarray(q)
    for kw in (
        dict(shift="frozen"),
        dict(shift="gamma_driver", kappa1=0.2, eta=0.7),
        dict(shift="gamma_driver", slicing="1+log", f_b=0.5, m=1.5),
    ):
        a = np.asarray(z4_shift_rhs(q, dq3, **kw))
        b = np.asarray(z4_shift_rhs_soa(q, dq3, **kw))
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-12)


def test_shift_soa_solver_step_matches_default():
    """A full shifted-Z4 ADER-DG step (Gamma-driver gauge) with
    ``impl='soa'`` matches the einsum default to rounding."""
    kw = dict(dim=2, order=2, grid_shape=(4, 2), dx=0.25,
              shift="gamma_driver", kappa1=0.2, eta=0.5)
    s_soa = make_z4_shift_solver(impl="soa", **kw)
    s_def = make_z4_shift_solver(**kw)
    Q0 = moving_gauge_wave_state(s_def, v=0.2)
    rngn = np.random.default_rng(17)
    Q0 = Q0 + 1e-4 * jnp.asarray(
        rngn.standard_normal(s_def.state_shape)
    )
    a = np.asarray(s_soa.step(Q0, 1e-3))
    b = np.asarray(s_def.step(Q0, 1e-3))
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-10)


def test_soa_solver_step_matches_default():
    """A full ADER-DG step with the SoA fused hook matches the default
    per-axis einsum path to rounding."""
    s_soa = make_z4_solver(dim=2, order=2, grid_shape=(4, 2), dx=0.25,
                           kappa1=0.2, fused_rhs="soa")
    s_def = make_z4_solver(dim=2, order=2, grid_shape=(4, 2), dx=0.25,
                           kappa1=0.2)
    Q0 = _noisy_gauge_wave(s_def, seed=9)
    a = np.asarray(s_soa.step(Q0, 1e-3))
    b = np.asarray(s_def.step(Q0, 1e-3))
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-11)
