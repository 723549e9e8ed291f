"""Example 04 (multiphase Cahn–Hilliard) tests: simplex constraint via
softmax, implicit Euler conservation, per-step warm start."""

import numpy as np
import pytest

from proximalgalerkin_tpu.models.multiphase import (
    initial_condition, solve_multiphase)
from proximalgalerkin_tpu.mesh import unit_square_mesh
from proximalgalerkin_tpu.spaces import FunctionSpace


@pytest.fixture(scope="module")
def solved():
    return solve_multiphase(N=10, M=10, tau0=1e-4, T=2e-4,
                            stopping_tol=1e-5, verbose=False)


def test_initial_condition_partition():
    mesh = unit_square_mesh(10, 10, diagonal="crossed")
    C = FunctionSpace.create(mesh, 1, value_size=4)
    u0 = initial_condition(C).reshape(-1, 4)
    assert np.allclose(u0.sum(axis=1), 1.0)
    assert set(np.unique(u0)) <= {0.0, 1.0}
    # all four species present
    assert all(u0[:, m].max() == 1.0 for m in range(4))


def test_simplex_constraint(solved):
    u = solved.u.reshape(-1, 4)
    # weak simplex enforcement: row sums ~ 1, values in [0,1] up to
    # projection error
    assert np.abs(u.sum(axis=1) - 1.0).max() < 1e-6
    assert u.min() > -0.15 and u.max() < 1.15


def test_mass_conserved(solved):
    m = [float(x[0]) for x in solved.mass_history]
    assert np.allclose(m, 1.0, atol=1e-10)


def test_iteration_bookkeeping(solved):
    assert len(solved.newton_iterations) == 2
    assert (solved.lvpp_iterations >= 1).all()
    assert (solved.newton_iterations >= solved.lvpp_iterations).all()


def test_fused_btlu_matches_default(solved):
    """The one-dispatch-per-Newton-solve path (snes_fused + LAGGED
    block-tridiagonal direct direction traced into the Newton while_loop,
    solve/nonlinear.py fused_newton_btlu) reproduces the host-loop
    trajectory — the record architecture that cuts both host dispatches
    and refactorizations for the 50^2x700-step record: f64 factor
    recursion, f32-cast apply, factor
    carried across Newton iterations and alpha-loop solves, refactoring
    only when stale-factor refinement misses ksp tolerance."""
    r2 = solve_multiphase(
        N=10, M=10, tau0=1e-4, T=2e-4, stopping_tol=1e-5, verbose=False,
        solver_options={"snes_fused": True, "ksp_type": "preonly",
                        "pc_type": "btlu", "ksp_rtol": 1e-9,
                        "pc_factor_dtype": "f64", "pc_factor_lag": 1})
    ref = np.asarray(solved.u)
    assert np.linalg.norm(np.asarray(r2.u) - ref) < 1e-8 * max(
        1.0, np.linalg.norm(ref))
    m = [float(x[0]) for x in r2.mass_history]
    assert np.allclose(m, 1.0, atol=1e-10)


def test_fused_btlu_cr_matches_default(solved):
    """fused Newton with the cyclic-reduction factor
    (pc_factor_algo='cr', la/blocktri.py bt_factor_cr) reproduces the
    host-loop trajectory — the log-depth batched factor that replaces
    the sequential Thomas scan on the device."""
    r2 = solve_multiphase(
        N=10, M=10, tau0=1e-4, T=2e-4, stopping_tol=1e-5, verbose=False,
        solver_options={"snes_fused": True, "ksp_type": "preonly",
                        "pc_type": "btlu", "ksp_rtol": 1e-9,
                        "pc_factor_dtype": "f64", "pc_factor_lag": 1,
                        "pc_factor_algo": "cr"})
    ref = np.asarray(solved.u)
    assert np.linalg.norm(np.asarray(r2.u) - ref) < 1e-8 * max(
        1.0, np.linalg.norm(ref))
    m = [float(x[0]) for x in r2.mass_history]
    assert np.allclose(m, 1.0, atol=1e-10)


def test_ell_split_matches_full_assembly():
    """The device EllSplit (closed-form softmax Jacobian
    d(-softmax)_m/dpsi_n = s_m s_n - delta_mn s_m scattered into the
    affine ELL data, models/multiphase.py _install_ell_split) must equal
    the full-jacfwd ELL assembly to roundoff — same quadrature, exact
    derivative, different factorization of the sum."""
    from proximalgalerkin_tpu.models import multiphase as mpmod
    from proximalgalerkin_tpu.solve import nonlinear as nlmod

    probs = []
    orig = nlmod.NonlinearProblem

    class Rec(orig):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            probs.append(self)

    mpmod.NonlinearProblem = Rec
    try:
        solve_multiphase(
            N=10, M=10, tau0=1e-4, T=1e-4, verbose=False,
            solver_options={"snes_fused": True, "ksp_type": "preonly",
                            "pc_type": "btlu", "ksp_rtol": 1e-9,
                            "pc_factor_dtype": "f64", "pc_factor_lag": 1})
    finally:
        mpmod.NonlinearProblem = orig
    p = probs[0]
    split = p.ell_split
    rng = np.random.default_rng(7)
    import jax.numpy as jnp
    x = jnp.asarray(rng.standard_normal(p.space.num_dofs) * 0.4)
    cc, kk = dict(p.coeffs), dict(p.consts)
    data_split = split.lin_data(cc, kk) + split.nl_core(x, cc, kk,
                                                        split.extra)
    Ae = p.form.element_matrices(x, cc, kk)
    data_full = p.ell_matrix.assemble(Ae)
    scale = max(1.0, float(jnp.abs(data_full).max()))
    assert float(jnp.abs(data_split - data_full).max()) < 1e-13 * scale


def test_split_jacobian_matches_direct_jacfwd():
    """The csr_data_override (cached affine CSR data + softmax-only
    rediff on the psi subspace) must reproduce the full-jacfwd Jacobian
    exactly (it is the same quadrature, just reassociated sums)."""
    from proximalgalerkin_tpu.models import multiphase as mpmod
    from proximalgalerkin_tpu.solve import nonlinear as nlmod

    probs = []
    orig = nlmod.NonlinearProblem

    class Rec(orig):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            probs.append(self)

    mpmod.NonlinearProblem = Rec
    try:
        solve_multiphase(N=10, M=10, tau0=1e-4, T=1e-4, verbose=False)
    finally:
        mpmod.NonlinearProblem = orig
    p = probs[0]
    rng = np.random.default_rng(3)
    import jax.numpy as jnp
    x = jnp.asarray(rng.standard_normal(p.space.num_dofs) * 0.4)
    A_split = p.jacobian_scipy(x)
    p.csr_data_override = None
    A_direct = p.jacobian_scipy(x)
    assert abs(A_split - A_direct).max() < 1e-14 * max(
        1.0, abs(A_direct).max())
