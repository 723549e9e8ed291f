"""P1 lumped-mass Schur fast path: cross-checks against the FD scheme.

On a uniform right-diagonal triangulation of the square, the P1 stiffness
matrix is exactly the 5-point stencil and the lumped mass is h^2, so the
lumped-P1 LVPP discretization coincides with the reference's FD scheme
(obstacle_finite_difference.jl) up to a row scaling — solutions must agree
to solver tolerance."""

import numpy as np
import pytest

from proximalgalerkin_tpu.mesh import rectangle_mesh
from proximalgalerkin_tpu.models.obstacle_p1 import P1ObstacleSolver
from proximalgalerkin_tpu.models.obstacle_fd import fd_obstacle_solve


def test_p1_lumped_matches_fd():
    N = 33
    mesh = rectangle_mesh(N - 1, N - 1, p0=(-1.0, -1.0), p1=(1.0, 1.0))
    s = P1ObstacleSolver(mesh, outer_tol=1e-9)
    res = s.solve()
    assert res.converged

    fd = fd_obstacle_solve(N, outer_tol=1e-9)

    # map FEM dofs -> grid
    pts = s.V.dof_points
    xs = np.linspace(-1, 1, N)
    ij = np.stack([np.searchsorted(xs, pts[:, 0] - 1e-12),
                   np.searchsorted(xs, pts[:, 1] - 1e-12)], axis=1)
    u_fem_grid = np.zeros((N, N))
    u_fem_grid[ij[:, 0], ij[:, 1]] = res.u
    assert np.abs(u_fem_grid - fd.u).max() < 1e-5


def test_p1_feasible_and_converged():
    mesh = rectangle_mesh(48, 48, p0=(-1.0, -1.0), p1=(1.0, 1.0))
    s = P1ObstacleSolver(mesh)
    res = s.solve()
    assert res.converged
    assert float((res.u - np.asarray(s.phi)).min()) > -1e-10
    assert res.newton_its < 60
    # boundary values zero
    assert np.abs(res.u[np.asarray(s.V.boundary_dofs())]).max() == 0.0


def test_p1_unstructured_diagonals():
    """Fast path works on crossed-diagonal (non-stencil) triangulations."""
    mesh = rectangle_mesh(24, 24, p0=(-1.0, -1.0), p1=(1.0, 1.0),
                          diagonal="crossed")
    s = P1ObstacleSolver(mesh)
    res = s.solve()
    assert res.converged
    assert float((res.u - np.asarray(s.phi)).min()) > -1e-10


def test_dia_matches_ell_on_crossed_mesh():
    """DIA and ELL storage are the same operator on crossed meshes.

    Regression for the round-1 bug where DIA was built from padded ELL
    triplets with last-write-wins assignment: the (row, row, 0.0) padding
    zeroed the stored diagonal of every interior cell-center node, so the
    solver silently converged to a wrong solution."""
    import jax.numpy as jnp
    mesh = rectangle_mesh(12, 12, p0=(-1.0, -1.0), p1=(1.0, 1.0),
                          diagonal="crossed")
    s_dia = P1ObstacleSolver(mesh)
    s_ell = P1ObstacleSolver(mesh, use_dia=False)
    assert s_dia.dia is not None and s_ell.dia is None

    # operator equivalence: spmv agrees on random vectors
    rng = np.random.default_rng(0)
    N = s_dia.N
    for _ in range(3):
        x = jnp.asarray(rng.normal(size=N))
        y_dia = np.asarray(s_dia.dia.spmv(x))
        y_ell = np.asarray(s_ell.ell.spmv(s_ell.A_data, x))
        np.testing.assert_allclose(y_dia, y_ell, rtol=1e-13, atol=1e-13)
    # diagonal intact (the bug zeroed 144/144 cell-center diagonals)
    d_dia = np.asarray(s_dia.dia.diagonal())
    d_ell = np.asarray(s_ell.ell.diagonal(s_ell.A_data))
    np.testing.assert_allclose(d_dia, d_ell, rtol=1e-13)
    assert (d_dia != 0.0).all()

    # and the two paths converge to the same solution
    r_dia = s_dia.solve()
    r_ell = s_ell.solve()
    assert r_dia.converged and r_ell.converged
    assert np.abs(r_dia.u - r_ell.u).max() < 1e-8


def test_cg_stall_guard():
    """The inner CG must not ride its full iteration budget when the
    requested tolerance sits below the dtype's noise floor: once the best
    residual is within 1e4x of the stop threshold and stops improving,
    it exits with the best iterate (observed 40k-iteration burns at
    1024^2 contact states before the guard)."""
    import jax.numpy as jnp
    from proximalgalerkin_tpu.models.obstacle_p1 import _cg, _CG_STALL_WINDOW

    rng = np.random.default_rng(5)
    n = 400
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    lam = np.linspace(1.0, 1e4, n)
    A64 = (Q * lam) @ Q.T
    A = jnp.asarray(A64, jnp.float32)
    b = jnp.asarray(rng.normal(size=n), jnp.float32)
    # tol far below f32 noise floor at condition 1e4 -> unattainable
    x, its = _cg(lambda v: A @ v, b, jnp.ones_like(b), 1e-12, 100_000)
    assert int(its) < 10_000, int(its)   # guard fired, not maxiter
    # and the returned iterate is still an accurate solve (f32-limited)
    x_exact = np.linalg.solve(A64, np.asarray(b, np.float64))
    rel = np.linalg.norm(np.asarray(x, np.float64) - x_exact) / \
        np.linalg.norm(x_exact)
    assert rel < 1e-4, rel

    # a comfortably reachable tolerance still converges normally
    x2, its2 = _cg(lambda v: A @ v, b, jnp.ones_like(b), 1e-3, 100_000)
    r2 = np.asarray(b) - np.asarray(A) @ np.asarray(x2)
    assert np.linalg.norm(r2) <= 1.1e-3 * np.linalg.norm(np.asarray(b))
    assert int(its2) < int(its)   # converged before any stall exit


def test_fused_solve_matches_loop():
    mesh = rectangle_mesh(32, 32, p0=(-1.0, -1.0), p1=(1.0, 1.0))
    s = P1ObstacleSolver(mesh, mixed_precision=True)
    a = s.solve()
    b = s.solve_fused()
    assert b.converged and a.converged
    assert b.outer_iterations == a.outer_iterations
    assert b.newton_its == a.newton_its
    assert np.abs(a.u - b.u).max() == 0.0


def test_mg_pc_matches_jacobi():
    """pc='mg' (lattice V-cycle PCG) must reproduce the Jacobi-CG
    solution while cutting inner iterations (~3x at n=32, h-independent
    at scale)."""
    import numpy as np
    from proximalgalerkin_tpu.mesh import rectangle_mesh
    from proximalgalerkin_tpu.models.obstacle_p1 import P1ObstacleSolver

    mesh = rectangle_mesh(32, 32, p0=(-1.0, -1.0), p1=(1.0, 1.0))
    r_j = P1ObstacleSolver(mesh, pc="jacobi").solve(max_outer=100)
    r_m = P1ObstacleSolver(mesh, pc="mg").solve(max_outer=100)
    assert r_m.converged
    assert np.linalg.norm(r_m.u - r_j.u) < 1e-7 * np.linalg.norm(r_j.u)
    assert r_m.cg_its_total < r_j.cg_its_total


def test_mg_pc_mixed_precision():
    import numpy as np
    from proximalgalerkin_tpu.mesh import rectangle_mesh
    from proximalgalerkin_tpu.models.obstacle_p1 import P1ObstacleSolver

    mesh = rectangle_mesh(32, 32, p0=(-1.0, -1.0), p1=(1.0, 1.0))
    r_j = P1ObstacleSolver(mesh, pc="jacobi").solve(max_outer=100)
    r_m = P1ObstacleSolver(mesh, pc="mg",
                           mixed_precision=True).solve(max_outer=100)
    assert r_m.converged
    assert np.linalg.norm(r_m.u - r_j.u) < 1e-6 * np.linalg.norm(r_j.u)


def test_ew_forcing_matches_fixed_solution():
    """cg_forcing="ew" (inexact-Newton inner tolerances) must converge to
    the same solution as the default fixed-tolerance scheme. Kept as an
    option only: measured at 64^2/128^2, the CG savings are outweighed by
    outer-iteration inflation."""
    import numpy as np
    from proximalgalerkin_tpu.mesh import rectangle_mesh
    from proximalgalerkin_tpu.models.obstacle_p1 import P1ObstacleSolver

    mesh = rectangle_mesh(32, 32, p0=(-1.0, -1.0), p1=(1.0, 1.0))
    a = P1ObstacleSolver(mesh, mixed_precision=True).solve()
    b = P1ObstacleSolver(mesh, mixed_precision=True,
                         cg_forcing="ew").solve()
    assert a.converged and b.converged
    assert float(np.abs(a.u - b.u).max()) < 1e-8
