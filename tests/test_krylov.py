"""Krylov layer tests: the Givens/MGS GMRES and the
equilibrated (two-sided Jacobi-scaled) direction solves that stand in for
MUMPS on nonsymmetric LVPP Jacobians (thermoforming QVI)."""

import jax.numpy as jnp
import numpy as np

from proximalgalerkin_tpu.la.krylov import gmres_givens, minres_info


def test_gmres_givens_dense():
    rng = np.random.default_rng(0)
    n = 200
    A = np.diag(np.linspace(1, 50, n)) \
        + 0.5 * rng.standard_normal((n, n)) / np.sqrt(n)
    x_true = rng.standard_normal(n)
    b = A @ x_true
    Aj = jnp.asarray(A)
    x = gmres_givens(lambda v: Aj @ v, jnp.asarray(b), tol=1e-12,
                     maxiter=2000, restart=40)
    assert np.linalg.norm(np.asarray(x) - x_true) < 1e-10

    d = jnp.asarray(1.0 / np.abs(np.diag(A)))
    x2 = gmres_givens(lambda v: Aj @ v, jnp.asarray(b), tol=1e-12,
                      maxiter=2000, restart=40, Minv_diag=d)
    assert np.linalg.norm(np.asarray(x2) - x_true) < 1e-10


def test_gmres_givens_restart_cycles():
    """Convergence must survive restarts (maxiter spanning many cycles)."""
    rng = np.random.default_rng(1)
    n = 120
    A = np.diag(np.linspace(0.5, 80, n))
    A[0, n - 1] = 5.0   # break normality
    b = rng.standard_normal(n)
    Aj = jnp.asarray(A)
    x = gmres_givens(lambda v: Aj @ v, jnp.asarray(b), tol=1e-11,
                     maxiter=1000, restart=15)
    assert np.linalg.norm(A @ np.asarray(x) - b) < 1e-9 * np.linalg.norm(b)


def test_minres_callable_preconditioner():
    """minres_info with a general SPD callable matches diagonal form."""
    rng = np.random.default_rng(2)
    n = 80
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    A = Q @ np.diag(np.concatenate([np.linspace(1, 10, n // 2),
                                    -np.linspace(1, 4, n - n // 2)])) @ Q.T
    b = rng.standard_normal(n)
    Aj = jnp.asarray(A)
    x1, _, _ = minres_info(lambda v: Aj @ v, jnp.asarray(b), tol=1e-12,
                           maxiter=1000)
    x2, _, _ = minres_info(lambda v: Aj @ v, jnp.asarray(b), tol=1e-12,
                           maxiter=1000, Minv=lambda v: 0.5 * v)
    assert np.linalg.norm(np.asarray(x1) - np.asarray(x2)) < 1e-8


def test_equilibrated_direction_thermoforming():
    """The equilibrated bicgstab/gmres_d direction matches host LU on the
    nonsymmetric thermoforming Jacobian (solve/nonlinear.py pc=jacobi)."""
    import scipy.sparse.linalg as spla
    from proximalgalerkin_tpu.mesh.generation import unit_square_mesh
    from proximalgalerkin_tpu.spaces import (DirichletBC, FunctionSpace,
                                             MixedSpace)
    from proximalgalerkin_tpu.assembly import VolumeForm
    from proximalgalerkin_tpu.solve import NonlinearProblem

    M, q_bound, beta, f = 12, 0.01, 1.0, 25.0
    mesh = unit_square_mesh(M, M)
    V = FunctionSpace.create(mesh, 1)
    space = MixedSpace([("u", V), ("T", V), ("psi", V)])

    def g(s):
        return jnp.clip(1.0 - s / q_bound, 0.0, 1.0)

    def residual(x, u, gu, c, gc, consts):
        alpha = consts["alpha"]
        expm = jnp.exp(-jnp.clip(u["psi"], -45.0, 45.0))
        mould = 1.0 - 2.0 * jnp.maximum(jnp.abs(x[0] - 0.5),
                                        jnp.abs(x[1] - 0.5))
        xi = jnp.sin(jnp.pi * x[0]) * jnp.sin(jnp.pi * x[1])
        return {"u": (u["psi"] - c["psi_prev"] - alpha * f,
                      alpha * gu["u"]),
                "T": (beta * u["T"] - g(expm), gu["T"]),
                "psi": (u["u"] + expm - (mould + xi * u["T"]), None)}

    form = VolumeForm(space, residual, 3, coeff_spaces={"psi_prev": V})
    bcs = [DirichletBC.from_marker("u", V, value=0.0)]
    p = NonlinearProblem(form, bcs, consts={"alpha": jnp.asarray(2.0**-6)})
    p.update(coeffs={"psi_prev": jnp.zeros(V.num_dofs)})
    x = jnp.asarray(p.set_bc(space.zeros()))
    F = p.residual(x)
    A = p.jacobian_scipy(x)
    dx_lu = spla.splu(A.tocsc()).solve(np.asarray(-F))

    for ksp in ("bicgstab", "gmres_d"):
        step = p.direction_solver(ksp, "jacobi", "ell")
        dx = np.asarray(step(x, F, p.coeffs, p.consts, 1e-11, 1e-13, 20000))
        rel = np.linalg.norm(dx - dx_lu) / np.linalg.norm(dx_lu)
        assert rel < 1e-7, (ksp, rel)


def test_fused_newton_matches_host_loop_obstacle_p2():
    """snes_fused (whole Newton while_loop in one XLA program,
    solve/nonlinear.py fused_newton) reproduces the host-loop driver:
    identical iteration counts and solutions over 3 LVPP outers."""
    import jax.numpy as jnp
    from proximalgalerkin_tpu.mesh import rectangle_mesh
    from proximalgalerkin_tpu.models.obstacle import setup_obstacle_problem
    from proximalgalerkin_tpu.solve.newton import NewtonSolver
    from proximalgalerkin_tpu.core.config import SolverOptions
    from proximalgalerkin_tpu.solve import AlphaScheduler

    mesh = rectangle_mesh(12, 12, p0=(-1.0, -1.0), p1=(1.0, 1.0))
    prob = setup_obstacle_problem(mesh, polynomial_order=2, verbose=False)
    p = prob.problem
    space = prob.space
    psi_sl, u_sl = space.slice_of("psi"), space.slice_of("u")
    base = {"snes_rtol": 1e-6, "snes_max_it": 50,
            "snes_linesearch_type": "none",
            "ksp_type": "minres", "pc_type": "jacobi", "mat_type": "ell",
            "ksp_rtol": 1e-11, "ksp_atol": 0.0, "ksp_max_it": 10000}
    sched = AlphaScheduler(scheme="double_exponential", alpha_max=1e5)

    def run(fused):
        sched.reset()
        opts = SolverOptions(dict(base, snes_fused=fused))
        x = jnp.zeros(space.num_dofs)
        x_k = x
        its = []
        for k in range(3):
            p.update(coeffs={"psi_k": x_k[psi_sl], "u_k": x_k[u_sl]},
                     consts={"alpha": jnp.asarray(sched.value(k))})
            r = NewtonSolver(p, opts).solve(x)
            assert r.converged, r.reason
            its.append(r.iterations)
            x = r.x
            x_k = x
        return its, np.asarray(x)

    its_h, xh = run(False)
    its_f, xf = run(True)
    assert its_h == its_f
    assert np.max(np.abs(xh - xf)) < 1e-9


def test_schur_negative_block_orientation_gradient_constraint():
    """Block-Schur must orient itself by the block0 diagonal sign: the
    gradient-constraint latent row (grad u - map) has a NEGATIVE block
    diagonal, where the unoriented Schur operator was negative definite
    and MINRES aborted at iteration 1 (la/schur.py)."""
    from proximalgalerkin_tpu.models.gradient_constraint import (
        setup_gradient_constraint)
    from proximalgalerkin_tpu.la.schur import make_schur_pc

    prob = setup_gradient_constraint(N=8, verbose=False)
    p = prob.solver.problem
    form = p.form
    for k in form.coeff_spaces:
        if k not in p.coeffs:
            p.coeffs[k] = jnp.zeros(form.coeff_spaces[k].num_dofs)
    x = jnp.asarray(p.set_bc(prob.space.zeros()))
    F = p.residual(x)
    ell = p.ell_matrix
    Ae = form.element_matrices(x, p.coeffs, p.consts)
    data = ell.assemble(Ae)
    N = prob.space.num_dofs
    m0 = np.zeros(N)
    m0[prob.space.slice_of("psi")] = 1.0
    bc1 = np.zeros(N)
    bci = np.asarray(p.bc_idx)
    bc1[bci] = 1.0 - m0[bci]
    Minv = make_schur_pc(ell, data, ell.arrays, jnp.asarray(m0),
                         jnp.asarray(bc1), cheb_steps=8)
    b = -F
    xs, rn, its = minres_info(lambda v: ell.spmv(data, v), b,
                              tol=1e-10, maxiter=5000, Minv=Minv)
    rel = float(jnp.linalg.norm(ell.spmv(data, xs) - b)
                / jnp.linalg.norm(b))
    assert rel < 1e-8
    assert 1 < int(its) < 5000


def test_mixed_precision_direction_obstacle():
    """ksp_precision=mixed (native-f32 equilibrated inner Krylov + f64
    refinement, solve/nonlinear.py) matches the f64 direction on a
    well-conditioned system to ~1e-8."""
    import scipy.sparse.linalg as spla
    from proximalgalerkin_tpu.mesh import rectangle_mesh
    from proximalgalerkin_tpu.models.obstacle import setup_obstacle_problem

    mesh = rectangle_mesh(10, 10, p0=(-1.0, -1.0), p1=(1.0, 1.0))
    prob = setup_obstacle_problem(mesh, polynomial_order=1, verbose=False)
    p = prob.problem
    space = prob.space
    p.update(coeffs={"psi_k": jnp.zeros(space.spaces["psi"].num_dofs),
                     "u_k": jnp.zeros(space.spaces["u"].num_dofs)})
    x = jnp.asarray(p.set_bc(space.zeros()))
    F = p.residual(x)
    A = p.jacobian_scipy(x)
    dx_lu = spla.splu(A.tocsc()).solve(np.asarray(-F))
    step = p.direction_solver("minres", "jacobi", "ell", precision="mixed")
    dx = np.asarray(step(x, F, p.coeffs, p.consts, 1e-10, 1e-12, 20000))
    rel = np.linalg.norm(dx - dx_lu) / np.linalg.norm(dx_lu)
    assert rel < 1e-7, rel
