"""Example 01 — the obstacle problem via proximal Galerkin (LVPP).

Device-native rebuild of examples/01_obstacle_problem/obstacle_pg.py: mixed
(u, psi) Lagrange spaces of equal order, pointwise bound u >= phi enforced by
the exp latent map, alpha schedules constant/double_exponential/geometric,
and the full observable set (energy, complementarity, primal/dual
feasibility, H1/L2 increments; obstacle_pg.py:145-152) recorded per outer
iteration.

Residual (obstacle_pg.py:116-124):
  F((u,psi); v,w) = alpha <grad u, grad v> + <psi, v> - <psi_k, v>
                  - alpha <f, v> + <u, w> - <exp(psi) + phi, w>
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping, Optional

import jax.numpy as jnp
import numpy as np

from ..assembly import VolumeForm
from ..core.config import SolverOptions
from ..mesh.mesh import Mesh
from ..solve import AlphaScheduler, LVPPSolver, LVPPResult, NonlinearProblem
from ..spaces import DirichletBC, FunctionSpace, MixedSpace


def spherical_cap_obstacle(x: np.ndarray) -> np.ndarray:
    """The reference's obstacle: a spherical cap of radius r0 = 0.5 blended
    into its tangent cone (obstacle_pg.py:92-104; same formula in the FD
    oracle obstacle_finite_difference.jl:13-27). x has shape (gdim, npts)."""
    r = np.sqrt(x[0] ** 2 + x[1] ** 2)
    r0, beta = 0.5, 0.9
    b = r0 * beta
    tmp = np.sqrt(r0**2 - b**2)
    B = tmp + b * b / tmp
    C = -b / tmp
    outside = B + r * C
    inside = np.sqrt(np.maximum(r0**2 - np.minimum(r, r0) ** 2, 0.0))
    return np.where(r > b, outside, inside)


@dataclass
class ObstacleProblem:
    space: MixedSpace
    form: VolumeForm
    problem: NonlinearProblem
    solver: LVPPSolver
    V: FunctionSpace

    def solve(self, x0=None) -> LVPPResult:
        x0 = self.space.zeros() if x0 is None else x0
        return self.solver.solve(x0)

    def u(self, result: LVPPResult) -> np.ndarray:
        return np.asarray(result.x[self.space.slice_of("u")])


def setup_obstacle_problem(
    mesh: Mesh,
    polynomial_order: int = 1,
    alpha_scheme: str = "double_exponential",
    alpha_max: float = 1e5,
    maximum_number_of_outer_loop_iterations: int = 100,
    tol_exit: float = 1e-6,
    obstacle: Callable = spherical_cap_obstacle,
    f: float = 0.0,
    quadrature_degree: int = 6,
    solver_options: Optional[Mapping] = None,
    verbose: bool = True,
) -> ObstacleProblem:
    """Build the LVPP obstacle solver with the reference's defaults
    (CLI flags of obstacle_pg.py:268-323; Newton rtol 1e-6, max 100, no
    linesearch, direct solve — petsc options at obstacle_pg.py:128-139)."""
    V = FunctionSpace.create(mesh, polynomial_order)
    space = MixedSpace([("u", V), ("psi", V)])

    def residual(x, u, gu, c, gc, consts):
        alpha = consts["alpha"]
        a0_u = u["psi"] - c["psi_k"] - alpha * f
        a1_u = alpha * gu["u"]
        a0_psi = u["u"] - jnp.exp(u["psi"]) - c["phi"]
        return {"u": (a0_u, a1_u), "psi": (a0_psi, None)}

    form = VolumeForm(space, residual, quadrature_degree,
                      coeff_spaces={"psi_k": V, "u_k": V})
    phi_q = form.interpolate_to_quadrature(obstacle)

    bcs = [DirichletBC.from_marker("u", V, value=0.0)]
    problem = NonlinearProblem(form, bcs, coeffs={"phi": jnp.asarray(phi_q)},
                               consts={"alpha": jnp.asarray(1.0)})

    u_sl, psi_sl = space.slice_of("u"), space.slice_of("psi")

    def prev_coeffs(x_k):
        return {"psi_k": x_k[psi_sl], "u_k": x_k[u_sl]}

    # ---- observables (obstacle_pg.py:145-152)
    energy_fn = form.make_functional(
        lambda x, u, gu, c, gc, k:
        0.5 * jnp.dot(gu["u"], gu["u"]) - f * u["u"])
    compl_fn = form.make_functional(
        lambda x, u, gu, c, gc, k:
        (c["psi_k"] - u["psi"]) / k["alpha"] * u["u"])
    feas_fn = form.make_functional(
        lambda x, u, gu, c, gc, k:
        jnp.where(u["u"] - c["phi"] < 0, -(u["u"] - c["phi"]), 0.0))
    dualfeas_fn = form.make_functional(
        lambda x, u, gu, c, gc, k:
        jnp.where(c["psi_k"] < u["psi"],
                  (u["psi"] - c["psi_k"]) / k["alpha"], 0.0))
    h1inc_fn = form.make_functional(
        lambda x, u, gu, c, gc, k:
        jnp.dot(gu["u"] - gc["u_k"], gu["u"] - gc["u_k"])
        + (u["u"] - c["u_k"]) ** 2)
    l2inc_fn = form.make_functional(
        lambda x, u, gu, c, gc, k:
        (jnp.exp(u["psi"]) - jnp.exp(c["psi_k"])) ** 2)

    base_coeffs = {"phi": jnp.asarray(phi_q)}

    def _obs(fn):
        def wrapped(x, x_k, alpha):
            coeffs = dict(base_coeffs, **prev_coeffs(x_k))
            return float(fn(x, coeffs, {"alpha": jnp.asarray(alpha)}))
        return wrapped

    observables = {
        "Energy": _obs(energy_fn),
        "Complementarity": lambda x, x_k, a: abs(_obs(compl_fn)(x, x_k, a)),
        "Feasibility": _obs(feas_fn),
        "Dual Feasibility": _obs(dualfeas_fn),
        "Latent increments": lambda x, x_k, a:
            float(np.sqrt(max(_obs(l2inc_fn)(x, x_k, a), 0.0))),
    }

    def increment(x, x_k):
        coeffs = dict(base_coeffs, **prev_coeffs(x_k))
        return float(np.sqrt(max(float(h1inc_fn(x, coeffs, {})), 0.0)))

    default_opts = {
        "snes_rtol": 1e-6, "snes_max_it": 100, "snes_linesearch_type": "none",
        "ksp_type": "preonly", "pc_type": "lu",
        "snes_error_if_not_converged": False,
    }
    default_opts.update(solver_options or {})

    solver = LVPPSolver(
        problem,
        newton_options=SolverOptions(default_opts),
        alpha=AlphaScheduler(scheme=alpha_scheme, C=1.0, r=1.5, q=1.5,
                             alpha_max=alpha_max),
        prev_coeffs=prev_coeffs,
        increment=increment,
        observables=observables,
        tol=tol_exit,
        max_iterations=maximum_number_of_outer_loop_iterations,
        verbose=verbose,
    )
    return ObstacleProblem(space=space, form=form, problem=problem,
                           solver=solver, V=V)


def solve_obstacle_problem(mesh: Mesh, **kwargs) -> tuple:
    prob = setup_obstacle_problem(mesh, **kwargs)
    result = prob.solve()
    return prob, result
