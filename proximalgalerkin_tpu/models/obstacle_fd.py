"""Example 01 (finite-difference variant) — LVPP obstacle problem with a
5-point stencil on the square [-1,1]^2.

Rebuild of examples/01_obstacle_problem/obstacle_finite_difference.jl:29-113:
same residual/Jacobian structure ([alpha*A u + psi - alpha*f - psi_k;
u - exp(psi) - phi]), same alpha rule min(max(C r^(q^k) - alpha, C), 1e2),
same tolerances (inner relative 1e-4, outer l2 1e-9).

Device-native design instead of the Julia sparse-direct solve: the latent
block is pointwise diagonal in FD, so each Newton step reduces exactly to
the SPD Schur system (alpha*A + D^{-1}) du = rhs, solved by CG with a
stencil matvec — all fused into one jitted Newton kernel of rolls/adds on
an (N, N) grid (elementwise only, no gathers, no sparse storage at all).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from .obstacle import spherical_cap_obstacle


def _laplacian_dirichlet(u, h2inv):
    """5-point Laplacian with homogeneous Dirichlet BC rows replaced by
    identity: interior -> (4u - neighbors)/h^2, boundary -> u."""
    n = u.shape[0]
    lap = 4.0 * u
    lap = lap - jnp.pad(u[1:, :], ((0, 1), (0, 0)))
    lap = lap - jnp.pad(u[:-1, :], ((1, 0), (0, 0)))
    lap = lap - jnp.pad(u[:, 1:], ((0, 0), (0, 1)))
    lap = lap - jnp.pad(u[:, :-1], ((0, 0), (1, 0)))
    lap = lap * h2inv
    interior = jnp.zeros((n, n), bool).at[1:-1, 1:-1].set(True)
    return jnp.where(interior, lap, u)


def _cg_stencil(matvec, b, tol, maxiter):
    x0 = jnp.zeros_like(b)
    r = b
    p = r
    rs = jnp.vdot(r, r)
    stop = tol * tol * rs

    def cond(state):
        i, x, r, p, rs = state
        return jnp.logical_and(i < maxiter, rs > stop)

    def body(state):
        i, x, r, p, rs = state
        Ap = matvec(p)
        a = rs / jnp.vdot(p, Ap)
        x = x + a * p
        r = r - a * Ap
        rs_new = jnp.vdot(r, r)
        p = r + (rs_new / rs) * p
        return i + 1, x, r, p, rs_new

    _, x, _, _, _ = jax.lax.while_loop(cond, body, (0, x0, r, p, rs))
    return x


@dataclass
class FDObstacleResult:
    u: np.ndarray
    phi: np.ndarray
    outer_iterations: int
    newton_its: int
    newton_per_outer: List[int]


def fd_obstacle_solve(N: int, max_outer: int = 100, newton_tol: float = 1e-4,
                      newton_max: int = 50, outer_tol: float = 1e-9,
                      alpha_cap: float = 1e2, cg_tol: float = 1e-10,
                      dtype=jnp.float64, verbose: bool = False
                      ) -> FDObstacleResult:
    """LVPP on an N x N grid; returns solution and Newton-iteration totals
    (the FD protocol records totals over the resolution sweep N = 2^j + 1,
    obstacle_finite_difference.jl:115-122)."""
    xs = np.linspace(-1.0, 1.0, N)
    h2inv = 1.0 / (xs[1] - xs[0]) ** 2
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    phi = spherical_cap_obstacle(np.stack([X.ravel(), Y.ravel()])).reshape(N, N)
    phi_j = jnp.asarray(phi, dtype)
    interior = jnp.zeros((N, N), bool).at[1:-1, 1:-1].set(True)

    @jax.jit
    def newton_solve(u, psi, psi_k, alpha):
        """Inner Newton loop, fully fused: residual, Schur-CG direction,
        update, until relative residual < newton_tol."""

        def residual(u, psi):
            g_u = alpha * _laplacian_dirichlet(u, h2inv) + jnp.where(
                interior, psi - psi_k, 0.0)
            # overflow-safe exp: a Newton overshoot at large alpha can push
            # psi past 709 transiently; exp(inf) would poison the whole
            # solve with NaN, while a huge-but-finite residual lets the
            # next Newton step pull psi back (physical psi is <= ~0 here)
            g_p = jnp.where(interior,
                            u - jnp.exp(jnp.minimum(psi, 500.0)) - phi_j, 0.0)
            return g_u, g_p

        g_u0, g_p0 = residual(u, psi)
        norm0 = jnp.sqrt(jnp.vdot(g_u0, g_u0) + jnp.vdot(g_p0, g_p0))

        def cond(state):
            it, u, psi, nrm = state
            return jnp.logical_and(it < newton_max, nrm > newton_tol * norm0)

        def body(state):
            it, u, psi, _ = state
            g_u, g_p = residual(u, psi)
            d = jnp.exp(jnp.minimum(psi, 500.0))   # latent diagonal
            # Deep-contact limit split (see obstacle_p1.py): where exp(psi)
            # has underflowed relative to the elliptic row scale, take the
            # exact d->0 Newton limit du = -g_p - d*g_u pointwise instead
            # of dividing by d inside the Schur operator.
            row_scale = alpha * 4.0 * h2inv + 1.0
            active = jnp.logical_and(interior, d * 1e14 * row_scale < 1.0)
            free = jnp.logical_and(interior, ~active)
            dsafe = jnp.maximum(d, 1e-300)
            du_a = jnp.where(active, -g_p - d * g_u, 0.0)
            rhs = jnp.where(
                free,
                -g_u - g_p / dsafe
                - alpha * _laplacian_dirichlet(du_a, h2inv), 0.0)

            # Symmetric Jacobi scaling of the Schur CG: rows of
            # S = alpha*A + D^{-1} span ~1e16 in deep contact, and the
            # squared terms CG forms from them reach ~1e38 — solve
            # D_S^{-1/2} S D_S^{-1/2} y = D_S^{-1/2} rhs instead, which
            # keeps every product O(1)-scaled and doubles as a Jacobi
            # preconditioner.
            sD = jnp.where(free,
                           jnp.sqrt(alpha * 4.0 * h2inv + 1.0 / dsafe), 1.0)

            def S(v):
                vf = jnp.where(free, v / sD, 0.0)
                Av = _laplacian_dirichlet(vf, h2inv)
                return jnp.where(free, (alpha * Av + vf / dsafe) / sD, v)

            y = _cg_stencil(S, jnp.where(free, rhs / sD, 0.0), cg_tol, 20 * N)
            du = jnp.where(free, y / sD, du_a)
            # latent update from the linear first Newton row (no division)
            dpsi = jnp.where(
                interior,
                -(g_u + alpha * _laplacian_dirichlet(du, h2inv)), 0.0)
            u, psi = u + du, psi + dpsi
            g_u, g_p = residual(u, psi)
            nrm = jnp.sqrt(jnp.vdot(g_u, g_u) + jnp.vdot(g_p, g_p))
            return it + 1, u, psi, nrm

        it, u, psi, nrm = jax.lax.while_loop(
            cond, body, (0, u, psi, norm0))
        return u, psi, it

    u = jnp.zeros((N, N), dtype)
    psi = jnp.ones((N, N), dtype)
    u_prev = jnp.zeros((N, N), dtype)
    psi_k = jnp.zeros((N, N), dtype)

    alpha, C, r, q = 1.0, 1.0, 1.5, 1.5
    total_newton = 0
    per_outer: List[int] = []
    k_done = 0
    for k in range(max_outer):
        try:
            alpha = min(max(C * r ** (q**k) - alpha, C), alpha_cap)
        except OverflowError:
            alpha = alpha_cap
        u, psi, nits = newton_solve(u, psi, psi_k, jnp.asarray(alpha, dtype))
        total_newton += int(nits)
        per_outer.append(int(nits))
        psi_k = psi
        k_done = k + 1
        inc = float(jnp.linalg.norm(u - u_prev))
        if verbose:
            print(f"outer {k + 1} alpha={alpha:.4g} newton={int(nits)} "
                  f"inc={inc:.3e}")
        if inc < outer_tol:
            break
        u_prev = u

    return FDObstacleResult(u=np.asarray(u), phi=phi,
                            outer_iterations=k_done,
                            newton_its=total_newton,
                            newton_per_outer=per_outer)


def fd_resolution_sweep(js=(1, 2, 3, 4, 5, 6), **kwargs) -> List[int]:
    """Newton totals over N = 2^j + 1, the reference's recorded protocol."""
    return [fd_obstacle_solve(2**j + 1, **kwargs).newton_its for j in js]
