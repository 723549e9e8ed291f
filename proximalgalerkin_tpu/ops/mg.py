"""Geometric multigrid V-cycle preconditioner for lattice operators
alpha*K5 + diag(w) on an m x m vertex-centered dof lattice.

The P1 obstacle fast path (models/obstacle_p1.py) reduces every Newton
step to an SPD Schur system S = alpha*K + diag(m2d) with pinned
(active/boundary) rows — on rectangle_mesh the stiffness K is exactly
the constant 5-point stencil {4; -1 N/S/E/W}, h-independent in 2D, so
only the diagonal varies between levels and Newton steps.  A V(1,1)
cycle with damped-Jacobi smoothing, full-weighting restriction and
bilinear prolongation (R = P^T/4, symmetric — CG-safe) bounds the PCG
iteration count where plain Jacobi-CG needs O(1/h) iterations: the
round-3 answer to the reference's multicore MUMPS factorizations
(obstacle_pg.py:131) staying ahead of Krylov at large N.

Pinned rows are folded into the diagonal (w += PIN at non-free dofs):
the smoother then freezes them and coarse corrections vanish there, so
one variable-diagonal operator per level covers Dirichlet rows, the
active set, and the free region uniformly.  Coarse diagonals follow the
mass-like scaling w_{l+1} = 4 * FW(w_l) (w ~ c(x) h^2 for a continuum
coefficient c).

Everything is f32, static shapes, jittable; restriction/prolongation are
dense matmuls against a 1-D full-weighting matrix (see `restrict`).
"""

from __future__ import annotations

from functools import partial
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

# diagonal weight standing in for a pinned (identity) row; large enough
# that the coarse-grid correction and smoother leave those dofs alone,
# small enough that f32 products with O(1e14) Schur diagonals stay finite
PIN = 1e18


_R_CACHE = {}


def _restriction_matrix(m: int, dtype) -> np.ndarray:
    """1-D full-weighting restriction matrix R (M+1, m), rows
    [1, 2, 1]/4 centered at the even fine points. 2-D restriction is the
    Kronecker form R X R^T; prolongation its exact transpose 4 R^T E R.
    Cached as NUMPY (a jnp array materialized during a jit trace is a
    staged constant — caching one across traces leaks the tracer)."""
    key = (m, np.dtype(dtype).name)
    if key not in _R_CACHE:
        M = (m - 1) // 2 + 1
        R = np.zeros((M, m), np.dtype(dtype))
        c = 2 * np.arange(M)
        R[np.arange(M), c] = 0.5
        R[np.arange(M - 1), c[:-1] + 1] += 0.25
        R[np.arange(1, M), c[1:] - 1] += 0.25
        _R_CACHE[key] = R
    return _R_CACHE[key]


def restrict(r2d):
    """Full-weighting restriction (m=2M+1 -> M+1), vertex-centered.

    Implemented as two dense matmuls (R X R^T), pinned to full f32
    precision: a reduced-precision default (TF32 on GPU tensor cores)
    makes the preconditioner unsymmetric at the ~1e-3 level, poison for
    CG, whose theory needs a fixed SPD M. The matmuls are exact and
    exactly transpose-consistent with `prolong`. Whether strided slices
    (la/gmg.py) beat them on the GPU is an open measurement."""
    R = _restriction_matrix(r2d.shape[0], r2d.dtype)
    with jax.default_matmul_precision("highest"):
        return R @ r2d @ R.T


def prolong(e2d):
    """Bilinear prolongation (M+1 -> 2M+1), the exact transpose of
    4*restrict (see `restrict` for why matmuls)."""
    m = 2 * (e2d.shape[0] - 1) + 1
    R = _restriction_matrix(m, e2d.dtype)
    with jax.default_matmul_precision("highest"):
        return 4.0 * (R.T @ e2d @ R)


def k5_apply(v2d):
    """Constant 5-point stiffness {4; -1 N/S/E/W} with zero Dirichlet
    exterior (P1 stiffness on a uniform right-triangulated lattice; the
    diagonal couplings are exactly zero, cf. the assembled DIA stencil)."""
    vp = jnp.pad(v2d, 1)
    return (4.0 * v2d - vp[:-2, 1:-1] - vp[2:, 1:-1]
            - vp[1:-1, :-2] - vp[1:-1, 2:])


def _levels_for(m: int) -> List[int]:
    ms = [m]
    while ms[-1] >= 9 and (ms[-1] - 1) % 2 == 0:
        ms.append((ms[-1] - 1) // 2 + 1)
    return ms


def make_mg_pc(m: int, nu: int = 1, omega: float = 0.8,
               coarse_sweeps: int = 24, dtype=jnp.float32):
    """Returns pc(alpha, w, r) ~ (alpha*K5 + diag(w))^{-1} r.

    alpha: scalar (f32).  w: (m*m,) nonnegative diagonal (PIN at pinned
    rows).  r: (m*m,) residual.  One V(nu,nu) cycle; the coarsest level
    is smoothed `coarse_sweeps` times (its diag-dominant pinned rows make
    Jacobi contract fast at 5..9 points across).
    """
    ms = _levels_for(m)
    nlev = len(ms)

    def setup(alpha, w_fine):
        """Build the level hierarchy once per operator (per Newton
        direction); the returned pc(r) is then called per CG iteration."""
        alpha = jnp.asarray(alpha, dtype)
        ws = [w_fine.reshape(ms[0], ms[0]).astype(dtype)]
        for l in range(1, nlev):
            ws.append(4.0 * restrict(ws[-1]))
        diags = [alpha * 4.0 + w for w in ws]

        def smooth(l, x, b, sweeps):
            d = diags[l]
            for _ in range(sweeps):
                r = b - (alpha * k5_apply(x) + ws[l] * x)
                x = x + omega * r / d
            return x

        def vcycle(l, b):
            if l == nlev - 1:
                return smooth(l, jnp.zeros_like(b), b, coarse_sweeps)
            x = smooth(l, jnp.zeros_like(b), b, nu)
            r = b - (alpha * k5_apply(x) + ws[l] * x)
            e = vcycle(l + 1, restrict(r))
            x = x + prolong(e)
            return smooth(l, x, b, nu)

        def pc(r_fine):
            r2 = r_fine.reshape(ms[0], ms[0]).astype(dtype)
            return vcycle(0, r2).reshape(-1)

        return pc

    return setup


def dot(a, b):
    """Inner product at full precision. An f32 dot left at the default
    precision may run in TF32 on a GPU (~1e-3 relative), too coarse for
    the CG recurrences."""
    return jnp.vdot(a, b, precision=jax.lax.Precision.HIGHEST)


def pcg(matvec, b, precond, tol, maxiter,
        stall_window: int = 16, stall_guard: float = 1e4):
    """Preconditioned CG with a callable (V-cycle) preconditioner; same
    breakdown guards, best-iterate tracking and noise-floor stall exit as
    models/obstacle_p1._cg (the window is shorter: each MG-PCG iteration
    does a V-cycle's worth of work, so 16 stalled iterations ~ 100+
    stalled Jacobi-CG ones)."""
    tiny = jnp.asarray(np.finfo(np.dtype(b.dtype)).tiny, b.dtype)
    x0 = jnp.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = dot(r, z)
    bnorm2 = dot(b, b)
    stop = tol * tol * bnorm2

    def cond(state):
        i, x, r, z, p, rz, ok, xb, rrb, ib = state
        stalled = jnp.logical_and(i - ib > stall_window,
                                  rrb < stall_guard * stop)
        return jnp.logical_and(
            jnp.logical_and(ok, ~stalled),
            jnp.logical_and(i < maxiter, dot(r, r) > stop))

    def body(state):
        i, x, r, z, p, rz, ok, xb, rrb, ib = state
        Ap = matvec(p)
        pAp = dot(p, Ap)
        good = jnp.logical_and(pAp > tiny, rz > tiny)
        a = jnp.where(good, rz / jnp.where(good, pAp, 1.0), 0.0)
        x = x + a * p
        r = r - a * Ap
        z = precond(r)
        rz_new = dot(r, z)
        beta = jnp.where(good, rz_new / jnp.where(good, rz, 1.0), 0.0)
        p = z + beta * p
        rr = dot(r, r)
        better = rr < rrb
        xb = jnp.where(better, x, xb)
        rrb = jnp.where(better, rr, rrb)
        ib = jnp.where(better, i + 1, ib)
        return i + 1, x, r, z, p, rz_new, good, xb, rrb, ib

    out = jax.lax.while_loop(
        cond, body, (0, x0, r, z, p, rz, jnp.asarray(True), x0, bnorm2, 0))
    return out[7], out[0]
