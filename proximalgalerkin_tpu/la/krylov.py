"""Device-resident Krylov solvers over matrix-free operators.

Replaces PETSc KSP (+MUMPS for `preonly`/`lu`, which lives in la/direct.py).
CG/GMRES/BiCGStab delegate to jax.scipy.sparse.linalg (jittable, matvec
closures); MINRES — the solver of the reference's C++ eikonal block system
(ex40.cpp:281) and the right Krylov method for LVPP's symmetric indefinite
saddle-point Jacobians — is implemented here as a lax.while_loop.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp


def cg(A: Callable, b, x0=None, *, tol=1e-10, atol=0.0, maxiter=10_000,
       M: Optional[Callable] = None):
    x, _ = jax.scipy.sparse.linalg.cg(A, b, x0=x0, tol=tol, atol=atol,
                                      maxiter=maxiter, M=M)
    return x


def gmres(A: Callable, b, x0=None, *, tol=1e-10, atol=0.0, maxiter=10_000,
          restart=30, M: Optional[Callable] = None):
    x, _ = jax.scipy.sparse.linalg.gmres(A, b, x0=x0, tol=tol, atol=atol,
                                         maxiter=maxiter, restart=restart,
                                         M=M, solve_method="batched")
    return x


def bicgstab(A: Callable, b, x0=None, *, tol=1e-10, atol=0.0, maxiter=10_000,
             M: Optional[Callable] = None):
    x, _ = jax.scipy.sparse.linalg.bicgstab(A, b, x0=x0, tol=tol, atol=atol,
                                            maxiter=maxiter, M=M)
    return x


def _minres_impl(A, b, x0, rtol, atol, maxiter, Minv_diag, Minv=None):
    """Preconditioned MINRES (Paige & Saunders) with a diagonal (Jacobi)
    preconditioner given as a vector of inverse diagonal entries (or ones),
    or a general SPD preconditioner callable Minv (takes precedence) —
    e.g. the block-Schur preconditioner of la/schur.py.

    Solves A x = b for symmetric (possibly indefinite) A — the LVPP
    saddle-point Newton systems. Preconditioner must be SPD.
    """
    dtype = b.dtype

    def precond(v):
        return Minv(v) if Minv is not None else Minv_diag * v

    x = x0
    r1 = b - A(x)
    y = precond(r1)
    beta1 = jnp.sqrt(jnp.maximum(jnp.vdot(r1, y), 0.0))

    eps = jnp.finfo(dtype).eps

    # state: (it, x, r1, r2, y, dbar? ...) follow standard minres recurrences
    def cond(state):
        (it, x, r1, r2, w, w2, phibar, rnorm, beta, betal, cs, sn,
         dbar, epsln, gmax, gmin, done) = state
        return jnp.logical_and(it < maxiter, jnp.logical_not(done))

    # Initialization for the Lanczos/MINRES recurrence
    beta = beta1
    r2 = r1
    w = jnp.zeros_like(b)
    w2 = jnp.zeros_like(b)
    phibar = beta1
    rnorm0 = beta1
    state = (jnp.array(0), x, r1, r2, w, w2, phibar, beta1,
             beta, jnp.array(0.0, dtype), jnp.array(-1.0, dtype),
             jnp.array(0.0, dtype), jnp.array(0.0, dtype),
             jnp.array(0.0, dtype), jnp.array(0.0, dtype),
             jnp.array(jnp.finfo(dtype).max, dtype),
             jnp.array(False))

    def body(state):
        (it, x, r1, r2, w, w2, phibar, rnorm, beta, betal, cs, sn,
         dbar, epsln, gmax, gmin, done) = state
        # Lanczos step
        s = 1.0 / jnp.maximum(beta, eps)
        v = s * precond(r2)
        yv = A(v)
        yv = jnp.where(it >= 1, yv - (beta / jnp.maximum(betal, eps)) * r1, yv)
        alfa = jnp.vdot(v, yv)
        yv = yv - (alfa / jnp.maximum(beta, eps)) * r2
        r1n, r2n = r2, yv
        z = precond(yv)
        betal_n = beta
        beta_n = jnp.sqrt(jnp.maximum(jnp.vdot(yv, z), 0.0))

        # apply previous rotation
        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln_n = sn * beta_n
        dbar_n = -cs * beta_n

        gamma = jnp.sqrt(gbar**2 + beta_n**2)
        gamma = jnp.maximum(gamma, eps)
        cs_n = gbar / gamma
        sn_n = beta_n / gamma
        phi = cs_n * phibar
        phibar_n = sn_n * phibar

        # update solution
        denom = 1.0 / gamma
        w1n = w2
        w2n = w
        wn = (v - oldeps * w1n - delta * w2n) * denom
        xn = x + phi * wn

        rnorm_n = phibar_n
        converged = rnorm_n <= jnp.maximum(rtol * rnorm0, atol)
        return (it + 1, xn, r1n, r2n, wn, w2n, phibar_n, rnorm_n,
                beta_n, betal_n, cs_n, sn_n, dbar_n, epsln_n,
                jnp.maximum(gmax, gamma), jnp.minimum(gmin, gamma), converged)

    out = jax.lax.while_loop(cond, body, state)
    return out[1], out[7], out[0]


def minres(A: Callable, b, x0=None, *, tol=1e-10, atol=0.0, maxiter=10_000,
           Minv_diag=None, Minv=None):
    """MINRES with optional inverse-diagonal (Jacobi) or general SPD
    (callable `Minv`) preconditioning.

    Pure function of traced values — usable inside an enclosing jit (the
    NewtonSolver compiles one fused Newton-direction kernel per option set).
    """
    if x0 is None:
        x0 = jnp.zeros_like(b)
    if Minv_diag is None:
        Minv_diag = jnp.ones_like(b)
    x, rnorm, its = _minres_impl(A, b, x0, jnp.asarray(tol, b.dtype),
                                 jnp.asarray(atol, b.dtype), maxiter,
                                 Minv_diag, Minv)
    return x


def gmres_givens(A: Callable, b, x0=None, *, tol=1e-10, atol=0.0,
                 maxiter=10_000, restart=30, Minv_diag=None):
    """Restarted GMRES(m) with CGS2 Arnoldi (classical Gram-Schmidt with
    one full reorthogonalization pass — Giraud et al., the numerically
    robust batched alternative to sequential MGS that keeps the
    projection a single big matvec) and Givens rotations,
    right-preconditioned by an inverse-diagonal vector.

    Built from matvecs, masked dots, and scalar rotations only — no
    Hessenberg least-squares solve_triangular on big systems and no
    host callbacks, so the whole solve stays one device program. The
    nonsymmetric-Jacobian stand-in for MUMPS (thermoforming QVI,
    multiphase)."""
    n = b.shape[0]
    dtype = b.dtype
    m = restart
    if x0 is None:
        x0 = jnp.zeros_like(b)
    dinv = jnp.ones_like(b) if Minv_diag is None else Minv_diag
    bnorm = jnp.linalg.norm(b)
    target = jnp.maximum(tol * bnorm, atol)

    def cycle(x):
        r = b - A(x)
        beta = jnp.linalg.norm(r)
        V = jnp.zeros((m + 1, n), dtype)
        V = V.at[0].set(r / jnp.maximum(beta, 1e-300))
        H = jnp.zeros((m + 1, m), dtype)
        cs = jnp.zeros(m, dtype)
        sn = jnp.zeros(m, dtype)
        g = jnp.zeros(m + 1, dtype).at[0].set(beta)

        def arnoldi(j, carry):
            V, H, cs, sn, g = carry
            w = A(dinv * V[j])
            # masked CGS2: classical Gram-Schmidt against V[0..j] (one
            # batched projection) + one reorthogonalization pass, which
            # restores MGS-level orthogonality loss bounds while staying
            # two big matvecs instead of j sequential dots
            mask = (jnp.arange(m + 1) <= j).astype(dtype)
            h = (V @ w) * mask
            w = w - h @ V
            h_corr = (V @ w) * mask
            w = w - h_corr @ V
            h = h + h_corr
            h2 = jnp.linalg.norm(w)
            V = V.at[j + 1].set(w / jnp.maximum(h2, 1e-300))
            # apply previous Givens rotations to the new column
            col = h.at[j + 1].set(h2)

            def rot(i, col):
                ci, si = cs[i], sn[i]
                a_, b_ = col[i], col[i + 1]
                col = col.at[i].set(ci * a_ + si * b_)
                return col.at[i + 1].set(-si * a_ + ci * b_)

            col = jax.lax.fori_loop(0, j, rot, col)
            denom = jnp.sqrt(col[j] ** 2 + col[j + 1] ** 2)
            cj = jnp.where(denom > 0, col[j] / jnp.maximum(denom, 1e-300),
                           1.0)
            sj = jnp.where(denom > 0,
                           col[j + 1] / jnp.maximum(denom, 1e-300), 0.0)
            col = col.at[j].set(denom).at[j + 1].set(0.0)
            cs = cs.at[j].set(cj)
            sn = sn.at[j].set(sj)
            gj = g[j]
            g = g.at[j].set(cj * gj).at[j + 1].set(-sj * gj)
            H = H.at[:, j].set(col[:m + 1])
            return V, H, cs, sn, g

        V, H, cs, sn, g = jax.lax.fori_loop(0, m, arnoldi,
                                            (V, H, cs, sn, g))
        # back-substitute the m x m upper-triangular system H y = g
        def back(i_, y):
            i = m - 1 - i_
            s = g[i] - jnp.dot(H[i, :], y)
            return y.at[i].set(s / jnp.where(jnp.abs(H[i, i]) > 1e-300,
                                             H[i, i], 1.0))

        y = jax.lax.fori_loop(0, m, back, jnp.zeros(m, dtype))
        x = x + dinv * (y @ V[:m])
        return x, jnp.abs(g[m])

    ncycles = max(1, -(-maxiter // m))

    def cond(s):
        i, x, rn = s
        return jnp.logical_and(i < ncycles, rn > target)

    def body(s):
        i, x, _ = s
        x, rn = cycle(x)
        return i + 1, x, rn

    r0 = jnp.linalg.norm(b - A(x0))
    _, x, _ = jax.lax.while_loop(cond, body, (0, x0, r0))
    return x


def minres_info(A: Callable, b, x0=None, *, tol=1e-10, atol=0.0,
                maxiter=10_000, Minv_diag=None, Minv=None):
    """minres that also returns (residual norm, iteration count) — for
    preconditioner studies and monitors."""
    if x0 is None:
        x0 = jnp.zeros_like(b)
    if Minv_diag is None:
        Minv_diag = jnp.ones_like(b)
    return _minres_impl(A, b, x0, jnp.asarray(tol, b.dtype),
                        jnp.asarray(atol, b.dtype), maxiter,
                        Minv_diag, Minv)


KRYLOV = {"cg": cg, "gmres": gmres, "gmres_d": gmres_givens,
          "bicgstab": bicgstab, "minres": minres}
