"""Schur-complement block preconditioning for 2x2 saddle systems.

Device-native rebuild of the reference's only non-LU linear-solver recipe —
the MFEM eikonal solver's MINRES + BlockDiagonalPreconditioner
(examples/09_eikonal/ex40.cpp:261-281):

    A = [[A00, A01], [A10, A11]]          (A10 = A01^T, symmetric)
    S = A10 diag(A00)^{-1} A01  (- A11)   (Mult_AtDA, ex40.cpp:265)
    P = blockdiag( diag(A00)^{-1},  approx-solve(S) )

The reference approximates the S-solve with a Gauss-Seidel sweep (or
UMFPACK LU). Both are host-sequential; the device stand-in is a fixed
Chebyshev polynomial in diag(S)^{-1} S — same smoothing role, but built
from SpMVs that vectorize on the device, and a *fixed linear SPD* operator,
which is what MINRES requires of its preconditioner.

Blocks are identified by a component mask m0 over the global dof vector
(field-contiguous in MixedSpace layout, but masks keep this generic), so
"block0" can be any field — for the eikonal system block0 is the latent
psi block, whose diagonal (the Hellinger-map derivative mass matrix) is
the invertible one.

Everything here is a pure function of ELL data / device arrays, usable
inside the fused Newton-direction jit.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp


def schur_diag(ell, data, arrays, m0, dinv0, bc1):
    """Exact diagonal of S~ = A10 diag(A00)^{-1} A01 - A11 + 2 diag(bc1).

    By symmetry diag(S)_i = sum_{j in block0} A[i,j]^2 / d0[j] - A[i,i]
    for rows i in block1 — one masked ELL row reduction.
    """
    cols = arrays["ell_cols"]
    m0c = m0[cols]
    quad = jnp.sum(data * data * m0c * dinv0[cols], axis=1)
    diagA = ell.diagonal(data, arrays)
    m1 = 1.0 - m0
    return m1 * (quad - diagA) + 2.0 * bc1


def _power_lmax(Sv: Callable, dinv, m1, iters: int):
    """Largest eigenvalue estimate of diag(S)^{-1} S on the block1
    subspace by power iteration (deterministic start)."""
    n = dinv.shape[0]
    v = m1 * (1.0 + 0.5 * jnp.sin(jnp.arange(n, dtype=dinv.dtype)))
    v = v / jnp.linalg.norm(v)

    def body(_, carry):
        v, lam = carry
        w = dinv * Sv(v)
        nrm = jnp.linalg.norm(w)
        return w / jnp.maximum(nrm, 1e-300), nrm

    v, lam = jax.lax.fori_loop(0, iters, body, (v, jnp.asarray(1.0, v.dtype)))
    return lam


def cheb_solve(Sv: Callable, dinv, lmin, lmax, b, steps: int):
    """Fixed-step preconditioned Chebyshev iteration for S z = b with the
    spectrum of diag(S)^{-1} S in [lmin, lmax] — the classical recurrence
    (Saad, Iterative Methods, Alg. 12.1), a fixed SPD polynomial in S."""
    d_ = (lmax + lmin) / 2.0
    c = (lmax - lmin) / 2.0
    z = jnp.zeros_like(b)
    r = b
    p = dinv * r
    alpha = 1.0 / d_
    z = z + alpha * p
    r = r - alpha * Sv(p)

    def body(_, carry):
        z, r, p, alpha = carry
        beta = (c * alpha / 2.0) ** 2
        alpha = 1.0 / (d_ - beta / alpha)
        p = dinv * r + beta * p
        z = z + alpha * p
        r = r - alpha * Sv(p)
        return z, r, p, alpha

    z, r, p, alpha = jax.lax.fori_loop(0, steps - 1, body, (z, r, p, alpha))
    return z


def schur_operator(ell, data, arrays, m0, bc1):
    """The SPD Schur operator on block1 and its exact diagonal.

    Returns (Sv, dS, dinv0): Sv the matrix-free action, dS its diagonal
    (both sign-corrected SPD), dinv0 the inverse block0 diagonal.

    Orientation: with block0 diagonal POSITIVE (eikonal's Hellinger-
    derivative mass), S~ = A10 d0^-1 A01 - A11 is the SPD Schur (A11
    <= 0 there); with block0 NEGATIVE (gradient constraint writes its
    latent row as grad u - map, so J_psi,psi = -dmap), the SPD Schur is
    the negation A11 - A10 d0^-1 A01 = A11 + A10 |d0|^-1 A01. One
    dominant-sign flip covers both.
    """
    m1 = 1.0 - m0
    diagA = ell.diagonal(data, arrays)
    d0 = m0 * diagA + m1                       # 1.0 off-block: safe divide
    dinv0 = jnp.where(jnp.abs(d0) > 1e-300, 1.0 / d0, 1.0)
    s0 = jnp.sign(jnp.sum(m0 * diagA))
    s0 = jnp.where(s0 == 0, 1.0, s0)

    def Sv(v):
        t = ell.spmv(data, m1 * v, arrays)     # A01 v1 (block0 rows of t)
        t0 = m0 * t * dinv0
        s = m1 * ell.spmv(data, t0, arrays)    # A10 d0^{-1} A01 v1
        return s0 * (s - m1 * t) + 2.0 * bc1 * v   # -A11 v1, bc sign fix

    dS = s0 * schur_diag(ell, data, arrays, m0, dinv0, jnp.zeros_like(bc1)) \
        + 2.0 * bc1
    return Sv, dS, dinv0


def make_schur_pc(ell, data, arrays, m0, bc1, *, cheb_steps: int = 4,
                  power_iters: int = 10, lmin_ratio: float = 30.0
                  ) -> Callable:
    """Build P^{-1} for MINRES from an assembled ELL Jacobian.

    m0:  (N,) 1.0 on block0 components (the invertible-diagonal block).
    bc1: (N,) 1.0 on Dirichlet dofs inside block1 (their rows are
         identity in A, which makes the raw S~ act as -I there; the
         +2 bc correction in S~ and its diagonal restores +I).
    Returns Minv(r) applying blockdiag(|d0|^{-1}, Chebyshev(S~)).
    """
    m1 = 1.0 - m0
    Sv, dS, dinv0 = schur_operator(ell, data, arrays, m0, bc1)
    dS_safe = jnp.where(jnp.abs(dS) > 1e-300, dS, 1.0)
    dinvS = m1 / dS_safe
    # 1.15 safety on the power estimate: ~10 iterations underestimates
    # lmax when the top eigenvalues cluster, and a Chebyshev polynomial
    # evaluated past its interval loses positivity (breaks MINRES). The
    # interval knobs are caller-tunable (pc_schur_* solver options) so
    # a spectrum escaping [lmin, lmax] is fixable without code edits.
    lmax = 1.15 * _power_lmax(Sv, dinvS, m1, power_iters)
    lmin = lmax / lmin_ratio

    cheb = partial(cheb_solve, Sv, dinvS, lmin, lmax, steps=cheb_steps)

    def Minv(r):
        return m0 * jnp.abs(dinv0) * r + cheb(m1 * r)

    return Minv


def make_schur_mg_pc(ell, data, arrays, m0, bc1, perm, grid_shape,
                     free_grid, levels: int, nu: int = 2) -> Callable:
    """Block-Schur preconditioner with a geometric-multigrid S-solve for
    LATTICE-structured block1 fields (P2 on uniform triangulations, Q_p on
    uniform quad grids — their dofs form a complete (pN+1)^2 lattice,
    la/gmg.py lattice_map).

    The Schur complement of the LVPP saddle systems is stiffness-dominated
    (S ~ alpha K + coupling); a fixed Chebyshev polynomial only damps the
    top of that spectrum, so MINRES iteration counts grow with alpha/h^2
    (measured: 400+ on gradient-constraint 16^2 vs 59 on the
    mass-dominated eikonal Schur). One V-cycle on the spectrally
    equivalent lattice operator alpha(x) A5 + m2d(x) is h- and
    alpha-robust (la/gmg.py measurements: 429 Jacobi-CG -> 10 MG-PCG).

    The stencil coefficients come from the operator itself, matrix-free:
    row sums of S give m2d (the zero-row-sum Laplacian part drops out);
    (diag - rowsum)/4 gives alpha(x).

    perm: (prod(grid_shape),) global dof index of each lattice point.
    """
    from .gmg import build_hierarchy_var, v_cycle_var
    m1 = 1.0 - m0
    Sv, dS, dinv0 = schur_operator(ell, data, arrays, m0, bc1)
    dtype = data.dtype

    # Stencil fit. The Laplacian strength MUST be a (near-)constant: the
    # P2<->P1-half-grid equivalence is between the P2 operator and the
    # CONSTANT-coefficient 5-point stencil; fitting alpha per node bakes
    # the vertex/edge diagonal checkerboard of P2 into the coefficient
    # and the V-cycle stops converging (measured: MINRES diverged).
    # rowsum isolates the zero-row-sum Laplacian part; the masked-mean
    # diagonal excess / 4 is the constant; the pointwise remainder stays
    # in the (diagonal) m2d term so Jacobi smoothing sees the exact diag.
    free_flat = jnp.asarray(free_grid).reshape(-1).astype(dtype)
    rowsum = Sv(m1)                          # S * ones on block1
    dS_l = dS[perm]
    excess = (dS_l - jnp.maximum(rowsum[perm], 0.0)) * free_flat
    alpha_c = jnp.maximum(jnp.sum(excess)
                          / (4.0 * jnp.maximum(jnp.sum(free_flat), 1.0)),
                          jnp.asarray(1e-30, dtype))
    m2d_g = jnp.maximum(dS_l - 4.0 * alpha_c,
                        jnp.asarray(0.0, dtype)).reshape(grid_shape)
    alpha_g = jnp.full(grid_shape, alpha_c, dtype)
    hierarchy = build_hierarchy_var(alpha_g, m2d_g,
                                    jnp.asarray(free_grid), levels)

    def Minv(r):
        rg = (m1 * r)[perm].reshape(grid_shape)
        zg = v_cycle_var(rg, hierarchy, nu=nu)
        z = jnp.zeros_like(r).at[perm].set(zg.reshape(-1))
        return m0 * jnp.abs(dinv0) * r + m1 * z

    return Minv
