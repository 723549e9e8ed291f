"""Geometric multigrid V-cycle for structured-grid Schur operators.

Preconditions the P1 fast path's SPD Schur system
    S = free * (alpha A + m2d I) + (1 - free) I
on an (m, m) vertex grid (rectangle_mesh numbering is lexicographic, so
the flat dof vector reshapes to the grid): damped-Jacobi smoothing,
full-weighting restriction, bilinear prolongation, rediscretized coarse
operators. Every operation is a pad/slice stencil — no gathers, only
contiguous streaming — and the whole cycle is pure jnp, usable inside the
fused Newton kernel.

The P1 stiffness stencil on a uniform right-diagonal triangulation is
h-independent in 2D: A = [[0,-1,-1],[-1,4,-1],[-1,-1,0]] (diagonal
neighbors along the triangulated diagonal), so coarse stiffnesses reuse
the same stencil; the variable diagonal m2d ~ c(x) M with M ~ h^2
restricts with a factor 4 per level.

Measured (129x129, f64, rtol 1e-10 PCG):
  - pure Poisson (uniform small m2d): Jacobi-CG 429 its, MG-PCG 10 its.
  - obstacle-contact Schur at alpha=85 (m2d = M^2/d spanning ~14 orders,
    irregular active set): Jacobi-CG 220 its, MG-PCG 72 its. The coarse
    grids cannot represent the contact free-boundary (the classic
    obstacle-multigrid limitation; a proper fix is truncated/monotone
    multigrid), and one V-cycle costs ~17 stencil applies, so the
    P1ObstacleSolver keeps Jacobi + the active/inactive split as its
    default preconditioner. Use this module when the system is
    Laplacian-dominated on a structured grid.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def stencil_apply(u, alpha, m2d, free):
    """S u on the (m, m) grid: alpha * A u + m2d * u on free points,
    identity elsewhere. For P1 on the uniform right-diagonal
    triangulation the hypotenuse couplings cancel exactly, leaving the
    classic 5-point stencil 4u - (N + S + E + W) (h-independent in 2D)."""
    uf = jnp.where(free, u, 0.0)
    Au = 4.0 * uf - (jnp.pad(uf[1:, :], ((0, 1), (0, 0)))
                     + jnp.pad(uf[:-1, :], ((1, 0), (0, 0)))
                     + jnp.pad(uf[:, 1:], ((0, 0), (0, 1)))
                     + jnp.pad(uf[:, :-1], ((0, 0), (1, 0))))
    return jnp.where(free, alpha * Au + m2d * u, u)


def restrict(r):
    """Full weighting to the (m//2+1, m//2+1) grid (m = 2k)."""
    # pad so slicing is uniform
    rp = jnp.pad(r, ((1, 1), (1, 1)))
    c = rp[1:-1:2, 1:-1:2]
    e = (rp[1:-1:2, 2::2] + rp[1:-1:2, :-2:2]
         + rp[2::2, 1:-1:2] + rp[:-2:2, 1:-1:2])
    d = (rp[2::2, 2::2] + rp[2::2, :-2:2]
         + rp[:-2:2, 2::2] + rp[:-2:2, :-2:2])
    return 0.25 * c + 0.125 * e + 0.0625 * d


def prolong(c, fine_shape):
    """Bilinear interpolation to the fine grid."""
    m = fine_shape[0]
    f = jnp.zeros(fine_shape, c.dtype)
    f = f.at[::2, ::2].set(c)
    # horizontal midpoints
    f = f.at[::2, 1::2].set(0.5 * (c[:, :-1] + c[:, 1:]))
    # vertical midpoints
    f = f.at[1::2, ::2].set(0.5 * (c[:-1, :] + c[1:, :]))
    # centers
    f = f.at[1::2, 1::2].set(0.25 * (c[:-1, :-1] + c[:-1, 1:]
                                     + c[1:, :-1] + c[1:, 1:]))
    return f


def build_hierarchy(m2d, free, levels: int):
    """Per-level (m2d, free) grids; m2d scales by 4 per coarsening
    (M ~ h^2), free coarsens conservatively (a coarse point is free only
    if its fine counterpart is)."""
    out = [(m2d, free)]
    cur_m2d, cur_free = m2d, free
    for _ in range(levels - 1):
        cur_m2d = 4.0 * restrict(cur_m2d)
        cur_free = restrict(jnp.where(cur_free, 1.0, 0.0))[...] > 0.999
        # boundary of the coarse grid is never free
        cur_free = cur_free.at[0, :].set(False).at[-1, :].set(False) \
            .at[:, 0].set(False).at[:, -1].set(False)
        out.append((cur_m2d, cur_free))
    return out


def v_cycle(r, hierarchy, alpha, level=0, nu=2, omega=0.8):
    """One V(nu, nu) cycle for S z = r; returns z."""
    m2d, free = hierarchy[level]
    diag = jnp.where(free, 4.0 * alpha + m2d, 1.0)

    def smooth(z, sweeps):
        def body(_, z):
            res = r - stencil_apply(z, alpha, m2d, free)
            return z + omega * res / diag
        return jax.lax.fori_loop(0, sweeps, body, z)

    z = smooth(jnp.zeros_like(r), nu)
    if level == len(hierarchy) - 1:
        return smooth(z, 24)          # coarsest: extra smoothing
    res = jnp.where(free, r - stencil_apply(z, alpha, m2d, free), 0.0)
    # The stencil is the h^2-scaled Laplacian (h-independent {4,-1}), so
    # the coarse operator represents (2h)^2 (-lap) = 4x the fine scale;
    # the restricted residual must carry the same factor 4 or the coarse
    # correction comes back 4x too small (78 -> 10 PCG its on Poisson).
    rc = 4.0 * restrict(res)
    zc = v_cycle(rc, hierarchy, alpha, level + 1, nu, omega)
    z = z + jnp.where(free, prolong(zc, r.shape), 0.0)
    # post-smoothing
    def body(_, z):
        res = r - stencil_apply(z, alpha, m2d, free)
        return z + omega * res / diag
    z = jax.lax.fori_loop(0, nu, body, z)
    return z


def mg_levels_for(m: int, coarsest: int = 17) -> int:
    lv = 1
    while (m - 1) % 2 == 0 and (m - 1) // 2 + 1 >= coarsest:
        m = (m - 1) // 2 + 1
        lv += 1
    return lv


# ------------------------- variable-coefficient variant (lattice Schur PC)

def build_hierarchy_var(alpha, m2d, free, levels: int):
    """Per-level (alpha, m2d, free) for grid-varying alpha(x): alpha is
    h-independent (restricted plainly), m2d ~ h^2 (restricted with the
    factor 4), free coarsens conservatively."""
    out = [(alpha, m2d, free)]
    cur_a, cur_m2d, cur_free = alpha, m2d, free
    for _ in range(levels - 1):
        cur_a = restrict(cur_a)
        cur_m2d = 4.0 * restrict(cur_m2d)
        cur_free = restrict(jnp.where(cur_free, 1.0, 0.0)) > 0.999
        cur_free = cur_free.at[0, :].set(False).at[-1, :].set(False) \
            .at[:, 0].set(False).at[:, -1].set(False)
        out.append((cur_a, cur_m2d, cur_free))
    return out


def v_cycle_var(r, hierarchy, level=0, nu=2, omega=0.8):
    """V(nu, nu) cycle for (alpha(x) A + m2d) z = r — the S-solve of the
    lattice Schur preconditioner. alpha(x)*(4u - sum nbrs) approximates
    div(alpha grad) to preconditioner accuracy for smooth alpha."""
    alpha, m2d, free = hierarchy[level]
    diag = jnp.where(free, 4.0 * alpha + m2d, 1.0)

    def smooth(z, sweeps):
        def body(_, z):
            res = r - stencil_apply(z, alpha, m2d, free)
            return z + omega * res / diag
        return jax.lax.fori_loop(0, sweeps, body, z)

    z = smooth(jnp.zeros_like(r), nu)
    if level == len(hierarchy) - 1:
        return smooth(z, 24)
    res = jnp.where(free, r - stencil_apply(z, alpha, m2d, free), 0.0)
    rc = 4.0 * restrict(res)
    zc = v_cycle_var(rc, hierarchy, level + 1, nu, omega)
    z = z + jnp.where(free, prolong(zc, r.shape), 0.0)
    return smooth(z, nu)


def lattice_map(points: np.ndarray):
    """Map dof coordinates that form a full 2D tensor lattice to grid
    indices. Returns (perm, shape): perm[grid_flat] = dof index, with
    shape (my, mx). Raises if the points are not a complete lattice —
    the caller falls back to the Chebyshev Schur PC.

    Lagrange-P2 dofs on a uniform right-diagonal triangulation and Q_p
    dofs on a uniform quad grid both form complete (p*N+1)^2 lattices
    (vertices + edge/interior nodes all land on the h/p sub-lattice)."""
    import numpy as _np
    pts = _np.asarray(points)
    if pts.shape[1] != 2:
        raise ValueError("lattice_map: 2D points only")
    out = []
    idx = []
    for d in range(2):
        x = pts[:, d]
        xs = _np.unique(_np.round(x, 9))
        h = _np.min(_np.diff(xs)) if len(xs) > 1 else 1.0
        i = _np.round((x - xs[0]) / h).astype(_np.int64)
        n = int(i.max()) + 1
        if not _np.allclose(xs[0] + i * h, x, atol=1e-8 * max(1.0, abs(h))):
            raise ValueError("lattice_map: points off-lattice")
        idx.append(i)
        out.append(n)
    mx, my = out
    flat = idx[1] * mx + idx[0]
    if len(_np.unique(flat)) != mx * my or len(pts) != mx * my:
        raise ValueError("lattice_map: incomplete lattice")
    perm = _np.empty(mx * my, dtype=_np.int64)
    perm[flat] = _np.arange(len(pts))
    return perm, (my, mx)
