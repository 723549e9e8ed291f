"""Explicit halo-exchange distribution via shard_map + ppermute.

The second (performance-tuned) distribution mode alongside the GSPMD
global-view sharding of parallel/sharding.py: domain rows are partitioned
across a 1D device mesh, each device holds its strip plus one halo row per
neighbor, and `jax.lax.ppermute` rings exchange the halos before each
stencil application — the literal device translation of the reference's
`Vec.ghostUpdate(INSERT/FORWARD)` neighbor exchange + `comm.allreduce`
norms (src/lvpp/problem.py:56-66, SURVEY.md §2.3), with the collectives
riding device interconnect instead of MPI.

Implemented here for the structured-grid (stencil) LVPP obstacle solver;
global reductions inside CG use jax.lax.psum exactly where the reference
calls comm.allreduce.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..models.obstacle import spherical_cap_obstacle


def _exchange_halo(block, axis="dev"):
    """Fill the first/last (halo) rows of each device's strip with the
    neighbors' boundary rows. block: (rows_local+2, N)."""
    n = jax.lax.psum(1, axis)
    idx = jax.lax.axis_index(axis)
    # send my last interior row down, my first interior row up
    down = jax.lax.ppermute(block[-2], axis,
                            [(i, (i + 1) % n) for i in range(n)])
    up = jax.lax.ppermute(block[1], axis,
                          [(i, (i - 1) % n) for i in range(n)])
    block = block.at[0].set(jnp.where(idx == 0, block[0], down))
    block = block.at[-1].set(jnp.where(idx == n - 1, block[-1], up))
    return block


def _lap_local(block, h2inv, interior):
    """5-point Laplacian on the halo-padded strip; identity on Dirichlet
    rows/cols (interior mask is halo-padded too)."""
    u = block
    lap = 4.0 * u
    lap = lap - jnp.concatenate([u[1:], jnp.zeros_like(u[:1])], axis=0)
    lap = lap - jnp.concatenate([jnp.zeros_like(u[:1]), u[:-1]], axis=0)
    lap = lap - jnp.pad(u[:, 1:], ((0, 0), (0, 1)))
    lap = lap - jnp.pad(u[:, :-1], ((0, 0), (1, 0)))
    return jnp.where(interior, lap * h2inv, u)


def fd_obstacle_solve_sharded(
    N: int,
    devices: Optional[list] = None,
    max_outer: int = 100,
    newton_tol: float = 1e-4,
    newton_max: int = 50,
    outer_tol: float = 1e-9,
    alpha_cap: float = 1e2,
    cg_tol: float = 1e-10,
    verbose: bool = False,
):
    """Distributed version of models/obstacle_fd.fd_obstacle_solve: the
    (N, N) grid row-sharded over a 1D device mesh with halo exchange.
    N-1 must be divisible by the device count... N rows are padded to a
    multiple of the mesh size."""
    devs = devices or jax.devices()
    nd = len(devs)
    mesh = Mesh(np.array(devs), ("dev",))

    rows = int(np.ceil(N / nd)) * nd      # padded row count
    pad = rows - N

    xs = np.linspace(-1.0, 1.0, N)
    h2inv = 1.0 / (xs[1] - xs[0]) ** 2
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    phi_full = spherical_cap_obstacle(
        np.stack([X.ravel(), Y.ravel()])).reshape(N, N)
    interior_full = np.zeros((N, N), bool)
    interior_full[1:-1, 1:-1] = True

    def pad_rows(a, fill=0.0):
        return np.pad(a, ((0, pad), (0, 0)), constant_values=fill)

    phi_p = jnp.asarray(pad_rows(phi_full, fill=-1e3))
    interior_p = jnp.asarray(pad_rows(interior_full, fill=False))

    sh = NamedSharding(mesh, P("dev", None))

    @partial(shard_map, mesh=mesh, in_specs=(P("dev", None),) * 5
             + (P(),), out_specs=(P("dev", None), P("dev", None), P()),
             check_vma=False)
    def newton_kernel(u, psi, psi_k, interior_f, phi, alpha):
        """One fused Newton solve on the row-sharded grid; each array is
        the device-local strip (rows/nd, N)."""
        interior = interior_f > 0.5

        def halo_pad(a):
            z = jnp.zeros_like(a[:1])
            return _exchange_halo(jnp.concatenate([z, a, z], axis=0))

        int_pad = jnp.concatenate([jnp.zeros_like(interior[:1]),
                                   interior,
                                   jnp.zeros_like(interior[:1])], axis=0)

        def lap(a):
            blk = halo_pad(a)
            return _lap_local(blk, h2inv, int_pad)[1:-1]

        def residual(u, psi):
            g_u = jnp.where(interior, alpha * lap(u) + (psi - psi_k), u)
            # overflow-safe exp (see models/obstacle_fd.py residual)
            g_p = jnp.where(interior,
                            u - jnp.exp(jnp.minimum(psi, 500.0)) - phi, 0.0)
            return g_u, g_p

        def dot(a, b):
            return jax.lax.psum(jnp.vdot(a, b), "dev")

        def cg(matvec, b, maxiter):
            x = jnp.zeros_like(b)
            r = b
            p = r
            rs = dot(r, r)
            stop = cg_tol * cg_tol * rs

            def cond(s):
                i, x, r, p, rs = s
                return jnp.logical_and(i < maxiter, rs > stop)

            def body(s):
                i, x, r, p, rs = s
                Ap = matvec(p)
                a_ = rs / dot(p, Ap)
                x = x + a_ * p
                r = r - a_ * Ap
                rs2 = dot(r, r)
                p = r + (rs2 / rs) * p
                return i + 1, x, r, p, rs2

            return jax.lax.while_loop(cond, body, (0, x, r, p, rs))[1]

        def newton_body(state):
            it, u, psi, _ = state
            g_u, g_p = residual(u, psi)
            d = jnp.exp(jnp.minimum(psi, 500.0))
            row_scale = alpha * 4.0 * h2inv + 1.0
            active = jnp.logical_and(interior, d * 1e14 * row_scale < 1.0)
            free = jnp.logical_and(interior, ~active)
            dsafe = jnp.maximum(d, 1e-300)
            du_a = jnp.where(active, -g_p - d * g_u, 0.0)
            rhs = jnp.where(free, -g_u - g_p / dsafe
                            - alpha * lap(du_a), 0.0)

            # symmetric Jacobi scaling (see models/obstacle_fd.py): keeps
            # CG's squared terms inside the dynamic range
            sD = jnp.where(free,
                           jnp.sqrt(alpha * 4.0 * h2inv + 1.0 / dsafe), 1.0)

            def S(v):
                vf = jnp.where(free, v / sD, 0.0)
                return jnp.where(free, (alpha * lap(vf) + vf / dsafe) / sD, v)

            y = cg(S, jnp.where(free, rhs / sD, 0.0), 20 * N)
            du = jnp.where(free, y / sD, du_a)
            dpsi = jnp.where(interior, -(g_u + alpha * lap(du)), 0.0)
            u, psi = u + du, psi + dpsi
            g_u, g_p = residual(u, psi)
            nrm = jnp.sqrt(dot(g_u, g_u) + dot(g_p, g_p))
            return it + 1, u, psi, nrm

        g_u0, g_p0 = residual(u, psi)
        n0 = jnp.sqrt(dot(g_u0, g_u0) + dot(g_p0, g_p0))
        it, u, psi, nrm = jax.lax.while_loop(
            lambda s: jnp.logical_and(s[0] < newton_max,
                                      s[3] > newton_tol * n0),
            newton_body, (0, u, psi, n0))
        return u, psi, it * jnp.ones((), jnp.int32)

    u = jax.device_put(jnp.zeros((rows, N)), sh)
    psi = jax.device_put(jnp.ones((rows, N)), sh)
    psi_k = jax.device_put(jnp.zeros((rows, N)), sh)
    interior_f = jax.device_put(interior_p.astype(jnp.float64), sh)
    phi_sh = jax.device_put(phi_p, sh)

    alpha = 1.0
    total = 0
    u_prev = u
    k_done = 0
    for k in range(max_outer):
        try:
            alpha = min(max(1.5 ** (1.5**k) - alpha, 1.0), alpha_cap)
        except OverflowError:
            alpha = alpha_cap
        u, psi, nits = newton_kernel(
            u, psi, psi_k, interior_f, phi_sh, jnp.asarray(alpha))
        total += int(nits)
        psi_k = psi
        inc = float(jnp.linalg.norm(u - u_prev))
        k_done = k + 1
        if verbose:
            print(f"outer {k + 1} alpha={alpha:.3g} newton={int(nits)} "
                  f"inc={inc:.2e}", flush=True)
        if inc < outer_tol:
            break
        u_prev = u

    return np.asarray(u)[:N], phi_full, k_done, total
