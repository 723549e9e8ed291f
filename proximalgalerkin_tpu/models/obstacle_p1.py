"""Example 01 fast path — P1 lumped-mass proximal Galerkin on any mesh.

The production/bench variant of the obstacle problem (BASELINE.md north
star: 1M DoF). Same LVPP structure as obstacle.py / the reference
(obstacle_pg.py:116-124), discretized with P1 Lagrange and vertex (lumped)
quadrature for the latent coupling terms. The payoff is the linear algebra:
the latent block is then pointwise diagonal, so each Newton step reduces
exactly to the SPD Schur system

    (alpha A + M_L^2 / D) du = rhs,     D = M_L * exp(psi),

solved by Jacobi-preconditioned CG over an ELL stiffness SpMV — robust
where Krylov on the full indefinite saddle system degrades as exp(psi) -> 0
in the contact set (the regime MUMPS handles for the reference). The whole
Newton loop is one fused jitted kernel; the outer LVPP loop stays in Python
and follows the reference's FD protocol (obstacle_finite_difference.jl:
70-111): alpha = min(max(C r^(q^k) - alpha, C), cap), inner relative
tolerance, outer l2 increment tolerance.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..la.ell import EllMatrix, EllPattern
from ..mesh.mesh import Mesh
from ..ops.mg import dot
from ..spaces import FunctionSpace, MixedSpace
from .obstacle import spherical_cap_obstacle


@dataclass
class P1ObstacleResult:
    u: np.ndarray
    psi: np.ndarray
    outer_iterations: int
    newton_its: int
    newton_per_outer: List[int]
    increments: List[float]
    converged: bool            # outer increment test met AND every
                               # Newton solve reached its stop
    cg_its_total: int = 0      # inner CG iterations (roofline accounting)
    # per outer step: (residual norm, inner CG iterations) before the
    # first Newton step, then after each step
    newton_history: List[List[Tuple[float, int]]] = field(
        default_factory=list)
    # outer steps (1-based) whose Newton loop ended above its stop
    newton_failed: List[int] = field(default_factory=list)


# When the f32 inner CG reaches its noise floor just above the requested
# relative tolerance it can cycle without progress for the rest of its
# budget (observed: 40k-iteration burns at 1024^2 contact states, CG
# riding maxiter = 40*sqrt(N)). Once the best residual is already within
# _CG_STALL_GUARD of the stop threshold, exit after _CG_STALL_WINDOW
# iterations without improvement and return the best iterate seen. The
# guard keeps the exit disarmed during the legitimately slow early phase,
# where the f32 residual can plateau for hundreds of iterations while
# still converging.
_CG_STALL_WINDOW = 128
_CG_STALL_GUARD = 1e4


def _cg(matvec, b, Minv, tol, maxiter, stall_guard=_CG_STALL_GUARD):
    """stall_guard: residual-slack factor arming the noise-floor exit.
    Pass 0.0 to disarm (pure-f64 callers, which have no iterative-
    refinement wrap to absorb the up-to-guard*tol residual slack)."""
    tiny = jnp.asarray(np.finfo(np.dtype(b.dtype)).tiny, b.dtype)
    x0 = jnp.zeros_like(b)
    r = b
    z = Minv * r
    p = z
    rz = dot(r, z)
    bnorm2 = dot(b, b)
    stop = tol * tol * bnorm2

    def cond(state):
        i, x, r, z, p, rz, ok, xb, rrb, ib = state
        stalled = jnp.logical_and(i - ib > _CG_STALL_WINDOW,
                                  rrb < stall_guard * stop)
        return jnp.logical_and(
            jnp.logical_and(ok, ~stalled),
            jnp.logical_and(i < maxiter, dot(r, r) > stop))

    def body(state):
        i, x, r, z, p, rz, ok, xb, rrb, ib = state
        Ap = matvec(p)
        pAp = dot(p, Ap)
        # breakdown detection: near the dtype's noise floor p'Ap can round
        # to <= 0 (refinement passes enter with |b| at roundoff level);
        # stop instead of dividing
        good = jnp.logical_and(pAp > tiny, rz > tiny)
        a = jnp.where(good, rz / jnp.where(good, pAp, 1.0), 0.0)
        x = x + a * p
        r = r - a * Ap
        z = Minv * r
        rz_new = dot(r, z)
        p = z + jnp.where(good, rz_new / jnp.where(good, rz, 1.0), 0.0) * p
        rr = dot(r, r)
        better = rr < rrb
        xb = jnp.where(better, x, xb)
        rrb = jnp.where(better, rr, rrb)
        ib = jnp.where(better, i + 1, ib)
        return i + 1, x, r, z, p, rz_new, good, xb, rrb, ib

    out = jax.lax.while_loop(
        cond, body, (0, x0, r, z, p, rz, jnp.asarray(True), x0, bnorm2, 0))
    return out[7], out[0]


class P1ObstacleSolver:
    def __init__(self, mesh: Mesh,
                 obstacle: Callable = spherical_cap_obstacle,
                 f: float = 0.0,
                 alpha_cap: float = 1e2,
                 outer_tol: float = 1e-8,
                 newton_tol: float = 1e-4,
                 newton_atol: float = 1e-11,
                 newton_max: int = 50,
                 cg_tol: float = 1e-10,
                 cg_max: Optional[int] = None,
                 mixed_precision: bool = False,
                 use_dia: bool = True,
                 pc: str = "jacobi",
                 cg_forcing: str = "fixed",
                 dtype=jnp.float64):
        if cg_forcing not in ("fixed", "ew"):
            raise ValueError(
                f"cg_forcing must be 'fixed' or 'ew', got {cg_forcing!r}")
        if cg_forcing == "ew" and not mixed_precision:
            # the EW logic lives only in the mixed-precision inner solve;
            # silently ignoring it would corrupt A/B measurements
            raise ValueError(
                "cg_forcing='ew' only affects the mixed_precision=True "
                "inner solve; combine it with mixed_precision=True")
        self.mesh = mesh
        V = FunctionSpace.create(mesh, 1)
        self.V = V
        N = V.num_dofs
        self.N = N
        space = MixedSpace([("u", V)])

        # Static P1 stiffness + lumped mass assembled on HOST (no device
        # compiles at setup; one transfer to HBM). For affine triangles the
        # element stiffness has the closed form |T| grad(lambda_i).
        # grad(lambda_j) — no quadrature-loop arrays, minimal memory.
        from ..native import scatter_add
        bdofs = V.boundary_dofs()
        dm = V.dofmap.astype(np.int64)                    # (e, 3)
        pattern = EllPattern.build(dm, N, bdofs)
        self.ell = EllMatrix(pattern, dtype)

        if mesh.cell_type == "triangle" and mesh.geom_degree == 1:
            pv = mesh.points[mesh.cell_vertices]          # (e, 3, 2)
            e1 = pv[:, 1] - pv[:, 0]
            e2 = pv[:, 2] - pv[:, 0]
            det = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
            area = 0.5 * np.abs(det)
            inv = 1.0 / det
            # grad(lambda): rows of [[e2y, -e2x], [-e1y, e1x]]/det give
            # grads of lambda_1, lambda_2; lambda_0 = -(l1 + l2)
            g1 = np.stack([e2[:, 1] * inv, -e2[:, 0] * inv], axis=1)
            g2 = np.stack([-e1[:, 1] * inv, e1[:, 0] * inv], axis=1)
            g0 = -(g1 + g2)
            G3 = np.stack([g0, g1, g2], axis=1)           # (e, 3, 2)
            Ae = np.einsum("eid,ejd,e->eij", G3, G3, area)
            Me = np.repeat(area[:, None] / 3.0, 3, axis=1)
        else:
            from ..assembly.geometry import cell_geometry
            from ..elements.quadrature import cell_quadrature
            qpts, qw = cell_quadrature(mesh.cell_type, 2)
            geom = cell_geometry(mesh, qpts, qw)
            phi_t, dphi_t = V.element.tabulate(qpts)
            gphi = np.einsum("eqdt,qit->eqid", geom.G, dphi_t)
            Ae = np.einsum("eqid,eqjd,eq->eij", gphi, gphi, geom.wdet)
            Me = np.einsum("qi,eq->ei", phi_t, geom.wdet)

        csr = scatter_add(Ae.reshape(-1), pattern.slot_map,
                          pattern.nnz + 1)
        csr[:pattern.nnz] = (csr[:pattern.nnz] * pattern.keep
                             + pattern.diag_ones)
        # host copy of the assembled CSR values (BCs applied) — the CPU
        # baseline in bench.py builds the reference saddle matrix from this
        # (NOT from A_data, whose layout changes if the DIA path is taken)
        self.A_csr_host = csr

        # lumped mass vector: M_L[i] = ∫ phi_i dx
        ML = scatter_add(Me.reshape(-1),
                         dm.reshape(-1), N)
        self.M_L = jnp.asarray(ML, dtype)

        # DIA fast path: when the stiffness pattern lives on few
        # diagonals (structured meshes / banded orderings), SpMV becomes
        # static shifts + FMAs — no gathers (la/dia.py). Built on HOST
        # first so (a) the ELL-form device transfer is skipped entirely
        # when DIA succeeds, and (b) the transfer itself is delta-encoded
        # (~1 MB instead of ~60 MB at 1024^2; whether that still pays on
        # a locally attached card is an open measurement).
        from ..la.dia import DiaMatrix, delta_device_put
        K = pattern.width
        dia_host = None
        if use_dia:
            # only TRUE csr slots — ELL (row, row, 0.0) padding entries
            # would collide with the genuine diagonal in DIA storage
            eg_flat = np.asarray(pattern.ell_gather).reshape(-1)
            true_mask = eg_flat < pattern.nnz
            dia_rows = np.repeat(np.arange(N, dtype=np.int64), K)[true_mask]
            dia_cols = np.asarray(pattern.ell_cols).reshape(-1)[true_mask]
            dia_vals = csr[eg_flat[true_mask]]
            dia_host = DiaMatrix.host_build(dia_rows, dia_cols, dia_vals, N)
        if dia_host is not None:
            offs, ddata = dia_host
            self.dia = DiaMatrix(offsets=offs, data=delta_device_put(ddata),
                                 n=N)
            self.A_data = self.dia.data
        else:
            self.dia = None
            self.A_data = jnp.asarray(csr[pattern.ell_gather], dtype)

        self.phi = jnp.asarray(obstacle(V.dof_points.T), dtype)
        mask = np.ones(N)
        mask[np.asarray(bdofs)] = 0.0
        self.interior = jnp.asarray(mask, dtype)
        self.f = f
        self.alpha_cap = alpha_cap
        self.outer_tol = outer_tol
        self.newton_tol = newton_tol
        self.newton_atol = newton_atol
        self.newton_max = newton_max
        self.cg_tol = cg_tol
        self.cg_max = cg_max or 40 * int(np.sqrt(N))
        self.cg_forcing = cg_forcing
        self.mixed_precision = mixed_precision
        self.dtype = dtype
        # f32 copies for the mixed-precision inner CG: the inner Krylov
        # runs in f32 (half the bytes of an f64 loop) with f64 iterative
        # refinement wrapped around it
        if mixed_precision:
            # cast on DEVICE (jnp) rather than shipping a second host copy
            self.A32 = jnp.asarray(self.A_data).astype(jnp.float32)
            if self.dia is not None:
                self.ea32 = {}     # DIA kernels never read the ELL arrays
            else:
                self.ea32 = dict(
                    self.ell.arrays,
                    keep=self.ell.arrays["keep"].astype(jnp.float32),
                    diag_ones=self.ell.arrays["diag_ones"].astype(
                        jnp.float32))

        # Geometric-MG preconditioner (ops/mg.py): V(1,1) on the dof
        # lattice, bounding PCG iterations where Jacobi-CG needs O(1/h).
        # Requires the constant 5-point stencil (rectangle_mesh P1 —
        # verified below, incl. zero diagonal couplings and isotropic
        # off-diagonals).
        self.pc = pc
        self._mg_setup = None
        self._mg_scale = 1.0
        if pc == "mg":
            m = int(round(np.sqrt(N)))
            ok = (self.dia is not None and m * m == N and
                  set(abs(int(o)) for o in self.dia.offsets)
                  <= {0, 1, m, m + 1})
            if ok:
                # host copy from the host build — NOT np.asarray(device
                # data), which would cost a 60 MB device-to-host copy
                dd = dia_host[1]
                offs = [int(o) for o in self.dia.offsets]
                interior2 = np.asarray(mask, bool).reshape(m, m)
                interior2[[0, -1], :] = False
                interior2[:, [0, -1]] = False
                core = interior2.reshape(-1)
                s_off = {}
                for k_, off in enumerate(offs):
                    vals = dd[k_][core]
                    if abs(off) == m + 1:
                        ok = ok and (np.abs(vals).max() < 1e-12)
                    elif off != 0:
                        s_off[abs(off)] = np.median(np.abs(vals))
                if ok and s_off:
                    s = float(np.mean(list(s_off.values())))
                    ok = all(abs(v - s) < 1e-10 * max(s, 1.0)
                             for v in s_off.values())
                    diag_vals = dd[offs.index(0)][core]
                    ok = ok and np.allclose(diag_vals, 4.0 * s,
                                            atol=1e-10 * max(s, 1.0))
                    self._mg_scale = s
            if not ok:
                raise ValueError(
                    "pc='mg' requires the isotropic 5-point lattice "
                    "stiffness (P1 on rectangle_mesh)")
            from ..ops.mg import make_mg_pc
            self._mg_setup = make_mg_pc(m)

        dia = self.dia
        if dia is not None:
            def _spmv(Ad, v, ea):
                return dia.spmv(v, Ad)

            def _diag(Ad, ea):
                return dia.diagonal(Ad)
        else:
            def _spmv(Ad, v, ea):
                return self.ell.spmv(Ad, v, ea)

            def _diag(Ad, ea):
                return self.ell.diagonal(Ad, ea)

        mg_setup = self._mg_setup
        mg_scale32 = jnp.asarray(self._mg_scale, jnp.float32)
        if mg_setup is not None:
            from ..ops.mg import PIN as _MG_PIN
            from ..ops.mg import k5_apply as _k5
            from ..ops.mg import pcg as _mg_pcg
            mg_m = int(round(np.sqrt(self.N)))
        interior = self.interior
        M_L = self.M_L
        phi = self.phi
        fv = jnp.asarray(f, dtype)
        newton_tol_ = newton_tol
        newton_atol_ = newton_atol
        newton_max_ = newton_max
        cg_tol_ = cg_tol
        cg_max_ = self.cg_max
        # Eisenstat–Walker-style inexact-Newton forcing (mixed path only):
        # the direction residual only needs to be small RELATIVE TO HOW
        # FAST NEWTON IS CONVERGING — EW choice 2:
        #   eta_k = clip(max(0.9*(|F_k|/|F_{k-1}|)^2, 0.1*stop/|F_k|),
        #                1e-9, 1e-2)
        # (loose while Newton progresses fast, never looser than what
        # landing under the Newton stop requires), forced tight once
        # |F_k| < 100*stop. "fixed" (default) keeps the round-3 behavior
        # bit-for-bit. Implemented in the mixed-precision branch below.
        forcing_ew = (cg_forcing == "ew")

        # The latent variable dives to psi ~ -O(sum alpha) at contact nodes
        # (exp(psi) = the primal-dual gap -> 0), so exp(psi) legitimately
        # underflows. The block Newton system stays well-posed in that limit
        # — a direct solver (the reference's MUMPS) handles it by pivoting.
        # We reproduce the limit exactly with an active/inactive row split:
        # nodes whose latent weight M^2/d exceeds the elliptic row scale by
        # KAPPA_MAX take their closed-form Newton limit
        #     du = -g_p/M - (d/M^2) g_u   (exact to O((1/KAPPA_MAX)^2)),
        # the rest form a bounded-condition SPD Schur system for CG.
        KAPPA_MAX = 1e14
        PSI_TOP = 50.0   # exp overflow guard; psi > ~1 never occurs at a sol

        def residual(u, psi, psi_k, alpha, A_data, ea):
            g_u = interior * (alpha * _spmv(A_data, u, ea)
                              + M_L * (psi - psi_k - alpha * fv))
            g_p = interior * M_L * (u - jnp.exp(psi) - phi)
            return g_u, g_p

        mixed = self.mixed_precision
        f32 = jnp.float32

        def newton_kernel(u, psi, psi_k, u_prev, alpha, A_data, ea,
                          A32, ea32):
            g_u0, g_p0 = residual(u, psi, psi_k, alpha, A_data, ea)
            norm0 = jnp.sqrt(jnp.vdot(g_u0, g_u0) + jnp.vdot(g_p0, g_p0))
            # relative tolerance with an absolute floor: late outer stages
            # start at residuals near roundoff where a 1e-4 relative
            # reduction is unattainable in f64
            stop = jnp.maximum(newton_tol_ * norm0, newton_atol_)
            diagA = _diag(A_data, ea)

            def cond(state):
                it, u, psi, nrm, cg_total, best, nrm_prev, hist = state
                return jnp.logical_and(it < newton_max_, nrm > stop)

            def body(state):
                it, u, psi, nrm_in, cg_total, best, nrm_prev, hist = state
                g_u, g_p = residual(u, psi, psi_k, alpha, A_data, ea)
                d = M_L * jnp.exp(psi)            # underflow to 0 is fine
                row_scale = alpha * diagA + M_L
                active = jnp.logical_and(
                    interior > 0,
                    d * KAPPA_MAX * row_scale < M_L * M_L)
                free = jnp.logical_and(interior > 0, ~active)
                dsafe = jnp.maximum(d, 1e-300)
                m2d = jnp.where(free, M_L * M_L / dsafe, 0.0)

                du_a = jnp.where(active,
                                 -g_p / M_L - (d / (M_L * M_L)) * g_u, 0.0)
                rhs = jnp.where(
                    free,
                    -g_u - (M_L / dsafe) * g_p
                    - alpha * _spmv(A_data, du_a, ea), 0.0)

                def S(v):
                    vf = jnp.where(free, v, 0.0)
                    return jnp.where(
                        free, alpha * _spmv(A_data, vf, ea) + m2d * v, v)

                diagS = jnp.where(free, alpha * diagA + m2d, 1.0)
                if not mixed:
                    if mg_setup is not None:
                        # f64 CG with the f32 V-cycle PC (a preconditioner
                        # only steers the search; CG in f64 keeps the
                        # accuracy) on the same Jacobi-scaled system as the
                        # mixed path below: on the unscaled operator the
                        # relative stop is measured in a norm dominated by
                        # the ~1e14 rows near the active threshold, and
                        # leaves the elliptic rows unresolved (Newton then
                        # stalls at deep contact)
                        sq = jnp.sqrt(diagS)
                        sqinv = 1.0 / sq
                        w_mg = jnp.where(free, m2d, _MG_PIN).astype(f32)
                        mgpc = mg_setup(
                            jnp.asarray(alpha, f32) * mg_scale32, w_mg)
                        wt, cg_its = _mg_pcg(
                            lambda vt: S(vt * sqinv) * sqinv, rhs * sqinv,
                            lambda r: sq * mgpc(
                                (sq * r).astype(f32)).astype(r.dtype),
                            cg_tol_, cg_max_, stall_guard=0.0)
                        w = wt * sqinv
                    else:
                        # stall guard disarmed: f64 CG at cg_tol=1e-10 does
                        # not sit above its noise floor, and there is no
                        # refinement wrap here to absorb guard-level
                        # residual slack
                        w, cg_its = _cg(S, rhs, 1.0 / diagS, cg_tol_,
                                        cg_max_, stall_guard=0.0)
                else:
                    # inner CG in native f32 on the symmetrically
                    # Jacobi-scaled system D^{-1/2} S D^{-1/2} (unit
                    # diagonal, rows bounded O(1) — unscaled Schur rows
                    # reach ~1e14 near the active threshold and overflow
                    # f32 norms), with two f64 refinement passes around it
                    sq = jnp.sqrt(diagS)
                    sqinv = 1.0 / sq
                    sqinv32 = sqinv.astype(f32)
                    m2d32 = m2d.astype(f32)
                    alpha32 = alpha.astype(f32)
                    ones32 = jnp.ones_like(sqinv32)
                    tol_fix = max(cg_tol_, 2e-6)
                    if forcing_ew:
                        # EW choice 2 (eta ~ gamma*(|F_k|/|F_{k-1}|)^2:
                        # loose while Newton progresses fast) with a
                        # lower safeguard 0.1*stop/|F_k| — never solve
                        # tighter than what landing under the Newton stop
                        # requires
                        ratio = nrm_in / jnp.maximum(nrm_prev, 1e-300)
                        eta = jnp.clip(
                            jnp.maximum(0.9 * ratio * ratio,
                                        0.1 * stop
                                        / jnp.maximum(nrm_in, 1e-300)),
                            1e-9, 1e-2)
                        # endgame guard: the LAST Newton steps set the
                        # iterate accuracy the outer loop's increment test
                        # sees — once within 100x of the Newton stop,
                        # solve tight (loose final directions were
                        # measured to stall outer increments and ADD
                        # outer iterations, costing more than the loose
                        # solves saved)
                        eta = jnp.where(nrm_in < 100.0 * stop,
                                        jnp.asarray(1e-9, eta.dtype), eta)
                        tol32 = jnp.maximum(jnp.asarray(tol_fix, f32),
                                            eta.astype(f32))
                    else:
                        eta = None
                        tol32 = jnp.asarray(tol_fix, f32)

                    if mg_setup is not None:
                        # lattice form of the Schur matvec: the verified
                        # isotropic 5-point stencil (setup check) as ONE
                        # fusible pad+slice group instead of ~20
                        # concatenate-based DIA shifts (fewer kernel
                        # launches per PCG iteration)
                        def S32t(vt):
                            v = vt * sqinv32
                            vf = jnp.where(free, v, jnp.asarray(0.0, f32))
                            y5 = _k5(vf.reshape(mg_m, mg_m)).reshape(-1)
                            y = jnp.where(
                                free,
                                alpha32 * mg_scale32 * y5 + m2d32 * v, v)
                            return y * sqinv32

                        # V-cycle PC for the scaled system: with
                        # M ~ S^-1 on the unscaled operator, the scaled
                        # preconditioner is D^1/2 M D^1/2 — i.e.
                        # z = sq * mg(sq * r) (sq <= ~1e8 stays in f32)
                        w_mg = jnp.where(free, m2d, _MG_PIN).astype(f32)
                        mgpc = mg_setup(alpha32 * mg_scale32, w_mg)
                        sq32 = sq.astype(f32)

                        def krylov32(bt):
                            return _mg_pcg(S32t, bt,
                                           lambda r: sq32 * mgpc(sq32 * r),
                                           tol32, cg_max_)
                    else:
                        def S32t(vt):
                            v = vt * sqinv32
                            vf = jnp.where(free, v, jnp.asarray(0.0, f32))
                            y = jnp.where(
                                free,
                                alpha32 * _spmv(A32, vf, ea32) + m2d32 * v,
                                v)
                            return y * sqinv32

                        def krylov32(bt):
                            return _cg(S32t, bt, ones32, tol32, cg_max_)

                    def solve32(b64):
                        xt, its = krylov32((b64 * sqinv).astype(f32))
                        return xt.astype(u.dtype) * sqinv, its

                    w, cg_its = solve32(rhs)
                    rhsn2 = jnp.vdot(rhs, rhs)
                    # refinement target: fixed ~1e-9 relative (f32 noise
                    # floor), or the EW forcing eta when adaptive
                    rthresh = ((eta * eta) * rhsn2 if forcing_ew
                               else 1e-18 * rhsn2)
                    for _ in range(2):
                        r = jnp.where(free, rhs - S(w), 0.0)
                        rn2 = jnp.vdot(r, r)
                        # refine only while the relative residual is above
                        # the target — beyond that the f32 CG operates at
                        # its noise floor and returns garbage
                        e, its2 = jax.lax.cond(
                            rn2 > rthresh,
                            lambda rr: solve32(rr),
                            lambda rr: (jnp.zeros_like(rr), 0),
                            r)
                        w = w + e
                        cg_its = cg_its + its2
                du = jnp.where(free, w, du_a)
                # back-substitute dpsi from the FIRST (linear) Newton row:
                # alpha A du + M_L dpsi = -g_u — no division by exp(psi),
                # so no error amplification in the deep-contact limit.
                dpsi = jnp.where(
                    interior > 0,
                    -(g_u + alpha * _spmv(A_data, du, ea)) / M_L, 0.0)
                u = u + du
                psi = jnp.minimum(psi + dpsi, PSI_TOP)
                g_u, g_p = residual(u, psi, psi_k, alpha, A_data, ea)
                nrm = jnp.sqrt(jnp.vdot(g_u, g_u) + jnp.vdot(g_p, g_p))
                # track the best iterate: Newton restarted at an
                # already-converged state with an unreachable tolerance
                # must not drift away (SNES never returns a worse state)
                bu, bp, bn = best
                improved = nrm < bn
                best = (jnp.where(improved, u, bu),
                        jnp.where(improved, psi, bp),
                        jnp.minimum(nrm, bn))
                hist = hist.at[it + 1].set(
                    jnp.stack([nrm, jnp.asarray(cg_its, nrm.dtype)]))
                return (it + 1, u, psi, nrm, cg_total + cg_its, best,
                        nrm_in, hist)

            init_best = (u, psi, norm0)
            # row 0: initial residual; row k: residual and inner CG
            # iterations of Newton step k (rows past the last step: inf)
            hist0 = jnp.full((newton_max_ + 1, 2), jnp.inf, norm0.dtype)
            hist0 = hist0.at[0].set(jnp.stack([norm0, 0.0 * norm0]))
            it, _, _, nrm, cg_total, best, _, hist = jax.lax.while_loop(
                cond, body, (0, u, psi, norm0, 0, init_best, norm0, hist0))
            u, psi, nrm = best
            # outer-loop increment fused here: one kernel per outer
            # iteration, no extra small-op compiles on device
            inc = jnp.linalg.norm(u - u_prev)
            return u, psi, it, cg_total, inc, stop, hist

        self._newton_fn = newton_kernel
        self._newton = jax.jit(newton_kernel)

        outer_tol_ = self.outer_tol

        def lvpp_kernel(u, psi, psi_k, u_prev, alphas, A_data, ea,
                        A32, ea32):
            """The ENTIRE LVPP solve as one XLA program: outer proximal
            loop (precomputed alpha schedule) wrapping the fused Newton
            while_loop — zero host round-trips until convergence."""

            def cond(c):
                k, u, psi, psi_k, u_prev, inc, tn, tcg, nfail = c
                return jnp.logical_and(k < alphas.shape[0],
                                       inc > outer_tol_)

            def body(c):
                k, u, psi, psi_k, u_prev, inc, tn, tcg, nfail = c
                alpha = alphas[k]
                u2, psi2, nits, cg, inc2, stop, hist = newton_kernel(
                    u, psi, psi_k, u_prev, alpha, A_data, ea, A32, ea32)
                failed = jnp.min(hist[:, 0]) > stop
                return (k + 1, u2, psi2, psi2, u2, inc2,
                        tn + nits, tcg + cg, nfail + failed.astype(int))

            big = jnp.asarray(jnp.inf, u.dtype)
            k, u, psi, _, _, inc, tn, tcg, nfail = jax.lax.while_loop(
                cond, body, (0, u, psi, psi_k, u_prev, big, 0, 0, 0))
            return u, psi, k, tn, tcg, inc, nfail

        self._lvpp_fused = jax.jit(lvpp_kernel)

    def alpha_schedule(self, max_outer: int = 100) -> np.ndarray:
        """Precomputed FD-rule alpha sequence (host recurrence)."""
        alphas = np.zeros(max_outer)
        alpha, C, r, q = 1.0, 1.0, 1.5, 1.5
        for k in range(max_outer):
            try:
                alpha = min(max(C * r ** (q**k) - alpha, C), self.alpha_cap)
            except OverflowError:
                alpha = self.alpha_cap
            alphas[k] = alpha
        return alphas

    def initial_state(self):
        """(u, psi, psi_k, u_prev) at the start of an LVPP solve."""
        zeros = jnp.zeros(self.N, self.dtype)
        return zeros, jnp.ones(self.N, self.dtype), zeros, zeros

    def newton_args(self, u, psi, psi_k, u_prev, alpha) -> tuple:
        """The arguments solve() passes to the jitted Newton kernel. A
        warm-up must pass exactly these (dtypes and weak types included)
        to reach the executable solve() runs."""
        ea = {} if self.dia is not None else self.ell.arrays
        mixed = self.mixed_precision
        return (u, psi, psi_k, u_prev, jnp.asarray(alpha, self.dtype),
                self.A_data, ea, self.A32 if mixed else self.A_data,
                self.ea32 if mixed else ea)

    def compile(self):
        """Compile the Newton kernel for solve()'s arguments, ahead of
        time (later solve() calls reuse the executable)."""
        return self._newton.lower(
            *self.newton_args(*self.initial_state(), 1.0)).compile()

    def solve_fused(self, max_outer: int = 100) -> P1ObstacleResult:
        """One-kernel LVPP solve (totals only; use solve() for
        per-iteration records)."""
        ea = {} if self.dia is not None else self.ell.arrays
        alphas = jnp.asarray(self.alpha_schedule(max_outer), self.dtype)
        u, psi, k, tn, tcg, inc, nfail = self._lvpp_fused(
            *self.initial_state(), alphas, self.A_data, ea,
            self.A32 if self.mixed_precision else self.A_data,
            self.ea32 if self.mixed_precision else ea)
        inc_f = float(inc)
        return P1ObstacleResult(
            u=np.asarray(u), psi=np.asarray(psi),
            outer_iterations=int(k), newton_its=int(tn),
            newton_per_outer=[], increments=[inc_f],
            converged=inc_f < self.outer_tol and int(nfail) == 0,
            cg_its_total=int(tcg))

    def solve(self, max_outer: int = 100, verbose: bool = False
              ) -> P1ObstacleResult:
        u, psi, psi_k, u_prev = self.initial_state()
        per_outer: List[int] = []
        increments: List[float] = []
        history: List[List[Tuple[float, int]]] = []
        failed: List[int] = []
        cg_total = 0
        converged = False
        for k, alpha in enumerate(self.alpha_schedule(max_outer)):
            u, psi, nits, cg_its, inc_dev, stop, hist = self._newton(
                *self.newton_args(u, psi, psi_k, u_prev, alpha))
            nits = int(nits)
            cg_total += int(cg_its)
            per_outer.append(nits)
            hist = np.asarray(hist)[:nits + 1]
            history.append([(float(r), int(c)) for r, c in hist])
            if hist[:, 0].min() > float(stop):
                failed.append(k + 1)
            psi_k = psi
            inc = float(inc_dev)
            increments.append(inc)
            if verbose:
                print(f"outer {k + 1} alpha={alpha:.4g} newton={nits} "
                      f"cg={int(cg_its)} residual={hist[-1, 0]:.3e} "
                      f"inc={inc:.3e}", flush=True)
            if inc < self.outer_tol:
                converged = not failed
                break
            u_prev = u

        return P1ObstacleResult(
            u=np.asarray(u), psi=np.asarray(psi),
            outer_iterations=len(per_outer), newton_its=sum(per_outer),
            newton_per_outer=per_outer, increments=increments,
            converged=converged, cg_its_total=cg_total,
            newton_history=history, newton_failed=failed)
