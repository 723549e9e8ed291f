"""Volume-form assembly as batched tensor contractions.

This is the device-native replacement for the reference's UFL -> FFCx -> C
kernel -> PETSc assembly pipeline (SURVEY.md layer 4; exercised from
src/lvpp/problem.py:54-77). Design:

  * A problem is defined by a *pointwise* residual function evaluated at
    quadrature points — `jax.jvp`/`jax.jacfwd` of that function replaces
    `ufl.derivative` (symbolic Gateaux derivative) exactly.
  * Field evaluation, physics, and test-function contraction are batched
    einsums over (cells, quadrature points): they run as dense device
    contractions and XLA fuses the elementwise physics into them.
  * The Jacobian never needs to be materialized: its action is the jvp of
    the assembled residual (cost ≈ 2 residuals), feeding matrix-free Krylov.
    Explicit element matrices / ELL / scipy CSR are available for the
    device Krylov operator, the host sparse LU fallback (standing in for
    MUMPS), and preconditioners.
  * All large per-cell arrays (quadrature geometry, gather indices,
    coefficients) are threaded through jitted kernels as runtime arguments,
    never closure constants — capturing them would embed hundreds of MB as
    XLA constants and trigger pathological constant folding at 1M+ DoF.

Residual convention: for test function v of field f,
    F_f(v) = ∫ a0_f · v + a1_f : grad(v) dx
where the user's pointwise function returns {field: (a0, a1)} given
(x, values, gradients, coefficients, coefficient gradients, constants).
"""

from __future__ import annotations

from functools import cached_property
from typing import Callable, Dict, Mapping, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..elements.quadrature import cell_quadrature
from ..spaces.space import MixedSpace
from .geometry import cell_geometry


def _canon_val(a, m):
    """Normalize a user value of a field with m components to shape (m,)."""
    a = jnp.asarray(a)
    return a.reshape(m) if a.ndim <= 1 else a


def _canon_grad(a, m, gdim):
    a = jnp.asarray(a)
    return a.reshape(m, gdim)


class VolumeForm:
    """Assembler for ∫ ... dx over all cells of the mesh of a MixedSpace.

    Args:
      space: the mixed function space of the unknowns.
      residual_fn: pointwise residual
          fn(x, u, gu, c, gc, consts) -> {field: (a0, a1 | None)}
        with x (gdim,), u[f] scalar or (m,), gu[f] (gdim,) or (m, gdim);
        coefficient values c[name] and gradients gc[name] analogous (gc[name]
        is None for raw quadrature-point coefficients).
      quadrature_degree: polynomial degree the rule integrates exactly
        (reference uses 6 for the obstacle problem, obstacle_pg.py:106).
      coeff_spaces: {name: FunctionSpace} for FE-function coefficients
        (e.g. the previous LVPP iterate psi_k); other coefficient entries
        passed at call time are treated as raw per-quadrature-point arrays
        of shape (ncells, nq, ...) (the quadrature-element obstacle phi,
        obstacle_pg.py:106-111).
    """

    def __init__(self, space: MixedSpace, residual_fn: Callable,
                 quadrature_degree: int,
                 coeff_spaces: Optional[Mapping[str, object]] = None,
                 jacobian_fn: Optional[Callable] = None,
                 dtype=jnp.float64, host_arrays: bool = False):
        self.space = space
        self.residual_fn = residual_fn
        # Optional modified-Jacobian residual: its derivative is used for
        # all Jacobian paths while residual_fn defines F — the analogue of
        # passing an explicit J to SNESProblem (reference problem.py:19,
        # 40-49; used for the stabilized QVI Jacobian
        # thermoforming_dolfinx.py:70-71 and the regularized fracture
        # Jacobian fracture_dolfinx.py:132-138).
        self.jacobian_fn = jacobian_fn
        self.coeff_spaces = dict(coeff_spaces or {})
        self.dtype = dtype
        mesh = space.mesh
        self.mesh = mesh
        self.qpts, self.qw = cell_quadrature(mesh.cell_type, quadrature_degree)
        self.nq = len(self.qw)
        geom = cell_geometry(mesh, self.qpts, self.qw)
        self.gdim, self.tdim = mesh.gdim, mesh.tdim

        # small basis tables (kept as closure constants — a few KB)
        self.tab: Dict[str, Tuple[jnp.ndarray, jnp.ndarray]] = {}
        self.field_m: Dict[str, int] = {}
        self.coeff_tab: Dict[str, Tuple[jnp.ndarray, jnp.ndarray]] = {}
        self.coeff_m: Dict[str, int] = {}

        # big per-cell arrays: threaded as runtime args through every kernel
        gather_idx: Dict[str, jnp.ndarray] = {}
        coeff_idx: Dict[str, jnp.ndarray] = {}
        for name in space.names:
            fs = space.spaces[name]
            phi, dphi = fs.element.tabulate(self.qpts)
            self.tab[name] = (jnp.asarray(phi, dtype), jnp.asarray(dphi, dtype))
            m = fs.value_size
            self.field_m[name] = m
            dm = fs.dofmap.astype(np.int64)
            idx = (space.offsets[name] + dm[:, :, None] * m
                   + np.arange(m)[None, None, :])
            gather_idx[name] = jnp.asarray(idx.astype(np.int32))
        for name, fs in self.coeff_spaces.items():
            phi, dphi = fs.element.tabulate(self.qpts)
            self.coeff_tab[name] = (jnp.asarray(phi, dtype),
                                    jnp.asarray(dphi, dtype))
            m = fs.value_size
            self.coeff_m[name] = m
            dm = fs.dofmap.astype(np.int64)
            idx = dm[:, :, None] * m + np.arange(m)[None, None, :]
            coeff_idx[name] = jnp.asarray(idx.astype(np.int32))

        # host_arrays=True keeps the big per-cell arrays as numpy (no HBM
        # transfer at construction) — for forms only used for host-side
        # assembly, e.g. the static-operator setup of the P1 fast path.
        conv = (lambda a: np.asarray(a)) if host_arrays else \
            (lambda a: jnp.asarray(a))
        self.cell_data: Dict[str, object] = {
            "xq": conv(np.asarray(geom.x, dtype)),       # (e, q, gdim)
            "wdet": conv(np.asarray(geom.wdet, dtype)),  # (e, q)
            "G": conv(np.asarray(geom.G, dtype)),        # (e, q, gdim, tdim)
            "gather_idx": {k: conv(v) for k, v in gather_idx.items()},
            "coeff_idx": {k: conv(v) for k, v in coeff_idx.items()},
        }

    # convenience accessors (host-side use)
    @property
    def xq(self):
        return self.cell_data["xq"]

    @property
    def wdet(self):
        return self.cell_data["wdet"]

    @property
    def G(self):
        return self.cell_data["G"]

    @property
    def gather_idx(self):
        return self.cell_data["gather_idx"]

    @property
    def coeff_idx(self):
        return self.cell_data["coeff_idx"]

    # ------------------------------------------------------------ evaluation

    def _eval_field(self, name: str, x, data):
        """vals (e,q,m), phys grads (e,q,m,gdim) of field `name` from the
        global mixed vector x."""
        phi, dphi = self.tab[name]
        zc = x[data["gather_idx"][name]]             # (e, i, m)
        vals = jnp.einsum("qi,eim->eqm", phi, zc)
        rg = jnp.einsum("qit,eim->eqmt", dphi, zc)
        grads = jnp.einsum("eqdt,eqmt->eqmd", data["G"], rg)
        return vals, grads

    def _eval_coeff(self, name: str, z, data):
        phi, dphi = self.coeff_tab[name]
        zc = z[data["coeff_idx"][name]]
        vals = jnp.einsum("qi,eim->eqm", phi, zc)
        rg = jnp.einsum("qit,eim->eqmt", dphi, zc)
        grads = jnp.einsum("eqdt,eqmt->eqmd", data["G"], rg)
        return vals, grads

    def _prepare_coeffs(self, coeffs, data):
        """Split user coefficients into per-quad-point (vals, grads|None)."""
        cv, cg = {}, {}
        for name, arr in (coeffs or {}).items():
            if name in self.coeff_tab:
                v, g = self._eval_coeff(name, jnp.asarray(arr, self.dtype), data)
                cv[name], cg[name] = v, g
            else:
                a = jnp.asarray(arr, self.dtype)
                if a.ndim == 2:   # (e, q) scalar coefficient
                    a = a[:, :, None]
                cv[name], cg[name] = a, None
        return cv, cg

    # ------------------------------------------------- pointwise call (user)

    def _user_shapes(self, vals, grads):
        u, gu = {}, {}
        for f, m in self.field_m.items():
            if m == 1:
                u[f] = vals[f][0]
                gu[f] = grads[f][0]
            else:
                u[f] = vals[f]
                gu[f] = grads[f]
        return u, gu

    def _user_coeff_shapes(self, cvals, cgrads):
        c = {k: (v[0] if v.shape == (1,) else v) for k, v in cvals.items()}
        gc = {k: (None if g is None else (g[0] if g.shape[0] == 1 and
                                          self.coeff_m.get(k, 1) == 1 else g))
              for k, g in cgrads.items()}
        return c, gc

    def _pointwise(self, xq, svals, sgrads, cvals, cgrads, consts,
                   fn: Optional[Callable] = None):
        """Canonical-shape pointwise residual: inputs svals[f] (m,),
        sgrads[f] (m, gdim); returns canonical (a0 (m,), a1 (m, gdim))."""
        u, gu = self._user_shapes(svals, sgrads)
        c, gc = self._user_coeff_shapes(cvals, cgrads)
        out = (fn or self.residual_fn)(xq, u, gu, c, gc, consts)
        res = {}
        for f, m in self.field_m.items():
            a0, a1 = out.get(f, (None, None))
            a0c = jnp.zeros((m,), self.dtype) if a0 is None else _canon_val(a0, m)
            a1c = (jnp.zeros((m, self.gdim), self.dtype) if a1 is None
                   else _canon_grad(a1, m, self.gdim))
            res[f] = (a0c, a1c)
        return res

    # ---------------------------------------------------------- residual

    def _residual_core(self, x, coeffs, consts, data=None, out_size=None):
        data = self.cell_data if data is None else data
        main, tail = self._chunked_cells(
            lambda c, d: self._residual_block(x, c, consts, d, out_size),
            coeffs, data, self.RESIDUAL_CHUNK)
        out = 0.0
        if main is not None:
            out = jnp.sum(main, axis=0)
        if tail is not None:
            out = out + tail
        return out

    def _residual_block(self, x, coeffs, consts, data, out_size=None):
        x = jnp.asarray(x, self.dtype)
        vals, grads = {}, {}
        for f in self.space.names:
            vals[f], grads[f] = self._eval_field(f, x, data)
        cv, cg = self._prepare_coeffs(coeffs, data)

        pw = lambda xq, sv, sg, cvq, cgq: self._pointwise(
            xq, sv, sg, cvq, cgq, consts)
        t = jax.vmap(jax.vmap(pw))(data["xq"], vals, grads, cv, cg)

        wdet, G = data["wdet"], data["G"]
        F = jnp.zeros(out_size or self.space.num_dofs, self.dtype)
        for f in self.space.names:
            phi, dphi = self.tab[f]
            a0, a1 = t[f]                            # (e,q,m), (e,q,m,gdim)
            wa0 = a0 * wdet[:, :, None]
            wa1 = jnp.einsum("eqdt,eqmd->eqmt", G,
                             a1 * wdet[:, :, None, None])
            r = (jnp.einsum("qi,eqm->eim", phi, wa0)
                 + jnp.einsum("qit,eqmt->eim", dphi, wa1))
            F = F.at[data["gather_idx"][f].reshape(-1)].add(r.reshape(-1))
        return F

    @cached_property
    def _residual_jit(self):
        return jax.jit(lambda x, coeffs, consts, data:
                       self._residual_core(x, coeffs, consts, data))

    def residual(self, x, coeffs=None, consts=None) -> jnp.ndarray:
        return self._residual_jit(x, coeffs or {}, consts or {},
                                  self.cell_data)

    # ------------------------------------------------- matrix-free Jacobian

    def _jacobian_residual_core(self, x, coeffs, consts, data=None,
                                out_size=None):
        """Residual whose derivative defines the Jacobian (may differ from
        the true residual when jacobian_fn is set)."""
        if self.jacobian_fn is None:
            return self._residual_core(x, coeffs, consts, data, out_size)
        data = self.cell_data if data is None else data
        main, tail = self._chunked_cells(
            lambda c, d: self._jacres_block(x, c, consts, d, out_size),
            coeffs, data, self.RESIDUAL_CHUNK)
        out = 0.0
        if main is not None:
            out = jnp.sum(main, axis=0)
        if tail is not None:
            out = out + tail
        return out

    def _jacres_block(self, x, coeffs, consts, data, out_size=None):
        x = jnp.asarray(x, self.dtype)
        vals, grads = {}, {}
        for f in self.space.names:
            vals[f], grads[f] = self._eval_field(f, x, data)
        cv, cg = self._prepare_coeffs(coeffs, data)
        pw = lambda xq, sv, sg, cvq, cgq: self._pointwise(
            xq, sv, sg, cvq, cgq, consts, self.jacobian_fn)
        t = jax.vmap(jax.vmap(pw))(data["xq"], vals, grads, cv, cg)
        wdet, G = data["wdet"], data["G"]
        F = jnp.zeros(out_size or self.space.num_dofs, self.dtype)
        for f in self.space.names:
            phi, dphi = self.tab[f]
            a0, a1 = t[f]
            wa0 = a0 * wdet[:, :, None]
            wa1 = jnp.einsum("eqdt,eqmd->eqmt", G,
                             a1 * wdet[:, :, None, None])
            r = (jnp.einsum("qi,eqm->eim", phi, wa0)
                 + jnp.einsum("qit,eqmt->eim", dphi, wa1))
            F = F.at[data["gather_idx"][f].reshape(-1)].add(r.reshape(-1))
        return F

    @cached_property
    def _jvp_jit(self):
        def action(x, v, coeffs, consts, data):
            f = lambda y: self._jacobian_residual_core(y, coeffs, consts, data)
            return jax.jvp(f, (x,), (v,))[1]
        return jax.jit(action)

    def jacobian_action(self, x, v, coeffs=None, consts=None) -> jnp.ndarray:
        """J(x) @ v without materializing J (replaces assemble_matrix+MatMult)."""
        return self._jvp_jit(x, v, coeffs or {}, consts or {}, self.cell_data)

    # ------------------------------------------------- element matrices

    # Cell-block sizes for chunked assembly (lax.map over blocks): the
    # batched einsums materialize (cells, nq, ...)-shaped intermediates
    # of tens of GB on large meshes — 27.7 GB for the jacfwd element
    # matrices at the 80^2 x qdeg-10 gradient-constraint mesh. Chunking
    # bounds the working set at identical results (tests/test_assembly.py).
    # The sizes were chosen for a 16 GB device and are not yet retuned
    # for an 80 GB one.
    ELEMENT_MATRIX_CHUNK = 2048
    RESIDUAL_CHUNK = 16384

    def _chunked_cells(self, block_fn, coeffs, data, chunk):
        """Run block_fn(coeffs_block, data_block) over cell blocks.
        Returns (stacked_main | None, tail_out | None): full blocks are
        evaluated under jax.lax.map (stacked on a leading axis), the
        remainder directly. FE-coefficient vectors pass through whole;
        per-cell quadrature coefficient arrays are sliced with the data.
        """
        e = data["wdet"].shape[0]
        if e <= chunk:
            return None, block_fn(dict(coeffs or {}), data)
        raw = {k: v for k, v in (coeffs or {}).items()
               if k not in self.coeff_tab}
        fe = {k: v for k, v in (coeffs or {}).items() if k in self.coeff_tab}

        def slice_tree(lo, n):
            d = jax.tree_util.tree_map(
                lambda a: jax.lax.dynamic_slice_in_dim(a, lo, n, axis=0),
                data)
            r = {k: jax.lax.dynamic_slice_in_dim(jnp.asarray(v, self.dtype),
                                                 lo, n, axis=0)
                 for k, v in raw.items()}
            return d, r

        nfull = e // chunk
        main = None
        if nfull:
            blocks = [slice_tree(i * chunk, chunk) for i in range(nfull)]
            stacked = jax.tree_util.tree_map(
                lambda *xs: jnp.stack(xs), *blocks)
            main = jax.lax.map(
                lambda dr: block_fn({**fe, **dr[1]}, dr[0]), stacked)
        tail = e - nfull * chunk
        tail_out = None
        if tail:
            d, r = slice_tree(nfull * chunk, tail)
            tail_out = block_fn({**fe, **r}, d)
        return main, tail_out

    def _element_matrices_core(self, x, coeffs, consts, data=None):
        """Full mixed element matrices (e, L, L), L = sum_f nl_f * m_f,
        local ordering = fields in space order, each (i, comp) interleaved.
        Large meshes are processed in cell blocks via lax.map to bound the
        jacfwd-einsum working set."""
        data = self.cell_data if data is None else data
        main, tail = self._chunked_cells(
            lambda c, d: self._element_matrices_block(x, c, consts, d),
            coeffs, data, self.ELEMENT_MATRIX_CHUNK)
        parts = []
        if main is not None:
            parts.append(main.reshape((-1,) + main.shape[2:]))
        if tail is not None:
            parts.append(tail)
        return parts[0] if len(parts) == 1 else jnp.concatenate(parts)

    def _element_matrices_block(self, x, coeffs, consts, data):
        x = jnp.asarray(x, self.dtype)
        vals, grads = {}, {}
        for f in self.space.names:
            vals[f], grads[f] = self._eval_field(f, x, data)
        cv, cg = self._prepare_coeffs(coeffs, data)

        jfn = self.jacobian_fn

        def pw_jac(xq, sv, sg, cvq, cgq):
            return jax.jacfwd(lambda s: self._pointwise(
                xq, s[0], s[1], cvq, cgq, consts, jfn))((sv, sg))

        K = jax.vmap(jax.vmap(pw_jac))(data["xq"], vals, grads, cv, cg)
        # K[f] = (Ja0, Ja1); Ja0 = ({g: d a0_f/d val_g}, {g: d a0_f/d grad_g})

        G, w = data["G"], data["wdet"]
        gphi = {}
        for f in self.space.names:
            phi, dphi = self.tab[f]
            gphi[f] = jnp.einsum("eqdt,qit->eqid", G, dphi)

        blocks = []
        for f in self.space.names:
            phif, _ = self.tab[f]
            gpf = gphi[f]
            row = []
            for g in self.space.names:
                phig, _ = self.tab[g]
                gpg = gphi[g]
                (K0, K1) = K[f]
                K00 = K0[0][g] * w[:, :, None, None]
                K01 = K0[1][g] * w[:, :, None, None, None]
                K10 = K1[0][g] * w[:, :, None, None, None]
                K11 = K1[1][g] * w[:, :, None, None, None, None]
                t1 = jnp.einsum("qi,eqab,qj->eiajb", phif, K00, phig)
                t2 = jnp.einsum("qi,eqabd,eqjd->eiajb", phif, K01, gpg)
                t3 = jnp.einsum("eqid,eqadb,qj->eiajb", gpf, K10, phig)
                t4 = jnp.einsum("eqid,eqadbc,eqjc->eiajb", gpf, K11, gpg)
                A = t1 + t2 + t3 + t4
                e, nlf, mf, nlg, mg = A.shape
                row.append(A.reshape(e, nlf * mf, nlg * mg))
            blocks.append(row)
        return jnp.concatenate(
            [jnp.concatenate(r, axis=2) for r in blocks], axis=1)

    @cached_property
    def _element_matrices_jit(self):
        return jax.jit(lambda x, coeffs, consts, data:
                       self._element_matrices_core(x, coeffs, consts, data))

    def element_matrices(self, x, coeffs=None, consts=None) -> jnp.ndarray:
        return self._element_matrices_jit(x, coeffs or {}, consts or {},
                                          self.cell_data)

    @cached_property
    def local_indices(self) -> np.ndarray:
        """(e, L) global dof for each local mixed slot (field-concatenated)."""
        per = [np.asarray(self.gather_idx[f]).reshape(self.mesh.num_cells, -1)
               for f in self.space.names]
        return np.concatenate(per, axis=1)

    def assemble_scipy(self, x, coeffs=None, consts=None):
        """Assembled CSR matrix on host (the MUMPS-replacement LU path for
        small/medium systems and verification)."""
        import scipy.sparse as sp
        Ae = np.asarray(self.element_matrices(x, coeffs, consts))
        gi = self.local_indices
        L = gi.shape[1]
        rows = np.repeat(gi, L, axis=1).reshape(-1)
        cols = np.tile(gi, (1, L)).reshape(-1)
        N = self.space.num_dofs
        A = sp.coo_matrix((Ae.reshape(-1), (rows, cols)), shape=(N, N))
        return A.tocsr()

    # ------------------------------------------------------------ diagonal

    def _diagonal_core(self, x, coeffs, consts, data=None, out_size=None):
        """Jacobian diagonal without materializing element matrices —
        O(ncells * nq * m^2 * d^2) memory, the Jacobi-preconditioner path
        for large (1M-DoF) systems."""
        data = self.cell_data if data is None else data
        main, tail = self._chunked_cells(
            lambda c, d: self._diagonal_block(x, c, consts, d, out_size),
            coeffs, data, self.ELEMENT_MATRIX_CHUNK)
        out = 0.0
        if main is not None:
            out = jnp.sum(main, axis=0)
        if tail is not None:
            out = out + tail
        return out

    def _diagonal_block(self, x, coeffs, consts, data, out_size=None):
        x = jnp.asarray(x, self.dtype)
        vals, grads = {}, {}
        for f in self.space.names:
            vals[f], grads[f] = self._eval_field(f, x, data)
        cv, cg = self._prepare_coeffs(coeffs, data)

        jfn = self.jacobian_fn

        def pw_jac(xq, sv, sg, cvq, cgq):
            return jax.jacfwd(lambda s: self._pointwise(
                xq, s[0], s[1], cvq, cgq, consts, jfn))((sv, sg))

        K = jax.vmap(jax.vmap(pw_jac))(data["xq"], vals, grads, cv, cg)
        G, w = data["G"], data["wdet"]
        out = jnp.zeros(out_size or self.space.num_dofs, self.dtype)
        for f in self.space.names:
            phi, dphi = self.tab[f]
            gphi = jnp.einsum("eqdt,qit->eqid", G, dphi)
            (K0, K1) = K[f]
            K00d = jnp.einsum("eqaa->eqa", K0[0][f])
            K01d = jnp.einsum("eqaad->eqad", K0[1][f])
            K10d = jnp.einsum("eqada->eqad", K1[0][f])
            K11d = jnp.einsum("eqadac->eqadc", K1[1][f])
            t1 = jnp.einsum("qi,qi,eq,eqa->eia", phi, phi, w, K00d)
            t2 = jnp.einsum("qi,eqid,eq,eqad->eia", phi, gphi, w, K01d + K10d)
            t4 = jnp.einsum("eqid,eqadc,eq,eqic->eia", gphi, K11d, w, gphi)
            d = t1 + t2 + t4                         # (e, i, a)
            out = out.at[data["gather_idx"][f].reshape(-1)].add(d.reshape(-1))
        return out

    @cached_property
    def _diag_jit(self):
        return jax.jit(lambda x, coeffs, consts, data:
                       self._diagonal_core(x, coeffs, consts, data))

    def jacobian_diagonal(self, x, coeffs=None, consts=None) -> jnp.ndarray:
        """Diagonal of the assembled Jacobian (Jacobi preconditioning)."""
        return self._diag_jit(x, coeffs or {}, consts or {}, self.cell_data)

    # ------------------------------------------------------- functionals

    def make_functional_core(self, fn: Callable) -> Callable:
        """The data-parameterized core of make_functional:
        (x, coeffs, consts, data) -> scalar. Exposed separately so the
        distributed layer (parallel/dofpart.py) can evaluate the same
        integrand on device-local rewritten cell data inside shard_map
        (x = the ghost-extended vector, data = data_loc)."""

        def functional_core(x, coeffs, consts, data):
            xx = jnp.asarray(x, self.dtype)
            vals, grads = {}, {}
            for f in self.space.names:
                vals[f], grads[f] = self._eval_field(f, xx, data)
            cv, cg = self._prepare_coeffs(coeffs, data)

            def pw(xq, sv, sg, cvq, cgq):
                u, gu = self._user_shapes(sv, sg)
                c, gc = self._user_coeff_shapes(cvq, cgq)
                return fn(xq, u, gu, c, gc, consts or {})

            vq = jax.vmap(jax.vmap(pw))(data["xq"], vals, grads, cv, cg)
            return jnp.sum(vq * data["wdet"])

        return functional_core

    def make_functional(self, fn: Callable) -> Callable:
        """Compile a scalar functional ∫ fn(x, u, gu, c, gc, consts) dx —
        the observables of the reference (energy, complementarity,
        feasibility, increments; obstacle_pg.py:145-152)."""
        jitted = jax.jit(self.make_functional_core(fn))

        def functional(x, coeffs=None, consts=None):
            return jitted(x, coeffs or {}, consts or {}, self.cell_data)

        return functional

    def interpolate_to_quadrature(self, fn: Callable) -> np.ndarray:
        """Evaluate a host function f(x:(gdim,npts)) at all physical
        quadrature points -> (ncells, nq) array (the quadrature-element
        interpolation of the obstacle, obstacle_pg.py:106-111)."""
        xq = np.asarray(self.xq)
        flat = xq.reshape(-1, self.gdim).T
        return np.asarray(fn(flat)).reshape(xq.shape[0], xq.shape[1])
