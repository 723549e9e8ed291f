"""Exterior-facet (ds) assembly.

The rebuild of DOLFINx's exterior-facet integrals (`ds` measures), needed
by the Signorini contact terms (signorini_dolfinx.py:244-249, latent
coupling on the contact boundary) and boundary observables. Facets are
grouped by their local index within the owning cell (a static, small set),
each group assembling as one batched einsum — same batched structure
as the volume path.

Geometry: quadrature points on the reference facet are mapped into the
owning cell's reference coordinates; the surface measure is the Gram
determinant of the facet tangent map, and outward normals come from the
cell Jacobian and the reference outward normal.
"""

from __future__ import annotations

from functools import cached_property
from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..elements.cells import reference_cell
from ..elements.lagrange import lagrange_element
from ..elements.quadrature import cell_quadrature
from ..spaces.space import MixedSpace


def _facet_maps(ref_cell):
    """Per local facet: (origin, tangent matrix (tdim, fdim), ref outward
    normal (tdim,))."""
    fdim = ref_cell.dim - 1
    fcell = reference_cell(ref_cell.facet_cell)
    maps = []
    bary = ref_cell.vertices.mean(axis=0)
    for fverts in ref_cell.facets:
        v0 = ref_cell.vertices[fverts[0]]
        T = np.stack([ref_cell.vertices[fverts[i + 1]] - v0
                      for i in range(fdim)], axis=1)   # (tdim, fdim)
        # outward normal: orthogonal to tangents, pointing away from bary
        if ref_cell.dim == 2:
            t = T[:, 0]
            n = np.array([t[1], -t[0]])
        else:
            n = np.cross(T[:, 0], T[:, 1])
        n = n / np.linalg.norm(n)
        mid = v0 + T.sum(axis=1) / (fdim + 1)
        if np.dot(n, mid - bary) < 0:
            n = -n
        maps.append((v0, T, n))
    return maps


class FacetForm:
    """Assembler for ∫_Γ ... ds over a set of exterior facets.

    residual_fn(x, u, gu, c, gc, n, consts) -> {field: a0}
      contributions are ∫ a0 · v ds for each test field (no grad(v) terms —
      sufficient for every reference ds integral).
    Coefficients: quadrature arrays of shape (nfacets, nq, ...) or scalars.
    """

    def __init__(self, space: MixedSpace, facets: np.ndarray,
                 residual_fn: Callable, quadrature_degree: int,
                 dtype=jnp.float64, jacobian_fn: Optional[Callable] = None):
        self.space = space
        self.residual_fn = residual_fn
        # Optional modified-Jacobian residual (the reference's regularized-
        # Jacobian pattern, fracture_dolfinx.py:132-138): its derivative is
        # used for element matrices / matrix-free actions while residual_fn
        # defines F — e.g. an eps-mass term keeping the latent block's
        # diagonal bounded away from zero for iterative solvers.
        self.jacobian_fn = jacobian_fn
        self.dtype = dtype
        mesh = space.mesh
        self.mesh = mesh
        ref = mesh.ref_cell
        self.facets = np.asarray(facets, dtype=np.int64)
        fq, fw = cell_quadrature(ref.facet_cell, quadrature_degree)
        self.nq = len(fw)

        cells = mesh.facet_cells[self.facets, 0]
        locals_ = mesh.facet_local_index[self.facets, 0]
        fmaps = _facet_maps(ref)
        geo_el = lagrange_element(mesh.cell_type, mesh.geom_degree)
        coords = mesh.points[mesh.cells]    # (ncells, ngeo, gdim)

        nfac = len(self.facets)
        gdim, tdim = mesh.gdim, mesh.tdim
        xq = np.zeros((nfac, self.nq, gdim))
        wdet = np.zeros((nfac, self.nq))
        normals = np.zeros((nfac, self.nq, gdim))
        # per-field basis tables at facet quadrature, per facet
        self.tabs: Dict[str, np.ndarray] = {}
        self.gtabs: Dict[str, np.ndarray] = {}
        field_tab = {f: np.zeros((nfac, self.nq,
                                  space.spaces[f].element.ndof))
                     for f in space.names}
        field_gtab = {f: np.zeros((nfac, self.nq,
                                   space.spaces[f].element.ndof, gdim))
                      for f in space.names}

        for lf in range(ref.num_facets):
            sel = np.flatnonzero(locals_ == lf)
            if len(sel) == 0:
                continue
            v0, T, nref = fmaps[lf]
            cell_pts = v0[None, :] + fq @ T.T        # (nq, tdim)
            gphi, gdphi = geo_el.tabulate(cell_pts)
            cc = coords[cells[sel]]                  # (n, ngeo, gdim)
            xq[sel] = np.einsum("qn,cnd->cqd", gphi, cc)
            J = np.einsum("qnt,cnd->cqdt", gdphi, cc)  # (n, nq, gdim, tdim)
            # facet tangents in physical space
            Jf = np.einsum("cqdt,tf->cqdf", J, T)      # (n, nq, gdim, fdim)
            Gram = np.einsum("cqdf,cqdg->cqfg", Jf, Jf)
            wdet[sel] = fw[None, :] * np.sqrt(np.abs(np.linalg.det(Gram)))
            # outward normal: J^{-T} nref normalized (gdim == tdim case)
            if gdim == tdim:
                Jinv = np.linalg.inv(J)
                nn = np.einsum("cqtd,t->cqd", Jinv, nref)
                nn /= np.linalg.norm(nn, axis=-1, keepdims=True)
                normals[sel] = nn
            for f in space.names:
                el = space.spaces[f].element
                phi, dphi = el.tabulate(cell_pts)
                field_tab[f][sel] = phi[None, :, :]
                if gdim == tdim:
                    GT = np.swapaxes(np.linalg.inv(J), -1, -2)
                else:
                    JTJ = np.einsum("cqdt,cqds->cqts", J, J)
                    GT = np.einsum("cqdt,cqts->cqds", J, np.linalg.inv(JTJ))
                field_gtab[f][sel] = np.einsum(
                    "cqdt,qit->cqid", GT, dphi)

        gather_idx = {}
        for f in space.names:
            fs = space.spaces[f]
            m = fs.value_size
            dm = fs.dofmap[cells].astype(np.int64)
            idx = (space.offsets[f] + dm[:, :, None] * m
                   + np.arange(m)[None, None, :])
            gather_idx[f] = jnp.asarray(idx.astype(np.int32))

        self.facet_data = {
            "xq": jnp.asarray(xq, dtype),
            "wdet": jnp.asarray(wdet, dtype),
            "normals": jnp.asarray(normals, dtype),
            "tab": {f: jnp.asarray(v, dtype) for f, v in field_tab.items()},
            "gtab": {f: jnp.asarray(v, dtype) for f, v in field_gtab.items()},
            "gather_idx": gather_idx,
        }
        self.field_m = {f: space.spaces[f].value_size for f in space.names}

    # ------------------------------------------------------------ core

    def _residual_core(self, x, coeffs, consts, data=None, out_size=None,
                       fn: Optional[Callable] = None):
        data = self.facet_data if data is None else data
        x = jnp.asarray(x, self.dtype)
        vals, grads = {}, {}
        for f in self.space.names:
            zc = x[data["gather_idx"][f]]            # (n, i, m)
            vals[f] = jnp.einsum("nqi,nim->nqm", data["tab"][f], zc)
            grads[f] = jnp.einsum("nqid,nim->nqmd", data["gtab"][f], zc)

        cv = {}
        for name, arr in (coeffs or {}).items():
            a = jnp.asarray(arr, self.dtype)
            if a.ndim == 2:
                a = a[:, :, None]
            cv[name] = a

        user_fn = fn or self.residual_fn

        def pw(xq, sv, sg, cvq, nrm):
            u = {f: (sv[f][0] if self.field_m[f] == 1 else sv[f])
                 for f in self.space.names}
            gu = {f: (sg[f][0] if self.field_m[f] == 1 else sg[f])
                  for f in self.space.names}
            c = {k: (v[0] if v.shape == (1,) else v) for k, v in cvq.items()}
            out = user_fn(xq, u, gu, c, {}, nrm, consts)
            res = {}
            for f, m in self.field_m.items():
                a0 = out.get(f)
                res[f] = (jnp.zeros((m,), self.dtype) if a0 is None
                          else jnp.asarray(a0).reshape(m))
            return res

        t = jax.vmap(jax.vmap(pw))(data["xq"], vals, grads, cv,
                                   data["normals"])
        F = jnp.zeros(out_size or self.space.num_dofs, self.dtype)
        for f in self.space.names:
            a0 = t[f] * data["wdet"][:, :, None]
            r = jnp.einsum("nqi,nqm->nim", data["tab"][f], a0)
            F = F.at[data["gather_idx"][f].reshape(-1)].add(r.reshape(-1))
        return F

    @cached_property
    def _residual_jit(self):
        return jax.jit(lambda x, coeffs, consts, data:
                       self._residual_core(x, coeffs, consts, data))

    def residual(self, x, coeffs=None, consts=None):
        return self._residual_jit(x, coeffs or {}, consts or {},
                                  self.facet_data)

    def _jacobian_residual_core(self, x, coeffs, consts, data=None,
                                out_size=None):
        """Residual whose derivative defines the Jacobian (differs from
        the true residual when jacobian_fn is set)."""
        return self._residual_core(x, coeffs, consts, data, out_size,
                                   fn=self.jacobian_fn)

    # ------------------------------------------------- element matrices

    def _element_matrices_core(self, x, coeffs, consts, data=None):
        """Facet element matrices (nfacets, L, L), L = sum_f nl_f * m_f —
        jacfwd of the pointwise facet residual (value + gradient coupling
        of a0 terms)."""
        data = self.facet_data if data is None else data
        x = jnp.asarray(x, self.dtype)
        vals, grads = {}, {}
        for f in self.space.names:
            zc = x[data["gather_idx"][f]]
            vals[f] = jnp.einsum("nqi,nim->nqm", data["tab"][f], zc)
            grads[f] = jnp.einsum("nqid,nim->nqmd", data["gtab"][f], zc)
        cv = {}
        for name, arr in (coeffs or {}).items():
            a = jnp.asarray(arr, self.dtype)
            if a.ndim == 2:
                a = a[:, :, None]
            cv[name] = a

        jfn = self.jacobian_fn or self.residual_fn

        def pw(xq, sv, sg, cvq, nrm):
            u = {f: (sv[f][0] if self.field_m[f] == 1 else sv[f])
                 for f in self.space.names}
            gu = {f: (sg[f][0] if self.field_m[f] == 1 else sg[f])
                  for f in self.space.names}
            c = {k: (v[0] if v.shape == (1,) else v) for k, v in cvq.items()}
            out = jfn(xq, u, gu, c, {}, nrm, consts)
            res = {}
            for f, m in self.field_m.items():
                a0 = out.get(f)
                res[f] = (jnp.zeros((m,), self.dtype) if a0 is None
                          else jnp.asarray(a0).reshape(m))
            return res

        def pw_jac(xq, sv, sg, cvq, nrm):
            return jax.jacfwd(lambda s: pw(xq, s[0], s[1], cvq, nrm))(
                (sv, sg))

        K = jax.vmap(jax.vmap(pw_jac))(data["xq"], vals, grads, cv,
                                       data["normals"])
        w = data["wdet"]
        blocks = []
        for f in self.space.names:
            tf = data["tab"][f]
            row = []
            for g in self.space.names:
                tg, gg = data["tab"][g], data["gtab"][g]
                K00 = K[f][0][g] * w[:, :, None, None]
                K01 = K[f][1][g] * w[:, :, None, None, None]
                t1 = jnp.einsum("nqi,nqab,nqj->niajb", tf, K00, tg)
                t2 = jnp.einsum("nqi,nqabd,nqjd->niajb", tf, K01, gg)
                A = t1 + t2
                n, nlf, mf, nlg, mg = A.shape
                row.append(A.reshape(n, nlf * mf, nlg * mg))
            blocks.append(row)
        return jnp.concatenate(
            [jnp.concatenate(r, axis=2) for r in blocks], axis=1)

    @cached_property
    def _elmat_jit(self):
        return jax.jit(lambda x, coeffs, consts, data:
                       self._element_matrices_core(x, coeffs, consts, data))

    def element_matrices(self, x, coeffs=None, consts=None):
        return self._elmat_jit(x, coeffs or {}, consts or {},
                               self.facet_data)

    @cached_property
    def local_indices(self) -> np.ndarray:
        per = [np.asarray(self.facet_data["gather_idx"][f]).reshape(
            len(self.facets), -1) for f in self.space.names]
        return np.concatenate(per, axis=1)

    def make_functional(self, fn: Callable) -> Callable:
        """∫_Γ fn(x, u, gu, c, gc, n, consts) ds (boundary observables,
        e.g. the Signorini penetration integral signorini_dolfinx.py:309-314)."""

        def core(x, coeffs, consts, data):
            xx = jnp.asarray(x, self.dtype)
            vals, grads = {}, {}
            for f in self.space.names:
                zc = xx[data["gather_idx"][f]]
                vals[f] = jnp.einsum("nqi,nim->nqm", data["tab"][f], zc)
                grads[f] = jnp.einsum("nqid,nim->nqmd", data["gtab"][f], zc)
            cv = {}
            for name, arr in (coeffs or {}).items():
                a = jnp.asarray(arr, self.dtype)
                if a.ndim == 2:
                    a = a[:, :, None]
                cv[name] = a

            def pw(xq, sv, sg, cvq, nrm):
                u = {f: (sv[f][0] if self.field_m[f] == 1 else sv[f])
                     for f in self.space.names}
                gu = {f: (sg[f][0] if self.field_m[f] == 1 else sg[f])
                      for f in self.space.names}
                c = {k: (v[0] if v.shape == (1,) else v)
                     for k, v in cvq.items()}
                return fn(xq, u, gu, c, {}, nrm, consts or {})

            vq = jax.vmap(jax.vmap(pw))(data["xq"], vals, grads, cv,
                                        data["normals"])
            return jnp.sum(vq * data["wdet"])

        jitted = jax.jit(core)

        def functional(x, coeffs=None, consts=None):
            return jitted(x, coeffs or {}, consts or {}, self.facet_data)

        return functional
