"""Host sparse direct solve (scipy SuperLU).

The escape hatch standing in for MUMPS (`pc_factor_mat_solver_type: mumps`
in every reference example, e.g. obstacle_pg.py:131): exact LU on host for
small/medium systems and for verifying the device Krylov path. The device fast
path is matrix-free Krylov in la/krylov.py.

Column ordering: MMD on A^T+A — LVPP Jacobians have symmetric sparsity,
where it halves fill and factor time vs scipy's COLAMD default (measured
at 240k dofs: 12.7 s / 7.5M nnz(L) vs 21.6 s / 15.2M). Falls back to
COLAMD if the symmetric ordering fails (nonsquare/degenerate patterns).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse.linalg as spla


_best_spec: dict = {}


def _splu(A_csc):
    # No ordering wins everywhere: MMD_AT_PLUS_A halves fill and time on
    # the 240k-dof gradient-constraint Jacobian (12.7 s vs COLAMD 21.6 s)
    # but is 60x WORSE on the 5.7k fracture Jacobian (6.45 s / 6.8M fill
    # vs COLAMD 0.105 s / 0.94M — measured), which round 2's MMD-first
    # policy turned into a 45 h record pace. MMD can also OOM where COLAMD
    # factors fine (200^2 qdeg-10 gradient system). So: race both once
    # per sparsity pattern (keyed by shape+nnz, which is fixed across
    # Newton steps of one problem) and keep the faster for the process.
    import time as _time
    key = (A_csc.shape[0], A_csc.nnz)
    spec = _best_spec.get(key)
    if spec is not None:
        return spla.splu(A_csc, permc_spec=spec)
    t0 = _time.time()
    lu_col = spla.splu(A_csc, permc_spec="COLAMD")
    t_col = _time.time() - t0
    if t_col < 5.0:
        # Don't race MMD when COLAMD is already fast: MMD's upside here is
        # < t_col per factor, while its downside is unbounded — on the 61k
        # multiphase saddle MMD fill-in ran >16 min / >7 GB RSS (measured
        # round 3) vs COLAMD's seconds, wedging the 700-step record inside
        # its first Newton direction. MMD only ever won in the slow-factor
        # regime (240k-dof gradient system: 21.6 s COLAMD vs 12.7 s MMD).
        _best_spec[key] = "COLAMD"
        return lu_col
    try:
        t0 = _time.time()
        lu_mmd = spla.splu(A_csc, permc_spec="MMD_AT_PLUS_A")
        t_mmd = _time.time() - t0
    except Exception:
        t_mmd, lu_mmd = float("inf"), None
    if t_mmd < t_col:
        _best_spec[key] = "MMD_AT_PLUS_A"
        return lu_mmd
    _best_spec[key] = "COLAMD"
    return lu_col


def lu_solve(A_csr, b: np.ndarray) -> np.ndarray:
    """One-shot sparse LU solve on host."""
    return _splu(A_csr.tocsc()).solve(np.asarray(b))


class LUFactorization:
    """Reusable factorization (KSPSolve with reused PC in PETSc terms).

    With ``perm_r``/``perm_c`` (from la/ordering.py) the matrix is
    pre-permuted and factored with SuperLU's NATURAL column order and
    static pivoting (``pivot_thresh=0.0``) — the METIS-ND-like path that
    replaces MUMPS's ordering on node-block saddle systems where COLAMD
    fill explodes (measured 30 s -> 4.4 s per factor on the 50^2
    multiphase Jacobian)."""

    def __init__(self, A_csr, perm_r=None, perm_c=None, pivot_thresh=None):
        if perm_r is None:
            self._perm_r = self._perm_c = None
            self._lu = _splu(A_csr.tocsc())
            return
        self._perm_r = np.asarray(perm_r)
        self._perm_c = np.asarray(perm_c if perm_c is not None else perm_r)
        Ap = A_csr[self._perm_r][:, self._perm_c].tocsc()
        kw = {} if pivot_thresh is None else dict(diag_pivot_thresh=pivot_thresh)
        self._lu = spla.splu(Ap, permc_spec="NATURAL", **kw)

    def solve(self, b: np.ndarray) -> np.ndarray:
        b = np.asarray(b)
        if self._perm_r is None:
            return self._lu.solve(b)
        y = self._lu.solve(b[self._perm_r])
        x = np.empty_like(y)
        x[self._perm_c] = y
        return x


class PermutedFactorizer:
    """Caches the (pattern-fixed) data gather from a CSR matrix to its
    ND-permuted CSC form, so repeated refactorizations skip scipy's
    generic two-sided fancy indexing (~1.5 s at 5M nnz -> ~50 ms).

    The role MUMPS's separated analyze/factorize phases play in the
    reference (symbolic once, numeric per Newton step)."""

    def __init__(self, A_csr, perm_r, perm_c, pivot_thresh=0.0,
                 dtype=np.float64):
        import scipy.sparse as sp
        self.perm_r = np.asarray(perm_r)
        self.perm_c = np.asarray(perm_c)
        self.pivot_thresh = pivot_thresh
        # f32 factorization halves factor+triangular-solve cost; iterative
        # refinement in _lu_direction recovers f64 directions (the factor's
        # ~1e-7 contraction per pass is far better than the ~0.1-0.3 drift
        # contraction of a lagged factor, so pass counts are unchanged)
        self.dtype = np.dtype(dtype)
        tag = A_csr.copy()
        # float64 holds integers exactly to 2^53; +1 so no stored entry
        # becomes a prunable zero
        tag.data = np.arange(1, tag.nnz + 1, dtype=np.float64)
        Ap = tag[self.perm_r][:, self.perm_c].tocsc()
        self._datamap = (Ap.data - 1.0).astype(np.int64)
        self._indices = Ap.indices
        self._indptr = Ap.indptr
        self._shape = Ap.shape
        self._sp = sp

    def factor(self, A_csr) -> "LUFactorization":
        Ap = self._sp.csc_matrix(
            (A_csr.data[self._datamap].astype(self.dtype, copy=False),
             self._indices, self._indptr),
            shape=self._shape)
        lu = LUFactorization.__new__(LUFactorization)
        lu._perm_r = self.perm_r
        lu._perm_c = self.perm_c
        kw = {} if self.pivot_thresh is None else \
            dict(diag_pivot_thresh=self.pivot_thresh)
        lu._lu = spla.splu(Ap, permc_spec="NATURAL", **kw)
        if self.dtype == np.float32:
            inner = lu._lu
            pr, pc = self.perm_r, self.perm_c

            class _F32Solve:
                def solve(self, b):
                    return inner.solve(b.astype(np.float32)).astype(
                        np.float64)
            lu._lu = _F32Solve()
        return lu
