"""Device-resident ELL sparse matrices.

The device-native replacement for PETSc's assembled AIJ matrices: fixed-width
padded rows (ELLPACK) so SpMV is a dense gather + multiply + row-reduce —
regular, vectorizable, and memory-bound on the device. Used
as the Krylov operator inside Newton: the Jacobian is assembled once per
Newton step (scatter-add of element matrices through a precomputed slot
map), then each Krylov iteration costs one gather-SpMV instead of a full
jvp re-assembly of the physics.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class EllPattern:
    """Host-precomputed sparsity data for a fixed mesh/space/BC set.

    csr slot layout: unique (row, col) pairs sorted lexicographically.
      slot_map:   (e*L*L,) csr slot of each element-matrix entry
      keep:       (nnz,) 0.0 where the entry is zeroed by BC rows/cols
      diag_ones:  (nnz,) 1.0 at bc-row diagonal slots (added post-zeroing)
      ell_gather: (N, K) csr slot feeding each ELL lane (nnz slot -> lane),
                  padded with slot nnz (a synthetic zero entry)
      ell_cols:   (N, K) column ids, padded with the row itself
    """

    num_dofs: int
    nnz: int
    width: int
    slot_map: np.ndarray
    keep: np.ndarray
    diag_ones: np.ndarray
    ell_gather: np.ndarray
    ell_cols: np.ndarray

    @classmethod
    def build(cls, local_indices: np.ndarray, num_dofs: int,
              bc_idx: Optional[np.ndarray] = None) -> "EllPattern":
        # Content-addressed disk cache: the sort-dedup over e*L*L entries
        # costs minutes of host time at protocol sizes (measured: ~110 s
        # for the 50^2 multiphase pattern, 13M entries, on the 1-core
        # bench host) and is identical across every run/probe/record of
        # the same problem. Keyed on the full input bytes, so stale hits
        # are impossible.
        import hashlib
        from pathlib import Path
        gi = np.asarray(local_indices, dtype=np.int64)
        bc_arr = (np.asarray(bc_idx, dtype=np.int64)
                  if bc_idx is not None else np.empty(0, np.int64))
        h = hashlib.sha256()
        h.update(gi.tobytes())
        h.update(np.int64(num_dofs).tobytes())
        h.update(bc_arr.tobytes())
        cache = Path(__file__).resolve().parents[2] / ".pattern_cache"
        f = cache / f"ell_{h.hexdigest()[:24]}.npz"
        if f.exists():
            try:
                z = np.load(f)
                return cls(num_dofs=int(z["num_dofs"]), nnz=int(z["nnz"]),
                           width=int(z["width"]), slot_map=z["slot_map"],
                           keep=z["keep"], diag_ones=z["diag_ones"],
                           ell_gather=z["ell_gather"], ell_cols=z["ell_cols"])
            except Exception:
                pass
        pat = cls._build_uncached(gi, num_dofs, bc_arr)
        try:
            cache.mkdir(exist_ok=True)
            tmp = f.with_suffix(".tmp.npz")
            np.savez(tmp, num_dofs=pat.num_dofs, nnz=pat.nnz,
                     width=pat.width, slot_map=pat.slot_map, keep=pat.keep,
                     diag_ones=pat.diag_ones, ell_gather=pat.ell_gather,
                     ell_cols=pat.ell_cols)
            tmp.replace(f)
        except Exception:
            pass
        return pat

    @classmethod
    def _build_uncached(cls, gi: np.ndarray, num_dofs: int,
                        bc_idx: np.ndarray) -> "EllPattern":
        from ..native import unique_with_inverse
        E, L = gi.shape
        rows = np.repeat(gi, L, axis=1).reshape(-1)
        cols = np.tile(gi, (1, L)).reshape(-1)
        key = rows * num_dofs + cols
        # native C++ sort-dedup (numpy fallback inside) — the setup hot
        # spot at 1M+ dofs
        uniq, slot = unique_with_inverse(key)
        nnz = len(uniq)
        urow = (uniq // num_dofs).astype(np.int64)
        ucol = (uniq % num_dofs).astype(np.int64)

        bc = np.zeros(num_dofs, dtype=bool)
        if bc_idx is not None and len(bc_idx):
            bc[np.asarray(bc_idx, dtype=np.int64)] = True
        keep = (~(bc[urow] | bc[ucol])).astype(np.float64)
        diag_ones = ((urow == ucol) & bc[urow]).astype(np.float64)

        counts = np.bincount(urow, minlength=num_dofs)
        K = int(counts.max()) if nnz else 1
        # lane index of each csr slot within its row (slots are row-sorted)
        row_start = np.zeros(num_dofs + 1, dtype=np.int64)
        np.cumsum(counts, out=row_start[1:])
        lane = np.arange(nnz) - row_start[urow]

        ell_gather = np.full((num_dofs, K), nnz, dtype=np.int64)
        ell_cols = np.tile(np.arange(num_dofs, dtype=np.int64)[:, None], (1, K))
        ell_gather[urow, lane] = np.arange(nnz)
        ell_cols[urow, lane] = ucol

        return cls(num_dofs=num_dofs, nnz=nnz, width=K,
                   slot_map=slot.astype(np.int32),
                   keep=keep, diag_ones=diag_ones,
                   ell_gather=ell_gather.astype(np.int32),
                   ell_cols=ell_cols.astype(np.int32))


class EllMatrix:
    """Pattern + device arrays; assemble(element_matrices) -> ELL data.

    Index/mask arrays are exposed as an `arrays` pytree meant to be passed
    into jitted kernels as runtime arguments (closure-capturing them embeds
    multi-MB constants into the XLA graph and triggers pathological
    constant folding)."""

    def __init__(self, pattern: EllPattern, dtype=jnp.float64):
        self.pattern = pattern
        self.dtype = dtype
        self._arrays = None

    @property
    def arrays(self):
        """Device index/mask arrays, transferred LAZILY on first use —
        the DIA fast path never touches them, and they are hundreds of MB
        at 1M+ dofs."""
        if self._arrays is None:
            pattern = self.pattern
            self._arrays = {
                "slot_map": jnp.asarray(pattern.slot_map),
                "keep": jnp.asarray(pattern.keep, self.dtype),
                "diag_ones": jnp.asarray(pattern.diag_ones, self.dtype),
                "ell_gather": jnp.asarray(pattern.ell_gather),
                "ell_cols": jnp.asarray(pattern.ell_cols),
            }
        return self._arrays

    def assemble(self, element_matrices: jnp.ndarray, arrays=None) -> jnp.ndarray:
        """(e, L, L) element matrices -> (N, K) ELL data with BCs applied
        (zeroed bc rows/cols, unit bc diagonal — the reference's
        assemble_matrix(J, a, bcs) semantics, problem.py:75-77)."""
        a = self.arrays if arrays is None else arrays
        flat = element_matrices.reshape(-1).astype(self.dtype)
        csr = jax.ops.segment_sum(flat, a["slot_map"],
                                  num_segments=self.pattern.nnz)
        csr = csr * a["keep"] + a["diag_ones"]
        padded = jnp.concatenate([csr, jnp.zeros((1,), self.dtype)])
        return padded[a["ell_gather"]]

    def spmv(self, data: jnp.ndarray, x: jnp.ndarray, arrays=None) -> jnp.ndarray:
        a = self.arrays if arrays is None else arrays
        return jnp.sum(data * x[a["ell_cols"]], axis=1)

    def diagonal(self, data: jnp.ndarray, arrays=None) -> jnp.ndarray:
        a = self.arrays if arrays is None else arrays
        row = jnp.arange(self.pattern.num_dofs)[:, None]
        mask = a["ell_cols"] == row
        return jnp.sum(jnp.where(mask, data, 0.0), axis=1)
