"""proximalgalerkin_tpu — an accelerator-native Latent Variable Proximal
Point (LVPP) finite-element framework in JAX.

A from-scratch, self-contained rebuild of the capabilities of
METHODS-Group/ProximalGalerkin (the companion code of the LVPP paper), designed
accelerator-first: unstructured-mesh FEM assembly runs as batched einsum
contractions over SoA cell arrays, Jacobians act matrix-free inside jitted
Krylov solvers, and distribution is SPMD sharding over a `jax.sharding.Mesh`
with device collectives — replacing the reference's
DOLFINx/PETSc/MUMPS/MPI stack.

Package layout (see SURVEY.md §7):
  core/        dtypes, options, converged reasons, logging
  elements/    reference cells, quadrature, orthonormal bases, Lagrange tabulation
  mesh/        SoA meshes, structured + parametric generators, topology
  spaces/      function spaces, dofmaps, mixed spaces, Dirichlet BCs
  forms/       pointwise weak forms (JAX autodiff replaces UFL derivative),
               entropy/Bregman map library (exp, softmax, hellinger, expm, tanhm)
  assembly/    geometry factors, residual/matrix assembly, sparsity
  la/          ELL sparse matrices, CG/MINRES/GMRES, preconditioners, host LU
  solve/       Newton (SNES-compatible semantics), LVPP outer driver
  parallel/    device-mesh partitioning, halo exchange, sharded assembly/solve
  models/      the 10 reference example problems as library models
  observables/ jitted functional registry + CSV/JSONL sinks
"""

import os

# FEM with 1e-8..1e-12 tolerances (reference protocol, BASELINE.md) needs f64
# accumulation. Enable x64 globally unless the user opts out; individual compute
# paths may still downcast (e.g. bf16/f32 element kernels with f64 reductions).
if os.environ.get("PGTPU_DISABLE_X64", "0") != "1":
    import jax

    jax.config.update("jax_enable_x64", True)

__version__ = "0.1.0"

from .core.config import SolverOptions, default_dtype  # noqa: E402,F401
from .core.reasons import ConvergedReason  # noqa: E402,F401
