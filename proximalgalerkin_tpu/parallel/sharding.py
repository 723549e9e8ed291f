"""SPMD domain decomposition over a JAX device mesh.

The device-native replacement for the reference's one parallelism strategy —
MPI mesh partitioning with PETSc ghost vectors (SURVEY.md §2.3;
src/lvpp/problem.py:56-66): cells are block-partitioned across devices of a
1D `jax.sharding.Mesh`; per-cell assembly arrays (quadrature geometry,
gather indices, quadrature-point coefficients) carry a NamedSharding along
the cell axis, the dof vector is replicated, and XLA inserts the
device collectives (all-reduce of the scatter-add, replicated reductions) that
ghostUpdate(ADD/REVERSE) + comm.allreduce perform explicitly under MPI.

Structured generators emit cells in block order, so a contiguous block
partition is also geometrically local — the halo between devices is one
strip of shared dofs, and the scatter-add reduction XLA emits is the ghost
accumulation of the MPI code.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh as DeviceMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from ..assembly.assemble import VolumeForm
from ..solve.nonlinear import NonlinearProblem


def device_mesh(n_devices: Optional[int] = None,
                axis_name: str = "cells") -> DeviceMesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return DeviceMesh(np.array(devs[:n]), (axis_name,))


def shard_form(form: VolumeForm, dmesh: DeviceMesh,
               axis_name: str = "cells") -> None:
    """Place the form's per-cell arrays with a cell-axis sharding.

    Requires ncells divisible by the mesh size (structured generators make
    this easy); cell padding for arbitrary meshes lands with the
    parametric-mesh partitioner.
    """
    n = dmesh.devices.size
    ncells = form.mesh.num_cells
    if ncells % n != 0:
        raise ValueError(f"ncells={ncells} not divisible by mesh size {n}")
    cell_sh = NamedSharding(dmesh, P(axis_name))
    cd = form.cell_data
    cd["xq"] = jax.device_put(cd["xq"], cell_sh)
    cd["wdet"] = jax.device_put(cd["wdet"], cell_sh)
    cd["G"] = jax.device_put(cd["G"], cell_sh)
    cd["gather_idx"] = {k: jax.device_put(v, cell_sh)
                        for k, v in cd["gather_idx"].items()}
    cd["coeff_idx"] = {k: jax.device_put(v, cell_sh)
                       for k, v in cd["coeff_idx"].items()}


def shard_problem(problem: NonlinearProblem, dmesh: DeviceMesh,
                  axis_name: str = "cells") -> None:
    """Shard a NonlinearProblem: cell arrays partitioned, quadrature-point
    coefficient arrays partitioned, dof-indexed data replicated."""
    shard_form(problem.form, dmesh, axis_name)
    cell_sh = NamedSharding(dmesh, P(axis_name))
    rep = NamedSharding(dmesh, P())
    new_coeffs = {}
    for k, v in problem.coeffs.items():
        if k in problem.form.coeff_tab:      # FE-function coefficient (dofs)
            new_coeffs[k] = jax.device_put(v, rep)
        else:                                 # quadrature-point coefficient
            new_coeffs[k] = jax.device_put(v, cell_sh)
    problem.coeffs = new_coeffs
    problem.bc_idx = jax.device_put(problem.bc_idx, rep)
    problem.bc_vals = jax.device_put(problem.bc_vals, rep)


def replicated(dmesh: DeviceMesh):
    return NamedSharding(dmesh, P())
