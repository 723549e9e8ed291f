"""Spectral (Zernike) obstacle solver tests."""

import numpy as np
import pytest

from proximalgalerkin_tpu.models.obstacle_spectral import (
    spectral_obstacle_solve, spectral_p_sweep)


def test_sweep_converges():
    res = spectral_p_sweep(ps=(8, 12, 16), verbose=False)
    assert res.newton_its[0] > 5
    # successive sup-differences shrink with degree
    assert res.sup_errors[2] < res.sup_errors[1]


def test_f32_refine_matches_f64_counts():
    # the device p-sweep path (f32 LU + 3 f64 refinement passes,
    # VERDICT r3 #7) must walk the same Newton trajectory as the f64
    # factorization — directions agree to ~1e-12 after refinement
    r64 = spectral_p_sweep(ps=(8, 12), verbose=False)
    r32 = spectral_p_sweep(ps=(8, 12), verbose=False,
                           solve_dtype="f32_refine")
    assert r32.newton_its == r64.newton_its
    for a, b in zip(r32.sup_errors, r64.sup_errors):
        if not (np.isnan(a) and np.isnan(b)):
            assert abs(a - b) < 1e-8


def test_matches_fem_on_disk():
    cu, its, ev = spectral_obstacle_solve(14)
    from proximalgalerkin_tpu.mesh.unstructured import create_disk_mesh
    from proximalgalerkin_tpu.models.obstacle_p1 import P1ObstacleSolver
    mesh = create_disk_mesh(0.07)
    s = P1ObstacleSolver(mesh)
    r1 = s.solve()
    pts = s.V.dof_points
    rr = np.sqrt(pts[:, 0] ** 2 + pts[:, 1] ** 2)
    tt = np.arctan2(pts[:, 1], pts[:, 0])
    sel = rr < 0.9
    uspec = ev(rr[sel], tt[sel])
    assert np.abs(uspec - r1.u[sel]).max() < 0.08
