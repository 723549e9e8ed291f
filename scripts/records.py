"""Runs of record for the reference's full-protocol examples.

Each record runs one model at the reference's protocol size with the
device-resident solver path on the first JAX device (the GPU, or the CPU
under JAX_PLATFORMS=cpu), and prints ONE JSON line with wall-clock +
iteration counts. One model per process:

    python scripts/records.py thermoforming [M]
    python scripts/records.py gradient [N]
    python scripts/records.py signorini2d [res]
    python scripts/records.py signorini3d [res]
    python scripts/records.py eigenvalue [N]
    python scripts/records.py multiphase [N] [steps]
    python scripts/records.py multiphase_device [N] [steps] [algo]
    python scripts/records.py obstacle_unstructured [res]
    python scripts/records.py monge_ampere [kmax]
    python scripts/records.py fracture [steps]
    python scripts/records.py distributed_obstacle [n] [outers]
    python scripts/records.py fracture_distributed [steps]

Reference protocols: thermoforming 150^2 (thermoforming_dolfinx.py:56),
gradient constraint 200^2 (gradient_constraint_dolfinx.py), Signorini
degree 2 (examples/02_signorini/README.md:28-30), eigenvalue 100^2
(eigenvalue_constraints_dolfinx.py:41-50), multiphase 50^2 dt=1e-5 to
T=7e-3, Monge-Ampere k=3..14 (monge_ampere_dolfinx.py:31), fracture 1001
load steps (fracture_dolfinx.py:207).
"""

import json
import os as _os
import pathlib as _pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parent.parent))

from proximalgalerkin_tpu.utils.runtime import enable_compile_cache  # noqa: E402

enable_compile_cache()

# Round-3 record solver: ALL-DEVICE directions — equilibrated block-Schur
# MINRES in native f32 wrapped in f64 iterative refinement
# (solve/nonlinear.py pc=schur + ksp_precision=mixed). Measured on the
# gradient-constraint saddle (tests/test_gradient_constraint.py): relative
# residuals ~1e-9, direction error vs LU ~1e-10 — past the round-2
# fixed-2-pass refinement's ~1e-6 stall, so LVPP/Newton counts stay
# reference-comparable without the 1-core host SuperLU bottleneck.
# PGTPU_RECORD_LU=1 restores the host-LU architecture for cross-checks.
_USE_LU = _os.environ.get("PGTPU_RECORD_LU") == "1"

# checkpoints/progress must survive host reboots (round-3 lesson: /tmp is
# wiped on reboot and the round-2 runs lost ~7 h of progress) — keep them
# in the repo's records/ dir, which also gets committed with the round.
RECDIR = _pathlib.Path(__file__).resolve().parent.parent / "records"
RECDIR.mkdir(exist_ok=True)


def lagged_nd_lu(**kw):
    """Direct-solver record architecture (the MUMPS analogue): device
    einsum assembly + host LU with geometric-ND ordering (la/ordering.py,
    analyze once per pattern) and factorization reuse across Newton
    iterations via refinement against the current Jacobian action
    (pc_factor_lag). Replaces round-2's COLAMD-per-iteration SuperLU
    (e.g. gradient 200^2: 68 min -> minutes)."""
    base = {"pc_factor_lag": 1, "pc_factor_ordering": "nd",
            "ksp_rtol": 1e-9}
    base.update(kw)
    return base


def schur_mixed(field0, **kw):
    # The all-device mixed+Schur path (block-Schur MINRES in f32 with f64
    # refinement) reaches LU-grade directions at small/mid N; no record
    # uses it. ksp_chunk_it splits each Krylov solve into host-monitored
    # chunks of ksp_chunk_it f32 MINRES iterations, warm-restarted from
    # dx0 until ksp_rtol or ksp_max_it total.
    if _USE_LU:
        return lagged_nd_lu()
    base = {"ksp_type": "minres", "pc_type": "schur",
            "pc_schur_field0": field0, "ksp_precision": "mixed",
            "ksp_max_it": 20000, "ksp_rtol": 1e-10,
            "ksp_chunk_it": 500, "ksp_refine_max": 6}
    base.update(kw)
    return base


def device_direct(**kw):
    """Record architecture for lattice protocols: the device
    block-tridiagonal direct solver (la/blocktri.py, pc_type=btlu) —
    line-ordered block-Thomas LDL as batched matmul scans, f32 factors +
    f64 refinement. This replaces the host lagged ND-LU for every
    *-on-a-lattice protocol.
    PGTPU_RECORD_LU=1 restores the host-LU cross-check architecture."""
    if _USE_LU:
        return lagged_nd_lu()
    base = {"ksp_type": "preonly", "pc_type": "btlu", "ksp_rtol": 1e-9}
    base.update(kw)
    return base


DEVICE_OPTS = {}


def _emit(name, t, extra):
    print(json.dumps({"record": name, "wall_s": round(t, 2), **extra}),
          flush=True)


def thermoforming(M=150):
    from proximalgalerkin_tpu.models.thermoforming import solve_thermoforming
    t0 = time.time()
    r = solve_thermoforming(M=M, solver_options=device_direct(),
                            verbose=True)
    _emit(f"thermoforming_{M}", time.time() - t0,
          {"lvpp": r.lvpp_iterations, "newton": r.total_newton,
           "converged": bool(r.converged)})


def gradient(N=200):
    from proximalgalerkin_tpu.models.gradient_constraint import (
        solve_gradient_constraint)
    t0 = time.time()
    prob, res = solve_gradient_constraint(
        N=N, solver_options=device_direct(), verbose=True)
    _emit(f"gradient_constraint_{N}", time.time() - t0,
          {"lvpp": res.iterations, "newton": int(sum(res.newton_steps)),
           "converged": bool(res.converged)})


def signorini2d(res=0.04):
    from proximalgalerkin_tpu.models.signorini import solve_signorini
    recs = []
    t0 = time.time()
    for disp in (-0.10, -0.15, -0.20):
        r = solve_signorini(res=res, degree=2, disp=disp,
                            solver_options=dict(DEVICE_OPTS), verbose=True)
        recs.append({"disp": disp, "lvpp": r.lvpp_iterations,
                     "newton": int(sum(r.newton_iterations)),
                     "penetration": float(r.penetrations[-1])})
    _emit(f"signorini2d_deg2_res{res}", time.time() - t0, {"runs": recs})


def signorini3d(res=0.12):
    from proximalgalerkin_tpu.models.signorini import solve_signorini
    from proximalgalerkin_tpu.mesh.parametric import create_half_sphere
    t0 = time.time()
    r = solve_signorini(tagged=create_half_sphere(res=res), degree=2,
                        disp=-0.10, solver_options=dict(DEVICE_OPTS),
                        verbose=True)
    _emit(f"signorini3d_deg2_res{res}", time.time() - t0,
          {"lvpp": r.lvpp_iterations,
           "newton": int(sum(r.newton_iterations)),
           "penetration": float(r.penetrations[-1])})


def eigenvalue(N=100):
    from proximalgalerkin_tpu.models.eigenvalue_constraints import (
        solve_eigenvalue_constraints)
    t0 = time.time()
    # ALL-DEVICE directions via the block-tridiagonal factor
    # (la/blocktri.py; the 100^2 dense factors need 26 GB, so the
    # streamed layout is taken where the device-memory budget is
    # smaller). ksp_rtol 1e-9 matches the gradient/thermoforming btlu
    # records; refinement reaches ~1e-10 in 2-3 passes.
    r = solve_eigenvalue_constraints(
        N=N, solver_options=device_direct(), verbose=True,
        checkpoint_path=str(RECDIR / f"ck_eigenvalue_{N}_btlu.npz"))
    lo, hi = r.eigenvalue_range()
    _emit(f"eigenvalue_{N}", time.time() - t0,
          {"lvpp": int(r.lvpp.iterations),
           "newton": int(sum(r.lvpp.newton_steps)),
           "lam_min": float(lo), "lam_max": float(hi)})


def multiphase(N=50, steps=None):
    from proximalgalerkin_tpu.models.multiphase import solve_multiphase
    dt = 1e-5
    T = 7e-3 if steps is None else steps * dt
    t0 = time.time()
    # resumable: snapshot every 10 steps + per-step JSONL so an interrupted
    # multi-hour run keeps its iteration arrays and restarts where it died
    # Solver: lagged ND-LU (la/ordering.py). The 12-field saddle needs a
    # factorization (block-Jacobi/Schur PCs fail on the simplex gauge
    # null-mode of softmax'); ND + field rotation + static pivoting cuts
    # SuperLU fill 115M -> 47M (30 s -> 2.5 s/factor), and pc_factor_lag
    # reuses factors across the ~45 Newton solves per step with
    # refinement against the current Jacobian action, so counts match
    # exact Newton. ksp_rtol 1e-9 (direction exactness; snes tol 1e-8).
    mp_opts = {"pc_factor_lag": 1, "pc_factor_ordering": "nd",
               "ksp_rtol": 1e-9}
    mp_opts.update(DEVICE_OPTS)
    r = solve_multiphase(N=N, M=N, tau0=dt, T=T, verbose=True,
                         solver_options=mp_opts,
                         checkpoint_path=str(RECDIR / f"ck_multiphase_{N}.npz"),
                         progress_jsonl=str(RECDIR / f"rec_multiphase_{N}.jsonl"))
    _emit(f"multiphase_{N}", time.time() - t0,
          {"steps": len(r.newton_iterations),
           "newton": int(np.sum(r.newton_iterations))})


def multiphase_device(N=50, steps=5, algo="cr", chunk=0):
    """On-device multiphase run: the first `steps` implicit-Euler steps
    of the 50^2 protocol with ALL directions on the device through the
    fused lagged-btlu Newton (solve/nonlinear.py fused_newton_btlu — one
    XLA dispatch per Newton solve, factor carried across the alpha loop;
    pc_factor_algo='cr' = log-depth cyclic-reduction factor,
    la/blocktri.py bt_factor_cr). Per-step wall + counts go to
    rec_multiphase_{N}_device.jsonl; compare counts line-by-line against
    the CPU record rec_multiphase_50.jsonl."""
    from proximalgalerkin_tpu.models.multiphase import solve_multiphase
    dt = 1e-5
    t0 = time.time()
    opts = {"snes_fused": True, "ksp_type": "preonly", "pc_type": "btlu",
            "ksp_rtol": 1e-9, "pc_factor_dtype": "f64",
            "pc_factor_apply_dtype": "f32", "pc_factor_lag": 1,
            "pc_factor_algo": algo}
    if chunk:
        # bound ONE device execution to `chunk` Newton iterations
        opts["snes_fused_chunk"] = int(chunk)
    jpath = RECDIR / f"rec_multiphase_{N}_device.jsonl"
    r = solve_multiphase(N=N, M=N, tau0=dt, T=steps * dt, verbose=True,
                         solver_options=opts,
                         progress_jsonl=str(jpath))
    _emit(f"multiphase_{N}_device_{algo}", time.time() - t0,
          {"steps": len(r.newton_iterations),
           "newton": [int(v) for v in r.newton_iterations],
           "lvpp": [int(v) for v in r.lvpp_iterations]})


def obstacle_unstructured(res=0.0085, tol=1e-8, alpha_max=1e4):
    """All-device directions on an UNSTRUCTURED mesh at protocol scale
    (VERDICT r4 missing #2 / next-round #2): the reference's actual
    example-01 geometry — a gmsh-style disk (generate_mesh_gmsh.py:46-48)
    — at >=100k dofs, obstacle LVPP to tol_exit=1e-8, directions via the
    graph-BFS LineBlocking + f64 block-tridiagonal device factor
    (la/blocktri.py _graph_level_blocks). res=0.0085 -> 101k dofs,
    nb=272 bs=562, dense f64 factors 3.4 GB. Run once on the GPU and
    once with JAX_PLATFORMS=cpu + PGTPU_RECORD_LU=1 for the
    counts-identical host-LU cross-check
    (records/rec_obstacle_unstructured_cpu.log)."""
    from proximalgalerkin_tpu.mesh.unstructured import create_disk_mesh
    from proximalgalerkin_tpu.models.obstacle import solve_obstacle_problem
    t0 = time.time()
    mesh = create_disk_mesh(res=res)
    # f64 factor AND f64 apply (the deep-contact equilibration scale,
    # s ~ 1e8, overflows an f32-cast apply); the f64 LU block inverse
    # handles the deep-contact block cond (~1e16, cross-scale u-psi
    # coupling). Alpha capped at 1e4 — at 1e5 the mixed model's
    # exp(psi) NaNs the residual on the HOST LU path too.
    # ksp_rtol 1e-12 (vs the lattice records' 1e-9): looser direction
    # slack slows the alpha-capped tail's increment contraction enough to
    # add one-Newton outers (55 vs the host LU's 42 at 1e-9)
    opts = device_direct(**({"pc_factor_dtype": "f64",
                             "pc_factor_lag": 1, "ksp_rtol": 1e-12}
                            if not _USE_LU else {}))
    prob, r = solve_obstacle_problem(
        mesh, polynomial_order=1, tol_exit=tol, alpha_max=alpha_max,
        maximum_number_of_outer_loop_iterations=60,
        solver_options=opts, verbose=True)
    _emit(f"obstacle_unstructured_res{res}", time.time() - t0,
          {"dofs": int(prob.space.num_dofs),
           "lvpp": int(r.iterations),
           "newton": [int(v) for v in r.newton_steps],
           "converged": bool(r.converged)})


def monge_ampere(kmax=14):
    from proximalgalerkin_tpu.models.monge_ampere import p_refinement_sweep
    t0 = time.time()
    r = p_refinement_sweep(kmin=3, kmax=kmax, verbose=True)
    _emit(f"monge_ampere_k{kmax}", time.time() - t0,
          {"errors": [float(e) for e in np.asarray(r.errors).ravel()]
           if hasattr(r, "errors") else str(r)})


def fracture(steps=1001, res=0.05):
    from proximalgalerkin_tpu.models.fracture import solve_fracture
    t0 = time.time()
    # Directions: exact lagged ND-LU — the architecture the 1001-step
    # record actually ran (RESULTS.md run-of-record table: "exact host
    # LU after an A/B probe showed LU needs 1 LVPP / 2-3 Newtons per
    # steady step vs 8-17 with mixed-precision device MINRES at this
    # 5k-dof size"). schur_mixed (the chunked emulated-f64 Krylov
    # workaround) is no longer on any record path; it remains available
    # for explicit probes only (VERDICT r3 #8).
    r = solve_fracture(num_load_steps=steps, Tmax=5.0, max_res=res,
                       solver_options=lagged_nd_lu(),
                       verbose=True,
                       checkpoint_path=str(RECDIR / f"ck_fracture_{steps}.npz"),
                       progress_jsonl=str(RECDIR / f"rec_fracture_{steps}.jsonl"))
    _emit(f"fracture_{steps}", time.time() - t0,
          {"steps": len(r.newton_per_step),
           "newton": int(sum(r.newton_per_step)),
           "max_damage": float(max(r.max_damage_history or [0.0])),
           "broken": bool(r.broken)})


def distributed_obstacle(n=224, outers=4):
    """Distributed execution at NON-TOY scale (VERDICT r4 next #4):
    obstacle on an n x n lattice (2*(n+1)^2 mixed dofs, >=100k at
    n=224) through DistributedLvppProblem on 8 virtual devices with the
    SCALABLE strong PC (asm_btlu: block-tridiagonal RAS subdomain
    factors) — per-device owned-dof memory, subdomain factor dims, and
    counts vs the single-device host-LU trajectory. On the CPU run with
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8
    (chip_smoke.py --four-cards runs the same comparison on 4 GPUs)."""
    import jax.numpy as jnp
    import numpy as np
    from proximalgalerkin_tpu.mesh import rectangle_mesh
    from proximalgalerkin_tpu.models.obstacle import setup_obstacle_problem
    from proximalgalerkin_tpu.parallel.dofpart import (
        DistributedProblem, DistributedLvppProblem)
    from proximalgalerkin_tpu.solve.lvpp import AlphaScheduler, LVPPSolver

    mesh = rectangle_mesh(n, n, p0=(-1.0, -1.0), p1=(1.0, 1.0))
    t0 = time.time()
    prob = setup_obstacle_problem(mesh, polynomial_order=1, verbose=False)
    p = prob.problem
    space = prob.space
    N = space.num_dofs
    psi_sl, u_sl = space.slice_of("psi"), space.slice_of("u")

    # single-device reference: exact lagged ND-LU directions
    ref = LVPPSolver(
        p, newton_options={"snes_rtol": 1e-6, "snes_max_it": 50,
                           "snes_linesearch_type": "none",
                           "pc_factor_lag": 1,
                           "pc_factor_ordering": "nd", "ksp_rtol": 1e-9},
        alpha=AlphaScheduler(scheme="double_exponential", alpha_max=1e5),
        prev_coeffs=lambda x_k: {"psi_k": x_k[psi_sl], "u_k": x_k[u_sl]},
        tol=1e-50, max_iterations=outers, verbose=True).solve(
            jnp.zeros(N))
    t_ref = time.time() - t0

    t0 = time.time()
    dp = DistributedProblem(p)
    dlp = DistributedLvppProblem(dp)
    dlp.update(coeffs={"phi": dp.scatter_cellq(np.asarray(p.coeffs["phi"]))})
    abt = dp._asm_btlu_setup()
    dist = LVPPSolver(
        dlp, newton_options={
            "snes_rtol": 1e-6, "snes_max_it": 50,
            "snes_linesearch_type": "none", "ksp_type": "preonly",
            "pc_type": "btlu", "ksp_rtol": 1e-11, "ksp_max_it": 600},
        alpha=AlphaScheduler(scheme="double_exponential", alpha_max=1e5),
        prev_coeffs=lambda xs: {"psi_k": dp.field_to_coeff(xs, "psi"),
                                "u_k": dp.field_to_coeff(xs, "u")},
        tol=1e-50, max_iterations=outers, verbose=True).solve(
            dp.scatter(np.zeros(N)))
    t_dist = time.time() - t0
    u_ref = np.asarray(ref.x)[u_sl]
    u_dist = dp.gather(dist.x)[u_sl]
    factor_mb = 5 * abt["nb"] * abt["bs"] ** 2 * 8 / 1e6
    _emit(f"distributed_obstacle_{n}", t_ref + t_dist, {
        "dofs": int(N), "per_device_owned": int(dp.Bsum),
        "ext_total": int(dp.ext_total),
        "subdomain_nb_bs": [abt["nb"], abt["bs"]],
        "subdomain_factor_MB_per_device": round(factor_mb, 1),
        "dense_asm_lu_would_be_MB": round(dp.ext_total**2 * 8 / 1e6, 1),
        "ref_newton": ref.newton_steps, "dist_newton": dist.newton_steps,
        "counts_identical": bool(ref.newton_steps == dist.newton_steps),
        "u_maxdiff": float(np.abs(u_dist - u_ref).max()),
        "wall_ref_s": round(t_ref, 1), "wall_dist_s": round(t_dist, 1)})


def fracture_distributed(steps=30, res=0.1, tmax=3.0):
    """Distributed retry machine under REAL failure (VERDICT r4 next #8):
    ~`steps` load steps at res `res` spanning crack nucleation, run
    through the dof-partitioned driver on 8 virtual CPU devices AND on
    the host, comparing per-step Newton/LVPP counts and retry firings.
    Run with JAX_PLATFORMS=cpu and
    XLA_FLAGS=--xla_force_host_platform_device_count=8."""
    from proximalgalerkin_tpu.models.fracture import solve_fracture
    opts = {"snes_linesearch_type": "l2", "snes_atol": 1e-6,
            "snes_rtol": 1e-8, "snes_max_it": 50, "ksp_type": "minres",
            "pc_type": "jacobi", "mat_type": "matfree",
            "ksp_rtol": 1e-11, "ksp_max_it": 6000}
    kw = dict(max_res=res, Tmin=0.0, Tmax=tmax, num_load_steps=steps,
              verbose=True)
    t0 = time.time()
    r_host = solve_fracture(solver_options=opts, **kw)
    t_host = time.time() - t0
    t0 = time.time()
    r_dist = solve_fracture(solver_options=opts, n_devices=8, **kw)
    t_dist = time.time() - t0
    _emit(f"fracture_distributed_{steps}x{res}", t_host + t_dist, {
        "host_newton": r_host.newton_per_step,
        "dist_newton": r_dist.newton_per_step,
        "host_lvpp": r_host.lvpp_per_step,
        "dist_lvpp": r_dist.lvpp_per_step,
        "host_retries": r_host.retries_per_step,
        "dist_retries": r_dist.retries_per_step,
        "counts_identical": bool(
            r_host.newton_per_step == r_dist.newton_per_step
            and r_host.lvpp_per_step == r_dist.lvpp_per_step),
        "c_diff": float(abs(r_dist.c - r_host.c).max()),
        "max_damage": float(max(r_dist.max_damage_history)),
        "wall_host_s": round(t_host, 1), "wall_dist_s": round(t_dist, 1)})


if __name__ == "__main__":
    which = sys.argv[1]
    def _coerce(a):
        try:
            return int(a)
        except ValueError:
            pass
        try:
            return float(a)
        except ValueError:
            return a
    args = [_coerce(a) for a in sys.argv[2:]]
    globals()[which](*args)
