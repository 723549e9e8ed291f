"""Bring-up smoke test: the LVPP obstacle north-star on one GPU.

    python chip_smoke.py                # phases 1-4 on the first GPU
    python chip_smoke.py --four-cards   # phase 1, then only phase 5 (4 GPUs)

Phases (each prints its own lines; the first failure ends the run with a
non-zero exit code and no result line):

  1. device      platform, device kind and count, JAX/CUDA plugin versions,
                 the card's name and power limit; fails unless the platform
                 is 'gpu'. Rebuilds the native host helper on this machine.
  2. main path   the BASELINE.md north star (example-01 obstacle, P1
                 lumped-mass LVPP, 1024^2 cells, 2,101,250 dofs, FD alpha
                 rule capped at 1e2, outer tolerance 1e-8) through
                 P1ObstacleSolver(mixed_precision=True, pc='mg'): timed
                 setup, compile and solve, counts, feasibility, peak device
                 memory, plus one profiler trace of a few Newton steps.
  3. reference   the same problem with the f64 inner CG
                 (mixed_precision=False, CG to 1e-12), compared with
                 phase 2: counts within stated bounds, solutions to 1e-6.
  4. block inv   the block-tridiagonal f64 LU block inverse and Thomas
                 factor at the unstructured-disk record size (nb=272,
                 bs=562), against numpy.
  5. four cards  the dof-partitioned LVPP obstacle (parallel/dofpart.py)
                 at the 224^2 record size on 4 devices against 1 device.

The last line of standard output is the JSON result object. The phases
are plain functions of a size and a device list, so tests can call them
at tiny sizes on the CPU; only main() insists on a GPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent

# Phase 3 bounds (mixed-precision solve against the f64-inner-CG solve).
# Outer counts within 1: the last outer step is decided by an l2
# increment test at 1e-8, and the two inner precisions can put the same
# step's increment on either side of it (64^2 on the CPU: 3.8e-9 mixed,
# 4.5e-8 f64), so one run may take one more outer step. Newton totals
# within 2: that extra outer step costs one Newton step at the capped
# alpha, and an inner solve one digit less exact can add one step to a
# Newton loop. Every Newton loop of both runs must reach its stop
# (_solve). The solutions must agree: 1e-6 in the max norm is two orders
# above one final outer increment (1e-8 in l2) and four below the
# solution scale (max u ~ 0.1-1).
REF_OUTER_SLACK = 1
REF_NEWTON_SLACK = 2
REF_U_TOL = 1e-6
# The reference's f64 inner CG stops at 1e-12 relative, two digits under
# the solver default: its stop is measured in the Jacobi-scaled norm,
# and at 1e-10 one Newton step of the alpha-85 outer step (128^2, CPU)
# ends 100x above the mixed run's residual; at 1e-12 it lands below it.
REF_CG_TOL = 1e-12
# Phase 4: LU backward error relative to the row norms of each block
# (the quantity iterative refinement contracts with), and the forward
# error against numpy on the well-conditioned blocks.
BLOCK_RESID_TOL = 1e-9
BLOCK_INV_RTOL = 1e-8
# Phase 5: partitioned and single-device runs solve the same Newton
# systems to ksp_rtol 1e-11; the record differs by 3.1e-13.
DIST_U_TOL = 1e-10
DIST_RECORD = {224: [5, 4, 3, 2]}


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check_devices(devices) -> None:
    """The measurement is defined on a GPU only: no CPU fallback."""
    if not devices or devices[0].platform != "gpu":
        kind = devices[0].platform if devices else "none"
        raise SystemExit(f"chip_smoke: need a GPU, JAX found {kind}")


def result_line(devices) -> str:
    """The contract's last line: platform, kind and count as JAX reports
    them for the devices the run used."""
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}})


def _peak_bytes(device) -> str:
    stats = device.memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    return "not reported" if peak is None else f"{peak} B"


# ------------------------------------------------------------- phase 1

def phase_device(devices) -> None:
    from proximalgalerkin_tpu import native
    from proximalgalerkin_tpu.utils.runtime import jax_versions, nvidia_smi
    d = devices[0]
    say("device", f"platform={d.platform} kind={d.device_kind} "
                  f"count={len(devices)}")
    say("device", f"versions: {jax_versions()}, "
                  f"python {sys.version.split()[0]}")
    say("device", f"nvidia-smi name, power.limit: {nvidia_smi()}")
    say("device", f"platform_version: {d.client.platform_version}")
    say("device", f"native helper rebuilt here: "
                  f"available={native.rebuild()}")


# ------------------------------------------------------------- phase 2/3

def _solve(n: int, device, tag: str, **opts) -> dict:
    """Build, compile (AOT, timed on its own) and solve the north-star
    obstacle problem at n x n cells on `device`; `opts` go to the
    solver."""
    import jax
    from proximalgalerkin_tpu.mesh import rectangle_mesh
    from proximalgalerkin_tpu.models.obstacle_p1 import P1ObstacleSolver

    with jax.default_device(device):
        t0 = time.perf_counter()
        mesh = rectangle_mesh(n, n, p0=(-1.0, -1.0), p1=(1.0, 1.0))
        s = P1ObstacleSolver(mesh, alpha_cap=1e2, outer_tol=1e-8,
                             pc="mg", **opts)
        jax.block_until_ready(s.A_data)
        t_setup = time.perf_counter() - t0

        t0 = time.perf_counter()
        s.compile()
        t_compile = time.perf_counter() - t0

        t0 = time.perf_counter()
        res = s.solve()
        t_solve = time.perf_counter() - t0
        feas = float((res.u - np.asarray(s.phi)).min())
        say(tag, f"n={n} dofs={2 * s.N} setup={t_setup:.3f}s "
                 f"compile={t_compile:.3f}s solve={t_solve:.3f}s")
        say(tag, f"outer={res.outer_iterations} newton={res.newton_its} "
                 f"per_outer={res.newton_per_outer} "
                 f"inner_cg={res.cg_its_total} "
                 f"converged={res.converged} min(u-phi)={feas:.3e} "
                 f"last_inc={res.increments[-1]:.3e}")
        say(tag, f"peak_bytes_in_use={_peak_bytes(device)}")
    for k, hist in enumerate(res.newton_history):
        if len(hist) > 4 or k + 1 in res.newton_failed:
            say(tag, f"outer {k + 1} Newton residual/inner CG: " + " ".join(
                f"{r:.3e}/{c}" for r, c in hist))
    if res.newton_failed:
        raise SystemExit(f"{tag}: Newton missed its stop at outer steps "
                         f"{res.newton_failed}")
    if not res.converged:
        raise SystemExit(f"{tag}: LVPP did not converge")
    if feas < -1e-12:
        raise SystemExit(f"{tag}: min(u - phi) = {feas:.3e} < -1e-12")
    return {"u": res.u, "outer": res.outer_iterations,
            "newton": res.newton_its, "per_outer": res.newton_per_outer,
            "cg": res.cg_its_total, "solver": s}


def trace_window(res: dict, device, tag: str = "main") -> None:
    """Profile one Newton solve of a _solve result's solver (the first
    outer step: a few Newton steps, each an MG-PCG solve) and reduce it
    to per-PCG-iteration device numbers."""
    import jax
    from proximalgalerkin_tpu.utils.profiling import device_kernel_stats
    s = res["solver"]
    args = s.newton_args(*s.initial_state(), 1.0)
    with tempfile.TemporaryDirectory() as tdir, jax.default_device(device):
        jax.profiler.start_trace(tdir)
        t0 = time.perf_counter()
        out = s._newton(*args)
        jax.block_until_ready(out)
        wall = time.perf_counter() - t0
        jax.profiler.stop_trace()
        st = device_kernel_stats(tdir)
    nits, cg = int(out[2]), int(out[3])
    say(tag, f"trace: newton={nits} pcg_its={cg} wall={wall:.4f}s "
             f"device_window={st['window_s']:.4f}s "
             f"busy={st['busy_s']:.4f}s idle_share={st['idle_share']:.4f}")
    per_it = st["window_s"] / max(cg, 1) * 1e6
    say(tag, f"trace: per PCG iteration {per_it:.1f} us, "
             f"{st['kernels'] / max(cg, 1):.1f} device kernels")
    say(tag, f"trace lines: {st['lines']}")
    say(tag, f"trace top kernels: {st['top']}")


def phase_main_path(n: int, devices, trace: bool = True) -> dict:
    res = _solve(n, devices[0], "main", mixed_precision=True)
    if trace:
        trace_window(res, devices[0])
    return res


def phase_reference(n: int, devices, main: dict) -> dict:
    ref = _solve(n, devices[0], "reference", mixed_precision=False,
                 cg_tol=REF_CG_TOL)
    du = float(np.abs(main["u"] - ref["u"]).max())
    say("reference", f"outer {main['outer']} vs {ref['outer']} (+-"
                     f"{REF_OUTER_SLACK}), newton {main['newton']} vs "
                     f"{ref['newton']} (+-{REF_NEWTON_SLACK}); "
                     f"max|u-u_ref|={du:.3e} (tol {REF_U_TOL:.0e})")
    if (abs(main["outer"] - ref["outer"]) > REF_OUTER_SLACK
            or abs(main["newton"] - ref["newton"]) > REF_NEWTON_SLACK):
        raise SystemExit("reference: iteration counts differ beyond the "
                         "stated bounds")
    if not du <= REF_U_TOL:
        raise SystemExit(f"reference: max|u-u_ref| = {du:.3e}")
    return ref


# ------------------------------------------------------------- phase 4

def cross_scale_block(n: int, seed: int = 3) -> np.ndarray:
    """Deep-contact LVPP saddle block after equilibration: SPD primal and
    latent diagonal blocks with ~1e8 cross-scale coupling (cond ~1e16),
    as in tests/test_blocktri.py."""
    rng = np.random.default_rng(seed)
    k = n // 2
    Q = rng.standard_normal((k, k))
    A = Q @ Q.T / k + np.eye(k)
    B = 1e8 * rng.standard_normal((k, n - k)) / np.sqrt(k)
    Q2 = rng.standard_normal((n - k, n - k))
    D = Q2 @ Q2.T / (n - k) + np.eye(n - k)
    return np.block([[A, B], [B.T, -D]])


def scaled_residual(M: np.ndarray, X: np.ndarray) -> float:
    """max |M X - I| relative to the row sums of |M| (per block)."""
    R = M @ X - np.eye(M.shape[-1])
    return float((np.abs(R) / np.abs(M).sum(axis=-1)[..., :, None]).max())


def phase_block_inverse(nb: int, bs: int, devices) -> None:
    import jax
    import jax.numpy as jnp
    from proximalgalerkin_tpu.la import blocktri as bt

    rng = np.random.default_rng(0)
    # diagonally dominant blocks (well conditioned) + the cross-scale one
    D = rng.standard_normal((nb, bs, bs)) / np.sqrt(bs)
    D += 4.0 * np.eye(bs)
    D[nb // 2] = cross_scale_block(bs)
    L = 0.5 * rng.standard_normal((nb - 1, bs, bs)) / np.sqrt(bs)
    U = 0.5 * rng.standard_normal((nb - 1, bs, bs)) / np.sqrt(bs)
    b = rng.standard_normal((nb, bs))
    dev = devices[0]
    Dd, Ld, Ud, bd = (jax.device_put(jnp.asarray(a), dev)
                      for a in (D, L, U, b))

    inv = jax.jit(bt._block_inv)
    t0 = time.perf_counter()
    X = np.asarray(jax.block_until_ready(inv(Dd)))
    t_inv = time.perf_counter() - t0
    res = max(scaled_residual(D[k], X[k]) for k in range(nb))
    ok = [k for k in range(nb) if k != nb // 2]
    Xnp = np.linalg.inv(D[ok])
    fwd = float(np.abs(X[ok] - Xnp).max() / np.abs(Xnp).max())
    say("blockinv", f"nb={nb} bs={bs} f64 batched inverse "
                    f"(first call, compile incl.) {t_inv:.3f}s; "
                    f"scaled residual max {res:.3e} "
                    f"(tol {BLOCK_RESID_TOL:.0e}, cross-scale block incl.); "
                    f"vs numpy.linalg.inv "
                    f"{fwd:.3e} (tol {BLOCK_INV_RTOL:.0e})")
    if not (np.isfinite(X).all() and res <= BLOCK_RESID_TOL
            and fwd <= BLOCK_INV_RTOL):
        raise SystemExit("blockinv: block inverse out of tolerance")

    # block-Thomas factor + apply on the tridiagonal system built from
    # the same blocks (cross-scale block replaced: the block recursion
    # is only strongly factorizable for the quasi-definite LVPP
    # structure as a whole, which random coupling does not have)
    D[nb // 2] = rng.standard_normal((bs, bs)) / np.sqrt(bs) + 4 * np.eye(bs)
    Dd = jax.device_put(jnp.asarray(D), dev)
    t0 = time.perf_counter()
    Minv, T = bt.bt_factor(Dd, Ld, Ud)
    x = np.asarray(jax.block_until_ready(bt.bt_apply(Minv, T, Ld, bd)))
    t_fac = time.perf_counter() - t0
    r = np.einsum("kij,kj->ki", D, x) - b
    r[1:] += np.einsum("kij,kj->ki", L, x[:-1])
    r[:-1] += np.einsum("kij,kj->ki", U, x[1:])
    rel = float(np.abs(r).max() / np.abs(b).max())
    say("blockinv", f"bt_factor+bt_apply (compile incl.) {t_fac:.3f}s; "
                    f"max|A x - b|/max|b| = {rel:.3e} (tol 1e-10)")
    if not rel <= 1e-10:
        raise SystemExit("blockinv: block-Thomas solve out of tolerance")


# ------------------------------------------------------------- phase 5

def _distributed_solve(n: int, outers: int, devices) -> dict:
    from proximalgalerkin_tpu.mesh import rectangle_mesh
    from proximalgalerkin_tpu.models.obstacle import setup_obstacle_problem
    from proximalgalerkin_tpu.parallel.dofpart import (
        DistributedLvppProblem, DistributedProblem)
    from proximalgalerkin_tpu.solve.lvpp import AlphaScheduler, LVPPSolver

    t0 = time.perf_counter()
    mesh = rectangle_mesh(n, n, p0=(-1.0, -1.0), p1=(1.0, 1.0))
    prob = setup_obstacle_problem(mesh, polynomial_order=1, verbose=False)
    p = prob.problem
    dp = DistributedProblem(p, devices=list(devices))
    dlp = DistributedLvppProblem(dp)
    dlp.update(coeffs={"phi": dp.scatter_cellq(np.asarray(p.coeffs["phi"]))})
    res = LVPPSolver(
        dlp, newton_options={
            "snes_rtol": 1e-6, "snes_max_it": 50,
            "snes_linesearch_type": "none", "ksp_type": "preonly",
            "pc_type": "btlu", "ksp_rtol": 1e-11, "ksp_max_it": 600},
        alpha=AlphaScheduler(scheme="double_exponential", alpha_max=1e5),
        prev_coeffs=lambda xs: {"psi_k": dp.field_to_coeff(xs, "psi"),
                                "u_k": dp.field_to_coeff(xs, "u")},
        tol=1e-50, max_iterations=outers, verbose=False).solve(
            dp.scatter(np.zeros(prob.space.num_dofs)))
    wall = time.perf_counter() - t0
    shards = res.x.addressable_shards
    return {"newton": [int(v) for v in res.newton_steps],
            "u": dp.gather(res.x)[prob.space.slice_of("u")],
            "dofs": int(prob.space.num_dofs), "owned": int(dp.Bsum),
            "shard_devices": sorted(str(s.device) for s in shards),
            "shard_sizes": sorted({int(s.data.shape[0]) for s in shards}),
            "wall": wall}


def phase_four_cards(n: int, outers: int, devices) -> None:
    if len(devices) < 4:
        raise SystemExit(f"four-cards: need 4 devices, have {len(devices)}")
    dist = _distributed_solve(n, outers, devices[:4])
    for d in devices[:4]:
        say("four-cards", f"{d}: peak_bytes_in_use={_peak_bytes(d)}")
    one = _distributed_solve(n, outers, devices[:1])
    du = float(np.abs(dist["u"] - one["u"]).max())
    say("four-cards", f"n={n} dofs={dist['dofs']} owned/device="
                      f"{dist['owned']} shards on {dist['shard_devices']} "
                      f"(sizes {dist['shard_sizes']})")
    say("four-cards", f"newton x4 {dist['newton']} ({dist['wall']:.3f}s "
                      f"incl. setup+compile) vs x1 {one['newton']} "
                      f"({one['wall']:.3f}s); max|u diff|={du:.3e} "
                      f"(tol {DIST_U_TOL:.0e})")
    if len(set(dist["shard_devices"])) != 4:
        raise SystemExit("four-cards: solution not split over 4 devices")
    if dist["newton"] != one["newton"]:
        raise SystemExit("four-cards: Newton counts differ")
    if n in DIST_RECORD and dist["newton"] != DIST_RECORD[n][:outers]:
        raise SystemExit(f"four-cards: counts differ from the record "
                         f"{DIST_RECORD[n]}")
    if not du <= DIST_U_TOL:
        raise SystemExit(f"four-cards: max|u diff| = {du:.3e}")


# ---------------------------------------------------------------- main

def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-device dof-partitioned phase")
    args = ap.parse_args(argv)

    import proximalgalerkin_tpu
    if not Path(proximalgalerkin_tpu.__file__).resolve().is_relative_to(HERE):
        raise SystemExit("chip_smoke: run from a checkout of the repo")
    from proximalgalerkin_tpu.utils.runtime import enable_compile_cache
    say("setup", f"compile cache: {enable_compile_cache()}")
    import jax
    devices = jax.devices()
    check_devices(devices)
    phase_device(devices)
    if args.four_cards:
        phase_four_cards(224, 4, devices)
        used = devices[:4]
    else:
        main_res = phase_main_path(1024, devices)
        phase_reference(1024, devices, main_res)
        phase_block_inverse(272, 562, devices)
        used = devices[:1]
    print(result_line(used), flush=True)


if __name__ == "__main__":
    main()
