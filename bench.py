"""Benchmark: 1M-DoF LVPP obstacle problem — assembly + Newton wall-clock
on one GPU.

Protocol (BASELINE.md north star): P1 obstacle problem on [-1,1]^2, the
reference's FD alpha rule min(max(C r^(q^k) - a, C), 1e2)
(obstacle_finite_difference.jl:78), outer l2-increment tolerance 1e-8.

Solver: the P1 lumped-mass proximal Galerkin fast path (obstacle_p1.py) —
fused jitted Newton, active/inactive deep-contact splitting, MG-PCG inner
solve in f32 with f64 iterative refinement (PGTPU_BENCH_MIXED=0 runs the
f64 inner CG, PGTPU_BENCH_PC=jacobi the Jacobi-CG). The solve and the
memory-bandwidth probe run in this process, on the first JAX device,
which must be a GPU: there is no CPU fallback and no reduced-size retry.

Baseline: the reference's per-Newton-step cost is a CPU sparse direct
factor+solve of the 2N x 2N saddle Jacobian (MUMPS; obstacle_pg.py:
128-139). Stand-in: scipy SuperLU factor+solve of the same saddle matrix
times the run's Newton count. It is measured by its own command,
`python bench.py --baseline N` (CPU only; it never opens the card), which
stores the seconds per step in .bench_cpu_baseline.json (listed in
.gitignore). The GPU bench only reads that file: without an entry for
its size, vs_baseline is null and the log says "not measured". Baseline
assembly time is NOT counted (favors the baseline).

Output: diagnostics on stderr; the last stdout line is one JSON object
{"metric", "value", "unit", "vs_baseline", "device"}.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
BASELINE_CACHE = REPO / ".bench_cpu_baseline.json"


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def mg_vcycle_bytes(m: int, esz: int, nu: int = 1,
                    coarse_sweeps: int = 24) -> int:
    """Bytes one ops/mg.py V-cycle must move, walked level by level: per
    Jacobi sweep read {x, b, w} + write x; per residual read {x, b, w} +
    write r; restrict/prolong read the source + write the target. The
    k5 stencil's shifted re-reads of x are assumed to hit in cache and
    are counted once (an assumption, not a measurement)."""
    ms = [m]
    while ms[-1] >= 9 and (ms[-1] - 1) % 2 == 0:
        ms.append((ms[-1] - 1) // 2 + 1)
    total = 0
    for li, mm in enumerate(ms):
        nl, nc = mm * mm, (((mm - 1) // 2 + 1) ** 2)
        if li == len(ms) - 1:
            total += coarse_sweeps * 4 * nl      # coarsest smooths
            continue
        total += 2 * nu * 4 * nl                 # pre+post smooths
        total += 4 * nl                          # residual
        total += (nl + nc) + (nc + nl)           # restrict + prolong
    return total * esz


def solve(n: int, tol: float) -> dict:
    """Set up, compile and time the north-star solve on the first device."""
    from proximalgalerkin_tpu.mesh import rectangle_mesh
    from proximalgalerkin_tpu.models.obstacle_p1 import P1ObstacleSolver

    t0 = time.time()
    mesh = rectangle_mesh(n, n, p0=(-1.0, -1.0), p1=(1.0, 1.0))
    mixed = os.environ.get("PGTPU_BENCH_MIXED", "1") == "1"
    # Default PC: the lattice V-cycle PCG (ops/mg.py), which needs ~45x
    # fewer inner iterations than Jacobi-CG at 1024^2.
    pc = os.environ.get("PGTPU_BENCH_PC", "mg")
    forcing = os.environ.get("PGTPU_BENCH_FORCING", "fixed")
    solver = P1ObstacleSolver(mesh, alpha_cap=1e2, outer_tol=tol,
                              mixed_precision=mixed, pc=pc,
                              cg_forcing=forcing)
    log(f"setup {time.time() - t0:.3f}s dofs {2 * solver.N}")

    # compile ahead of time for exactly the arguments solve() passes, so
    # the timed window runs the cached executable and compiles nothing
    t0 = time.time()
    solver.compile()
    log(f"compile {time.time() - t0:.3f}s")

    t0 = time.time()
    result = solver.solve(verbose=False)
    elapsed = time.time() - t0
    feas = float((result.u - np.asarray(solver.phi)).min())

    # Bytes the inner Krylov loop must move, from the op walk above and
    # the DIA SpMV; achieved bandwidth is that over the solve time.
    N = solver.N
    ndiags = (solver.A_data.shape[0] if solver.A_data.ndim == 2
              else solver.ell.pattern.width)
    esz = 4 if mixed else 8          # inner CG element size (f32 | f64)
    cg = int(result.cg_its_total)
    # PCG body: matvec (A once + x once + y once) + {x,r,p updates,
    # 3 dots} ~ 7 vector streams
    body_bytes = (ndiags + 2) * N * esz + 7 * N * esz
    if pc == "mg":
        iter_bytes = body_bytes + mg_vcycle_bytes(n + 1, esz)
    else:
        iter_bytes = body_bytes + 2 * N * esz    # diagonal PC
    total_bytes = cg * iter_bytes
    total_flops = cg * (2 * ndiags * N + 6 * N)
    gbps = total_bytes / max(elapsed, 1e-9) / 1e9
    log(f"roofline: cg_its={cg} ndiags={ndiags} bytes={total_bytes:.3e} "
        f"flops={total_flops:.3e} achieved={gbps:.1f} GB/s "
        f"gflops={total_flops / max(elapsed, 1e-9) / 1e9:.1f}")
    return {"elapsed": elapsed, "dofs": 2 * N, "newton": result.newton_its,
            "outer": result.outer_iterations,
            "converged": result.converged, "feasibility": feas,
            "cg_its": cg, "membw_gbps": gbps, "esz": esz}


def stream_gbps(n_elems: int, esz: int) -> float:
    """Measured device memory bandwidth (GB/s) for the utilization
    denominator: a 3-stream axpy recurrence in the bench dtype.

      1. The repetition loop runs ON DEVICE (lax.fori_loop inside one
         jit, traced trip count so all timings share one executable):
         timing separate dispatches would measure launch latency.
      2. The working set must exceed the card's L2 cache (50 MB on the
         H100): at the bench vector size (4-8 MB) the loop carries would
         stay cache-resident and read back more than HBM can deliver.
         Each carry is padded to ~1 GB so every iteration streams HBM.
      3. Completion is observed by fetching a scalar.
    Dispatch + fetch latency is cancelled by a least-squares fit of wall
    time vs trip count: the intercept is overhead, the slope is seconds
    per 3-stream pass (read u, read v, write v'; u' = v is an alias).
    Four independent chains per trip keep one chain's loads overlapping
    another's stores."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    dt = jnp.float32 if esz == 4 else jnp.float64
    chains, gb_per_buf = 4, 0.6
    rows = max(1, int(gb_per_buf * 1e9) // (n_elems * esz))
    us = tuple(jnp.full((rows, n_elems), 1.0 + i, dt) for i in range(chains))
    vs = tuple(jnp.full((rows, n_elems), 2.0 + i, dt) for i in range(chains))
    iter_bytes = 3 * rows * n_elems * esz * chains

    @jax.jit
    def stream(u, v, reps):
        def body(_, uv):
            u, v = uv
            return v, tuple(0.5 * ui + 0.5 * vi for ui, vi in zip(u, v))
        return lax.fori_loop(0, reps, body, (u, v))[1]

    def timed(reps):
        r = jnp.int32(reps)
        best = float("inf")
        for _ in range(3):
            t0 = time.time()
            float(stream(us, vs, r)[0][0, 0])      # fetch = true barrier
            best = min(best, time.time() - t0)
        return best

    timed(2)                                       # compile + warm
    counts = [5, 20, 60, 120]
    times = [timed(r) for r in counts]
    slope = float(np.polyfit(np.asarray(counts, float),
                             np.asarray(times, float), 1)[0])
    gbps = iter_bytes / max(slope, 1e-12) / 1e9
    log(f"stream: carry {rows}x{n_elems} x{chains} "
        f"({chains * rows * n_elems * esz / 1e9:.2f} GB), slope "
        f"{slope * 1e3:.3f} ms/iter -> {gbps:.1f} GB/s "
        f"(times {[round(t, 4) for t in times]})")
    return gbps


# ---------------------------------------------------------- CPU baseline

def _cpu_saddle_lu_seconds(n: int) -> float:
    """Factor+solve the 2N x 2N saddle Newton matrix once on host CPU."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    from proximalgalerkin_tpu.mesh import rectangle_mesh
    from proximalgalerkin_tpu.models.obstacle_p1 import P1ObstacleSolver

    mesh = rectangle_mesh(n, n, p0=(-1.0, -1.0), p1=(1.0, 1.0))
    s = P1ObstacleSolver(mesh)
    N = s.N
    # build from the host CSR values + true (non-padded) ELL slots —
    # s.A_data may be DIA-layout (ndiags, N) after the fast-path
    # substitution, which paired with ELL coordinates scrambles the matrix
    pat = s.ell.pattern
    eg = np.asarray(pat.ell_gather).reshape(-1)
    keep = eg < pat.nnz
    rows = np.repeat(np.arange(N), pat.width)[keep]
    cols = np.asarray(pat.ell_cols).reshape(-1)[keep]
    vals = s.A_csr_host[eg[keep]]
    A = sp.coo_matrix((vals, (rows, cols)), shape=(N, N)).tocsr()
    M = sp.diags(np.asarray(s.M_L))
    D = sp.diags(np.asarray(s.M_L) * np.exp(-1.0))
    K = sp.bmat([[A, M], [M, -D]], format="csc")
    t0 = time.time()
    lu = spla.splu(K)
    lu.solve(np.ones(2 * N))
    return time.time() - t0


def _baseline_cache() -> dict:
    return (json.loads(BASELINE_CACHE.read_text())
            if BASELINE_CACHE.exists() else {})


def measure_baseline(n: int) -> float:
    """`bench.py --baseline n`: host SuperLU seconds per Newton step at
    size n, stored in the cache the GPU bench reads."""
    seconds = _cpu_saddle_lu_seconds(n)
    data = _baseline_cache()
    data[f"saddle_n{n}"] = seconds
    BASELINE_CACHE.write_text(json.dumps(data))
    return seconds


def main():
    sys.path.insert(0, str(REPO))
    if len(sys.argv) > 1 and sys.argv[1] == "--baseline":
        print(json.dumps({"lu_seconds": measure_baseline(int(sys.argv[2]))}))
        return

    from proximalgalerkin_tpu.utils.runtime import (
        enable_compile_cache, jax_versions, nvidia_smi)
    log(f"compile cache: {enable_compile_cache()}")
    import jax
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    log(f"device: {device}")
    log(f"env: {jax_versions()}, python {sys.version.split()[0]}; "
        f"nvidia-smi name, power.limit: {nvidia_smi()}")
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found {dev.platform}")

    n = int(os.environ.get("PGTPU_BENCH_N", "1024"))
    tol = float(os.environ.get("PGTPU_BENCH_TOL", "1e-8"))
    result = solve(n, tol)
    if not result["converged"]:
        raise SystemExit("bench: LVPP solve did not converge")
    elapsed = result["elapsed"]
    log(f"dofs={result['dofs']} newton={result['newton']} "
        f"outer={result['outer']} cg_its={result['cg_its']} "
        f"feas={result['feasibility']:.2e} elapsed={elapsed:.3f}s")

    peak = stream_gbps(result["dofs"] // 2, result["esz"])
    log(f"roofline: achieved={result['membw_gbps']:.1f} GB/s "
        f"stream_peak={peak:.1f} GB/s "
        f"membw_util={result['membw_gbps'] / peak:.3f}")

    vs_baseline = None
    per_step = _baseline_cache().get(f"saddle_n{n}")
    if per_step is None:
        log(f"baseline: not measured (no entry for n={n} in "
            f"{BASELINE_CACHE.name}; `python bench.py --baseline {n}` "
            f"measures it on the host CPU)")
    else:
        baseline_total = per_step * max(result["newton"], 1)
        log(f"baseline: {per_step:.3f} s/step x {result['newton']} = "
            f"{baseline_total:.1f}s (host SuperLU)")
        vs_baseline = round(baseline_total / max(elapsed, 1e-9), 3)
    print(json.dumps({
        "metric": f"obstacle_lvpp_{result['dofs']}dof_wallclock",
        "value": round(elapsed, 3), "unit": "s",
        "vs_baseline": vs_baseline, "device": device}))


if __name__ == "__main__":
    main()
