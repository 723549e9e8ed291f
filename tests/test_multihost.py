"""Two-process multi-host smoke test (SURVEY §2.3 / VERDICT r2 item 6).

The reference's MPI paths are 'correct by construction, never tested in
CI' (SURVEY §4); here the multi-host analogue IS tested: two real OS
processes,
each with two CPU devices, join through jax.distributed.initialize and
psum a global sharded array — the minimal proof that the multihost wiring
(coordinator handshake, cross-process device mesh, cross-process
collectives) works. Multi-host accelerator runs use the same
init_multihost().
"""

import os
import socket
import subprocess
import sys
import textwrap

import pytest

_WORKER = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, os.getcwd())
    import jax
    jax.config.update("jax_platforms", "cpu")
    from proximalgalerkin_tpu.parallel.multihost import (
        init_multihost, is_coordinator)
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from jax import shard_map

    pid, n, devs = init_multihost()
    assert n == 2, n
    assert len(devs) == 4, devs                  # 2 hosts x 2 cpu devices
    mesh = Mesh(np.array(devs), ("dev",))
    sh = NamedSharding(mesh, P("dev"))

    def kern(x):
        return jax.lax.psum(jnp.sum(x), "dev") * jnp.ones_like(x)

    f = jax.jit(shard_map(kern, mesh=mesh, in_specs=P("dev"),
                          out_specs=P("dev")))
    # global vector [0, 1, 2, 3]: this process owns elements 2*pid, 2*pid+1
    locals_ = [jax.device_put(jnp.asarray([2.0 * pid + i]), d)
               for i, d in enumerate(jax.local_devices())]
    g = jax.make_array_from_single_device_arrays((4,), sh, locals_)
    out = f(g)
    total = float(np.asarray(out.addressable_shards[0].data)[0])
    assert abs(total - 6.0) < 1e-12, total       # 0+1+2+3
    if is_coordinator():
        print("MULTIHOST_OK", total)
""")


_LVPP_WORKER = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, os.getcwd())
    import jax
    jax.config.update("jax_platforms", "cpu")
    from proximalgalerkin_tpu.parallel.multihost import (
        init_multihost, is_coordinator)
    import jax.numpy as jnp
    import numpy as np

    pid, n, devs = init_multihost()
    assert n == 2 and len(devs) == 4

    from proximalgalerkin_tpu.mesh.unstructured import create_disk_mesh
    from proximalgalerkin_tpu.models.obstacle import setup_obstacle_problem
    from proximalgalerkin_tpu.parallel.dofpart import (
        DistributedProblem, DistributedLvppProblem)
    from proximalgalerkin_tpu.solve.lvpp import AlphaScheduler, LVPPSolver

    # identical deterministic setup on every process (the reference's
    # rank-0-generate-then-distribute becomes generate-everywhere: the
    # mesher is deterministic, so device_put sees the same host data on
    # both processes — the jax multi-controller contract)
    mesh = create_disk_mesh(0.25)
    prob = setup_obstacle_problem(mesh, polynomial_order=1, verbose=False)
    p = prob.problem
    space = prob.space
    N = space.num_dofs
    opts = {"snes_rtol": 1e-6, "snes_max_it": 50,
            "snes_linesearch_type": "none", "ksp_type": "minres",
            "pc_type": "jacobi", "mat_type": "matfree",
            "ksp_rtol": 1e-11, "ksp_max_it": 2000}
    dp = DistributedProblem(p)       # 4 devices across 2 processes
    dlp = DistributedLvppProblem(dp)
    dlp.update(coeffs={"phi": dp.scatter_cellq(np.asarray(p.coeffs["phi"]))})
    res = LVPPSolver(
        dlp, newton_options=dict(opts),
        alpha=AlphaScheduler(scheme="double_exponential", alpha_max=1e5),
        prev_coeffs=lambda xs: {"psi_k": dp.field_to_coeff(xs, "psi"),
                                "u_k": dp.field_to_coeff(xs, "u")},
        tol=1e-50, max_iterations=3, verbose=False).solve(
            dp.scatter(np.zeros(N)))
    xnorm = float(jnp.linalg.norm(res.x))     # replicated scalar
    if is_coordinator():
        print("LVPP_MULTIHOST", res.newton_steps, round(xnorm, 10))
""")


@pytest.mark.skipif(os.environ.get("PGTPU_SKIP_MULTIHOST") == "1",
                    reason="explicitly disabled")
def test_two_process_lvpp_obstacle(tmp_path):
    """A REAL distributed LVPP solve over the multi-host wiring (VERDICT r4
    next-round #6, upgrading the psum smoke): two OS processes x two CPU
    devices run the obstacle problem through DistributedLvppProblem on a
    4-device cross-process mesh; Newton counts and the solution norm must
    match the same solve computed single-process."""
    # single-process reference (all 8 local virtual devices exist, but the
    # solve below is single-device through the host path)
    from proximalgalerkin_tpu.mesh.unstructured import create_disk_mesh
    from proximalgalerkin_tpu.models.obstacle import setup_obstacle_problem
    from proximalgalerkin_tpu.solve.lvpp import AlphaScheduler, LVPPSolver
    import jax.numpy as jnp
    import numpy as np

    mesh = create_disk_mesh(0.25)
    prob = setup_obstacle_problem(mesh, polynomial_order=1, verbose=False)
    opts = {"snes_rtol": 1e-6, "snes_max_it": 50,
            "snes_linesearch_type": "none", "ksp_type": "minres",
            "pc_type": "jacobi", "mat_type": "matfree",
            "ksp_rtol": 1e-11, "ksp_max_it": 2000}
    space = prob.space
    psi_sl, u_sl = space.slice_of("psi"), space.slice_of("u")
    ref = LVPPSolver(
        prob.problem, newton_options=dict(opts),
        alpha=AlphaScheduler(scheme="double_exponential", alpha_max=1e5),
        prev_coeffs=lambda x_k: {"psi_k": x_k[psi_sl], "u_k": x_k[u_sl]},
        tol=1e-50, max_iterations=3, verbose=False).solve(
            jnp.zeros(space.num_dofs))
    ref_norm = float(jnp.linalg.norm(ref.x))

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "lvpp_worker.py"
    script.write_text(_LVPP_WORKER)
    env = dict(os.environ)
    env["JAX_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
    env["JAX_NUM_PROCESSES"] = "2"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    procs = []
    for pid in range(2):
        e = dict(env)
        e["JAX_PROCESS_ID"] = str(pid)
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], env=e, cwd=os.getcwd(),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    for pr in procs:
        try:
            out, _ = pr.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            pr.kill()
            out, _ = pr.communicate()
        outs.append(out)
    assert all(pr.returncode == 0 for pr in procs), "\n---\n".join(outs)
    line = next((ln for o in outs for ln in o.splitlines()
                 if ln.startswith("LVPP_MULTIHOST")), None)
    assert line is not None, "\n---\n".join(outs)
    # counts identical to the single-process trajectory
    counts = eval(line.split("LVPP_MULTIHOST ")[1].rsplit(" ", 1)[0])
    xnorm = float(line.rsplit(" ", 1)[1])
    assert counts == ref.newton_steps, (counts, ref.newton_steps)
    assert abs(xnorm - ref_norm) < 1e-7 * max(ref_norm, 1.0)


@pytest.mark.skipif(os.environ.get("PGTPU_SKIP_MULTIHOST") == "1",
                    reason="explicitly disabled")
def test_two_process_psum(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ)
    env["JAX_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
    env["JAX_NUM_PROCESSES"] = "2"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    procs = []
    for pid in range(2):
        e = dict(env)
        e["JAX_PROCESS_ID"] = str(pid)
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], env=e, cwd=os.getcwd(),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    for pr in procs:
        try:
            out, _ = pr.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            pr.kill()
            out, _ = pr.communicate()
        outs.append(out)
    assert all(pr.returncode == 0 for pr in procs), "\n---\n".join(outs)
    assert any("MULTIHOST_OK" in o for o in outs), "\n---\n".join(outs)
