"""The GPU bring-up surface: chip_smoke.py's phases at tiny sizes on the
CPU, the compile-cache helper, the device-memory factor budget, the CLI
platform choice, the trace reduction, and the fixed XLA MG-PCG path of
the P1 obstacle solver."""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from proximalgalerkin_tpu.la import blocktri  # noqa: E402
from proximalgalerkin_tpu.utils import runtime  # noqa: E402


# ------------------------------------------------------------ compile cache

@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_location(env_set, monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: the helper leaves it to JAX and sets
    nothing; unset: the cache goes to <checkout>/.jax_cache."""
    before = jax.config.jax_compilation_cache_dir
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        where = runtime.enable_compile_cache()
        now = jax.config.jax_compilation_cache_dir
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    if env_set:
        assert where == str(tmp_path)
        assert now == before
    else:
        assert where == str(REPO / ".jax_cache") == now


# ------------------------------------------------------------ chip_smoke

def test_chip_smoke_refuses_cpu_devices():
    with pytest.raises(SystemExit, match="need a GPU"):
        chip_smoke.check_devices(jax.devices("cpu"))
    with pytest.raises(SystemExit):
        chip_smoke.check_devices([])


def test_chip_smoke_result_line_keys():
    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    line = chip_smoke.result_line([Dev(), Dev(), Dev(), Dev()])
    obj = json.loads(line)
    assert obj == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}
    assert "\n" not in line


def test_chip_smoke_main_path_agrees_with_f64_reference():
    """Phases 2 and 3 at 64^2: both converge feasibly with every Newton
    loop reaching its stop, the counts agree within the stated bounds,
    the solutions to REF_U_TOL (phase_reference raises SystemExit
    otherwise)."""
    devs = jax.devices()
    main = chip_smoke.phase_main_path(64, devs, trace=False)
    ref = chip_smoke.phase_reference(64, devs, main)
    assert main["per_outer"][:4] == ref["per_outer"][:4] == [5, 3, 2, 1]
    assert abs(main["outer"] - ref["outer"]) <= chip_smoke.REF_OUTER_SLACK
    assert np.abs(main["u"] - ref["u"]).max() <= chip_smoke.REF_U_TOL


def test_chip_smoke_block_inverse_small():
    """Phase 4 at a tiny batch: the LU block inverse (incl. the
    cross-scale deep-contact block) and the Thomas factor pass their
    stated tolerances."""
    chip_smoke.phase_block_inverse(6, 64, jax.devices())


def test_chip_smoke_four_devices_match_one():
    """Phase 5 at 16^2 on 4 virtual CPU devices against 1 device:
    identical Newton counts, solution split over the 4 devices."""
    devs = jax.devices()
    assert len(devs) >= 4
    chip_smoke.phase_four_cards(16, 2, devs)


@pytest.mark.gpu
def test_chip_smoke_phases_on_gpu(gpu_devices):
    """Phases 2-4 at 256^2 on the card (run with -m gpu on a GPU
    machine)."""
    main = chip_smoke.phase_main_path(256, gpu_devices, trace=False)
    chip_smoke.phase_reference(256, gpu_devices, main)
    chip_smoke.phase_block_inverse(32, 562, gpu_devices)


# ------------------------------------------------------------ block inverse

def test_block_inv_is_lu_on_every_dtype():
    rng = np.random.default_rng(1)
    M = rng.standard_normal((3, 40, 40)) + 8.0 * np.eye(40)
    for dt in (jnp.float32, jnp.float64):
        X = np.asarray(blocktri._block_inv(jnp.asarray(M, dt)))
        np.testing.assert_allclose(
            X, np.linalg.inv(M), rtol=1e-4 if dt == jnp.float32 else 1e-12,
            atol=1e-6 if dt == jnp.float32 else 1e-14)


# ------------------------------------------------------------ memory budget

class _FakeDevice:
    def __init__(self, platform, stats):
        self.platform, self._stats = platform, stats

    def memory_stats(self):
        return self._stats


def test_factor_budget_from_device_limit_and_host(monkeypatch):
    gpu = _FakeDevice("gpu", {"bytes_limit": 60e9, "bytes_in_use": 0})
    assert blocktri.default_factor_budget(gpu) == pytest.approx(
        blocktri.DEVICE_FACTOR_FRACTION * 60e9)
    assert blocktri.default_factor_budget(jax.devices("cpu")[0]) == \
        blocktri.HOST_FACTOR_BUDGET_BYTES
    with pytest.raises(ValueError, match="no memory limit"):
        blocktri.default_factor_budget(_FakeDevice("gpu", None))

    # LineBlocking.build's default comes from the first device
    from proximalgalerkin_tpu.la.ell import EllPattern
    rng = np.random.default_rng(0)
    pattern = EllPattern.build(rng.integers(0, 120, size=(200, 3)), 120,
                               np.empty(0, np.int64))
    pts = rng.standard_normal((120, 2))
    monkeypatch.setattr(blocktri.jax, "devices", lambda *a: [gpu])
    blk = blocktri.LineBlocking.build(pattern, pts)
    assert blk.max_bytes == pytest.approx(
        blocktri.DEVICE_FACTOR_FRACTION * 60e9)
    monkeypatch.undo()
    blk = blocktri.LineBlocking.build(pattern, pts)
    assert blk.max_bytes == blocktri.HOST_FACTOR_BUDGET_BYTES


# ------------------------------------------------------------ CLI

def test_cli_platform_choices():
    from proximalgalerkin_tpu.cli import build_parser
    args = build_parser().parse_args(["--platform", "gpu", "obstacle-fd"])
    assert args.platform == "gpu"
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--platform", "tpu", "obstacle-fd"])


# ------------------------------------------------------------ trace reduction

def test_busy_seconds_unions_overlaps():
    from proximalgalerkin_tpu.utils.profiling import busy_seconds
    ns = 10**9
    ivs = [(0, 2 * ns), (1 * ns, 3 * ns), (5 * ns, 6 * ns),
           (5 * ns, 5 * ns + 1)]
    assert busy_seconds(ivs) == pytest.approx(4.0)
    assert busy_seconds([]) == 0.0


# ------------------------------------------------------------ solver path

def test_p1_mg_mixed_path_ignores_kernel_env(monkeypatch):
    """P1ObstacleSolver(mixed_precision=True, pc='mg') always runs the
    XLA MG-PCG: the former kernel-selection variables change nothing."""
    from proximalgalerkin_tpu.mesh import rectangle_mesh
    from proximalgalerkin_tpu.models.obstacle_p1 import P1ObstacleSolver

    mesh = rectangle_mesh(16, 16, p0=(-1.0, -1.0), p1=(1.0, 1.0))
    base = P1ObstacleSolver(mesh, mixed_precision=True, pc="mg").solve()
    for k, v in (("PGTPU_MGFUSED", "1"), ("PGTPU_MGFUSED_CHUNK", "8"),
                 ("PGTPU_MGFUSED_WHILE", "1"), ("PGTPU_PALLAS", "force")):
        monkeypatch.setenv(k, v)
    s = P1ObstacleSolver(mesh, mixed_precision=True, pc="mg")
    hlo = s._newton.lower(
        *s.newton_args(*s.initial_state(), 1.0)).as_text()
    assert "custom_call" not in hlo and "pallas" not in hlo.lower()
    res = s.solve()
    assert res.converged
    assert res.newton_its == base.newton_its
    assert np.array_equal(res.u, base.u)


@pytest.mark.parametrize("pc", ["mg", "jacobi"])
def test_p1_mixed_f32_dots_at_full_precision(pc):
    """No f32 dot on the mixed inner solve is left at DEFAULT precision,
    which a GPU may run in TF32."""
    import re
    from proximalgalerkin_tpu.mesh import rectangle_mesh
    from proximalgalerkin_tpu.models.obstacle_p1 import P1ObstacleSolver

    mesh = rectangle_mesh(8, 8, p0=(-1.0, -1.0), p1=(1.0, 1.0))
    s = P1ObstacleSolver(mesh, mixed_precision=True, pc=pc)
    hlo = s._newton.lower(
        *s.newton_args(*s.initial_state(), 1.0)).as_text()
    dots = [l for l in hlo.splitlines() if "dot_general" in l]
    f32 = [l for l in dots if re.search(r"tensor<[0-9x]*xf32>", l)]
    assert f32 and all("HIGHEST, HIGHEST" in l for l in f32)


def test_p1_newton_missing_its_stop_fails_the_solve():
    """A Newton loop cut at newton_max above its stop is recorded, makes
    the solve unconverged, and fails chip_smoke's solve phase."""
    from proximalgalerkin_tpu.mesh import rectangle_mesh
    from proximalgalerkin_tpu.models.obstacle_p1 import P1ObstacleSolver

    mesh = rectangle_mesh(16, 16, p0=(-1.0, -1.0), p1=(1.0, 1.0))
    res = P1ObstacleSolver(mesh, mixed_precision=True, pc="mg",
                           newton_max=2).solve(max_outer=3)
    assert res.newton_failed and res.newton_failed[0] == 1
    assert not res.converged
    assert [len(h) for h in res.newton_history] == [
        k + 1 for k in res.newton_per_outer]
    with pytest.raises(SystemExit, match="missed its stop"):
        chip_smoke._solve(16, jax.devices()[0], "main",
                          mixed_precision=True, newton_max=2)


def test_p1_f64_mg_newton_steps_resolve_deep_contact():
    """The f64 MG-PCG inner solve stops in the Jacobi-scaled norm: every
    Newton solve past the first outer steps cuts its residual by 1e-5 or
    more (stopping on the unscaled residual, the alpha-85 step at 128^2
    managed 1e-4)."""
    from proximalgalerkin_tpu.mesh import rectangle_mesh
    from proximalgalerkin_tpu.models.obstacle_p1 import P1ObstacleSolver

    mesh = rectangle_mesh(128, 128, p0=(-1.0, -1.0), p1=(1.0, 1.0))
    res = P1ObstacleSolver(mesh, mixed_precision=False, pc="mg").solve()
    assert res.converged
    ratios = [h[-1][0] / h[0][0] for h in res.newton_history[4:]]
    assert max(ratios) < 1e-5, ratios
