#!/usr/bin/env bash
# Rebuild the benchmark environment from scratch (the role the reference's
# docker/Dockerfile plays: a runnable recipe, not just a version list —
# ENVIRONMENT.lock stays the human-readable summary).
#
# Usage:  ./scripts/setup_env.sh [venv-dir]     (default: .venv)
#
# Notes:
#  - requirements.lock is a `pip freeze` of the development env (jax 0.9.0
#    on python 3.12). GPU runs additionally need JAX's CUDA 12 plugin
#    (jax-cuda12-plugin / jax-cuda12-pjrt, same version as jax), which is
#    machine-provisioned and intentionally not pinned here.
#  - The package itself is pure Python + optional C extension; the C
#    helper (native/pattern.cpp) builds automatically on import if a
#    compiler is present, with a numpy fallback otherwise.
set -euo pipefail
cd "$(dirname "$0")/.."

VENV="${1:-.venv}"
python3 -m venv "$VENV"
# shellcheck disable=SC1091
source "$VENV/bin/activate"
pip install --upgrade pip
pip install -r requirements.lock
pip install -e .

# smoke: import + one tiny CPU solve + unit tests of the core
JAX_PLATFORMS=cpu python -c "
import proximalgalerkin_tpu as pg
from proximalgalerkin_tpu.models.obstacle_fd import fd_obstacle_solve
r = fd_obstacle_solve(9, max_outer=3, verbose=False)
print('smoke ok')"
JAX_PLATFORMS=cpu python -m pytest tests/test_elements.py tests/test_maps.py -q
echo "environment ready: source $VENV/bin/activate"
