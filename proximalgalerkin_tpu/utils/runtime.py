"""Process-level runtime helpers shared by the entry points (CLI, bench.py,
chip_smoke.py, scripts/records.py): the persistent compilation cache and
the identity of the machine a number was measured on."""

from __future__ import annotations

import importlib.metadata
import os
import subprocess
from pathlib import Path

# Fixed cache location inside the checkout (listed in .gitignore). The path
# is part of what JAX keys the cache on, so it must not move between runs.
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and this
    sets nothing. Otherwise the cache goes to <checkout>/.jax_cache. Call
    before the first compilation of the process."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)


def nvidia_smi(fields: str = "name,power.limit") -> str:
    """`nvidia-smi --query-gpu=<fields>` as one line per card, run in a
    child process that never touches JAX or the card's memory."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except FileNotFoundError:
        return "nvidia-smi not found"
    if out.returncode != 0:
        return f"nvidia-smi failed (rc={out.returncode})"
    return "; ".join(l.strip() for l in out.stdout.splitlines() if l.strip())


def jax_versions() -> str:
    """jax, jaxlib and any CUDA plugin distributions with their versions."""
    names = sorted(
        {d.metadata["Name"] for d in importlib.metadata.distributions()
         if d.metadata["Name"]
         and (d.metadata["Name"].lower() in ("jax", "jaxlib")
              or d.metadata["Name"].lower().startswith("jax-cuda"))})
    return ", ".join(f"{n} {importlib.metadata.version(n)}" for n in names)
