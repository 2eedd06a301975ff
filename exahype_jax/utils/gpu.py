"""Run-time helpers for the programs that run on the GPU (``bench.py``,
``chip_smoke.py``, ``scripts/cell_stage_probe.py``, the examples).

- :func:`require_gpu` — stop unless JAX's default backend is a GPU; a
  measurement never falls back to the CPU.
- :func:`card_info` — the card's name and power limit as ``nvidia-smi``
  reports them (a card set below its maximum runs slower under load, so
  every number is reported beside them).
- :func:`use_compile_cache` — JAX's persistent compilation cache: where
  ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it and nothing is set
  here; otherwise the cache lives in ``<checkout>/.jax_cache``;
- :func:`select_platform` — the examples' ``--cpu`` flag.
"""

from __future__ import annotations

import os
import pathlib
import subprocess

#: The checkout root (the directory holding the ``exahype_jax`` package).
CHECKOUT = pathlib.Path(__file__).resolve().parents[2]


def require_gpu():
    """Return ``jax.devices()`` if the default backend is a GPU, else raise
    ``SystemExit`` with a message (exit code 2)."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default backend is {devices[0].platform!r} "
            f"({devices[0].device_kind}); this program measures the GPU only"
        )
    return devices


def card_info() -> str:
    """``name, power.limit`` of every card, one line each, from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True,
        capture_output=True,
        text=True,
        timeout=60,
    )
    return out.stdout.strip()


def compile_cache_dir() -> pathlib.Path | None:
    """The directory this program sets for the compile cache, or ``None``
    where ``JAX_COMPILATION_CACHE_DIR`` is set (JAX then uses it itself)."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return CHECKOUT / ".jax_cache"


def use_compile_cache() -> None:
    """Turn on JAX's persistent compilation cache (see module doc)."""
    import jax

    path = compile_cache_dir()
    if path is not None:
        jax.config.update("jax_compilation_cache_dir", str(path))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


def select_platform(cpu: bool) -> bool:
    """Platform choice of the example scripts: ``cpu=True`` (their ``--cpu``
    flag) runs on the CPU with kernels in interpret mode; otherwise a GPU
    is required and the compile cache is on.  Call before any JAX
    computation; returns ``cpu`` (pass it on as ``interpret=``)."""
    import jax

    if cpu:
        jax.config.update("jax_platforms", "cpu")
    else:
        require_gpu()
        use_compile_cache()
    return cpu
