"""Process set-up shared by the entry points (chip_smoke.py, bench.py,
benches/): the compile cache, the device the run is on, and the card's
name and power limit.

Caches live at fixed paths inside the checkout (listed in .gitignore), so
a later process finds what an earlier one stored.
"""

from __future__ import annotations

import os
import subprocess

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
CACHE_ROOT = os.path.join(REPO_ROOT, ".cache")
DEFAULT_COMPILE_CACHE = os.path.join(CACHE_ROOT, "jax")


def compile_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else the fixed in-checkout path."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_COMPILE_CACHE


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache. JAX reads
    JAX_COMPILATION_CACHE_DIR itself; only when it is unset is the fixed
    default set here. Returns the directory in use."""
    import jax

    d = compile_cache_dir()
    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        jax.config.update("jax_compilation_cache_dir", d)
    return d


def device_info() -> dict:
    """Platform, device_kind and count of the default backend, as JAX
    reports them — named on every benchmark output line."""
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def require_gpu() -> dict:
    """device_info(), or SystemExit when the default backend is not a GPU:
    a measurement never falls back to the CPU."""
    info = device_info()
    if info["platform"] != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default backend is {info['platform']!r} "
            f"({info['kind']}); this entry point runs on the card only"
        )
    return info


def card_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for every card, read by a
    child process that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()
