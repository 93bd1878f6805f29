"""One-command release gate (`make ci`): lint -> CPU suite -> (when the
machine has an NVIDIA GPU) the GPU leg: `pytest -m gpu`, chip_smoke.py
and the headline bench.

Each leg runs in its own process, one after another, so one process at a
time holds the card; this script itself stays off JAX. Without a card the
GPU leg reports "not run: no GPU" — never a pass.

Exit code 0 = every leg that ran passed; non-zero otherwise.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(name: str, cmd: list[str], timeout: int | None = None) -> bool:
    print(f"\n=== ci: {name} ===", flush=True)
    t0 = time.time()
    try:
        rc = subprocess.run(cmd, cwd=REPO, timeout=timeout).returncode
    except subprocess.TimeoutExpired:
        print(f"--- {name}: TIMEOUT after {timeout}s", flush=True)
        return False
    print(f"--- {name}: {'PASS' if rc == 0 else f'FAIL rc={rc}'} "
          f"({time.time() - t0:.0f}s)", flush=True)
    return rc == 0


def gpu_present() -> bool:
    """An NVIDIA card answers nvidia-smi (read without importing JAX)."""
    if shutil.which("nvidia-smi") is None:
        return False
    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                             text=True, timeout=60)
    except subprocess.TimeoutExpired:
        return False
    return out.returncode == 0 and "GPU" in out.stdout


def main() -> int:
    py = sys.executable
    # The fast leg by default: tests marked `slow` (sharded composition,
    # large-N, property sweeps) run only with --full / FULL=1.
    full = "--full" in sys.argv[1:] or os.environ.get("FULL") == "1"
    ok = True
    ok &= run("lint", [py, "tools/lint.py"])
    sel = [] if full else ["-m", "not slow"]
    cpu_env = ["env", "JAX_PLATFORMS=cpu"]
    ok &= run("tests" + ("" if full else " (fast leg: -m 'not slow')"),
              [*cpu_env, py, "-m", "pytest", "tests/", "-q", *sel],
              timeout=5400)
    if not ok:
        print("\nci: FAILED before the GPU leg", flush=True)
        return 1
    if not gpu_present():
        print("\nci: PASS (CPU legs). GPU leg: not run: no GPU.", flush=True)
        return 0
    ok &= run("gpu tests", [py, "-m", "pytest", "tests/", "-q", "-m", "gpu"],
              timeout=3600)
    ok &= run("chip smoke", [py, "chip_smoke.py"], timeout=1200)
    ok &= run("headline", [py, "bench.py"], timeout=1800)
    print(f"\nci: {'PASS (all legs incl. GPU)' if ok else 'FAILED'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
