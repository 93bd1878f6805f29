"""chip_smoke.py at a tiny size on the CPU: each phase's Plan call and its
reference comparison through the GPU route, the engine A/B's bit-exactness
check, and the refusal to run (non-zero exit, no result line) without a
GPU or without the rest of the repository."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

from concrete_ntt_tpu import native64, native_binary64, prime64  # noqa: E402
from concrete_ntt_tpu.tables import PRIMES32  # noqa: E402

N, B = 2048, 2


@pytest.mark.parametrize("p", [1073479681, 4293918721])
def test_phase_prime32(rng, gpu_route, p):
    assert chip_smoke.phase_prime32(rng, N, B, p)["width"] == 32


@pytest.mark.parametrize("p", [1125899903827969, prime64.Solinas])
def test_phase_prime64(rng, gpu_route, p):
    assert chip_smoke.phase_prime64(rng, N, B, p)["width"] == 64


@pytest.mark.parametrize(
    "module,tier,binary",
    [(native64, "Plan32", False), (native64, "Plan52", False),
     (native_binary64, "Plan32", True)],
)
def test_phase_native64(rng, gpu_route, module, tier, binary):
    info = chip_smoke.phase_native64(rng, N, B, module, tier, binary=binary)
    assert info["n"] == N


def test_phase_product(rng, gpu_route):
    assert chip_smoke.phase_product(rng, N, B)["p"] == PRIMES32[0]


def test_phase_native128(rng, gpu_route):
    assert chip_smoke.phase_native128(rng, N, 1)["n"] == N


def test_engine_ab_checks_both_engines(rng, gpu_route):
    rows = list(chip_smoke.engine_ab(rng, n=N, batch=1, calls=1))
    assert [r["case"] for r in rows] == [
        "prime32-fwd", "prime64-fwd", "native64-Plan32-polymul"]
    for r in rows:
        assert len(r["us_per_call"]["xla"]) == len(r["us_per_call"]["mxu"]) == 2
    assert "CONCRETE_NTT_TPU_ENGINE" not in os.environ


def test_check_refuses_a_mismatch():
    chip_smoke._check("same", np.arange(4), np.arange(4))
    with pytest.raises(AssertionError, match="not bit-exact"):
        chip_smoke._check("differ", np.arange(4), np.arange(1, 5))
    with pytest.raises(AssertionError, match="shape"):
        chip_smoke._check("shape", np.arange(4), np.arange(5))


def _run(cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "chip_smoke.py", *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


@pytest.mark.parametrize("args", [(), ("--four-cards",)])
def test_refuses_without_gpu(args):
    res = _run(ROOT, *args)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert "no GPU" in res.stderr


def test_refuses_without_the_repository(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    res = _run(str(tmp_path))
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_result_line_is_last_and_exact(monkeypatch, capsys):
    """With the device checks stubbed, main() ends on the exact result line."""
    from concrete_ntt_tpu.utils import runtime

    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    monkeypatch.setattr(runtime, "require_gpu", lambda: dev)
    monkeypatch.setattr(runtime, "card_name_and_power_limit",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    monkeypatch.setattr(runtime, "enable_compile_cache", lambda: "/cache")
    monkeypatch.setattr(chip_smoke, "main_phases", lambda rng: iter(()))
    monkeypatch.setattr(chip_smoke, "engine_ab", lambda rng: iter(()))
    assert chip_smoke.main([]) == 0
    lines = capsys.readouterr().out.strip().split("\n")
    assert json.loads(lines[-1]) == {"ok": True, "device": dev}
    assert lines[-1] == json.dumps({"ok": True, "device": dev})
    assert "NVIDIA H100 80GB HBM3, 700.00 W" in lines[:-1]
