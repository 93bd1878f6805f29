"""Process set-up helpers (utils/runtime.py), the peaks table and trace
reduction (utils/profiling.py), the native build's source-hash key, and the
per-coefficient golden oracle."""

import os
import shutil

import numpy as np
import pytest

from concrete_ntt_tpu import _native
from concrete_ntt_tpu.golden import polymul as gpoly
from concrete_ntt_tpu.utils import profiling, runtime


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.compile_cache_dir() == str(tmp_path)


def test_compile_cache_default_is_fixed_inside_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = runtime.compile_cache_dir()
    assert d == runtime.DEFAULT_COMPILE_CACHE == runtime.compile_cache_dir()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.commonpath([d, root]) == root
    assert os.path.basename(os.path.dirname(d)) == ".cache"
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".cache/" in f.read().split()


def test_enable_compile_cache_sets_only_the_default(monkeypatch, tmp_path):
    import jax

    before = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        jax.config.update("jax_compilation_cache_dir", before)
        assert runtime.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == before  # JAX reads the env
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        assert runtime.enable_compile_cache() == runtime.DEFAULT_COMPILE_CACHE
        assert jax.config.jax_compilation_cache_dir == runtime.DEFAULT_COMPILE_CACHE
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_device_info_and_require_gpu_refuses_cpu():
    info = runtime.device_info()
    assert info["platform"] == "cpu" and info["count"] == 8
    with pytest.raises(SystemExit, match="no GPU"):
        runtime.require_gpu()


def test_peaks_known_kind():
    pk = profiling.peaks("NVIDIA H100 80GB HBM3")
    assert pk["int8_ops_per_s"] == 1979e12 and pk["hbm_bytes_per_s"] == 3.35e12
    r = profiling.Roofline(seconds=1e-3, hbm_bytes=int(3.35e9 / 2),
                           int8_ops=int(1979e9 / 4), kind="NVIDIA H100 80GB HBM3")
    assert r.hbm_share == pytest.approx(0.5) and r.int8_share == pytest.approx(0.25)
    assert r.bound == "hbm" and r.share == pytest.approx(0.5)


@pytest.mark.parametrize("kind", ["AMD Instinct MI300X", "cpu", "NVIDIA A100-SXM4-80GB"])
def test_peaks_unknown_kind_raises(kind):
    with pytest.raises(KeyError, match="no published peaks"):
        profiling.peaks(kind)
    with pytest.raises(KeyError):
        profiling.Roofline(seconds=1.0, hbm_bytes=1, int8_ops=1, kind=kind).share


def test_fourstep_int8_ops_counts_both_passes():
    # n = 2^14: n1 = n2 = 128; E = 8 (u64 operand) / 4, D = 4
    ops = profiling.fourstep_int8_ops(1 << 14, 8, e_col=8, e_row=4)
    assert ops == 2 * 8 * (128 * 1024 * 512 + 128 * 512 * 512)


def test_native_library_keyed_by_source_hash(tmp_path):
    src = tmp_path / "hostmath.cpp"
    shutil.copy(_native._SRC, src)
    a = _native.so_path(str(src))
    assert a == _native.so_path(str(src))
    assert os.path.dirname(a) == str(tmp_path)
    src.write_text(src.read_text() + "\n// edited\n")
    assert _native.so_path(str(src)) != a


def test_native_library_loads_from_the_hashed_path():
    if _native.lib() is None:
        pytest.skip("no C++ toolchain")
    assert os.path.exists(_native.so_path())
    assert os.path.basename(_native.so_path()).startswith("hostmath-")


@pytest.mark.parametrize("n", [8, 32])
def test_negacyclic_coefficients_match_schoolbook(rng, n):
    a = [int(v) for v in rng.integers(0, 1 << 62, n, dtype=np.uint64)]
    b = [int(v) for v in rng.integers(0, 1 << 62, n, dtype=np.uint64)]
    p = 1073479681
    full = gpoly.negacyclic_convolution_mod(a, b, p)
    ks = list(range(n))
    assert gpoly.negacyclic_coefficients(a, b, ks, p) == full
    assert gpoly.negacyclic_coefficients(a, b, ks, 1 << 64) == \
        gpoly.negacyclic_convolution_wrapping(a, b, 64)


@pytest.mark.parametrize(
    "spans,want",
    [([(0, 10)], 10), ([(0, 10), (5, 15)], 15), ([(0, 10), (20, 25)], 15),
     ([(20, 25), (0, 10), (2, 3), (9, 21)], 25)],
)
def test_busy_ns_is_the_union_of_intervals(spans, want):
    assert profiling.busy_ns(spans) == want


def test_hlo_op_bytes_reads_entry_shapes():
    hlo = """HloModule m

%fused (p: u32[4,8]) -> s8[4,32] {
  %p = u32[4,8]{1,0} parameter(0)
}

ENTRY %main (a: u32[4,8]) -> s32[4,16] {
  %a.1 = u32[4,8]{1,0} parameter(0)
  %loop_convert_fusion.3 = s8[4,32]{1,0} fusion(%a.1), kind=kLoop, calls=%fused
  %gemm_fusion_dot.2 = s32[4,16]{1,0} fusion(%loop_convert_fusion.3, %a.1), kind=kCustom
  ROOT %t = (s32[4,16]{1,0}, s8[4,32]{1,0}) tuple(%gemm_fusion_dot.2, %loop_convert_fusion.3)
}
"""
    got = profiling.hlo_op_bytes(hlo)
    assert got["loop_convert_fusion_3"] == 128 + 128
    assert got["gemm_fusion_dot_2"] == 256 + 128 + 128
    assert got["loop_convert_fusion_3"] + got["gemm_fusion_dot_2"] == 768
