"""Native (CRT wrapping) plan tests: the exactness contract — polymul equals
schoolbook negacyclic convolution in wrapping machine arithmetic — plus
roundtrips, both tiers, and binary variants (reference test patterns
native64.rs:1176-1243, native32.rs:507-…, SURVEY.md §4.1/4.3)."""

import numpy as np
import pytest

from concrete_ntt_tpu import (
    native32,
    native64,
    native128,
    native_binary32,
    native_binary64,
    native_binary128,
)
from concrete_ntt_tpu.golden import polymul as gpoly
from concrete_ntt_tpu.ops.u32 import np_u128_to_limbs, limbs_to_py_u128

N = 64


def _u32(rng, n=N):
    return rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)


def _u64(rng, n=N):
    return rng.integers(0, 1 << 64, n, dtype=np.uint64)


def _u128(rng, n=N):
    return [int(a) << 64 | int(b) for a, b in zip(_u64(rng, n), _u64(rng, n))]


def _bin32(rng, n=N):
    return rng.integers(0, 2, n, dtype=np.uint64).astype(np.uint32)


def _bin64(rng, n=N):
    return rng.integers(0, 2, n, dtype=np.uint64)


def _bin128(rng, n=N):
    return [int(v) for v in rng.integers(0, 2, n, dtype=np.uint64)]


# -- width 32 ----------------------------------------------------------------


@pytest.mark.parametrize("tier", ["plan32", "plan52"])
def test_native32_polymul(tier, rng):
    plan = (native32.Plan32 if tier == "plan32" else native32.Plan52).try_new(N)
    assert plan is not None
    lhs, rhs = _u32(rng), _u32(rng)
    got = np.asarray(plan.negacyclic_polymul(lhs, rhs))
    want = gpoly.negacyclic_convolution_wrapping(lhs.tolist(), rhs.tolist(), 32)
    assert got.tolist() == want


@pytest.mark.parametrize("tier", ["plan32", "plan52"])
def test_native32_roundtrip(tier, rng):
    plan = (native32.Plan32 if tier == "plan32" else native32.Plan52).try_new(N)
    x = _u32(rng)
    back = np.asarray(plan.inv(plan.fwd(x), out_format="u32"))
    want = (x.astype(np.uint64) * N & 0xFFFFFFFF).astype(np.uint32)
    assert (back == want).all()


# -- width 64 ----------------------------------------------------------------


@pytest.mark.parametrize("tier", ["plan32", "plan52"])
def test_native64_polymul(tier, rng):
    plan = (native64.Plan32 if tier == "plan32" else native64.Plan52).try_new(N)
    assert plan is not None
    lhs, rhs = _u64(rng), _u64(rng)
    got = plan.negacyclic_polymul(lhs, rhs)
    assert got.dtype == np.uint64
    want = gpoly.negacyclic_convolution_wrapping(lhs.tolist(), rhs.tolist(), 64)
    assert got.tolist() == want


def test_native64_roundtrip(rng):
    plan = native64.Plan32.try_new(N)
    x = _u64(rng)
    residues = plan.fwd(x)
    assert residues.shape == (5, N)
    from concrete_ntt_tpu.ops.u32 import limbs_to_np_u64

    back = limbs_to_np_u64(np.asarray(plan.inv(residues)))
    with np.errstate(over="ignore"):
        want = x * np.uint64(N)
    assert (back == want).all()


def test_native64_batched(rng):
    plan = native64.Plan32.try_new(N)
    lhs = _u64(rng, 3 * N).reshape(3, N)
    rhs = _u64(rng, 3 * N).reshape(3, N)
    got = plan.negacyclic_polymul(lhs, rhs)
    for i in range(3):
        want = gpoly.negacyclic_convolution_wrapping(
            lhs[i].tolist(), rhs[i].tolist(), 64
        )
        assert got[i].tolist() == want


def test_native64_channel_accessors():
    plan = native64.Plan32.try_new(N)
    from concrete_ntt_tpu.tables import NATIVE64_PRIMES

    for i in range(5):
        assert plan.ntt(i).p == NATIVE64_PRIMES[i]
    assert plan.ntt_0().p == NATIVE64_PRIMES[0]
    assert plan.ntt_4().p == NATIVE64_PRIMES[4]


# -- width 128 ---------------------------------------------------------------


def test_native128_polymul(rng):
    plan = native128.Plan32.try_new(N)
    assert plan is not None
    lhs, rhs = _u128(rng), _u128(rng)
    got = plan.negacyclic_polymul(lhs, rhs)
    want = gpoly.negacyclic_convolution_wrapping(lhs, rhs, 128)
    assert got == want


def test_native128_limb_api(rng):
    plan = native128.Plan32.try_new(N)
    lhs = _u128(rng)
    limbs = np_u128_to_limbs(lhs)
    residues = plan.fwd(limbs)
    assert residues.shape == (10, N)
    back = limbs_to_py_u128(np.asarray(plan.inv(residues)))
    mask = (1 << 128) - 1
    assert back == [(v * N) & mask for v in lhs]


# -- binary variants ----------------------------------------------------------


@pytest.mark.parametrize("tier", ["plan32", "plan52"])
def test_binary32_polymul(tier, rng):
    plan = (native_binary32.Plan32 if tier == "plan32" else native_binary32.Plan52).try_new(N)
    lhs, rhs = _u32(rng), _bin32(rng)
    got = np.asarray(plan.negacyclic_polymul(lhs, rhs))
    want = gpoly.negacyclic_convolution_wrapping(lhs.tolist(), rhs.tolist(), 32)
    assert got.tolist() == want


@pytest.mark.parametrize("tier", ["plan32", "plan52"])
def test_binary64_polymul(tier, rng):
    plan = (native_binary64.Plan32 if tier == "plan32" else native_binary64.Plan52).try_new(N)
    lhs, rhs = _u64(rng), _bin64(rng)
    got = plan.negacyclic_polymul(lhs, rhs)
    want = gpoly.negacyclic_convolution_wrapping(lhs.tolist(), rhs.tolist(), 64)
    assert got.tolist() == want


def test_binary128_polymul(rng):
    plan = native_binary128.Plan32.try_new(N)
    lhs, rhs = _u128(rng), _bin128(rng)
    got = plan.negacyclic_polymul(lhs, rhs)
    want = gpoly.negacyclic_convolution_wrapping(lhs, rhs, 128)
    assert got == want


def test_binary_fwd_binary_skips_reduction(rng):
    plan = native_binary64.Plan32.try_new(N)
    rhs = _bin64(rng)
    res = np.asarray(plan.fwd_binary(rhs))
    # binary fwd == regular fwd on {0,1} inputs (residue = value)
    res2 = np.asarray(plan.fwd(rhs))
    assert (res == res2).all()


def test_try_new_invalid_n():
    # The reference caps N at 2^15 (primes ≡ 1 mod 2^16, lib.rs:767-769);
    # this build extends to 2^17 via the ≡ 1 (mod 2^18) family and
    # fails beyond that.
    assert native64.Plan32.try_new(1 << 16) is not None
    assert native64.Plan32.try_new(1 << 18) is None
    assert native64.Plan32.try_new(48) is None


# -- planar limb-tuple format (the performance format) ------------------------


@pytest.mark.slow
@pytest.mark.parametrize("tier", ["plan32", "plan52"])
def test_native64_planar_polymul_matches_interleaved(tier, rng):
    """Planar (lo, hi) tuples are the zero-marshalling device format;
    results must be bit-identical to the array formats."""
    from concrete_ntt_tpu.ops.u32 import np_u64_to_limbs

    plan = (native64.Plan32 if tier == "plan32" else native64.Plan52).try_new(N)
    assert plan is not None
    lhs, rhs = _u64(rng, (3, N)), _u64(rng, (3, N))
    want = np.asarray(plan.negacyclic_polymul(lhs, rhs))  # np64 format

    ll, rl = np_u64_to_limbs(lhs), np_u64_to_limbs(rhs)
    got = plan.negacyclic_polymul(
        (ll[..., 0], ll[..., 1]), (rl[..., 0], rl[..., 1])
    )
    assert isinstance(got, tuple) and len(got) == 2
    lo, hi = (np.asarray(g) for g in got)
    assert lo.shape == (3, N) and lo.dtype == np.uint32
    back = lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
    np.testing.assert_array_equal(back, want)


def test_native64_planar_fwd_inv_roundtrip(rng):
    from concrete_ntt_tpu.ops.u32 import np_u64_to_limbs

    plan = native64.Plan32.try_new(N)
    x = _u64(rng, (2, N))
    xl = np_u64_to_limbs(x)
    residues = plan.fwd((xl[..., 0], xl[..., 1]))
    ref_res = plan.fwd(x)
    np.testing.assert_array_equal(np.asarray(residues), np.asarray(ref_res))
    lo, hi = plan.inv(residues, out_format="planar")
    back = np.asarray(lo).astype(np.uint64) | (
        np.asarray(hi).astype(np.uint64) << np.uint64(32)
    )
    np.testing.assert_array_equal(back, (x * np.uint64(N)))


def test_native128_planar_polymul_matches_py128(rng):
    plan = native128.Plan32.try_new(N)
    lhs, rhs = _u128(rng), _u128(rng)
    want = plan.negacyclic_polymul(lhs, rhs)
    ll, rl = np_u128_to_limbs(lhs), np_u128_to_limbs(rhs)
    got = plan.negacyclic_polymul(
        tuple(ll[..., i] for i in range(4)), tuple(rl[..., i] for i in range(4))
    )
    assert isinstance(got, tuple) and len(got) == 4
    stacked = np.stack([np.asarray(g) for g in got], axis=-1)
    assert limbs_to_py_u128(stacked) == want
