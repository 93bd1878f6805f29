"""Four-step int8-matmul prime64 engine: bit-exactness vs the stage engine.

Covers the two supported regimes — p < 2^62 with exact magic (the 52-bit
table primes) and Goldilocks 2^64-2^32+1 — plus lazy (arbitrary u64)
representative inputs and the folded inverse scale.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from concrete_ntt_tpu import prime64
from concrete_ntt_tpu.ops import mxu64
from concrete_ntt_tpu.ops.u32 import np_u64_to_limbs
from concrete_ntt_tpu.tables import GOLDILOCKS, PRIMES52

N = 256


def _pairs(x):
    limbs = np_u64_to_limbs(x)
    return jnp.asarray(limbs[..., 0]), jnp.asarray(limbs[..., 1])


def _u64(pair):
    return np.asarray(pair[0]).astype(np.uint64) | (
        np.asarray(pair[1]).astype(np.uint64) << np.uint64(32)
    )


@pytest.mark.parametrize("p", [PRIMES52[0], PRIMES52[3], GOLDILOCKS])
def test_fwd_inv_bit_exact_vs_stage_engine(rng, monkeypatch, p):
    monkeypatch.setenv("CONCRETE_NTT_TPU_ENGINE", "xla")
    plan = prime64.Plan.try_new(N, p)
    x = (rng.integers(0, 1 << 64, (3, N), dtype=np.uint64).astype(object) % p).astype(
        np.uint64
    )
    limbs = np_u64_to_limbs(x)
    want_f = np.asarray(plan.fwd(limbs))
    want_i = np.asarray(plan.inv(limbs))
    lo, hi = _pairs(x)
    got_f = mxu64.fwd((lo, hi), n=N, p=p)
    np.testing.assert_array_equal(
        np.stack([np.asarray(got_f[0]), np.asarray(got_f[1])], -1), want_f
    )
    got_i = mxu64.inv((lo, hi), n=N, p=p)
    np.testing.assert_array_equal(
        np.stack([np.asarray(got_i[0]), np.asarray(got_i[1])], -1), want_i
    )


@pytest.mark.parametrize("p", [PRIMES52[0], GOLDILOCKS])
def test_scaled_inverse_folds_constant(rng, p):
    plan = prime64.Plan.try_new(N, p)
    x = (rng.integers(0, 1 << 64, (2, N), dtype=np.uint64).astype(object) % p).astype(
        np.uint64
    )
    lo, hi = _pairs(x)
    s = 987654321
    base = _u64(mxu64.inv((lo, hi), n=N, p=p)).astype(object)
    scaled = _u64(mxu64.inv((lo, hi), n=N, p=p, scale=s)).astype(object)
    np.testing.assert_array_equal(scaled, base * s % p)


def test_arbitrary_u64_representatives(rng):
    p = PRIMES52[0]
    plan = prime64.Plan.try_new(N, p)
    x = rng.integers(0, 1 << 64, (2, N), dtype=np.uint64)  # NOT reduced mod p
    got = mxu64.fwd(_pairs(x), n=N, p=p)
    want = np.asarray(
        plan.fwd(np_u64_to_limbs((x.astype(object) % p).astype(np.uint64)))
    )
    np.testing.assert_array_equal(
        np.stack([np.asarray(got[0]), np.asarray(got[1])], -1), want
    )


def test_dispatch_forced_mxu_matches_xla(rng, monkeypatch):
    n = 2048
    p = PRIMES52[1]
    plan = prime64.Plan.try_new(n, p)
    x = (rng.integers(0, 1 << 64, (2, n), dtype=np.uint64).astype(object) % p).astype(
        np.uint64
    )
    monkeypatch.setenv("CONCRETE_NTT_TPU_ENGINE", "xla")
    want_f = np.asarray(plan.fwd(x))
    monkeypatch.setenv("CONCRETE_NTT_TPU_ENGINE", "mxu")
    np.testing.assert_array_equal(np.asarray(plan.fwd(x)), want_f)


def test_applicability_gates():
    assert mxu64.applicable(4096, PRIMES52[0])
    assert mxu64.applicable(4096, GOLDILOCKS)
    assert mxu64.applicable(4096, (1 << 62) + 135)  # any odd p > 2^33
    assert not mxu64.applicable(1024, PRIMES52[0])  # below size threshold
    assert not mxu64.applicable(4096, 1 << 40)  # even
    assert not mxu64.applicable(4096, (1 << 30) + 3)  # small p: prime32 turf


@pytest.mark.parametrize(
    "p",
    [
        2251799813554177,  # p51
        4611686018427322369,  # p62
        9223372036853661697,  # p63
        18446744073707716609,  # >= 2^63 generic
    ],
)
def test_all_reference_regimes_bit_exact(rng, monkeypatch, p):
    monkeypatch.setenv("CONCRETE_NTT_TPU_ENGINE", "xla")
    plan = prime64.Plan.try_new(N, p)
    x = (rng.integers(0, 1 << 64, (2, N), dtype=np.uint64).astype(object) % p).astype(
        np.uint64
    )
    limbs = np_u64_to_limbs(x)
    want_f = np.asarray(plan.fwd(limbs))
    lo, hi = _pairs(x)
    got = mxu64.fwd((lo, hi), n=N, p=p)
    np.testing.assert_array_equal(
        np.stack([np.asarray(got[0]), np.asarray(got[1])], -1), want_f
    )
