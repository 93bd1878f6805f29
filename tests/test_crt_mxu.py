"""int8-matmul Garner lift (crt_mxu) == scalar-chain lift (ops/crt), bit-exact.

The int8 lift re-expresses the mixed-radix accumulation as an int8
digit-plane matmul (exact int32 accumulation, CLAUDE.md: int8 dots are
exact on CPU too), so equality must hold to the bit on every backend."""

import numpy as np
import pytest

import jax.numpy as jnp

from concrete_ntt_tpu import crt_mxu, native64
from concrete_ntt_tpu.ops import crt
from concrete_ntt_tpu.tables import PRIMES32


def _primes(k):
    # the native plans' channel primes (30-bit, pairwise coprime)
    return tuple(PRIMES32[:k])


def _mods(rng, primes, shape):
    return [
        jnp.asarray(rng.integers(0, p, shape, dtype=np.uint32)) for p in primes
    ]


@pytest.mark.parametrize("shape", [(4, 257), (1, 64)])
def test_rec_u64_from5_mxu_matches(rng, shape):
    primes = _primes(5)
    mods = _mods(rng, primes, shape)
    want = crt.rec_u64_from5(mods, primes)
    got = crt_mxu.rec_u64_from5(mods, primes)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_rec_u128_from5_mxu_matches(rng):
    primes = _primes(5)
    mods = _mods(rng, primes, (3, 128))
    want = crt.rec_u128_from5(mods, primes)
    got = crt_mxu.rec_u128_from5(mods, primes)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_rec_u128_from10_mxu_matches(rng):
    from concrete_ntt_tpu.tables import native_channel_primes

    primes = native_channel_primes(10, 1 << 10)
    assert primes is not None
    mods = _mods(rng, primes, (3, 128))
    want = crt.rec_u128_from10(mods, primes)
    got = crt_mxu.rec_u128_from10(mods, primes)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_rec_boundary_values():
    """All-zero, all-(p-1), and max-residue corners hit the sign select and
    the carry sweep's extremes."""
    primes = _primes(5)
    ones = jnp.ones((1, 8), dtype=np.uint32)
    for mods in (
        [jnp.zeros((1, 8), dtype=np.uint32) for _ in primes],
        [ones * np.uint32(p - 1) for p in primes],
        [ones * np.uint32(1) for _ in primes],
    ):
        want = crt.rec_u64_from5(mods, primes)
        got = crt_mxu.rec_u64_from5(mods, primes)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_native64_polymul_gate(rng, monkeypatch):
    """negacyclic_polymul is bit-identical with the int8 lift on and off."""
    n = 512
    plan = native64.Plan32.try_new(n)
    assert plan is not None
    a = rng.integers(0, 1 << 64, (2, n), dtype=np.uint64)
    b = rng.integers(0, 1 << 64, (2, n), dtype=np.uint64)
    monkeypatch.setenv("CONCRETE_NTT_TPU_MXU_LIFT", "0")
    want = np.asarray(plan.negacyclic_polymul(a, b))
    monkeypatch.setenv("CONCRETE_NTT_TPU_MXU_LIFT", "1")
    got = np.asarray(plan.negacyclic_polymul(a, b))
    np.testing.assert_array_equal(got, want)
