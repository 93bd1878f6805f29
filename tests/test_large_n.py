"""Large-N support beyond the reference's cap.

The reference's hardcoded primes are ≡ 1 (mod 2^16), capping negacyclic
transforms at N = 2^15 (lib.rs:767-769; benches stop at 32768,
benches/ntt.rs:84). This build adds an extended 30-bit family ≡ 1
(mod 2^18), unlocking N up to 2^17 for the native CRT plans — needed for
the multi-device sharded-transform configs (BASELINE.md).

Full schoolbook oracles are O(N^2) and unusable at 2^16; correctness rests
on (a) the roundtrip law inv(fwd(x)) == N*x per channel, (b) a wrapping
polymul against a *sparse* operand where the convolution is computable
exactly, and (c) cross-engine equality (already covered for the engines at
small N).
"""

import numpy as np
import pytest

from concrete_ntt_tpu import native64, prime32
from concrete_ntt_tpu.tables import native_channel_primes, primes32_ext


def test_extended_prime_family_properties():
    ps = primes32_ext()
    assert len(ps) == 10 and len(set(ps)) == 10
    for p in ps:
        assert p < 1 << 30 and p % (1 << 18) == 1


def test_channel_prime_selection_by_size():
    assert native_channel_primes(5, 1 << 15) is not None
    assert native_channel_primes(5, 1 << 16) == primes32_ext()[:5]
    assert native_channel_primes(5, 1 << 18) is None


@pytest.mark.parametrize("n", [1 << 16, 1 << 17])
def test_prime32_roundtrip_at_2pow16(rng, n):
    p = primes32_ext()[0]
    plan = prime32.Plan.try_new(n, p)
    assert plan is not None
    x = rng.integers(0, p, (1, n), dtype=np.uint32)
    y = np.asarray(plan.inv(plan.fwd(x)))
    want = (x.astype(np.uint64) * np.uint64(n) % np.uint64(p)).astype(np.uint32)
    np.testing.assert_array_equal(y, want)


def test_product_2xu32_sparse_polymul_at_2pow16(rng):
    """product-2xu32-65536 bench-row shape: fused 2-channel product plan
    over the ext-prime factors, vs the exact sparse (monomial) oracle."""
    from concrete_ntt_tpu import product

    n = 1 << 16
    f1, f2 = primes32_ext()[0], primes32_ext()[1]
    m = f1 * f2
    plan = product.Plan.try_new(n, m, (f1, f2))
    assert plan is not None
    lhs = rng.integers(0, m, (1, n), dtype=np.uint64)
    s = 23451
    rhs = np.zeros((1, n), dtype=np.uint64)
    rhs[0, s] = 1
    got = np.asarray(plan.negacyclic_polymul(lhs, rhs))
    want = np.zeros(n, dtype=np.uint64)
    want[s:] = lhs[0, : n - s]
    want[:s] = np.array(
        [(m - int(v)) % m for v in lhs[0, n - s:]], dtype=np.uint64
    )  # x^n = -1 (mod m)
    np.testing.assert_array_equal(got[0], want)


def test_native64_sparse_polymul_at_2pow16(rng):
    n = 1 << 16
    plan = native64.Plan32.try_new(n)
    assert plan is not None
    # rhs = x^s (a single monomial): negacyclic product is an exact rotation
    # with sign wrap — computable without an O(n^2) oracle.
    lhs = rng.integers(0, 1 << 64, (1, n), dtype=np.uint64)
    s = 12345
    rhs = np.zeros((1, n), dtype=np.uint64)
    rhs[0, s] = 1
    got = np.asarray(plan.negacyclic_polymul(lhs, rhs))
    want = np.zeros(n, dtype=np.uint64)
    want[s:] = lhs[0, : n - s]
    want[:s] = (-lhs[0, n - s :].astype(np.int64)).astype(np.uint64)  # x^n = -1
    np.testing.assert_array_equal(got[0], want)
