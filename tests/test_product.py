"""Product plan tests, mirroring the reference's roundtrip matrix
(product.rs:976-1153): u64×1, u32×1, u32×2 (incl. Bounded + Accumulate),
u30×2, u32×4, u32×2+u64×1 channel mixes, plus validation rejections
(product.rs:1155-1166)."""

import numpy as np
import pytest

from concrete_ntt_tpu import product
from concrete_ntt_tpu.golden import polymul as gpoly
from concrete_ntt_tpu.tables import GOLDILOCKS, PRIMES32
from concrete_ntt_tpu.utils.prime import largest_prime_in_arithmetic_progression64

N = 64

P32A = largest_prime_in_arithmetic_progression64(2 * N, 1, 1 << 31, (1 << 32) - 1)
P32B = largest_prime_in_arithmetic_progression64(2 * N, 1, 1 << 31, P32A - 1)
P30A, P30B = PRIMES32[0], PRIMES32[1]

# four small primes so the modulus stays < 2^64 (the plan modulus is u64,
# as in the reference)
_P15 = []
_hi = (1 << 15) - 1
while len(_P15) < 4:
    p = largest_prime_in_arithmetic_progression64(2 * N, 1, 1 << 10, _hi)
    _P15.append(p)
    _hi = p - 1
P15A, P15B, P15C, P15D = sorted(_P15)

# a "u64-class" prime (>= 2^32) small enough to combine with two 15-bit ones
P33 = largest_prime_in_arithmetic_progression64(2 * N, 1, 1 << 32, (1 << 33) - 1)


def _mk(n, factors):
    m = 1
    for f in factors:
        m *= f
    plan = product.Plan.try_new(n, m, sorted(factors))
    assert plan is not None
    return plan, m


def _rand_mod(rng, m, n=N):
    return np.array([int(rng.integers(0, min(m, 1 << 63))) % m for _ in range(n)], dtype=np.uint64)


CHANNEL_MIXES = [
    [GOLDILOCKS],  # u64 × 1
    [P30A],  # u32 × 1
    [P30A, P30B],  # u30 × 2
    [P32B, P32A],  # u32 × 2 (≥ 2^31)
    [P15A, P15B, P15C, P15D],  # u32 × 4 (small primes; Π < 2^64)
    [P15A, P15B, P33],  # u32×2 + u64×1 (Π < 2^64)
]


@pytest.mark.parametrize("factors", CHANNEL_MIXES)
def test_roundtrip(factors, rng):
    plan, m = _mk(N, factors)
    x = _rand_mod(rng, m)
    dom = plan.fwd(x)
    back = plan.inv(plan.normalize(dom))
    assert back.tolist() == x.tolist()


@pytest.mark.parametrize("factors", [[P30A, P30B], [P15A, P15B, P33]])
def test_polymul_mod_m(factors, rng):
    plan, m = _mk(N, factors)
    lhs = _rand_mod(rng, m)
    rhs = _rand_mod(rng, m)
    got = plan.negacyclic_polymul(lhs, rhs)
    want = gpoly.negacyclic_convolution_mod(lhs.tolist(), rhs.tolist(), m)
    assert got.tolist() == want


def test_inv_accumulate(rng):
    plan, m = _mk(N, [P30A, P30B])
    lhs = _rand_mod(rng, m)
    rhs = _rand_mod(rng, m)
    acc0 = _rand_mod(rng, m)
    dom = plan.mul_assign_normalize(plan.fwd(lhs), plan.fwd(rhs))
    got = plan.inv(dom, mode=product.ACCUMULATE, standard=acc0)
    conv = gpoly.negacyclic_convolution_mod(lhs.tolist(), rhs.tolist(), m)
    want = [(int(a) + c) % m for a, c in zip(acc0, conv)]
    assert got.tolist() == want


def test_polymul_accumulate_mode(rng):
    """negacyclic_polymul(mode=ACCUMULATE): the tfhe-rs PBS composite
    (fwd, fwd, pointwise, lift, += acc) in one call (product.rs:444-445)."""
    plan, m = _mk(N, [P30A, P30B])
    lhs = _rand_mod(rng, m)
    rhs = _rand_mod(rng, m)
    acc0 = _rand_mod(rng, m)
    got = plan.negacyclic_polymul(lhs, rhs, mode=product.ACCUMULATE, standard=acc0)
    conv = gpoly.negacyclic_convolution_mod(lhs.tolist(), rhs.tolist(), m)
    want = [(int(a) + c) % m for a, c in zip(acc0, conv)]
    assert got.tolist() == want


def test_fwd_bounded(rng):
    # Bounded mode: inputs are centered small values mod m; roundtrip must
    # reproduce them exactly (product.rs:303-322 semantics).
    plan, m = _mk(N, [P30A, P30B])
    bound = 1 << 20
    signed = rng.integers(-(bound // 2), bound // 2, N)
    x = np.array([int(v) % m for v in signed], dtype=np.uint64)
    dom = plan.fwd(x, mode=product.bounded(bound))
    back = plan.inv(plan.normalize(dom))
    assert back.tolist() == x.tolist()


def test_fwd_bounded_matches_generic(rng):
    # p_i | modulus, so the centered residues represent the SAME values mod
    # each p_i: bounded fwd must agree with generic fwd channel-for-channel
    # (it is purely the cheaper representation, product.rs:303-322).
    plan, m = _mk(N, [P30A, P30B])
    bound = 1 << 20
    signed = rng.integers(-(bound // 2), bound // 2, N)
    x = np.array([int(v) % m for v in signed], dtype=np.uint64)
    dom_b = plan.fwd(x, mode=product.bounded(bound))
    dom_g = plan.fwd(x)
    np.testing.assert_array_equal(np.asarray(dom_b.res32), np.asarray(dom_g.res32))


def test_polymul_bounded_fused_matches_generic(rng, monkeypatch):
    """Bounded-mode lhs fwd rides the per-channel-input channel-grid kernel
    (interpret mode) and matches the generic fused row bit-for-bit."""
    n = 2048
    plan, m = _mk(n, [P30A, P30B])
    bound = 1 << 20
    signed = rng.integers(-(bound // 2), bound // 2, (1, n))
    lhs = np.array([[int(v) % m for v in row] for row in signed], dtype=np.uint64)
    rhs = np.array(
        [[int(rng.integers(0, 1 << 63)) % m for _ in range(n)]], dtype=np.uint64
    )
    monkeypatch.setenv("CONCRETE_NTT_TPU_ENGINE", "mxu")
    want = np.asarray(plan.negacyclic_polymul(lhs, rhs))
    got = np.asarray(
        plan.negacyclic_polymul(lhs, rhs, lhs_fwd_mode=product.bounded(bound))
    )
    np.testing.assert_array_equal(got, want)
    monkeypatch.setenv("CONCRETE_NTT_TPU_ENGINE", "xla")
    ref = np.asarray(
        plan.negacyclic_polymul(lhs, rhs, lhs_fwd_mode=product.bounded(bound))
    )
    np.testing.assert_array_equal(got, ref)


def test_mul_accumulate(rng):
    plan, m = _mk(N, [P30A, P30B])
    a = _rand_mod(rng, m)
    b = _rand_mod(rng, m)
    c = _rand_mod(rng, m)
    d = _rand_mod(rng, m)
    fa, fb, fc, fd = plan.fwd(a), plan.fwd(b), plan.fwd(c), plan.fwd(d)
    acc = plan.mul_assign_normalize(fa, fb)
    acc = plan.mul_accumulate(acc, plan.normalize(fc), fd)
    got = plan.inv(acc)
    conv_ab = gpoly.negacyclic_convolution_mod(a.tolist(), b.tolist(), m)
    conv_cd = gpoly.negacyclic_convolution_mod(c.tolist(), d.tolist(), m)
    want = [(x + y) % m for x, y in zip(conv_ab, conv_cd)]
    assert got.tolist() == want


def test_validation():
    # product.rs:1155-1166 patterns
    assert product.Plan.try_new(N, 15, [3, 5]) is None  # 3,5 lack 2n-th roots
    assert product.Plan.try_new(N, P30A * P30B, [P30B, P30A]) is None  # unsorted
    assert product.Plan.try_new(N, P30A * P30A, [P30A, P30A]) is None  # duplicate
    assert product.Plan.try_new(N, P30A * P30B + 1, [P30A, P30B]) is None  # mismatch
    # 1s are stripped:
    plan = product.Plan.try_new(N, P30A, [1, P30A])
    assert plan is not None and plan.factors == (P30A,)


def test_product_plan_on_mxu_engine_matches_xla(rng, monkeypatch):
    """The product plan's channels ride the four-step engine at n >= 2048."""
    import numpy as np

    from concrete_ntt_tpu import product
    from concrete_ntt_tpu.tables import PRIMES32

    n = 2048
    f1, f2 = PRIMES32[0], PRIMES32[1]
    plan = product.Plan.new(n, f1 * f2, (f1, f2))
    lhs = rng.integers(0, f1 * f2, (1, n)).astype(np.uint64)
    rhs = rng.integers(0, f1 * f2, (1, n)).astype(np.uint64)
    monkeypatch.setenv("CONCRETE_NTT_TPU_ENGINE", "xla")
    want = np.asarray(plan.negacyclic_polymul(lhs, rhs))
    monkeypatch.setenv("CONCRETE_NTT_TPU_ENGINE", "mxu")
    got = np.asarray(plan.negacyclic_polymul(lhs, rhs))
    np.testing.assert_array_equal(got, want)
