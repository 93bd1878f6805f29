"""Stage-split hybrid engine (ops/stagesplit.py): bit-exactness vs mxu64.

The hybrid must be indistinguishable from the direct four-step engine for
every prime regime, any-representative inputs (full u64 range — exercises
the wrap corrections in the prefix butterflies), both directions, folded
scales, and split depths ℓ = 1 and 2. Runs on the CPU backend (int8 dots
exact everywhere)."""

import numpy as np
import pytest

import jax.numpy as jnp

from concrete_ntt_tpu.ops import mxu64, stagesplit
from concrete_ntt_tpu.tables import GOLDILOCKS
from concrete_ntt_tpu.utils.prime import (
    largest_prime_in_arithmetic_progression64 as lpap,
)


def _regime_prime(n, tag):
    return {
        "p50": lambda: lpap(2 * n, 1, 0, 1 << 50),
        "p62": lambda: lpap(2 * n, 1, 1 << 61, 1 << 62),
        "p63": lambda: lpap(2 * n, 1, 1 << 62, 1 << 63),
        "gl": lambda: GOLDILOCKS,
        "p64": lambda: lpap(2 * n, 1, 1 << 63, (1 << 64) - 1),
    }[tag]()


def _limbs(rng, b, n):
    x = rng.integers(0, 1 << 64, (b, n), dtype=np.uint64)  # any representative
    return (
        jnp.asarray((x & 0xFFFFFFFF).astype(np.uint32)),
        jnp.asarray((x >> np.uint64(32)).astype(np.uint32)),
    )


@pytest.mark.parametrize("tag", ["p50", "p62", "p63", "gl", "p64"])
@pytest.mark.parametrize("n,n_h", [(512, 256), (512, 128), (1024, 256)])
def test_hybrid_fwd_inv_match_mxu64(rng, n, n_h, tag):
    p = _regime_prime(n, tag)
    limbs = _limbs(rng, 2, n)
    got = stagesplit.fwd64(limbs, n=n, p=p, n_h=n_h)
    want = mxu64.fwd(limbs, n=n, p=p)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    got_i = stagesplit.inv64(limbs, n=n, p=p, n_h=n_h)
    want_i = mxu64.inv(limbs, n=n, p=p)
    for g, w in zip(got_i, want_i):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("tag", ["p50", "gl"])
def test_hybrid_inv_folded_scale(rng, tag):
    n, n_h = 512, 256
    p = _regime_prime(n, tag)
    s = pow(n, p - 2, p) * pow(2, 64, p) % p
    limbs = _limbs(rng, 2, n)
    got = stagesplit.inv64(limbs, n=n, p=p, scale=s, n_h=n_h)
    want = mxu64.inv(limbs, n=n, p=p, scale=s)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_dispatch_hybrid_at_2pow15_matches_direct(rng, monkeypatch):
    """The dispatch tier the GPU route picks at n > 2^14 (u64 pairs) is the
    hybrid, bit-identical to the direct four-step through the public
    dispatch entry points."""
    from concrete_ntt_tpu.ops import ntt_dispatch

    n = 1 << 15
    p = _regime_prime(n, "p50")
    limbs = _limbs(rng, 1, n)
    want_f = mxu64.fwd(limbs, n=n, p=p)
    want_i = mxu64.inv(limbs, n=n, p=p, scale=7)
    monkeypatch.setattr(ntt_dispatch, "_platform", lambda: "gpu")
    assert ntt_dispatch.served_by(64, n, p) == "hybrid"
    got_f = ntt_dispatch.try_fwd64(limbs, n, p)
    got_i = ntt_dispatch.try_inv64(limbs, n, p, scale=7)
    for g, w in zip(got_f + got_i, want_f + want_i):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize(
    "p",
    [
        (1 << 64) - (1 << 32) + 1,  # gl: c64 = 2^32-1, double wrap ~2^-32
        1125899904679937,           # ~2^50
        (1 << 62) - 57,             # large c64
        (1 << 63) + 29,             # p > 2^63 (c64 = 2^64 - p)
    ],
)
def test_rep_safe_add_sub64_adversarial(p):
    """_add_rep64/_sub_rep64 wrap corrections at the exact boundaries the
    random tests essentially never hit (second-wrap probability is
    c64/2^64 — 2^-32 for Goldilocks). Exhaustive over a boundary grid."""
    from concrete_ntt_tpu.ops.stagesplit import _add_rep64, _sub_rep64
    from concrete_ntt_tpu.ops.u32 import const64_like

    c64i = (1 << 64) % p
    c64 = const64_like(c64i)
    M = (1 << 64) - 1
    boundary = [0, 1, c64i - 1, c64i, c64i + 1, p - 1, p, p + 1,
                M - c64i - 1, M - c64i, M - c64i + 1, M - 1, M]
    boundary = sorted({v & M for v in boundary})
    a = np.array([x for x in boundary for _ in boundary], dtype=np.uint64)
    b = np.array([y for _ in boundary for y in boundary], dtype=np.uint64)
    pair = lambda v: (
        jnp.asarray((v & 0xFFFFFFFF).astype(np.uint32)),
        jnp.asarray((v >> np.uint64(32)).astype(np.uint32)),
    )
    join = lambda t: np.asarray(t[0]).astype(np.uint64) | (
        np.asarray(t[1]).astype(np.uint64) << np.uint64(32)
    )
    got_add = join(_add_rep64(pair(a), pair(b), c64))
    got_sub = join(_sub_rep64(pair(a), pair(b), c64))
    for i in range(len(a)):
        assert int(got_add[i]) % p == (int(a[i]) + int(b[i])) % p
        assert int(got_sub[i]) % p == (int(a[i]) - int(b[i])) % p


@pytest.mark.parametrize("p", [1073479681, 2147352577, 4293918721])
def test_rep_safe_add_sub32_adversarial(p):
    from concrete_ntt_tpu.ops.stagesplit import _add_rep32, _sub_rep32

    c32i = (1 << 32) % p
    c32 = np.uint32(c32i)
    M = (1 << 32) - 1
    boundary = [0, 1, c32i - 1, c32i, c32i + 1, p - 1, p, p + 1,
                M - c32i - 1, M - c32i, M - c32i + 1, M - 1, M]
    boundary = sorted({v & M for v in boundary})
    a = np.array([x for x in boundary for _ in boundary], dtype=np.uint32)
    b = np.array([y for _ in boundary for y in boundary], dtype=np.uint32)
    got_add = np.asarray(_add_rep32(jnp.asarray(a), jnp.asarray(b), c32))
    got_sub = np.asarray(_sub_rep32(jnp.asarray(a), jnp.asarray(b), c32))
    for i in range(len(a)):
        assert int(got_add[i]) % p == (int(a[i]) + int(b[i])) % p
        assert int(got_sub[i]) % p == (int(a[i]) - int(b[i])) % p


def _regime_prime32(n, tag):
    return {
        "lt30": lambda: lpap(2 * n, 1, 0, 1 << 30),
        "lt31": lambda: lpap(2 * n, 1, 1 << 30, 1 << 31),
        "gen": lambda: lpap(2 * n, 1, 1 << 31, (1 << 32) - 1),
    }[tag]()


@pytest.mark.parametrize("tag", ["lt30", "lt31", "gen"])
@pytest.mark.parametrize("n,n_h", [(512, 256), (512, 128), (1024, 256)])
def test_hybrid32_fwd_inv_match_mxu32(rng, n, n_h, tag):
    from concrete_ntt_tpu.ops import mxu32, stagesplit as ss

    p = _regime_prime32(n, tag)
    x = jnp.asarray(rng.integers(0, 1 << 32, (2, n), dtype=np.uint64)
                    .astype(np.uint32))  # any u32 representative
    np.testing.assert_array_equal(
        np.asarray(ss.fwd32(x, n=n, p=p, n_h=n_h)),
        np.asarray(mxu32.fwd(x, n=n, p=p)),
    )
    s = pow(n, p - 2, p) * pow(2, 32, p) % p
    np.testing.assert_array_equal(
        np.asarray(ss.inv32(x, n=n, p=p, scale=s, n_h=n_h)),
        np.asarray(mxu32.inv(x, n=n, p=p, scale=s)),
    )


def test_dispatch_hybrid32_at_2pow15_matches_direct(rng, monkeypatch):
    """No route serves the 32-bit hybrid; it stays bit-identical to the
    four-step the GPU route dispatches at n = 2^15."""
    from concrete_ntt_tpu import prime32
    from concrete_ntt_tpu.ops import ntt_dispatch, stagesplit as ss

    n = 1 << 15
    p = _regime_prime32(n, "lt30")
    x = rng.integers(0, p, (1, n), dtype=np.uint32)
    monkeypatch.setattr(ntt_dispatch, "_platform", lambda: "gpu")
    assert ntt_dispatch.served_by(32, n, p) == "mxu"
    plan = prime32.Plan.new(n, p)
    np.testing.assert_array_equal(
        np.asarray(ss.fwd32(jnp.asarray(x), n=n, p=p)), np.asarray(plan.fwd(x))
    )
    np.testing.assert_array_equal(
        np.asarray(ss.inv32(jnp.asarray(x), n=n, p=p)), np.asarray(plan.inv(x))
    )


def test_hybrid_roundtrip_is_n_times_x(rng):
    n, n_h = 1024, 256
    p = _regime_prime(n, "p50")
    x = rng.integers(0, p, (2, n), dtype=np.uint64)
    limbs = (
        jnp.asarray((x & 0xFFFFFFFF).astype(np.uint32)),
        jnp.asarray((x >> np.uint64(32)).astype(np.uint32)),
    )
    y = stagesplit.inv64(
        stagesplit.fwd64(limbs, n=n, p=p, n_h=n_h), n=n, p=p, n_h=n_h
    )
    got = np.asarray(y[0]).astype(np.uint64) | (
        np.asarray(y[1]).astype(np.uint64) << np.uint64(32)
    )
    want = (x.astype(object) * n % p).astype(np.uint64)
    np.testing.assert_array_equal(got, want)
