"""u32 limb-arithmetic kernel-vs-bigint equivalence tests — the analogue
of the reference's SIMD-vs-scalar lane-exact tests (SURVEY.md §4.4:
lib.rs:794-908 widening muls, native64.rs:1245-1293 reconstruction slices)."""

import numpy as np
import pytest

from concrete_ntt_tpu.ops import u32 as ops

jnp = pytest.importorskip("jax.numpy")


def _rand_u32(rng, shape):
    return jnp.asarray(rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32))


def test_mulhi_mulwide(rng):
    a = _rand_u32(rng, 512)
    b = _rand_u32(rng, 512)
    ai = np.asarray(a).astype(object)
    bi = np.asarray(b).astype(object)
    hi = np.asarray(ops.mulhi_u32(a, b))
    lo2, hi2 = ops.mulwide_u32(a, b)
    lo2 = np.asarray(lo2)
    hi2 = np.asarray(hi2)
    for i in range(512):
        prod = int(ai[i]) * int(bi[i])
        assert int(hi[i]) == prod >> 32
        assert int(lo2[i]) == prod & 0xFFFFFFFF
        assert int(hi2[i]) == prod >> 32


@pytest.mark.parametrize("p", [0x3F5A0001, (1 << 31) - 1, 4294967291])
def test_mont_mul(p, rng):
    ninv = ops.mont_neginv(p)
    a = jnp.asarray(rng.integers(0, p, 256, dtype=np.uint64).astype(np.uint32))
    b = jnp.asarray(rng.integers(0, p, 256, dtype=np.uint64).astype(np.uint32))
    got = np.asarray(ops.mont_mul(a, b, p, ninv))
    r_inv = pow(1 << 32, p - 2, p)
    an, bn = np.asarray(a), np.asarray(b)
    for i in range(256):
        want = int(an[i]) * int(bn[i]) * r_inv % p
        assert int(got[i]) == want
    assert (got < p).all()


@pytest.mark.parametrize("p", [0x3F5A0001, 4294967291])
def test_add_sub_mod(p, rng):
    a = jnp.asarray(rng.integers(0, p, 256, dtype=np.uint64).astype(np.uint32))
    b = jnp.asarray(rng.integers(0, p, 256, dtype=np.uint64).astype(np.uint32))
    add = np.asarray(ops.add_mod(a, b, p))
    sub = np.asarray(ops.sub_mod(a, b, p))
    an = np.asarray(a).astype(np.uint64)
    bn = np.asarray(b).astype(np.uint64)
    assert (add == (an + bn) % p).all()
    assert (sub == (an + p - bn) % p).all()


def test_shoup_mul(rng):
    p = 0x3F5A0001
    w = int(rng.integers(0, p))
    ws = (w << 32) // p
    z = jnp.asarray(rng.integers(0, 1 << 32, 256, dtype=np.uint64).astype(np.uint32))
    lazy = np.asarray(ops.shoup_mul_lazy(z, jnp.uint32(w), jnp.uint32(ws), p))
    full = np.asarray(ops.shoup_mul(z, jnp.uint32(w), jnp.uint32(ws), p))
    zn = np.asarray(z).astype(np.uint64)
    assert (lazy < 2 * p).all()
    assert (lazy % p == zn * w % p).all()
    assert (full == zn * w % p).all()


def test_u64_limb_ops(rng):
    n = 256
    a64 = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    b64 = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    a = (jnp.asarray((a64 & 0xFFFFFFFF).astype(np.uint32)), jnp.asarray((a64 >> 32).astype(np.uint32)))
    b = (jnp.asarray((b64 & 0xFFFFFFFF).astype(np.uint32)), jnp.asarray((b64 >> 32).astype(np.uint32)))

    def as64(pair):
        return np.asarray(pair[0]).astype(np.uint64) | (np.asarray(pair[1]).astype(np.uint64) << np.uint64(32))

    with np.errstate(over="ignore"):
        assert (as64(ops.add64(a, b)) == a64 + b64).all()
        assert (as64(ops.sub64(a, b)) == a64 - b64).all()
        assert (as64(ops.mullo64(a, b)) == a64 * b64).all()
    assert (np.asarray(ops.geq64(a, b)) == (a64 >= b64)).all()

    l0, l1, l2, l3 = (np.asarray(v) for v in ops.mulwide64(a, b))
    for i in range(n):
        prod = int(a64[i]) * int(b64[i])
        got = int(l0[i]) | int(l1[i]) << 32 | int(l2[i]) << 64 | int(l3[i]) << 96
        assert got == prod

    hi_lo, hi_hi = (np.asarray(v) for v in ops.mulhi64(a, b))
    for i in range(n):
        assert (int(hi_lo[i]) | int(hi_hi[i]) << 32) == (int(a64[i]) * int(b64[i])) >> 64


def test_u64_conversions(rng):
    x = rng.integers(0, 1 << 64, 64, dtype=np.uint64)
    limbs = ops.np_u64_to_limbs(x)
    assert limbs.shape == (64, 2) and limbs.dtype == np.uint32
    assert (ops.limbs_to_np_u64(limbs) == x).all()


def test_u128_conversions(rng):
    vals = [int(rng.integers(0, 1 << 63)) << 65 | int(rng.integers(0, 1 << 63)) for _ in range(16)]
    limbs = ops.np_u128_to_limbs(vals)
    assert ops.limbs_to_py_u128(limbs) == vals


def test_reduce_u32_mod(rng):
    for p in (0x3F5A0001, (1 << 29) + 3 * (1 << 16) + 1):
        m = (1 << 32) // p
        x = jnp.asarray(rng.integers(0, 1 << 32, 512, dtype=np.uint64).astype(np.uint32))
        got = np.asarray(ops.reduce_u32_mod(x, p, m))
        assert (got == np.asarray(x).astype(np.uint64) % p).all()


def test_shoup_mul_u32_lazy64(rng):
    """u32-operand Shoup specialization: t ≡ z·w (mod p), t in [0, 2p),
    exercised across the w/p regimes the fused mxu64 epilogue uses."""
    for p in ((1 << 50) - 27 * (1 << 16) + 0x1BFFF * 0 + 1125899903500289,
              (1 << 61) + 20 * (1 << 18) + 1,
              (1 << 62) - (1 << 16) + 1):
        if p % 2 == 0:
            continue
        w = int(rng.integers(0, p))
        wsh = (w << 64) // p
        z = rng.integers(0, 1 << 32, 512, dtype=np.uint64).astype(np.uint32)
        got = ops.shoup_mul_u32_lazy64(
            jnp.asarray(z),
            (np.uint32(w & 0xFFFFFFFF), np.uint32(w >> 32)),
            (np.uint32(wsh & 0xFFFFFFFF), np.uint32(wsh >> 32)),
            p,
        )
        lo, hi = (np.asarray(v) for v in got)
        for i in range(512):
            t = int(lo[i]) | int(hi[i]) << 32
            assert t < 2 * p
            assert t % p == int(z[i]) * w % p


def test_gl_mul_lazy(rng):
    """Lazy Goldilocks product: any-u64 representative out, correct residue."""
    P = ops.GOLDILOCKS_P
    a64 = rng.integers(0, 1 << 64, 256, dtype=np.uint64)
    b64 = rng.integers(0, 1 << 64, 256, dtype=np.uint64)
    la = ops.np_u64_to_limbs(a64)
    lb = ops.np_u64_to_limbs(b64)
    a = (jnp.asarray(la[:, 0]), jnp.asarray(la[:, 1]))
    b = (jnp.asarray(lb[:, 0]), jnp.asarray(lb[:, 1]))
    lo, hi = (np.asarray(v) for v in ops.gl_mul_lazy(a, b))
    for i in range(256):
        t = int(lo[i]) | int(hi[i]) << 32
        assert t % P == int(a64[i]) * int(b64[i]) % P
