"""int8-matmul-assisted CRT reconstructions (the Garner "lift" of the
inverse side).

The lift has two phases:

  1. digit extraction (reference v2 pairing: pair digits + outer Garner,
     native64.rs:91-141 / native128.rs:20-118) — sequential mod-p algebra,
     elementwise;
  2. mixed-radix accumulation  Σ_i digit_i · (Π_{j<i} P_j)  mod 2^w —
     a LINEAR map from the digits' bytes to the result's bytes with
     CONSTANT integer coefficients.

Phase 2 is a matmul: split each digit into xor-128 int8 byte planes (the
same trick as the NTT operand planes, ops/traced_scalar._digit8), multiply
by a constant [K, 4·out_limbs] int8 matrix whose (k, c) entry is byte c of
(256^b · prefix_i mod 2^w) offset by -128, and repair both offsets with one
extra ones-column (Σx) plus a per-column numpy constant — byte-exact in
int32 accumulators (≤ K·255² + corrections < 2^24), then one carry sweep
packs the byte columns into u32 limbs. Wrapping mod 2^w falls out of
dropping byte columns ≥ w/8 and the final carry-out.

Everything here is plain XLA (`lax.dot_general` int8×int8→int32, exact on
every backend when contracting the last axis), covered by the same
bit-exact cross-engine tests as ops/crt.py (tests/test_native.py golden /
wrapping oracles + tests/test_crt_mxu.py equality on random inputs).

The contraction is short (K = 21/41), so the elementwise chain lift
(ops/crt.py) is the default; whether this formulation wins on the H100 is
not measured. Gate: CONCRETE_NTT_TPU_MXU_LIFT = 1 turns the int8 lift on
(tools/ab_lift.py measures both); anything else keeps the chain lift.
"""

from __future__ import annotations

import os
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from .ops import crt
from .ops.u32 import const64_like, const_limbs, geq64, select64, select_limbs, sub64, sub_limbs


def mxu_lift_enabled() -> bool:
    return os.environ.get("CONCRETE_NTT_TPU_MXU_LIFT", "0") == "1"


@lru_cache(maxsize=32)
def _mixed_radix_matrix(limb_counts: tuple, prefixes: tuple, out_limbs: int):
    """Constant int8 matrix [K+1, 4·out_limbs+1] + int32 correction row.

    Row (i, li, b) maps byte b of limb li of digit i; column c accumulates
    byte c of Σ digit_i · prefix_i mod 2^(32·out_limbs). Last input row is
    conceptual only — the extra OUTPUT column holds Σx for the offset
    repair (its matrix entries are +1)."""
    ncol = 4 * out_limbs
    mask = (1 << (32 * out_limbs)) - 1
    rows = []
    for nlimb, pref in zip(limb_counts, prefixes):
        for li in range(nlimb):
            for b in range(4):
                cval = ((pref & mask) << (8 * (4 * li + b))) & mask
                rows.append([(cval >> (8 * c)) & 0xFF for c in range(ncol)])
    m = np.array(rows, dtype=np.int64)  # [K, ncol] raw bytes 0..255
    k = m.shape[0]
    mat = np.concatenate(
        [(m - 128).astype(np.int8), np.ones((k, 1), dtype=np.int8)], axis=1
    )
    # Σ_k (x+128)(c-128+128) = acc + 128·Σx + (128·Σ_k (c_k-128) + K·2^14)
    const_col = (128 * (m - 128).sum(axis=0) + k * 16384).astype(np.int64)
    assert const_col.min() >= 0 and const_col.max() + k * 255 * 255 + 128 * k * 255 < (1 << 31)
    return mat, const_col.astype(np.uint32)


def _mixed_radix_mxu(digits, prefixes, out_limbs: int):
    """Σ digit_i · prefix_i mod 2^(32·out_limbs) as one int8 matmul.

    digits: list of little-endian u32 limb tuples ([..., n] arrays);
    prefixes: python ints. Returns an out_limbs tuple of u32 arrays."""
    limb_counts = tuple(len(d) for d in digits)
    mat, const_col = _mixed_radix_matrix(
        limb_counts, tuple(int(p) for p in prefixes), out_limbs
    )
    planes = [
        ((limb >> np.uint32(8 * b)) ^ np.uint32(128)).astype(jnp.int8)
        for d in digits
        for limb in d
        for b in range(4)
    ]
    x = jnp.stack(planes, axis=-1)  # [..., n, K] int8 == byte - 128
    acc = jax.lax.dot_general(
        x,
        jnp.asarray(mat),
        (((x.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    ncol = 4 * out_limbs
    sumx = acc[..., ncol].astype(jnp.uint32)
    cc = jnp.asarray(const_col)
    carry = jnp.zeros_like(sumx)
    out = []
    cur = jnp.zeros_like(sumx)
    for c in range(ncol):
        t = acc[..., c].astype(jnp.uint32) + (sumx << np.uint32(7)) + cc[c] + carry
        cur = cur | ((t & np.uint32(0xFF)) << np.uint32(8 * (c % 4)))
        carry = t >> np.uint32(8)
        if c % 4 == 3:
            out.append(cur)
            cur = jnp.zeros_like(sumx)
    return tuple(out)


def rec_u64_from5(mods, primes):
    """int8-matmul twin of ops.crt.rec_u64_from5 (bit-identical): the
    digit extraction (phase 1) reuses the exact crt helpers; the u64
    mixed-radix accumulation is one int8 matmul."""
    p0, p1, p2, p3, p4 = primes
    m0, m1, m2, m3, m4 = mods
    p12 = p1 * p2
    p34 = p3 * p4
    mod_p12 = crt._pair_digit(m1, m2, p1, p2)
    mod_p34 = crt._pair_digit(m3, m4, p3, p4)
    z = jnp.zeros_like(m0)
    v0 = (m0, z)
    v12 = crt._mul_mod64(
        crt._sub_mod64_lazy(mod_p12, v0, p12),
        pow(p0 % p12, (p1 - 1) * (p2 - 1) - 1, p12),
        p12,
    )
    partial = crt.add64(v0, crt._mul_mod64(v12, p0 % p34, p34))
    v34 = crt._mul_mod64(
        crt._sub_mod64_lazy(mod_p34, partial, p34),
        pow((p0 * p12) % p34, (p3 - 1) * (p4 - 1) - 1, p34),
        p34,
    )
    sign = geq64(v34, const64_like(p34 // 2 + 1))
    pos = _mixed_radix_mxu([(m0,), v12, v34], [1, p0, p0 * p12], 2)
    neg = sub64(pos, const64_like((p0 * p12 * p34) & ((1 << 64) - 1)))
    return select64(sign, neg, pos)


def rec_u128_from5(mods, primes):
    """int8-matmul twin of ops.crt.rec_u128_from5 (native_binary128 lift)."""
    p0, p1, p2, p3, p4 = primes
    m0, m1, m2, m3, m4 = mods
    p12 = p1 * p2
    p34 = p3 * p4
    mod_p12 = crt._pair_digit(m1, m2, p1, p2)
    mod_p34 = crt._pair_digit(m3, m4, p3, p4)
    z = jnp.zeros_like(m0)
    v0 = (m0, z)
    v12 = crt._mul_mod64(
        crt._sub_mod64_lazy(mod_p12, v0, p12),
        pow(p0 % p12, (p1 - 1) * (p2 - 1) - 1, p12),
        p12,
    )
    partial = crt.add64(v0, crt._mul_mod64(v12, p0 % p34, p34))
    v34 = crt._mul_mod64(
        crt._sub_mod64_lazy(mod_p34, partial, p34),
        pow((p0 * p12) % p34, (p3 - 1) * (p4 - 1) - 1, p34),
        p34,
    )
    sign = geq64(v34, const64_like(p34 // 2 + 1))
    pos = _mixed_radix_mxu([(m0,), v12, v34], [1, p0, p0 * p12], 4)
    neg = sub_limbs(pos, const_limbs((p0 * p12 * p34) & ((1 << 128) - 1), 4))
    return select_limbs(sign, neg, pos)


def rec_u128_from10(mods, primes):
    """int8-matmul twin of ops.crt.rec_u128_from10 (native128 lift, the north-star
    shape): v2 pair digits + outer Garner exactly as the crt version, then
    one [K=40(+1), 16(+1)] int8 matmul replaces the four u64×u128
    mullo_limbs accumulation chains."""
    assert len(primes) == 10 and len(mods) == 10
    pairs = [(primes[2 * i], primes[2 * i + 1]) for i in range(5)]
    pair_mods = [
        crt._pair_digit(mods[2 * i], mods[2 * i + 1], *pairs[i]) for i in range(5)
    ]
    pair_p = [a * b for a, b in pairs]

    digits = [pair_mods[0]]
    prefix = 1
    for i in range(1, 5):
        prefix = prefix * pair_p[i - 1]
        pi = pair_p[i]
        acc = digits[-1]
        for j in range(i - 2, -1, -1):
            acc = crt.add64(digits[j], crt._mul_mod64(acc, pair_p[j] % pi, pi))
        phi = pow(prefix % pi, crt._carmichael(pairs[i]) - 1, pi)
        d = crt._mul_mod64(crt._sub_mod64_lazy(pair_mods[i], acc, pi), phi, pi)
        digits.append(d)

    p89 = pair_p[4]
    sign = geq64(digits[4], const64_like(p89 // 2 + 1))
    prefixes = [1]
    for i in range(1, 5):
        prefixes.append(prefixes[-1] * pair_p[i - 1])
    total = prefixes[-1] * pair_p[4]
    pos = _mixed_radix_mxu(digits, prefixes, 4)
    neg = sub_limbs(pos, const_limbs(total & ((1 << 128) - 1), 4))
    return select_limbs(sign, neg, pos)
