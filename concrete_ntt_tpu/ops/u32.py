"""u32-limb modular arithmetic primitives (device-side, elementwise).

This is the replacement for the reference's SIMD layer (src/lib.rs
V3/V4/V4IFma widening multiplies, lib.rs:126-334). The arithmetic stays in
32-bit lanes (no jax_enable_x64), so *all* wide arithmetic decomposes into uint32 limbs
with 16-bit-split high multiplies — the direct analogue of the reference's
`widening_mul_u64x8` built from 32-bit partial products (lib.rs:171-203).

Every function here is pure jnp on uint32 arrays and runs identically under
plain XLA on the GPU and on the CPU backend (tests).

Value representations:
  * u32 scalar fields: plain uint32 arrays.
  * u64 values: little-endian limb pairs `(lo, hi)` of uint32 arrays.
  * u128 values: 4-tuples `(l0, l1, l2, l3)` of uint32 arrays.

Modular-multiplication strategies (mirroring the reference's regimes):
  * Shoup multiplication by a plan constant w with precomputed companion
    w_shoup = ⌊w·2^32/p⌋ — 1 mulhi + 2 mullo (less_than_30bit.rs:115-129).
  * Montgomery multiplication for arbitrary operand pairs (replaces the
    reference's Barrett ladders, prime32.rs:286-408, which lean on native
    u64 lanes we don't have).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

U32 = jnp.uint32
_MASK16 = np.uint32(0xFFFF)


def u32(x) -> jnp.ndarray:
    return jnp.asarray(x, dtype=jnp.uint32)


# ---------------------------------------------------------------------------
# Wide 32x32 products via 16-bit splits
# ---------------------------------------------------------------------------


def mulhi_u32(a, b):
    """High 32 bits of the 64-bit product a*b (a, b uint32)."""
    a_lo = a & _MASK16
    a_hi = a >> 16
    b_lo = b & _MASK16
    b_hi = b >> 16
    ll = a_lo * b_lo
    lh = a_lo * b_hi
    hl = a_hi * b_lo
    hh = a_hi * b_hi
    mid = (ll >> 16) + (lh & _MASK16) + (hl & _MASK16)
    return hh + (lh >> 16) + (hl >> 16) + (mid >> 16)


def mulwide_u32(a, b):
    """Full 64-bit product of uint32 operands as a (lo, hi) limb pair."""
    a_lo = a & _MASK16
    a_hi = a >> 16
    b_lo = b & _MASK16
    b_hi = b >> 16
    ll = a_lo * b_lo
    lh = a_lo * b_hi
    hl = a_hi * b_lo
    hh = a_hi * b_hi
    mid = (ll >> 16) + (lh & _MASK16) + (hl & _MASK16)
    lo = (ll & _MASK16) | (mid << 16)
    hi = hh + (lh >> 16) + (hl >> 16) + (mid >> 16)
    return lo, hi


def cond_sub(x, m):
    """x - m if x >= m else x (single lazy-reduction step)."""
    m = np.uint32(m) if not hasattr(m, "dtype") else m
    return jnp.where(x >= m, x - m, x)


def add_mod(a, b, p):
    """(a + b) mod p for a, b in [0, p), any p < 2^32 (overflow-aware)."""
    s = a + b
    ovf = s < a
    # On overflow the true sum is s + 2^32 ∈ [2^32, 2p) → subtract p once
    # (2^32 - p added modularly); otherwise a single conditional subtract.
    return jnp.where(ovf, s - np.uint32(p), cond_sub(s, np.uint32(p)))


def sub_mod(a, b, p):
    """(a - b) mod p for a, b in [0, p)."""
    d = a - b
    return jnp.where(a >= b, d, d + np.uint32(p))


# ---------------------------------------------------------------------------
# Shoup multiplication (one constant operand)
# ---------------------------------------------------------------------------


def shoup_mul_lazy(z, w, w_shoup, p):
    """t ≡ z*w (mod p) with t in [0, 2p), for any z < 2^32, w < p < 2^31.

    Harvey's precomputed-quotient multiplication — the same algebra as the
    reference's fwd butterfly core (less_than_30bit.rs:126-128):
    t = z*w - ⌊z*w_shoup / 2^32⌋*p, all wrapping.
    """
    q = mulhi_u32(z, w_shoup)
    return z * w - q * np.uint32(p)


def shoup_mul(z, w, w_shoup, p):
    """z*w mod p, canonical [0, p)."""
    return cond_sub(shoup_mul_lazy(z, w, w_shoup, p), np.uint32(p))


# ---------------------------------------------------------------------------
# Montgomery multiplication (both operands variable)
# ---------------------------------------------------------------------------


def mont_neginv(p: int) -> int:
    """-p^{-1} mod 2^32 (host-side plan constant; p odd)."""
    inv = pow(p, -1, 1 << 32)
    return (-inv) % (1 << 32)


def mont_mul(a, b, p, p_neginv):
    """a*b*2^{-32} mod p, canonical [0, p), for any odd p < 2^32.

    REDC with explicit carry tracking so it stays correct for p ≥ 2^31
    (where intermediate [0, 2p) would overflow u32).
    """
    lo, hi = mulwide_u32(a, b)
    m = lo * np.uint32(p_neginv)
    mp_hi = mulhi_u32(m, np.uint32(p))
    carry = (lo != 0).astype(jnp.uint32)  # lo(ab)+lo(mp) is 0 or exactly 2^32
    t = hi + mp_hi
    ovf = t < hi
    s = t + carry
    ovf = ovf | (s < t)
    # true r = s (+ 2^32 if ovf) ∈ [0, 2p); reduce to [0, p).
    return jnp.where(ovf, s - np.uint32(p), cond_sub(s, np.uint32(p)))


def to_mont(x: int, p: int) -> int:
    """Host-side: x·2^32 mod p (for precomputing Montgomery-form constants)."""
    return (x << 32) % p


# ---------------------------------------------------------------------------
# Barrett-style reduction helpers
# ---------------------------------------------------------------------------


def reduce_u32_mod(x, p: int, m_barrett: int):
    """x mod p for any x < 2^32, p < 2^30, with m_barrett = ⌊2^32/p⌋ (host const).

    q = ⌊x·m/2^32⌋ underestimates x/p by at most 2 → two conditional subtracts.
    """
    q = mulhi_u32(x, np.uint32(m_barrett))
    r = x - q * np.uint32(p)
    r = cond_sub(r, np.uint32(2 * p))
    return cond_sub(r, np.uint32(p))


# ---------------------------------------------------------------------------
# u64 limb-pair arithmetic
# ---------------------------------------------------------------------------


def add64(a, b):
    """Wrapping 64-bit add of limb pairs."""
    a_lo, a_hi = a
    b_lo, b_hi = b
    lo = a_lo + b_lo
    carry = (lo < a_lo).astype(jnp.uint32)
    return lo, a_hi + b_hi + carry


def sub64(a, b):
    """Wrapping 64-bit subtract of limb pairs."""
    a_lo, a_hi = a
    b_lo, b_hi = b
    lo = a_lo - b_lo
    borrow = (a_lo < b_lo).astype(jnp.uint32)
    return lo, a_hi - b_hi - borrow


def geq64(a, b):
    """a >= b for limb pairs."""
    a_lo, a_hi = a
    b_lo, b_hi = b
    return (a_hi > b_hi) | ((a_hi == b_hi) & (a_lo >= b_lo))


def select64(c, a, b):
    return jnp.where(c, a[0], b[0]), jnp.where(c, a[1], b[1])


def cond_sub64(x, m):
    """x - m if x >= m else x, for limb pairs (m may be a python int)."""
    m = const64_like(m, x[0]) if isinstance(m, int) else m
    return select64(geq64(x, m), sub64(x, m), x)


def const64_like(v: int, ref=None):
    """Broadcastable (lo, hi) uint32 scalar pair from a python int."""
    del ref  # scalars broadcast against any shape
    return np.uint32(v & 0xFFFFFFFF), np.uint32((v >> 32) & 0xFFFFFFFF)


def mullo64(a, b):
    """Low 64 bits of the product of two u64 limb pairs."""
    a_lo, a_hi = a
    b_lo, b_hi = b
    lo, hi = mulwide_u32(a_lo, b_lo)
    hi = hi + a_lo * b_hi + a_hi * b_lo
    return lo, hi


def mulwide64(a, b):
    """Full 128-bit product of two u64 limb pairs → 4 uint32 limbs."""
    a_lo, a_hi = a
    b_lo, b_hi = b
    p0_lo, p0_hi = mulwide_u32(a_lo, b_lo)
    p1_lo, p1_hi = mulwide_u32(a_lo, b_hi)
    p2_lo, p2_hi = mulwide_u32(a_hi, b_lo)
    p3_lo, p3_hi = mulwide_u32(a_hi, b_hi)
    # limb 1 = p0_hi + p1_lo + p2_lo (with carries into limbs 2, 3)
    s1 = p0_hi + p1_lo
    c1 = (s1 < p0_hi).astype(jnp.uint32)
    l1 = s1 + p2_lo
    c1 = c1 + (l1 < s1).astype(jnp.uint32)
    # limb 2 = p1_hi + p2_hi + p3_lo + c1
    s2 = p1_hi + p2_hi
    c2 = (s2 < p1_hi).astype(jnp.uint32)
    l2a = s2 + p3_lo
    c2 = c2 + (l2a < s2).astype(jnp.uint32)
    l2 = l2a + c1
    c2 = c2 + (l2 < l2a).astype(jnp.uint32)
    l3 = p3_hi + c2
    return p0_lo, l1, l2, l3


def mulhi64(a, b):
    """High 64 bits of the 128-bit product, as a limb pair."""
    _, _, l2, l3 = mulwide64(a, b)
    return l2, l3


def mul64_u32(a, b32):
    """Low 64 bits of (u64 limb pair a) * (u32 b32)."""
    a_lo, a_hi = a
    lo, hi = mulwide_u32(a_lo, b32)
    return lo, hi + a_hi * b32


def add64c(a, b):
    """Wrapping 64-bit add returning (sum_pair, carry_out as uint32 0/1)."""
    a_lo, a_hi = a
    b_lo, b_hi = b
    lo = a_lo + b_lo
    c0 = (lo < a_lo).astype(jnp.uint32)
    hi = a_hi + b_hi
    c1 = (hi < a_hi).astype(jnp.uint32)
    hi2 = hi + c0
    c2 = (hi2 < hi).astype(jnp.uint32)
    return (lo, hi2), c1 | c2


def sub64b(a, b):
    """Wrapping 64-bit subtract returning (diff_pair, borrow_out as bool)."""
    a_lo, a_hi = a
    b_lo, b_hi = b
    borrow = (a_hi < b_hi) | ((a_hi == b_hi) & (a_lo < b_lo))
    return sub64(a, b), borrow


def add_mod64(a, b, p: int):
    """(a + b) mod p for limb pairs in [0, p), any p < 2^64."""
    s, carry = add64c(a, b)
    neg_p = const64_like((1 << 64) - p)
    over = carry.astype(bool)
    reduced = cond_sub64(s, p)
    wrapped = add64(s, neg_p)
    return select64(over, wrapped, reduced)


def sub_mod64(a, b, p: int):
    """(a - b) mod p for limb pairs in [0, p)."""
    d, borrow = sub64b(a, b)
    return select64(borrow, add64(d, const64_like(p)), d)


def mont_neginv64(p: int) -> int:
    """-p^{-1} mod 2^64 (host-side; p odd)."""
    return (-pow(p, -1, 1 << 64)) % (1 << 64)


def mont_mul64(a, b, p: int, p_neginv: int):
    """a·b·2^{-64} mod p for odd p < 2^64 (REDC).

    Precondition: a·b < 2^64·p (e.g. one operand < p, or both < 2^32·√p) —
    then REDC's t = (a·b + m·p)/2^64 < 2p and one conditional subtract
    yields the canonical [0, p) result. For two arbitrary u64
    representatives the quotient can reach 2p + p/2^64 and the result may
    land in [p, 2p); call sites keep one side canonical.

    Replaces the reference's u256-reciprocal generic multiplication
    (generic_solinas.rs:42-75) — same canonical result, limb-friendly.
    """
    l0, l1, l2, l3 = mulwide64(a, b)
    t_lo = (l0, l1)
    t_hi = (l2, l3)
    m = mullo64(t_lo, const64_like(p_neginv))
    mp_hi = mulhi64(m, const64_like(p))
    # low 64 bits of T + m·p are zero; carry out iff T_lo != 0.
    carry = ((l0 != 0) | (l1 != 0)).astype(jnp.uint32)
    s, c1 = add64c(t_hi, mp_hi)
    s2, c2 = add64c(s, (carry, np.uint32(0)))
    over = (c1 | c2).astype(bool)
    neg_p = const64_like((1 << 64) - p)
    return select64(over, add64(s2, neg_p), cond_sub64(s2, p))


def shoup_mul_lazy64(z, w, w_shoup, p: int):
    """t ≡ z·w (mod p), t in [0, 2p), for z < 2^64, w < p < 2^63 (limb pairs)."""
    q = mulhi64(z, w_shoup)
    return sub64(mullo64(z, w), mullo64(q, const64_like(p)))


def shoup_mul_u32_lazy64(z32, w, w_shoup, p):
    """t ≡ z·w (mod p), t in [0, 2p), for a *u32* operand z against a u64
    constant w < p < 2^63 with companion w_shoup = ⌊w·2^64/p⌋ (limb pairs;
    arrays, np scalars, or traced SMEM scalars).

    Specialization of shoup_mul_lazy64 exploiting z < 2^32: the quotient
    q = ⌊z·w_shoup/2^64⌋ < z·w/p + 1 ≤ 2^32 fits a single u32, so computing
    it needs only the top limb of the 96-bit product z·w_shoup — 2 wide
    multiplies instead of the 4 of a full mulhi64. Used for the top-limb
    folds of the 3-limb four-step combine (ops/mxu64)."""
    w_lo, w_hi = w
    wsh_lo, wsh_hi = w_shoup
    p_pair = const64_like(p) if isinstance(p, int) else p
    # q = bits [64, 96) of z·w_shoup = hi(z·wsh_hi) + carry(lo(z·wsh_hi) + hi(z·wsh_lo))
    lo1, hi1 = mulwide_u32(z32, wsh_hi)
    t = lo1 + mulhi_u32(z32, wsh_lo)
    q = hi1 + (t < lo1).astype(jnp.uint32)
    return sub64(mul64_u32((w_lo, w_hi), z32), mul64_u32(p_pair, q))


# ---------------------------------------------------------------------------
# Generic N-limb arithmetic (u128 and mixed-width products; wrapping)
# ---------------------------------------------------------------------------


def add_limbs(a: tuple, b: tuple) -> tuple:
    """Wrapping multi-limb add (lengths must match; final carry dropped)."""
    assert len(a) == len(b)
    out = []
    carry = None
    for x, y in zip(a, b):
        s = x + y
        c0 = (s < x).astype(jnp.uint32)
        if carry is not None:
            s2 = s + carry
            c0 = c0 | (s2 < s).astype(jnp.uint32)
            s = s2
        out.append(s)
        carry = c0
    return tuple(out)


def sub_limbs(a: tuple, b: tuple) -> tuple:
    """Wrapping multi-limb subtract."""
    assert len(a) == len(b)
    out = []
    borrow = None
    for x, y in zip(a, b):
        d = x - y
        b0 = (x < y).astype(jnp.uint32)
        if borrow is not None:
            d2 = d - borrow
            b0 = b0 | (d < borrow).astype(jnp.uint32)
            d = d2
        out.append(d)
        borrow = b0
    return tuple(out)


def mullo_limbs(a: tuple, b: tuple, out_len: int) -> tuple:
    """Low `out_len` limbs of the product of limb tuples a and b (wrapping).

    Schoolbook with full carry propagation; all partials are 32x32→64 via
    mulwide_u32. Used for u128 Horner evaluation in CRT reconstruction.
    """
    acc = [None] * out_len  # per-position lists to sum with carries

    def add_at(pos: int, val):
        # add uint32 val into limb `pos`, propagating carries upward
        while pos < out_len:
            if acc[pos] is None:
                acc[pos] = val
                return
            s = acc[pos] + val
            carry = (s < val).astype(jnp.uint32)
            acc[pos] = s
            if pos + 1 >= out_len:
                return
            val = carry
            pos += 1
            # fast exit when no carry possible is skipped; carries are cheap

    for i, x in enumerate(a):
        if i >= out_len:
            break
        for j, y in enumerate(b):
            k = i + j
            if k >= out_len:
                break
            lo, hi = mulwide_u32(x, y)
            add_at(k, lo)
            if k + 1 < out_len:
                add_at(k + 1, hi)
    zero = jnp.zeros_like(a[0])
    return tuple(v if v is not None else zero for v in acc)


def geq_limbs(a: tuple, b: tuple):
    """a >= b for equal-length limb tuples."""
    assert len(a) == len(b)
    res = a[0] >= b[0]
    for x, y in zip(a[1:], b[1:]):
        res = (x > y) | ((x == y) & res)
    return res


def select_limbs(c, a: tuple, b: tuple) -> tuple:
    return tuple(jnp.where(c, x, y) for x, y in zip(a, b))


def const_limbs(v: int, length: int) -> tuple:
    return tuple(np.uint32((v >> (32 * k)) & 0xFFFFFFFF) for k in range(length))


# ---------------------------------------------------------------------------
# Goldilocks prime p = 2^64 - 2^32 + 1 (reference: prime64::Solinas,
# generic_solinas.rs:103-128). With φ = 2^32: 2^64 ≡ φ-1, 2^96 ≡ -1,
# so a 128-bit product (l0,l1,l2,l3) reduces with shifts/adds only.
# ---------------------------------------------------------------------------

GOLDILOCKS_P = (1 << 64) - (1 << 32) + 1
_PHI_M1 = np.uint32(0xFFFFFFFF)  # φ - 1 low limb


def gl_reduce128_lazy(l0, l1, l2, l3):
    """Reduce 4-limb value mod Goldilocks to a u64 representative (< 2^64,
    possibly ≥ p — one cond_sub64 away from canonical)."""
    lo64 = (l0, l1)
    # t0 = lo64 - l3  (mod p): on borrow the wrapped value is ≡ +.(φ-1) high,
    # subtract φ-1 to compensate for the -2^64.
    t0, b1 = sub64b(lo64, (l3, np.uint32(0)))
    t0 = select64(b1, sub64(t0, (_PHI_M1, np.uint32(0))), t0)
    # t1 = l2·(φ-1) = (l2 << 32) - l2, exact in 64 bits.
    t1 = sub64((np.uint32(0), l2), (l2, np.uint32(0)))
    t2, c2 = add64c(t0, t1)
    return select64(c2.astype(bool), add64(t2, (_PHI_M1, np.uint32(0))), t2)


def gl_reduce128(l0, l1, l2, l3):
    """Reduce 4-limb value mod Goldilocks to canonical [0, p)."""
    return cond_sub64(gl_reduce128_lazy(l0, l1, l2, l3), GOLDILOCKS_P)


def gl_mul_lazy(a, b):
    """a·b mod Goldilocks as a u64 representative (shift/add reduction only;
    4 wide multiplies total — cheaper than a Montgomery multiply)."""
    l0, l1, l2, l3 = mulwide64(a, b)
    return gl_reduce128_lazy(l0, l1, l2, l3)


def gl_mul(a, b):
    """a·b mod Goldilocks, canonical, limb pairs (a, b < 2^64 arbitrary)."""
    l0, l1, l2, l3 = mulwide64(a, b)
    return gl_reduce128(l0, l1, l2, l3)


def gl_add(a, b):
    """(a + b) mod Goldilocks for a, b in [0, p)."""
    return add_mod64(a, b, GOLDILOCKS_P)


def gl_sub(a, b):
    """(a - b) mod Goldilocks for a, b in [0, p)."""
    return sub_mod64(a, b, GOLDILOCKS_P)


# ---------------------------------------------------------------------------
# Host/device conversion helpers
# ---------------------------------------------------------------------------


def np_u64_to_limbs(x):
    """NumPy uint64 array → stacked (..., 2) uint32 little-endian limbs."""
    import numpy as np

    x = np.asarray(x, dtype=np.uint64)
    return np.stack(
        [(x & np.uint64(0xFFFFFFFF)).astype(np.uint32), (x >> np.uint64(32)).astype(np.uint32)],
        axis=-1,
    )


def limbs_to_np_u64(limbs):
    """(..., 2) uint32 limb array (numpy or jax) → NumPy uint64."""
    import numpy as np

    limbs = np.asarray(limbs)
    return limbs[..., 0].astype(np.uint64) | (limbs[..., 1].astype(np.uint64) << np.uint64(32))


def np_u128_to_limbs(values):
    """Iterable of python ints (< 2^128) → (..., 4) uint32 limbs."""
    import numpy as np

    vals = list(values)
    out = np.zeros((len(vals), 4), dtype=np.uint32)
    for i, v in enumerate(vals):
        v = int(v)
        for k in range(4):
            out[i, k] = (v >> (32 * k)) & 0xFFFFFFFF
    return out


def limbs_to_py_u128(limbs):
    """(..., 4) uint32 limbs → list of python ints."""
    import numpy as np

    limbs = np.asarray(limbs, dtype=np.uint32)
    flat = limbs.reshape(-1, 4)
    return [
        int(r[0]) | (int(r[1]) << 32) | (int(r[2]) << 64) | (int(r[3]) << 96)
        for r in flat
    ]
