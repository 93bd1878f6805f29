"""Prime64 butterfly regimes (u64 values as u32 limb pairs).

Batched re-design of the reference's prime64 dispatch ladder
(prime64.rs:794-864). The reference's five regimes map to four here:

  * p < 2^62  — 64-bit Shoup, lazy [0,4p)  (less_than_62bit.rs:7-130).
    This tier also covers the 50-bit PRIMES52 family, i.e. it subsumes the
    reference's AVX512-IFMA less_than_50bit/51bit tiers (no 52-bit multiplier here; the u32-limb
    Shoup path is the equivalent).
  * p < 2^63  — 64-bit Shoup, lazy [0,2p)  (less_than_63bit.rs).
  * p = 2^64 - 2^32 + 1 — Goldilocks/Solinas special reduction
    (generic_solinas.rs:103-128), the flagship prime64 path: reduction is
    pure shifts/adds on 32-bit limbs.
  * any other p — Montgomery-domain twiddles via REDC64 (replaces the
    reference's u256-reciprocal generic engine, generic_solinas.rs:42-75).

Engine value convention: parts = (lo, hi) uint32 arrays; twiddle parts are
(w_lo, w_hi[, ws_lo, ws_hi]).
"""

from __future__ import annotations

from .u32 import (
    add64,
    add_mod64,
    cond_sub64,
    const64_like,
    gl_add,
    gl_mul,
    gl_sub,
    mont_mul64,
    shoup_mul_lazy64,
    sub64,
    sub_mod64,
)


def _canon2(pair, p):
    return cond_sub64(pair, p)


def make_fwd_shoup62(p: int):
    two_p = 2 * p

    def butterfly(z0, z1, w):
        (x0l, x0h), (x1l, x1h), (wl, wh, wsl, wsh) = z0, z1, w
        x0 = cond_sub64((x0l, x0h), two_p)  # [0,4p) -> [0,2p)
        t = shoup_mul_lazy64((x1l, x1h), (wl, wh), (wsl, wsh), p)  # [0,2p)
        y0 = add64(x0, t)  # [0,4p) < 2^64
        y1 = add64(sub64(x0, t), const64_like(two_p))  # [0,4p)
        return y0, y1

    def last_butterfly(z0, z1, w):
        (x0l, x0h), (x1l, x1h), (wl, wh, wsl, wsh) = z0, z1, w
        x0 = _canon2(cond_sub64((x0l, x0h), two_p), p)
        t = _canon2(shoup_mul_lazy64((x1l, x1h), (wl, wh), (wsl, wsh), p), p)
        y0 = _canon2(add64(x0, t), p)
        y1 = _canon2(add64(sub64(x0, t), const64_like(p)), p)
        return y0, y1

    return butterfly, last_butterfly


def make_inv_shoup62(p: int):
    two_p = 2 * p

    def butterfly(z0, z1, w):
        (x0l, x0h), (x1l, x1h), (wl, wh, wsl, wsh) = z0, z1, w
        x0 = (x0l, x0h)
        x1 = (x1l, x1h)
        y0 = cond_sub64(add64(x0, x1), two_p)  # [0,2p)
        t = add64(sub64(x0, x1), const64_like(two_p))  # [0,4p)
        y1 = shoup_mul_lazy64(t, (wl, wh), (wsl, wsh), p)  # [0,2p)
        return y0, y1

    def last_butterfly(z0, z1, w):
        y0, y1 = butterfly(z0, z1, w)
        return _canon2(y0, p), _canon2(y1, p)

    return butterfly, last_butterfly


def make_fwd_shoup63(p: int):
    """[0,2p) variant for 2^62 <= p < 2^63 (values stay < 2^64)."""

    def butterfly(z0, z1, w):
        (x0l, x0h), (x1l, x1h), (wl, wh, wsl, wsh) = z0, z1, w
        x0 = cond_sub64((x0l, x0h), p)  # [0,p)
        t = _canon2(shoup_mul_lazy64((x1l, x1h), (wl, wh), (wsl, wsh), p), p)
        y0 = add64(x0, t)  # [0,2p)
        y1 = add64(sub64(x0, t), const64_like(p))  # [0,2p)
        return y0, y1

    def last_butterfly(z0, z1, w):
        y0, y1 = butterfly(z0, z1, w)
        return _canon2(y0, p), _canon2(y1, p)

    return butterfly, last_butterfly


def make_inv_shoup63(p: int):
    def butterfly(z0, z1, w):
        (x0l, x0h), (x1l, x1h), (wl, wh, wsl, wsh) = z0, z1, w
        x0 = (x0l, x0h)
        x1 = (x1l, x1h)
        y0 = cond_sub64(add64(x0, x1), p)  # inputs [0,p) -> [0,p)
        t = add64(sub64(x0, x1), const64_like(p))  # [0,2p)
        y1 = _canon2(shoup_mul_lazy64(t, (wl, wh), (wsl, wsh), p), p)
        return y0, y1

    return butterfly, butterfly


def make_fwd_goldilocks():
    def butterfly(z0, z1, w):
        (x0l, x0h), (x1l, x1h), (wl, wh) = z0, z1, w
        t = gl_mul((x1l, x1h), (wl, wh))
        y0 = gl_add((x0l, x0h), t)
        y1 = gl_sub((x0l, x0h), t)
        return y0, y1

    return butterfly, butterfly  # canonical every stage


def make_inv_goldilocks():
    def butterfly(z0, z1, w):
        (x0l, x0h), (x1l, x1h), (wl, wh) = z0, z1, w
        x0 = (x0l, x0h)
        x1 = (x1l, x1h)
        y0 = gl_add(x0, x1)
        y1 = gl_mul(gl_sub(x0, x1), (wl, wh))
        return y0, y1

    return butterfly, butterfly


def make_fwd_generic64(p: int, p_neginv: int):
    """Arbitrary odd p < 2^64: Montgomery-form twiddles, canonical stages."""

    def butterfly(z0, z1, w):
        (x0l, x0h), (x1l, x1h), (wl, wh) = z0, z1, w
        t = mont_mul64((x1l, x1h), (wl, wh), p, p_neginv)
        y0 = add_mod64((x0l, x0h), t, p)
        y1 = sub_mod64((x0l, x0h), t, p)
        return y0, y1

    return butterfly, butterfly


def make_inv_generic64(p: int, p_neginv: int):
    def butterfly(z0, z1, w):
        (x0l, x0h), (x1l, x1h), (wl, wh) = z0, z1, w
        x0 = (x0l, x0h)
        x1 = (x1l, x1h)
        y0 = add_mod64(x0, x1, p)
        y1 = mont_mul64(sub_mod64(x0, x1, p), (wl, wh), p, p_neginv)
        return y0, y1

    return butterfly, butterfly
