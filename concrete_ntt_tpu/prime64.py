"""64-bit prime negacyclic NTT plan (u32 limb pairs).

Capability parity with the reference's `prime64::Plan`
(src/prime64.rs:701-1129). The arithmetic stays in 32-bit lanes, so u64
coefficients live as little-endian uint32 limb pairs on device — the
analogue of the reference's `widening_mul_u64x8` building 64-bit lanes from
32-bit partial products (lib.rs:171-203).

Regime dispatch (vs the reference's five tiers, prime64.rs:794-864):
  * p = 2^64-2^32+1 → Goldilocks/Solinas special path (generic_solinas.rs:103-128)
    — the flagship tier (reduction = limb shifts/adds).
  * p < 2^62 → 64-bit Shoup lazy-[0,4p) (less_than_62bit.rs); subsumes the
    IFMA less_than_50bit/51bit tiers (PRIMES52 runs here).
  * p < 2^63 → 64-bit Shoup lazy-[0,2p) (less_than_63bit.rs).
  * otherwise → Montgomery-domain twiddles via REDC64 (replaces the u256
    reciprocal generic engine, generic_solinas.rs:42-75).

Data formats accepted by all methods:
  * uint32 arrays of shape [..., n, 2] — the device-native limb form
    (jit/vmap composable);
  * NumPy uint64 arrays of shape [..., n] — host convenience; converted on
    the way in, and the result is returned as NumPy uint64.

Conventions identical to prime32: fwd standard order → bit-reversed, [0,p);
inv bit-reversed → standard order, unnormalized (inv(fwd(x)) == n·x).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from .golden.ntt import negacyclic_twiddles
from .ops import butterflies64 as bf64
from .ops.engine import fwd_stages, inv_stages
from .ops.u32 import (
    GOLDILOCKS_P,
    add_mod64,
    const64_like,
    gl_add,
    gl_mul,
    limbs_to_np_u64,
    mont_mul64,
    mont_neginv64,
    np_u64_to_limbs,
)
from .utils.prime import is_prime64

#: exported name parity with `prime64::Solinas` (prime64.rs:22)
Solinas = GOLDILOCKS_P

MIN_N = 2  # reference requires n >= 16 (prime64.rs:706-709); see prime32.MIN_N.


def _variant(p: int) -> str:
    if p == GOLDILOCKS_P:
        return "goldilocks"
    if p < 1 << 62:
        return "shoup62"
    if p < 1 << 63:
        return "shoup63"
    return "generic"


def _split(vals: list[int]) -> tuple[np.ndarray, np.ndarray]:
    arr = np.array(vals, dtype=np.uint64)
    return (arr & np.uint64(0xFFFFFFFF)).astype(np.uint32), (arr >> np.uint64(32)).astype(
        np.uint32
    )


@lru_cache(maxsize=64)
def _tables(n: int, p: int):
    twid, inv_twid = negacyclic_twiddles(p, n)
    v = _variant(p)
    if v == "generic":
        tw = [(w << 64) % p for w in twid]
        itw = [(w << 64) % p for w in inv_twid]
        return {"twid": _split(tw), "inv_twid": _split(itw)}
    if v == "goldilocks":
        return {"twid": _split(list(twid)), "inv_twid": _split(list(inv_twid))}
    tws = [(w << 64) // p for w in twid]
    itws = [(w << 64) // p for w in inv_twid]
    return {
        "twid": _split(list(twid)),
        "twid_shoup": _split(tws),
        "inv_twid": _split(list(inv_twid)),
        "inv_twid_shoup": _split(itws),
    }


def _butterflies(p: int, direction: str):
    v = _variant(p)
    if v == "goldilocks":
        return (bf64.make_fwd_goldilocks() if direction == "fwd" else bf64.make_inv_goldilocks())
    if v == "shoup62":
        return (bf64.make_fwd_shoup62(p) if direction == "fwd" else bf64.make_inv_shoup62(p))
    if v == "shoup63":
        return (bf64.make_fwd_shoup63(p) if direction == "fwd" else bf64.make_inv_shoup63(p))
    ninv = mont_neginv64(p)
    return (
        bf64.make_fwd_generic64(p, ninv)
        if direction == "fwd"
        else bf64.make_inv_generic64(p, ninv)
    )


@partial(jax.jit, static_argnames=("p", "direction"))
def _transform(lo, hi, tw, *, p, direction):
    bf, lbf = _butterflies(p, direction)
    run = fwd_stages if direction == "fwd" else inv_stages
    out = run((lo, hi), tw, bf, lbf)
    return out[0], out[1]


@partial(jax.jit, static_argnames=("p", "kind", "c"))
def _pointwise(a_lo, a_hi, b_lo, b_hi, *, p, kind, c):
    a = (a_lo, a_hi)
    b = (b_lo, b_hi)
    if p == GOLDILOCKS_P:
        if kind == "mul_norm":
            r = gl_mul(gl_mul(a, b), const64_like(c))
        elif kind == "normalize":
            r = gl_mul(a, const64_like(c))
        else:  # mul_acc_term: lhs*rhs (b) added to acc later
            r = gl_mul(a, b)
        return r
    ninv = mont_neginv64(p)
    if kind == "mul_norm":
        r = mont_mul64(mont_mul64(a, b, p, ninv), const64_like(c), p, ninv)
    elif kind == "normalize":
        r = mont_mul64(a, const64_like(c), p, ninv)
    else:
        r = mont_mul64(mont_mul64(a, b, p, ninv), const64_like(c), p, ninv)
    return r


@partial(jax.jit, static_argnames=("p",))
def _add_mod64_arrays(a_lo, a_hi, b_lo, b_hi, *, p):
    if p == GOLDILOCKS_P:
        return gl_add((a_lo, a_hi), (b_lo, b_hi))
    return add_mod64((a_lo, a_hi), (b_lo, b_hi), p)


@dataclass(frozen=True)
class Plan:
    """Negacyclic NTT plan for Z/pZ, p < 2^64 prime, n a power of two."""

    n: int
    p: int
    _tbl: dict = field(repr=False, compare=False)

    @classmethod
    def try_new(cls, n: int, p: int) -> "Plan | None":
        try:
            return cls.new(n, p)
        except ValueError:
            return None

    @classmethod
    def new(cls, n: int, p: int) -> "Plan":
        if n < MIN_N or n & (n - 1) != 0:
            raise ValueError(f"n must be a power of two >= {MIN_N}, got {n}")
        if not (2 <= p < 1 << 64):
            raise ValueError(f"p must be a 64-bit modulus, got {p}")
        if not is_prime64(p):
            raise ValueError(f"p must be prime, got {p}")
        if (p - 1) % (2 * n) != 0:
            raise ValueError(f"no 2n-th root of unity: 2*{n} does not divide {p}-1")
        return cls(n=n, p=p, _tbl=_tables(n, p))

    @property
    def variant(self) -> str:
        return _variant(self.p)

    @property
    def n_inv(self) -> int:
        return pow(self.n, self.p - 2, self.p)

    # -- data marshalling ----------------------------------------------------

    def _to_limbs(self, x):
        """Returns (lo [B,n], hi [B,n], lead_shape, was_u64)."""
        if isinstance(x, np.ndarray) and x.dtype == np.uint64:
            limbs = np_u64_to_limbs(x)
            was_u64 = True
        else:
            limbs = jnp.asarray(x)
            if limbs.dtype != jnp.uint32 or limbs.shape[-1] != 2:
                raise TypeError(
                    "expected NumPy uint64 [..., n] or uint32 limb array [..., n, 2]"
                )
            was_u64 = False
        if limbs.shape[-2] != self.n:
            raise ValueError(f"transform axis must be n={self.n}, got {limbs.shape}")
        lead = limbs.shape[:-2]
        limbs = jnp.asarray(limbs).reshape(-1, self.n, 2)
        return limbs[..., 0], limbs[..., 1], lead, was_u64

    def _from_limbs(self, lo, hi, lead, was_u64):
        out = jnp.stack([lo, hi], axis=-1).reshape(*lead, self.n, 2)
        if was_u64:
            return limbs_to_np_u64(np.asarray(out))
        return out

    def _twid_parts(self, direction: str):
        t = self._tbl
        if self.variant in ("goldilocks", "generic"):
            w = t["twid"] if direction == "fwd" else t["inv_twid"]
            return tuple(jnp.asarray(a) for a in w)
        w = t["twid"] if direction == "fwd" else t["inv_twid"]
        ws = t["twid_shoup"] if direction == "fwd" else t["inv_twid_shoup"]
        return tuple(jnp.asarray(a) for a in (*w, *ws))

    # -- transforms ----------------------------------------------------------

    def fwd(self, x):
        lo, hi, lead, u64 = self._to_limbs(x)
        from .ops import ntt_dispatch

        out = ntt_dispatch.try_fwd64((lo, hi), self.n, self.p)
        if out is None:
            out = _transform(
                lo, hi, self._twid_parts("fwd"), p=self.p, direction="fwd"
            )
        return self._from_limbs(out[0], out[1], lead, u64)

    def inv(self, x):
        lo, hi, lead, u64 = self._to_limbs(x)
        from .ops import ntt_dispatch

        out = ntt_dispatch.try_inv64((lo, hi), self.n, self.p)
        if out is None:
            out = _transform(
                lo, hi, self._twid_parts("inv"), p=self.p, direction="inv"
            )
        return self._from_limbs(out[0], out[1], lead, u64)

    # -- elementwise ops (prime64.rs:944-1129) --------------------------------

    def mul_assign_normalize(self, lhs, rhs):
        a_lo, a_hi, lead, u64 = self._to_limbs(lhs)
        b_lo, b_hi, _, _ = self._to_limbs(rhs)
        if self.variant == "goldilocks":
            c = self.n_inv
        else:
            c = (self.n_inv << 128) % self.p
        lo, hi = _pointwise(a_lo, a_hi, b_lo, b_hi, p=self.p, kind="mul_norm", c=c)
        return self._from_limbs(lo, hi, lead, u64)

    def normalize(self, values):
        a_lo, a_hi, lead, u64 = self._to_limbs(values)
        if self.variant == "goldilocks":
            c = self.n_inv
        else:
            c = (self.n_inv << 64) % self.p
        lo, hi = _pointwise(a_lo, a_hi, a_lo, a_hi, p=self.p, kind="normalize", c=c)
        return self._from_limbs(lo, hi, lead, u64)

    def mul_accumulate(self, acc, lhs, rhs):
        a_lo, a_hi, lead, u64 = self._to_limbs(lhs)
        b_lo, b_hi, _, _ = self._to_limbs(rhs)
        c_lo, c_hi, _, _ = self._to_limbs(acc)
        if self.variant == "goldilocks":
            c = 1
        else:
            c = (1 << 128) % self.p
        t_lo, t_hi = _pointwise(a_lo, a_hi, b_lo, b_hi, p=self.p, kind="mul_acc", c=c)
        lo, hi = _add_mod64_arrays(c_lo, c_hi, t_lo, t_hi, p=self.p)
        return self._from_limbs(lo, hi, lead, u64)

    # -- convenience ---------------------------------------------------------

    def negacyclic_polymul(self, lhs, rhs):
        fl = self.fwd(lhs)
        fr = self.fwd(rhs)
        return self.inv(self.mul_assign_normalize(fl, fr))
