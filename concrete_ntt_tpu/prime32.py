"""32-bit prime negacyclic NTT plan (batch-first).

Capability parity with the reference's `prime32::Plan`
(src/prime32.rs:600-928): precomputed bit-reversed negacyclic twiddle tables
with Shoup companions, forward/inverse transforms, and the fused elementwise
ops. Differences by design (SURVEY.md §7):

  * **Batch-first, functional**: transforms take `[..., n]` uint32 arrays and
    return new arrays (the reference mutates a single `&mut [u32]` buffer).
    Everything is jit-compatible and vmappable.
  * **Regime dispatch by modulus size** matches prime32.rs:713-755 —
    p < 2^30 lazy-[0,4p), p < 2^31 lazy-[0,2p) — but the reference's
    p ≥ 2^31 Lemire-reciprocal engine is replaced by Montgomery-domain
    twiddles (the arithmetic stays in u32 lanes).
  * Elementwise ops use Montgomery products instead of the reference's
    Barrett ladders (prime32.rs:286-598); outputs are identical (canonical).

Outputs are bit-exact with the Rust reference: fwd = standard order →
bit-reversed NTT values in [0,p); inv = bit-reversed → standard order,
unnormalized (inv(fwd(x)) == n·x mod p; prime32.rs:704-761).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from .golden.ntt import negacyclic_twiddles
from .ops import butterflies32 as bf32
from .ops import ntt_dispatch
from .ops.engine import fwd_stages, inv_stages
from .ops.u32 import add_mod, mont_mul, mont_neginv
from .utils.prime import is_prime64

MIN_N = 2  # reference requires n >= 32 (SIMD width, prime32.rs:632-635); the
# vectorized engine has no such constraint, so we accept any power of two
# >= 2 (superset of the reference's domain).


def _variant(p: int) -> str:
    if p < 1 << 30:
        return "lt30"
    if p < 1 << 31:
        return "lt31"
    return "generic"


@lru_cache(maxsize=64)
def _tables(n: int, p: int):
    """Host-side twiddle tables (bit-reversed order, Shoup/Montgomery forms)."""
    twid, inv_twid = negacyclic_twiddles(p, n)
    tw = np.array(twid, dtype=np.uint32)
    itw = np.array(inv_twid, dtype=np.uint32)
    if _variant(p) == "generic":
        tw_m = np.array([(w << 32) % p for w in twid], dtype=np.uint32)
        itw_m = np.array([(w << 32) % p for w in inv_twid], dtype=np.uint32)
        return {"twid": tw_m, "inv_twid": itw_m}
    tws = np.array([(w << 32) // p for w in twid], dtype=np.uint32)
    itws = np.array([(w << 32) // p for w in inv_twid], dtype=np.uint32)
    return {"twid": tw, "twid_shoup": tws, "inv_twid": itw, "inv_twid_shoup": itws}


@partial(jax.jit, static_argnames=("p", "variant", "p_neginv"))
def _fwd_xla(x, twid, twid_shoup, *, p, variant, p_neginv):
    if variant == "lt30":
        bf, lbf = bf32.make_fwd_lt30(p)
        tp = (twid, twid_shoup)
    elif variant == "lt31":
        bf, lbf = bf32.make_fwd_lt31(p)
        tp = (twid, twid_shoup)
    else:
        bf, lbf = bf32.make_fwd_generic32(p, p_neginv)
        tp = (twid,)
    return fwd_stages((x,), tp, bf, lbf)[0]


@partial(jax.jit, static_argnames=("p", "variant", "p_neginv"))
def _inv_xla(x, inv_twid, inv_twid_shoup, *, p, variant, p_neginv):
    if variant == "lt30":
        bf, lbf = bf32.make_inv_lt30(p)
        tp = (inv_twid, inv_twid_shoup)
    elif variant == "lt31":
        bf, lbf = bf32.make_inv_lt31(p)
        tp = (inv_twid, inv_twid_shoup)
    else:
        bf, lbf = bf32.make_inv_generic32(p, p_neginv)
        tp = (inv_twid,)
    return inv_stages((x,), tp, bf, lbf)[0]


@partial(jax.jit, static_argnames=("p", "p_neginv", "c1"))
def _mul_normalize(lhs, rhs, *, p, p_neginv, c1):
    v = mont_mul(lhs, rhs, p, p_neginv)
    return mont_mul(v, jnp.uint32(c1), p, p_neginv)


@partial(jax.jit, static_argnames=("p", "p_neginv", "c2"))
def _normalize(x, *, p, p_neginv, c2):
    return mont_mul(x, jnp.uint32(c2), p, p_neginv)


@partial(jax.jit, static_argnames=("p", "p_neginv", "c3"))
def _mul_accumulate(acc, lhs, rhs, *, p, p_neginv, c3):
    v = mont_mul(lhs, rhs, p, p_neginv)
    t = mont_mul(v, jnp.uint32(c3), p, p_neginv)
    return add_mod(acc, t, p)


@dataclass(frozen=True)
class Plan:
    """Negacyclic NTT plan for Z/pZ, p < 2^32 prime, n a power of two.

    Mirrors `prime32::Plan::try_new(n, p)` (prime32.rs:630-686): requires
    p prime with a primitive 2n-th root of unity (2n | p-1).
    """

    n: int
    p: int
    _tbl: dict = field(repr=False, compare=False)

    # -- construction --------------------------------------------------------

    @classmethod
    def try_new(cls, n: int, p: int) -> "Plan | None":
        """Returns None for invalid (n, p) — parity with Plan::try_new."""
        try:
            return cls.new(n, p)
        except ValueError:
            return None

    @classmethod
    def new(cls, n: int, p: int) -> "Plan":
        if n < MIN_N or n & (n - 1) != 0:
            raise ValueError(f"n must be a power of two >= {MIN_N}, got {n}")
        if not (2 <= p < 1 << 32):
            raise ValueError(f"p must be a 32-bit modulus, got {p}")
        if not is_prime64(p):
            raise ValueError(f"p must be prime, got {p}")
        if (p - 1) % (2 * n) != 0:
            raise ValueError(f"no 2n-th root of unity: 2*{n} does not divide {p}-1")
        return cls(n=n, p=p, _tbl=_tables(n, p))

    # -- derived constants ---------------------------------------------------

    @property
    def variant(self) -> str:
        return _variant(self.p)

    @property
    def p_neginv(self) -> int:
        return mont_neginv(self.p)

    @property
    def n_inv(self) -> int:
        return pow(self.n, self.p - 2, self.p)

    # -- transforms ----------------------------------------------------------

    def _prep(self, x):
        x = jnp.asarray(x)
        if x.dtype != jnp.uint32:
            raise TypeError(f"expected uint32 coefficients, got {x.dtype}")
        if x.shape[-1] != self.n:
            raise ValueError(f"last axis must be n={self.n}, got {x.shape}")
        lead = x.shape[:-1]
        return x.reshape(-1, self.n), lead

    def fwd(self, x):
        """Forward negacyclic NTT: [..., n] standard order, values < p →
        bit-reversed NTT values in [0, p). (prime32.rs:704-755)"""
        xb, lead = self._prep(x)
        out = ntt_dispatch.fwd32(
            xb, self._tbl, p=self.p, variant=self.variant, p_neginv=self.p_neginv
        )
        return out.reshape(*lead, self.n)

    def inv(self, x):
        """Inverse negacyclic NTT: bit-reversed → standard order, UNnormalized:
        inv(fwd(x)) == n·x mod p. (prime32.rs:757-807)"""
        xb, lead = self._prep(x)
        out = ntt_dispatch.inv32(
            xb, self._tbl, p=self.p, variant=self.variant, p_neginv=self.p_neginv
        )
        return out.reshape(*lead, self.n)

    # -- elementwise ops (prime32.rs:812-927) --------------------------------

    def mul_assign_normalize(self, lhs, rhs):
        """lhs·rhs·n^{-1} mod p, elementwise, canonical."""
        c1 = (self.n_inv << 64) % self.p
        return _mul_normalize(
            jnp.asarray(lhs), jnp.asarray(rhs), p=self.p, p_neginv=self.p_neginv, c1=c1
        )

    def normalize(self, values):
        """values·n^{-1} mod p, elementwise."""
        c2 = (self.n_inv << 32) % self.p
        return _normalize(jnp.asarray(values), p=self.p, p_neginv=self.p_neginv, c2=c2)

    def mul_accumulate(self, acc, lhs, rhs):
        """acc + lhs·rhs mod p, elementwise."""
        c3 = (1 << 64) % self.p
        return _mul_accumulate(
            jnp.asarray(acc),
            jnp.asarray(lhs),
            jnp.asarray(rhs),
            p=self.p,
            p_neginv=self.p_neginv,
            c3=c3,
        )

    # -- convenience ---------------------------------------------------------

    def negacyclic_polymul(self, lhs, rhs):
        """Full negacyclic polynomial product (fwd → pointwise·n^{-1} → inv)."""
        fl = self.fwd(lhs)
        fr = self.fwd(rhs)
        return self.inv(self.mul_assign_normalize(fl, fr))
