"""Generic product-of-distinct-primes NTT plan (L4).

Capability parity with src/product.rs — the tfhe-rs integration layer: the
user supplies modulus = Π factors (distinct primes, 1s allowed and stripped,
sorted ascending; product.rs:158-186). Primes < 2^32 get prime32 plans, the
rest prime64 plans (product.rs:185-196). Unlike the native plans, inv output
is the canonical CRT value mod `modulus` (no signed truncation): the plan
implements arithmetic in Z/modulus·Z.

Modes (product.rs:10-20):
  * FwdMode "generic": residue = value % p_i.
  * FwdMode bounded(b): for the 2×u32-channel case with b < min(p0, p1),
    centered representation — values ≥ modulus/2 map to p_i − (modulus − v)
    (product.rs:303-322). Falls back to generic when inapplicable.
  * InvMode "replace" / "accumulate": overwrite, or add mod modulus into the
    provided standard buffer (the tfhe-rs PBS hot path, product.rs:444-445).

Inverse CRT uses the Knuth TAOCP 4.3.2 mixed-radix algorithm with pairwise
modular inverses p_i^{-1} mod p_j (runtime ext-Euclid in the reference,
product.rs:22-64; host-side pow() here), evaluated with vectorized
Shoup/Montgomery channel arithmetic instead of per-coefficient scalar loops.

Data layout: instead of the reference's flat `&mut [u64]` NTT-domain buffer
with a bytemuck-cast u32 region (product.rs:261-279), the NTT domain is an
`NttDomain` pytree: res32 [k32, ..., n] uint32 and res64 [k64, ..., n, 2]
uint32 limb pairs — jit/vmap/shard-friendly.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from . import prime32, prime64
from .ops.u32 import (
    add64,
    add_mod,
    add_mod64,
    const64_like,
    geq64,
    limbs_to_np_u64,
    mont_mul,
    mont_mul64,
    mont_neginv,
    mont_neginv64,
    mul64_u32,
    mullo64,
    np_u64_to_limbs,
    shoup_mul,
    sub64,
    sub_mod,
    sub_mod64,
    cond_sub64,
)
from .utils.prime import is_prime64

GENERIC = "generic"
REPLACE = "replace"
ACCUMULATE = "accumulate"


def bounded(bound: int):
    """FwdMode::Bounded(bound) equivalent."""
    return ("bounded", int(bound))


@jax.tree_util.register_pytree_node_class
@dataclass
class NttDomain:
    """Per-channel NTT-domain residues (the reference's flat buffer, as a pytree)."""

    res32: jnp.ndarray | None  # [k32, ..., n] uint32
    res64: jnp.ndarray | None  # [k64, ..., n, 2] uint32

    def tree_flatten(self):
        return (self.res32, self.res64), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def _mul_const_mod32(x, c: int, p: int):
    """x·c mod p, canonical, x < p, c const, any odd prime p < 2^32."""
    if p < 1 << 31:
        return shoup_mul(x, jnp.uint32(c), jnp.uint32((c << 32) // p), p)
    return mont_mul(x, jnp.uint32((c << 32) % p), p, mont_neginv(p))


def _mul_const_mod64(x_pair, c: int, p: int):
    """x·c mod p, canonical, limb pairs, any odd prime p < 2^64."""
    if p < 1 << 63:
        q = (c << 64) // p
        from .ops.u32 import shoup_mul_lazy64

        return cond_sub64(shoup_mul_lazy64(x_pair, const64_like(c), const64_like(q), p), p)
    return mont_mul64(x_pair, const64_like((c << 64) % p), p, mont_neginv64(p))


@dataclass(frozen=True)
class Plan:
    """NTT plan modulo a product of distinct primes (product.rs:139-229)."""

    n: int
    modulus: int
    factors: tuple
    plans32: tuple = field(repr=False)
    plans64: tuple = field(repr=False)

    @classmethod
    def try_new(cls, n: int, modulus: int, factors) -> "Plan | None":
        try:
            return cls.new(n, modulus, factors)
        except ValueError:
            return None

    @classmethod
    def new(cls, n: int, modulus: int, factors) -> "Plan":
        factors = [int(f) for f in factors]
        stripped = [f for f in factors if f != 1]
        if sorted(factors) != factors:
            raise ValueError("factors must be sorted in increasing order")
        if len(set(stripped)) != len(stripped):
            raise ValueError("factors must be distinct")
        prod = 1
        for f in stripped:
            prod *= f
        if prod != modulus:
            raise ValueError("product of factors must equal modulus")
        if not (1 <= modulus < 1 << 64):
            raise ValueError("modulus must fit in u64")
        for f in stripped:
            if not is_prime64(f):
                raise ValueError(f"factor {f} is not prime")
        p32 = tuple(f for f in stripped if f < 1 << 32)
        p64 = tuple(f for f in stripped if f >= 1 << 32)
        plans32 = tuple(prime32.Plan.new(n, p) for p in p32)
        plans64 = tuple(prime64.Plan.new(n, p) for p in p64)
        return cls(
            n=n, modulus=modulus, factors=tuple(stripped), plans32=plans32, plans64=plans64
        )

    # -- helpers ---------------------------------------------------------------

    @property
    def primes32(self):
        return tuple(pl.p for pl in self.plans32)

    @property
    def primes64(self):
        return tuple(pl.p for pl in self.plans64)

    def ntt_size(self) -> int:
        return self.n

    def _marshal(self, x):
        if isinstance(x, np.ndarray) and x.dtype == np.uint64:
            limbs = jnp.asarray(np_u64_to_limbs(x))
            fmt = "np64"
        else:
            limbs = jnp.asarray(x)
            if limbs.dtype != jnp.uint32 or limbs.shape[-1] != 2:
                raise TypeError("expected NumPy uint64 [..., n] or uint32 [..., n, 2]")
            fmt = "limbs"
        if limbs.shape[-2] != self.n:
            raise ValueError(f"transform axis must be n={self.n}")
        lead = limbs.shape[:-2]
        limbs = limbs.reshape(-1, self.n, 2)
        return limbs[..., 0], limbs[..., 1], lead, fmt

    # -- forward (product.rs:273-356) ------------------------------------------

    def fwd(self, standard, mode=GENERIC) -> NttDomain:
        lo, hi, lead, _ = self._marshal(standard)

        res32 = []
        use_bounded = (
            isinstance(mode, tuple)
            and mode[0] == "bounded"
            and len(self.plans32) == 2
            and len(self.plans64) == 0
            and mode[1] < min(self.primes32)
        )
        if not use_bounded and self.plans32 and not self.plans64:
            # fused split+fwd: the four-step forward consumes raw limbs
            # (residue reduction folded into the column matmul)
            from .ops import ntt_dispatch

            ntts = ntt_dispatch.try_fwd32_wide_all((lo, hi), self.plans32)
            if ntts is not None:
                out32 = jnp.stack(ntts, axis=0).reshape(
                    len(ntts), *lead, self.n
                )
                return NttDomain(out32, None)
        if use_bounded:
            # centered representation (product.rs:303-322): values are small
            # signed quantities mod `modulus`; lift negatives to p_i - (m - v).
            half = const64_like(self.modulus // 2)
            positive = ~geq64((lo, hi), half)  # standard < modulus/2
            comp_lo, comp_hi = sub64(const64_like(self.modulus), (lo, hi))
            for pl in self.plans32:
                pos_res = lo  # bound < p_i so the value itself is the residue
                neg_res = jnp.uint32(pl.p) - comp_lo
                res32.append(jnp.where(positive, pos_res, neg_res))
            # fused path: the centering is one cheap elementwise stage; the
            # per-channel transforms still ride the four-step engine
            from .ops import ntt_dispatch

            ntts = ntt_dispatch.try_fwd32_perchannel_all(
                jnp.stack(res32, axis=0), self.plans32
            )
            if ntts is not None:
                out32 = jnp.stack(ntts, axis=0).reshape(
                    len(ntts), *lead, self.n
                )
                return NttDomain(out32, None)
        else:
            for pl in self.plans32:
                p = pl.p
                ninv = mont_neginv(p)
                # value mod p = lo·(2^32 mod p)·2^-32 + hi·(2^64 mod p)·2^-32
                r = add_mod(
                    mont_mul(lo, jnp.uint32((1 << 32) % p), p, ninv),
                    mont_mul(hi, jnp.uint32((1 << 64) % p), p, ninv),
                    p,
                )
                res32.append(r)

        res64 = []
        for pl in self.plans64:
            p = pl.p
            # value mod p via Montgomery: value·(2^64 mod p)·2^-64 = value mod p
            r = mont_mul64((lo, hi), const64_like((1 << 64) % p), p, mont_neginv64(p))
            res64.append(r)

        out32 = None
        if res32:
            ntts = [pl.fwd(r) for pl, r in zip(self.plans32, res32)]
            out32 = jnp.stack(ntts, axis=0).reshape(len(res32), *lead, self.n)
        out64 = None
        if res64:
            ntts = []
            for pl, (rl, rh) in zip(self.plans64, res64):
                ntts.append(pl.fwd(jnp.stack([rl, rh], axis=-1)))
            out64 = jnp.stack(ntts, axis=0).reshape(len(res64), *lead, self.n, 2)
        return NttDomain(out32, out64)

    # -- inverse (product.rs:360-879) -------------------------------------------

    def inv(self, ntt: NttDomain, mode=REPLACE, standard=None, out_format=None):
        k32 = len(self.plans32)
        k64 = len(self.plans64)
        lead = None
        res32 = []
        if k32:
            arr = jnp.asarray(ntt.res32)
            lead = arr.shape[1:-1]
            arr = arr.reshape(k32, -1, self.n)
            from .ops import ntt_dispatch

            res32 = ntt_dispatch.try_inv32_all(arr, self.plans32)
            if res32 is None:
                res32 = [self.plans32[i].inv(arr[i]) for i in range(k32)]
        res64 = []
        if k64:
            arr = jnp.asarray(ntt.res64)
            lead = arr.shape[1:-2]
            arr = arr.reshape(k64, -1, self.n, 2)
            for i in range(k64):
                out = self.plans64[i].inv(arr[i])
                res64.append((out[..., 0], out[..., 1]))

        if lead is None:  # no channels at all: value is 0 (product.rs:386-393)
            raise ValueError("plan has no channels")

        acc = self._mixed_radix_lift(res32, res64)

        if mode == ACCUMULATE:
            if standard is None:
                raise ValueError("accumulate mode requires the standard buffer")
            s_lo, s_hi, lead2, fmt2 = self._marshal(standard)
            acc = add_mod64((s_lo, s_hi), acc, self.modulus)
            lead = lead2
            out_format = out_format or fmt2

        out = jnp.stack(acc, axis=-1).reshape(*lead, self.n, 2)
        if (out_format or "np64") == "np64":
            return limbs_to_np_u64(np.asarray(out))
        return out

    def _mixed_radix_lift(self, res32, res64):
        """Knuth 4.3.2 mixed-radix digits with pairwise inverses
        (product.rs:791-879) + wrapping-u64 Horner accumulation: standard-
        order channel residues -> canonical value mod `modulus` (limb pair).
        Channel order = u32 channels then u64 channels; factors are sorted
        ascending, so every earlier digit v_i < p_i < p_j is already reduced
        mod p_j (the reference relies on the same order)."""
        digits32 = []
        for j, pj in enumerate(self.primes32):
            x = res32[j]
            for i, vi in enumerate(digits32):
                pi = self.primes32[i]
                inv_c = pow(pi % pj, pj - 2, pj)
                x = _mul_const_mod32(sub_mod(x, vi, pj), inv_c, pj)
            digits32.append(x)
        digits64 = []
        for j, pj in enumerate(self.primes64):
            x = res64[j]
            for i, vi in enumerate(digits32):
                pi = self.primes32[i]
                inv_c = pow(pi % pj, pj - 2, pj)
                vi64 = (vi, jnp.zeros_like(vi))
                x = _mul_const_mod64(sub_mod64(x, vi64, pj), inv_c, pj)
            for i, vi in enumerate(digits64):
                pi = self.primes64[i]
                inv_c = pow(pi % pj, pj - 2, pj)
                x = _mul_const_mod64(sub_mod64(x, vi, pj), inv_c, pj)
            digits64.append(x)

        # Horner accumulation, wrapping u64 (product.rs:864-874): acc built
        # from the most-significant (u64) digits down to the u32 digits.
        z = jnp.zeros_like(res32[0] if res32 else res64[0][0])
        acc = (z, z)
        for v, p in zip(reversed(digits64), reversed(self.primes64)):
            acc = add64(mullo64(acc, const64_like(p)), v)
        for v, p in zip(reversed(digits32), reversed(self.primes32)):
            acc = add64(mul64_u32(acc, jnp.uint32(p)), (v, jnp.zeros_like(v)))
        return acc

    # -- elementwise (channel-wise delegation, product.rs:885-966) --------------

    def mul_assign_normalize(self, lhs: NttDomain, rhs: NttDomain) -> NttDomain:
        r32 = None
        if len(self.plans32):
            r32 = jnp.stack(
                [
                    pl.mul_assign_normalize(lhs.res32[i], rhs.res32[i])
                    for i, pl in enumerate(self.plans32)
                ],
                axis=0,
            )
        r64 = None
        if len(self.plans64):
            r64 = jnp.stack(
                [
                    pl.mul_assign_normalize(lhs.res64[i], rhs.res64[i])
                    for i, pl in enumerate(self.plans64)
                ],
                axis=0,
            )
        return NttDomain(r32, r64)

    def normalize(self, values: NttDomain) -> NttDomain:
        r32 = None
        if len(self.plans32):
            r32 = jnp.stack(
                [pl.normalize(values.res32[i]) for i, pl in enumerate(self.plans32)], axis=0
            )
        r64 = None
        if len(self.plans64):
            r64 = jnp.stack(
                [pl.normalize(values.res64[i]) for i, pl in enumerate(self.plans64)], axis=0
            )
        return NttDomain(r32, r64)

    def mul_accumulate(self, acc: NttDomain, lhs: NttDomain, rhs: NttDomain) -> NttDomain:
        r32 = None
        if len(self.plans32):
            r32 = jnp.stack(
                [
                    pl.mul_accumulate(acc.res32[i], lhs.res32[i], rhs.res32[i])
                    for i, pl in enumerate(self.plans32)
                ],
                axis=0,
            )
        r64 = None
        if len(self.plans64):
            r64 = jnp.stack(
                [
                    pl.mul_accumulate(acc.res64[i], lhs.res64[i], rhs.res64[i])
                    for i, pl in enumerate(self.plans64)
                ],
                axis=0,
            )
        return NttDomain(r32, r64)

    # -- convenience + the tfhe-rs hot path --------------------------------------

    def negacyclic_polymul(self, lhs, rhs, mode=REPLACE, standard=None,
                           out_format=None, lhs_fwd_mode=GENERIC):
        """End-to-end product mod `modulus`; mode=ACCUMULATE adds into
        `standard` (the tfhe-rs NTT-PBS hot loop, product.rs:444-445);
        lhs_fwd_mode=bounded(b) applies the centered forward representation
        to lhs (the PBS accumulator operand, product.rs:303-322).

        u32-only channel sets ride the fused four-step fast path: residue
        split folded into the forward's column matmul (Bounded centering is
        one extra cheap elementwise stage), bare Montgomery pointwise +
        scaled inverse, then the CRT lift (+ accumulate) as one fused XLA
        elementwise stage — the device shape of the reference's
        hand-written AVX512 lift+accumulate kernel (product.rs:419-789).
        Falls back to the generic channel-wise path (bit-identical) when
        the four-step engine does not serve the channels."""
        out = self._try_polymul_fused(lhs, rhs, mode, standard, out_format,
                                      lhs_fwd_mode)
        if out is not None:
            return out
        # Honor the marshaled input format on the generic path too, so the
        # return type matches the fused path for the same call (and traced
        # uint32-limb inputs stay jittable instead of hitting np.asarray).
        if out_format is None:
            out_format = (
                "np64"
                if isinstance(lhs, np.ndarray) and lhs.dtype == np.uint64
                else "limbs"
            )
        fl = self.fwd(lhs, lhs_fwd_mode)
        fr = self.fwd(rhs)
        return self.inv(
            self.mul_assign_normalize(fl, fr), mode, standard, out_format
        )

    def _try_polymul_fused(self, lhs, rhs, mode, standard, out_format,
                           lhs_fwd_mode=GENERIC):
        if self.plans64 or not self.plans32:
            return None
        from .ops import ntt_dispatch

        lo, hi, lead, fmt = self._marshal(lhs)
        rlo, rhi, _, _ = self._marshal(rhs)
        use_bounded = (
            isinstance(lhs_fwd_mode, tuple)
            and lhs_fwd_mode[0] == "bounded"
            and len(self.plans32) == 2
            and lhs_fwd_mode[1] < min(self.primes32)
        )
        if use_bounded:
            half = const64_like(self.modulus // 2)
            positive = ~geq64((lo, hi), half)
            comp_lo, _ = sub64(const64_like(self.modulus), (lo, hi))
            res = jnp.stack(
                [
                    jnp.where(positive, lo, jnp.uint32(pl.p) - comp_lo)
                    for pl in self.plans32
                ],
                axis=0,
            )
            fl = ntt_dispatch.try_fwd32_perchannel_all(res, self.plans32)
        else:
            fl = ntt_dispatch.try_fwd32_wide_all((lo, hi), self.plans32)
        if fl is None:
            return None
        fr = ntt_dispatch.try_fwd32_wide_all((rlo, rhi), self.plans32)
        res = ntt_dispatch.try_pointwise_inv32_all(
            jnp.stack(fl, axis=0), jnp.stack(fr, axis=0), self.plans32
        )
        if res is None:
            return None
        acc = self._mixed_radix_lift(list(res), [])
        if mode == ACCUMULATE:
            if standard is None:
                raise ValueError("accumulate mode requires the standard buffer")
            s_lo, s_hi, lead, fmt2 = self._marshal(standard)
            acc = add_mod64((s_lo, s_hi), acc, self.modulus)
            fmt = fmt2
        out = jnp.stack(acc, axis=-1).reshape(*lead, self.n, 2)
        if (out_format or fmt or "np64") == "np64":
            return limbs_to_np_u64(np.asarray(out))
        return out


