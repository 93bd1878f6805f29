"""Shared machinery for the native (CRT wrapping-arithmetic) NTT plans.

The reference implements six nearly-identical plan families
(native{32,64,128}.rs, native_binary{32,64,128}.rs), each in two tiers:
Plan32 (k× 30-bit prime32 channels) and Plan52 (k× 50-bit prime64 channels,
AVX512-IFMA only). Here one parameterized base covers them all; the concrete
modules configure primes, channel counts, split/reconstruct kernels, and the
value width.

Device data conventions:
  * u32-width values: uint32 arrays [..., n]
  * u64-width values: NumPy uint64 [..., n] (host convenience) or uint32 limb
    arrays [..., n, 2] (device-native)
  * u128-width values: uint32 limb arrays [..., n, 4] (device-native) or
    lists of Python ints (host convenience)
  * Plan32 NTT-domain residues: uint32 [k, ..., n] (channel-leading — the
    natural axis to shard across chips, SURVEY.md §2.7)
  * Plan52 NTT-domain residues: uint32 [k, ..., n, 2]
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax.numpy as jnp
import numpy as np

from . import prime32, prime64
from .ops import crt as crt_ops
from .ops.u32 import limbs_to_np_u64, limbs_to_py_u128, np_u128_to_limbs, np_u64_to_limbs


def _marshal_in(x, width: int, n: int):
    """→ (limb arrays tuple, lead shape, original format tag)."""
    if width == 32:
        arr = jnp.asarray(x)
        if arr.dtype != jnp.uint32 or arr.shape[-1] != n:
            raise TypeError(f"expected uint32 [..., {n}] input")
        lead = arr.shape[:-1]
        a = arr.reshape(-1, n)
        return (a,), lead, "u32"
    nlimbs = width // 32
    if (
        isinstance(x, (list, tuple))
        and len(x) == nlimbs
        and all(hasattr(e, "shape") and getattr(e, "ndim", 0) >= 1 for e in x)
    ):
        # planar limb tuple (lo, hi[, ...]) — the PERFORMANCE format:
        # planar tuples are exactly what the engines consume, so
        # marshalling is a no-op, where the interleaved [..., n, nlimbs]
        # array costs two de-interleaves and one re-interleave per step.
        arrs = tuple(jnp.asarray(e) for e in x)
        if any(a.dtype != jnp.uint32 or a.shape != arrs[0].shape for a in arrs):
            raise TypeError(f"planar limbs must be {nlimbs} same-shape uint32 arrays")
        if arrs[0].shape[-1] != n:
            raise ValueError(f"transform axis must be n={n}, got {arrs[0].shape}")
        lead = arrs[0].shape[:-1]
        return tuple(a.reshape(-1, n) for a in arrs), lead, "planar"
    if isinstance(x, np.ndarray) and x.dtype == np.uint64 and width == 64:
        limbs = jnp.asarray(np_u64_to_limbs(x))
        fmt = "np64"
    elif isinstance(x, (list, tuple)) and width == 128:
        limbs = jnp.asarray(np_u128_to_limbs(x))
        fmt = "py128"
    else:
        limbs = jnp.asarray(x)
        if limbs.dtype != jnp.uint32 or limbs.shape[-1] != nlimbs:
            raise TypeError(f"expected uint32 limb array [..., {n}, {nlimbs}]")
        fmt = "limbs"
    if limbs.shape[-2] != n:
        raise ValueError(f"transform axis must be n={n}, got {limbs.shape}")
    lead = limbs.shape[:-2]
    limbs = limbs.reshape(-1, n, nlimbs)
    return tuple(limbs[..., i] for i in range(nlimbs)), lead, fmt


def _marshal_out(parts: tuple, lead, fmt: str, n: int):
    if fmt == "u32":
        return parts[0].reshape(*lead, n)
    if fmt == "planar":
        return tuple(p.reshape(*lead, n) for p in parts)
    out = jnp.stack(parts, axis=-1).reshape(*lead, n, len(parts))
    if fmt == "np64":
        return limbs_to_np_u64(np.asarray(out))
    if fmt == "py128":
        return limbs_to_py_u128(np.asarray(out))
    return out


@dataclass(frozen=True)
class NativePlanBase:
    """k-channel CRT plan: split → k prime NTTs → pointwise → k inverse NTTs
    → signed wrapping reconstruction (reference call stack SURVEY.md §3.3)."""

    n: int
    width: int  # 32 / 64 / 128: the wrapping arithmetic width
    primes: tuple
    plans: tuple = field(repr=False)  # underlying prime32/prime64 Plans
    tier: str = "plan32"  # "plan32" (u32 channels) | "plan52" (u64 channels)

    # -- residue split -------------------------------------------------------

    def _split(self, parts):
        if self.tier == "plan32":
            if self.width == 32:
                return crt_ops.split_u32(parts[0], self.primes)
            if self.width == 64:
                return crt_ops.split_u64(parts[0], parts[1], self.primes)
            return crt_ops.split_u128(parts, self.primes)
        # plan52 tier: u64-limb-pair residues mod ~50-bit primes
        if self.width == 32:
            z = jnp.zeros_like(parts[0])
            return [(parts[0], z) for _ in self.primes]  # x < 2^32 < p
        if self.width == 64:
            return crt_ops.split_u64_to_p50(parts[0], parts[1], self.primes)
        raise NotImplementedError("no plan52 tier at width 128 (parity w/ reference)")

    def _split_binary(self, parts):
        """{0,1} operands need no reduction (fwd_binary,
        native_binary64.rs:372-389): the residue is the value itself."""
        lo = parts[0]
        if self.tier == "plan32":
            return [lo for _ in self.primes]
        z = jnp.zeros_like(lo)
        return [(lo, z) for _ in self.primes]

    # -- residue stacking ----------------------------------------------------

    def _stack(self, residues):
        if self.tier == "plan32":
            return jnp.stack(residues, axis=0)
        return jnp.stack(
            [jnp.stack(r, axis=-1) for r in residues], axis=0
        )  # [k, B, n, 2]

    def _unstack(self, stacked):
        k = len(self.primes)
        if self.tier == "plan32":
            return [stacked[i] for i in range(k)]
        return [(stacked[i, ..., 0], stacked[i, ..., 1]) for i in range(k)]

    def _residues_in(self, ntt):
        """Validate/flatten user-provided NTT-domain residues."""
        arr = jnp.asarray(ntt)
        exp_trail = (self.n,) if self.tier == "plan32" else (self.n, 2)
        k = len(self.primes)
        if arr.shape[0] != k or arr.shape[-len(exp_trail):] != exp_trail:
            raise ValueError(
                f"expected residues [k={k}, ..., {exp_trail}], got {arr.shape}"
            )
        lead = arr.shape[1 : -len(exp_trail)]
        arr = arr.reshape(k, -1, *exp_trail)
        return arr, lead

    # -- transforms ----------------------------------------------------------

    def _plan_io(self, plan, r, direction):
        """Run one channel's prime NTT on residues in device layout."""
        if self.tier == "plan32":
            return plan.fwd(r) if direction == "fwd" else plan.inv(r)
        limbs = jnp.stack(r, axis=-1)
        out = plan.fwd(limbs) if direction == "fwd" else plan.inv(limbs)
        return (out[..., 0], out[..., 1])

    def fwd(self, x):
        """value array [..., n] → NTT-domain residues [k, ..., n(, 2)]."""
        parts, lead, _ = _marshal_in(x, self.width, self.n)
        residues = None
        from .ops import ntt_dispatch

        if self.tier == "plan32":
            residues = ntt_dispatch.try_fwd32_wide_all(parts, self.plans)
        else:
            residues = ntt_dispatch.try_fwd64_wide_all(parts, self.plans)
        if residues is None:
            residues = self._split(parts)
            residues = [
                self._plan_io(plan, r, "fwd") for plan, r in zip(self.plans, residues)
            ]
        out = self._stack(residues)
        trail = out.shape[2:]
        return out.reshape(len(self.primes), *lead, *trail)

    def fwd_binary(self, x):
        """Binary-operand forward: skips the modular reduction."""
        parts, lead, _ = _marshal_in(x, self.width, self.n)
        residues = self._split_binary(parts)
        residues = [
            self._plan_io(plan, r, "fwd") for plan, r in zip(self.plans, residues)
        ]
        out = self._stack(residues)
        trail = out.shape[2:]
        return out.reshape(len(self.primes), *lead, *trail)

    def inv(self, ntt, out_format: str | None = None):
        """NTT-domain residues → wrapping value array (signed CRT lift)."""
        arr, lead = self._residues_in(ntt)
        residues = self._unstack(arr)
        residues = [
            self._plan_io(plan, r, "inv") for plan, r in zip(self.plans, residues)
        ]
        value_parts = self._reconstruct(residues)
        if not isinstance(value_parts, tuple):
            value_parts = (value_parts,)
        fmt = out_format or ("u32" if self.width == 32 else "limbs")
        return _marshal_out(value_parts, lead, fmt, self.n)

    def _reconstruct(self, residues):
        raise NotImplementedError

    # -- end-to-end product (negacyclic_polymul, native64.rs:1042-1069) -------

    def _pointwise_inv(self, fl_arr, fr_arr):
        """Per-channel pointwise·n^-1 then inverse NTT → standard-order
        residue list (fused on the four-step engine: bare Montgomery pointwise with
        the 2^32 and n^-1 factors folded into the inverse column matrix)."""
        from .ops import ntt_dispatch

        if self.tier == "plan32":
            fused = ntt_dispatch.try_pointwise_inv32_all(fl_arr, fr_arr, self.plans)
        else:
            fused = ntt_dispatch.try_pointwise_inv64_all(fl_arr, fr_arr, self.plans)
        if fused is not None:
            return fused
        residues = []
        for i, plan in enumerate(self.plans):
            if self.tier == "plan32":
                prod = plan.mul_assign_normalize(fl_arr[i], fr_arr[i])
                residues.append(self._plan_io(plan, prod, "inv"))
            else:
                prod = plan.mul_assign_normalize(fl_arr[i], fr_arr[i])
                residues.append(
                    self._plan_io(plan, (prod[..., 0], prod[..., 1]), "inv")
                )
        return residues

    def negacyclic_polymul(self, lhs, rhs, rhs_binary: bool = False):
        out_fmt = self._fmt_of(lhs)
        _, lead0, _ = _marshal_in(lhs, self.width, self.n)
        fl = self.fwd(lhs)
        fr = self.fwd_binary(rhs) if rhs_binary else self.fwd(rhs)
        fl_arr, _ = self._residues_in(fl)
        fr_arr, _ = self._residues_in(fr)
        residues = self._pointwise_inv(fl_arr, fr_arr)
        value_parts = self._reconstruct(residues)
        if not isinstance(value_parts, tuple):
            value_parts = (value_parts,)
        out = _marshal_out(value_parts, lead0, out_fmt, self.n)
        if out_fmt in ("u32", "np64"):
            return out.reshape(*lead0, self.n)
        if out_fmt == "limbs":
            return out.reshape(*lead0, self.n, self.width // 32)
        return out  # py128: flat list (host convenience; use limb form for batches)

    def _fmt_of(self, x):
        if self.width == 32:
            return "u32"
        if isinstance(x, np.ndarray) and x.dtype == np.uint64:
            return "np64"
        if isinstance(x, (list, tuple)):
            if len(x) == self.width // 32 and all(
                hasattr(e, "shape") and getattr(e, "ndim", 0) >= 1 for e in x
            ):
                return "planar"
            return "py128"
        return "limbs"

    # -- accessors (parity with ntt_0()..ntt_k(), native64.rs:950-969) --------

    def ntt(self, i: int):
        return self.plans[i]


def build_plans32(n: int, primes) -> tuple:
    plans = tuple(prime32.Plan.try_new(n, p) for p in primes)
    if any(p is None for p in plans):
        return ()
    return plans


def build_plans52(n: int, primes) -> tuple:
    plans = tuple(prime64.Plan.try_new(n, p) for p in primes)
    if any(p is None for p in plans):
        return ()
    return plans
