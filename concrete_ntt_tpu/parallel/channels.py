"""CRT residue channels sharded across chips (the north-star multi-chip
configuration, BASELINE.json configs[4]).

The k CRT channels of a native plan are independent between the residue
split and the reconstruction (reference anchor: the 10 channels of
/root/reference/src/native128.rs:123-137; call-stack seam SURVEY.md §3.3).
That independence is the natural cross-chip sharding seam: this module puts
the stacked residue array [k, B, n1, n2] on a device mesh with

  * k  sharded over a `ch` mesh axis  (channel parallelism — the EP analogue),
  * B  sharded over a `dp` mesh axis  (data parallelism), and
  * the four-step transform factor sharded over an `sp` mesh axis with ONE
    `jax.lax.all_to_all` per transform pass pair (sequence parallelism,
    parallel/fourstep_mxu.py's decomposition),

all inside ONE shard_map: split -> fwd -> pointwise -> inv run entirely on
local shards; the only cross-channel communication is the all-gather that
feeds the CRT reconstruction at the very end.

Because different channels carry different primes, each rank's local section
receives ITS channels' tables as sharded array operands and computes with
*traced* per-channel scalars (ops/traced_scalar.py), so results are
bit-identical to the single-device engines (asserted by tests on the
virtual CPU mesh and on the card).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from .._native_common import _marshal_in, _marshal_out
from ..ops.traced_scalar import (
    _digit8,
    _dot8,
    _multi_tables,
    _neginv_vec,
    _sc_combine,
    _sc_epilogue_canonical,
    _sc_epilogue_scaled_lazy,
)
from ..ops.u32 import mulhi_u32, mulwide_u32

_SC64_FIELDS = ("p", "c64", "c64_shoup", "p_neginv", "barrett", "two_p")


def _sc_mont(a, b, p, p_neginv):
    """Montgomery product a*b*2^-32 mod p with traced scalars (u32.mont_mul
    with array scalars; explicit overflow tracking). Any-u32 representatives
    in, any-u32 representative out; the result is canonical [0, p) only when
    the true REDC quotient t < 2p — guaranteed when both inputs are < p
    (current call sites feed canonical inputs)."""
    lo, hi = mulwide_u32(a, b)
    m = lo * p_neginv
    mp_hi = mulhi_u32(m, p)
    carry = (lo != 0).astype(jnp.uint32)
    t = hi + mp_hi
    ovf = t < hi
    s = t + carry
    ovf = ovf | (s < t)
    return jnp.where(ovf, s - p, jnp.where(s >= p, s - p, s))


class ChannelShardedNative:
    """Multi-chip negacyclic polymul for a plan32-tier native plan.

    Mesh axes: `ch_axis` shards the CRT channels (required), `batch_axis`
    shards the batch (optional), `sp_axis` shards the four-step transform
    with one all-to-all per pass pair (optional). Axes not present in the
    mesh are treated as unsharded.

    I/O: the same value formats as the underlying plan (NumPy uint64
    [B, n], uint32 limb arrays [B, n, nlimbs], or uint32 [B, n]);
    `negacyclic_polymul` returns the wrapping product in the input format.
    """

    def __init__(self, plan, mesh, ch_axis: str = "ch", batch_axis=None,
                 sp_axis=None):
        if plan.tier != "plan32":
            raise ValueError("channel sharding requires a plan32-tier plan")
        n, primes = plan.n, tuple(plan.primes)
        k = len(primes)
        if not all((1 << 29) < p < (1 << 30) for p in primes):
            raise ValueError("channel sharding needs 30-bit table primes")
        cs = mesh.shape[ch_axis]
        if k % cs:
            raise ValueError(f"{k} channels must divide over ch={cs}")
        self.plan, self.mesh = plan, mesh
        self.ch, self.dp, self.sp = ch_axis, batch_axis, sp_axis
        s = mesh.shape[sp_axis] if sp_axis else 1
        self._s = s

        log2n = n.bit_length() - 1
        n1 = 1 << (log2n // 2)
        n2 = n // n1
        self.n1, self.n2 = n1, n2
        if n2 % s or n1 % s:
            raise ValueError(f"sp={s} must divide n1={n1} and n2={n2}")

        self.n_limbs = plan.width // 32
        scales = tuple(
            pow(n, p - 2, p) * pow(2, 32, p) % p for p in primes
        )  # n^-1 * 2^32: normalization + Montgomery compensation
        tabs = _multi_tables(n, primes, self.n_limbs, scales)
        scal6 = np.zeros((k, 6), dtype=np.uint32)
        scal6[:, :5] = tabs["scalars"]
        scal6[:, 5] = _neginv_vec(primes)

        ch = ch_axis
        put = lambda a, spec: jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec))
        f = tabs["fwd"]
        i = tabs["inv"]
        self._consts = (
            put(scal6, P(ch, None)),
            # fwd: wide column planes (contract n1), row planes (contract n2)
            put(f[0], P(ch, None, None)),
            put(f[1], P(ch, None, None)),
            put(f[2], P(ch, None, None)),
            put(f[3], P(ch, None, None)),
            *[put(d, P(ch, sp_axis, None)) for d in f[4]],  # d [k, n2, n1]
            # inv: row planes (contract n2), scaled column planes (contract n1)
            put(i[0], P(ch, None, None)),
            put(i[1], P(ch, None, None)),
            put(i[2], P(ch, None, None)),
            put(i[3], P(ch, None, None)),
            *[put(e, P(ch, sp_axis, None)) for e in i[4]],  # e [k, n1, n2]
        )
        self._val_spec = P(batch_axis, None, sp_axis)  # [B, n1, n2] per limb
        self._build()

    # -- local (per-rank) sections ------------------------------------------

    def _fwd_local(self, parts, scal, p1, c1, p2, c2, dg):
        """parts: n_limbs × [b, n1, n2/s] value shards -> NTT domain
        [k_loc, b, n1/s, n2] (bit-reversed when flattened)."""
        k_loc = scal.shape[0]
        v = tuple(jnp.swapaxes(a, 1, 2) for a in parts)  # [b, n2/s, n1]
        xd = (
            jnp.concatenate([_digit8(a) for a in v], axis=-1)
            if len(v) > 1
            else _digit8(v[0])
        )
        ys = []
        for c in range(k_loc):
            sc = tuple(scal[c, j] for j in range(5))
            lo, hi = _sc_combine(_dot8(xd, p1[c]), c1[c], self.n1)
            ys.append(
                _sc_epilogue_scaled_lazy(lo, hi, tuple(d[c][None] for d in dg), sc)
            )
        y = jnp.stack(ys, axis=0)  # [k_loc, b, n2/s, n1] lazy reps
        if self.sp:
            y = jax.lax.all_to_all(
                y, self.sp, split_axis=3, concat_axis=2, tiled=True
            )  # -> [k_loc, b, n2, n1/s]
        y = jnp.swapaxes(y, 2, 3)  # [k_loc, b, n1/s, n2]
        outs = []
        for c in range(k_loc):
            sc = tuple(scal[c, j] for j in range(5))
            lo, hi = _sc_combine(_dot8(_digit8(y[c]), p2[c]), c2[c], self.n2)
            outs.append(_sc_epilogue_canonical(lo, hi, sc))
        return jnp.stack(outs, axis=0)

    def _inv_local(self, x, scal, g1, gc1, a2, ac2, eg):
        """x: [k_loc, b, n1/s, n2] any-u32 NTT-domain reps -> standard-order
        residues [k_loc, b, n1, n2/s] (scaled by n^-1*2^32 via the folded
        inverse column planes)."""
        k_loc = scal.shape[0]
        ys = []
        for c in range(k_loc):
            sc = tuple(scal[c, j] for j in range(5))
            lo, hi = _sc_combine(_dot8(_digit8(x[c]), g1[c]), gc1[c], self.n2)
            ys.append(
                _sc_epilogue_scaled_lazy(lo, hi, tuple(e[c][None] for e in eg), sc)
            )
        y = jnp.stack(ys, axis=0)  # [k_loc, b, n1/s, n2]
        if self.sp:
            y = jax.lax.all_to_all(
                y, self.sp, split_axis=3, concat_axis=2, tiled=True
            )  # -> [k_loc, b, n1, n2/s]
        y = jnp.swapaxes(y, 2, 3)  # [k_loc, b, n2/s, n1]
        outs = []
        for c in range(k_loc):
            sc = tuple(scal[c, j] for j in range(5))
            lo, hi = _sc_combine(_dot8(_digit8(y[c]), a2[c]), ac2[c], self.n1)
            outs.append(_sc_epilogue_canonical(lo, hi, sc))
        return jnp.swapaxes(jnp.stack(outs, axis=0), 2, 3)  # [k_loc, b, n1, n2/s]

    def _polymul_local(self, *args):
        nl = self.n_limbs
        parts_l = args[:nl]
        parts_r = args[nl : 2 * nl]
        scal = args[2 * nl]
        rest = args[2 * nl + 1 :]
        p1, c1, p2, c2 = rest[:4]
        dg = rest[4:8]
        g1, gc1, a2, ac2 = rest[8:12]
        eg = rest[12:16]
        fl = self._fwd_local(parts_l, scal, p1, c1, p2, c2, dg)
        fr = self._fwd_local(parts_r, scal, p1, c1, p2, c2, dg)
        pv = scal[:, 0][:, None, None, None]
        nv = scal[:, 5][:, None, None, None]
        prod = _sc_mont(fl, fr, pv, nv)
        return self._inv_local(prod, scal, g1, gc1, a2, ac2, eg)

    def _build(self):
        mesh, ch, dp, sp = self.mesh, self.ch, self.dp, self.sp
        nl = self.n_limbs
        const_specs = (
            P(ch, None),
            *[P(ch, None, None)] * 4,
            *[P(ch, sp, None)] * 4,
            *[P(ch, None, None)] * 4,
            *[P(ch, sp, None)] * 4,
        )
        self._polymul_sharded = jax.jit(
            shard_map(
                self._polymul_local,
                mesh=mesh,
                in_specs=(*[self._val_spec] * (2 * nl), *const_specs),
                out_specs=P(ch, dp, None, sp),
                check_vma=False,
            )
        )

    # -- public API ----------------------------------------------------------

    def _to_dist(self, x):
        parts, lead, fmt = _marshal_in(x, self.plan.width, self.plan.n)
        b = parts[0].shape[0]
        put = lambda a: jax.device_put(
            a.reshape(b, self.n1, self.n2), NamedSharding(self.mesh, self._val_spec)
        )
        return tuple(put(a) for a in parts), lead, fmt

    def negacyclic_polymul(self, lhs, rhs):
        """End-to-end wrapping negacyclic product on the mesh. The transform
        pipeline runs fully sharded; the CRT reconstruction all-gathers the
        k standard-order residues (the only cross-channel collective)."""
        parts_l, lead, fmt = self._to_dist(lhs)
        parts_r, _, _ = self._to_dist(rhs)
        res = self._polymul_sharded(*parts_l, *parts_r, *self._consts)
        # gather channels + transform shards; keep batch sharded over dp
        k, b = res.shape[0], res.shape[1]
        res = jax.device_put(
            res, NamedSharding(self.mesh, P(None, self.dp, None, None))
        ).reshape(k, b, self.plan.n)
        value_parts = self.plan._reconstruct([res[i] for i in range(k)])
        if not isinstance(value_parts, tuple):
            value_parts = (value_parts,)
        return _marshal_out(value_parts, lead, fmt, self.plan.n)


class ChannelShardedNative52:
    """Multi-chip negacyclic polymul for a plan52-tier native plan — the
    64-bit-channel twin of ChannelShardedNative: the
    k prime64 CRT channels (~50-bit table primes) shard over `ch`, batch
    over `dp`, and the four-step factor over `sp` with one all_to_all per
    transform, composed in ONE shard_map. Local sections run the
    traced-scalar mxu64 algebra (the same limb-pair digit-plane matmuls +
    fused Shoup scaled epilogue as ops/mxu64.py), so results are
    bit-identical to the single-device Plan52 engines."""

    def __init__(self, plan, mesh, ch_axis: str = "ch", batch_axis=None,
                 sp_axis=None):
        from ..ops import mxu64
        from ..ops.traced_scalar import _multi_tables64

        if plan.tier != "plan52":
            raise ValueError("ChannelShardedNative52 requires a plan52 plan")
        n, primes = plan.n, tuple(plan.primes)
        k = len(primes)
        if not all((1 << 33) < p < (1 << 62) for p in primes):
            raise ValueError("plan52 channel sharding needs p in (2^33, 2^62)")
        cs = mesh.shape[ch_axis]
        if k % cs:
            raise ValueError(f"{k} channels must divide over ch={cs}")
        self.plan, self.mesh = plan, mesh
        self.ch, self.dp, self.sp = ch_axis, batch_axis, sp_axis
        s = mesh.shape[sp_axis] if sp_axis else 1
        self._s = s
        self._mxu64 = mxu64

        log2n = n.bit_length() - 1
        n1 = 1 << (log2n // 2)
        n2 = n // n1
        self.n1, self.n2 = n1, n2
        if n2 % s or n1 % s:
            raise ValueError(f"sp={s} must divide n1={n1} and n2={n2}")

        self.n_limbs = plan.width // 32  # value limbs (1 for u32, 2 for u64)
        scales = tuple(
            pow(n, p - 2, p) * pow(2, 64, p) % p for p in primes
        )  # n^-1 * 2^64: normalization + Montgomery compensation
        tabs = _multi_tables64(n, primes, scales)
        self._n_tab = len(tabs["fwd"][4])  # 10 ("shoup" scale mode)

        ch = ch_axis
        put = lambda a, spec: jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec))
        f = tabs["fwd"]
        i = tabs["inv"]
        self._consts = (
            put(tabs["scalars"], P(ch, None)),  # [k, 16] u32 limb-pair scalars
            put(f[0], P(ch, None, None)),
            put(f[1], P(ch, None, None)),
            put(f[2], P(ch, None, None)),
            put(f[3], P(ch, None, None)),
            *[put(d, P(ch, sp_axis, None)) for d in f[4]],  # d tabs [k, n2, n1]
            put(i[0], P(ch, None, None)),
            put(i[1], P(ch, None, None)),
            put(i[2], P(ch, None, None)),
            put(i[3], P(ch, None, None)),
            *[put(e, P(ch, sp_axis, None)) for e in i[4]],  # e tabs [k, n1, n2]
        )
        self._val_spec = P(batch_axis, None, sp_axis)  # [B, n1, n2] per limb
        self._build()

    @staticmethod
    def _sc(scal_row):
        return {
            name: (scal_row[2 * j], scal_row[2 * j + 1])
            for j, name in enumerate(_SC64_FIELDS)
        }

    # -- local (per-rank) sections ------------------------------------------

    def _fwd_local(self, parts, scal, p1, c1, p2, c2, tg):
        """parts: n_limbs × [b, n1, n2/s] value limb shards -> NTT domain
        [k_loc, b, n1/s, n2, 2] canonical limb pairs."""
        from ..ops.traced_scalar import _sc_canonical, _sc_scaled_epilogue

        mxu64 = self._mxu64
        k_loc = scal.shape[0]
        if len(parts) == 1:  # u32 values: hi limb is zero (< 2^32 < p)
            parts = (parts[0], jnp.zeros_like(parts[0]))
        v = tuple(jnp.swapaxes(a, 1, 2) for a in parts)  # [b, n2/s, n1]
        xd = mxu64._digit_cat(v)
        ys = []
        for c in range(k_loc):
            sc = self._sc(scal[c])
            big = mxu64._dot(xd, p1[c])
            trip = mxu64._combine8(big, c1[c], self.n1, c1.shape[1])
            lo, hi = _sc_scaled_epilogue(*trip, tuple(t[c] for t in tg), sc)
            ys.append(jnp.stack([lo, hi], axis=-1))
        y = jnp.stack(ys, axis=0)  # [k_loc, b, n2/s, n1, 2] lazy reps
        if self.sp:
            y = jax.lax.all_to_all(
                y, self.sp, split_axis=3, concat_axis=2, tiled=True
            )  # -> [k_loc, b, n2, n1/s, 2]
        y = jnp.swapaxes(y, 2, 3)  # [k_loc, b, n1/s, n2, 2]
        outs = []
        for c in range(k_loc):
            sc = self._sc(scal[c])
            big = mxu64._dot(
                mxu64._digit_cat(
                    (y[c, ..., 0], y[c, ..., 1]), p2.shape[1] // self.n2
                ),
                p2[c],
            )
            trip = mxu64._combine8(big, c2[c], self.n2, c2.shape[1])
            lo, hi = _sc_canonical(*trip, sc)
            outs.append(jnp.stack([lo, hi], axis=-1))
        return jnp.stack(outs, axis=0)

    def _inv_local(self, x, scal, g1, gc1, a2, ac2, eg):
        """x: [k_loc, b, n1/s, n2, 2] NTT-domain reps -> standard-order
        residues [k_loc, b, n1, n2/s, 2] (scaled by n^-1*2^64 via the
        folded inverse column planes)."""
        from ..ops.traced_scalar import _sc_canonical, _sc_scaled_epilogue

        mxu64 = self._mxu64
        k_loc = scal.shape[0]
        ys = []
        for c in range(k_loc):
            sc = self._sc(scal[c])
            big = mxu64._dot(mxu64._digit_cat((x[c, ..., 0], x[c, ..., 1])), g1[c])
            trip = mxu64._combine8(big, gc1[c], self.n2, gc1.shape[1])
            lo, hi = _sc_scaled_epilogue(*trip, tuple(e[c] for e in eg), sc)
            ys.append(jnp.stack([lo, hi], axis=-1))
        y = jnp.stack(ys, axis=0)  # [k_loc, b, n1/s, n2, 2]
        if self.sp:
            y = jax.lax.all_to_all(
                y, self.sp, split_axis=3, concat_axis=2, tiled=True
            )  # -> [k_loc, b, n1, n2/s, 2]
        y = jnp.swapaxes(y, 2, 3)  # [k_loc, b, n2/s, n1, 2]
        outs = []
        for c in range(k_loc):
            sc = self._sc(scal[c])
            big = mxu64._dot(
                mxu64._digit_cat(
                    (y[c, ..., 0], y[c, ..., 1]), a2.shape[1] // self.n1
                ),
                a2[c],
            )
            trip = mxu64._combine8(big, ac2[c], self.n1, ac2.shape[1])
            lo, hi = _sc_canonical(*trip, sc)
            outs.append(jnp.stack([lo, hi], axis=-1))
        return jnp.swapaxes(jnp.stack(outs, axis=0), 2, 3)

    def _polymul_local(self, *args):
        from ..ops.traced_scalar import _sc_mont_mul64

        nl = self.n_limbs
        nt = self._n_tab
        parts_l = args[:nl]
        parts_r = args[nl : 2 * nl]
        scal = args[2 * nl]
        rest = args[2 * nl + 1 :]
        p1, c1, p2, c2 = rest[:4]
        tg = rest[4 : 4 + nt]
        g1, gc1, a2, ac2 = rest[4 + nt : 8 + nt]
        eg = rest[8 + nt : 8 + 2 * nt]
        fl = self._fwd_local(parts_l, scal, p1, c1, p2, c2, tg)
        fr = self._fwd_local(parts_r, scal, p1, c1, p2, c2, tg)
        prods = []
        for c in range(scal.shape[0]):
            sc = self._sc(scal[c])
            lo, hi = _sc_mont_mul64(
                (fl[c, ..., 0], fl[c, ..., 1]),
                (fr[c, ..., 0], fr[c, ..., 1]),
                sc["p"], sc["p_neginv"],
            )
            prods.append(jnp.stack([lo, hi], axis=-1))
        prod = jnp.stack(prods, axis=0)
        return self._inv_local(prod, scal, g1, gc1, a2, ac2, eg)

    def _build(self):
        mesh, ch, dp, sp = self.mesh, self.ch, self.dp, self.sp
        nl = self.n_limbs
        nt = self._n_tab
        const_specs = (
            P(ch, None),
            *[P(ch, None, None)] * 4,
            *[P(ch, sp, None)] * nt,
            *[P(ch, None, None)] * 4,
            *[P(ch, sp, None)] * nt,
        )
        self._polymul_sharded = jax.jit(
            shard_map(
                self._polymul_local,
                mesh=mesh,
                in_specs=(*[self._val_spec] * (2 * nl), *const_specs),
                out_specs=P(ch, dp, None, sp, None),
                check_vma=False,
            )
        )

    # -- public API ----------------------------------------------------------

    def _to_dist(self, x):
        parts, lead, fmt = _marshal_in(x, self.plan.width, self.plan.n)
        b = parts[0].shape[0]
        put = lambda a: jax.device_put(
            a.reshape(b, self.n1, self.n2), NamedSharding(self.mesh, self._val_spec)
        )
        return tuple(put(a) for a in parts), lead, fmt

    def negacyclic_polymul(self, lhs, rhs):
        """End-to-end wrapping negacyclic product on the mesh (plan52 tier);
        the CRT reconstruction all-gathers the k standard-order limb-pair
        residues (the only cross-channel collective)."""
        parts_l, lead, fmt = self._to_dist(lhs)
        parts_r, _, _ = self._to_dist(rhs)
        res = self._polymul_sharded(*parts_l, *parts_r, *self._consts)
        k, b = res.shape[0], res.shape[1]
        res = jax.device_put(
            res, NamedSharding(self.mesh, P(None, self.dp, None, None, None))
        ).reshape(k, b, self.plan.n, 2)
        value_parts = self.plan._reconstruct(
            [(res[i, ..., 0], res[i, ..., 1]) for i in range(k)]
        )
        if not isinstance(value_parts, tuple):
            value_parts = (value_parts,)
        return _marshal_out(value_parts, lead, fmt, self.plan.n)
