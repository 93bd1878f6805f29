"""Multi-device four-step NTT: the sharded matmul transform over a mesh.

The single-device four-step engine (ops/mxu32.py) factors the transform into
column-matmul -> diagonal -> row-matmul. That factorization IS the
distributed decomposition (SURVEY.md §5: N = N1 x N2 with the inter-factor
transpose as the collective):

  * coefficient layout: [B, n1, n2] sharded on the n2 axis (columns);
  * the column matmul contracts n1 — embarrassingly parallel over columns;
  * the four-step diagonal is elementwise with a per-rank slice;
  * ONE jax.lax.all_to_all redistributes n2-sharding to n1-sharding (the
    distributed transpose);
  * the row matmul contracts n2 — parallel over the now-local rows.

The layouts alternate stably: values sharded P(dp, None, sp) <-> NTT domain
sharded P(dp, sp, None), so fwd -> pointwise -> inv chains need exactly one
all-to-all per transform and the pointwise stage is purely local. Batch
shards over a data-parallel axis independently.

Results are bit-identical to the single-chip engine (tests run on the
virtual CPU mesh, XLA int8 dots are exact everywhere).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops import mxu32, mxu64


def make_sharded_prime32_mxu(plan, mesh, axis: str = "sp", batch_axis=None):
    """(fwd, inv, to_dist, from_dist) for one prime32 channel.

    fwd: [B, n1, n2] values (P(dp, None, sp)) -> [B, n1, n2] NTT domain
         (P(dp, sp, None)), bit-reversed layout when flattened.
    inv: the exact mirror (unnormalized).
    to_dist/from_dist: [B, n] flat <-> distributed [B, n1, n2] views.
    """
    n, p = plan.n, plan.p
    tbl = mxu32._mxu_tables(n, p)
    n1, n2 = tbl["n1"], tbl["n2"]
    s = mesh.shape[axis]
    if n2 % s or n1 % s:
        raise ValueError(f"mesh axis size {s} must divide n1={n1} and n2={n2}")

    dp = batch_axis
    val_spec = P(dp, None, axis)  # [B, n1, n2] sharded on columns
    ntt_spec = P(dp, axis, None)  # [B, n1, n2] sharded on rows

    # four-step diagonals, sharded to match their consumption layout
    d_tabs = tuple(np.asarray(a) for a in tbl["d"])  # [n2, n1] (fwd mid)
    e_tabs = tuple(np.asarray(a) for a in tbl["e"])  # [n1, n2] (inv mid)

    def _pass(x, which, diag=()):
        """One modular-matmul pass on the local shard."""
        if diag:
            return mxu32._matmod_scaled_lazy(x, tbl[which], tuple(diag), tbl, p=p)
        return mxu32._matmod(x, tbl[which], tbl, p=p)

    def fwd_local(x_loc, *d_loc):
        # x_loc [b, n1, n2/s] -> contract n1 with the shared column matrix
        v = x_loc.transpose(0, 2, 1)  # [b, n2/s, n1]
        y = _pass(v, "A", d_loc)
        # distributed transpose: n2-sharding -> n1-sharding
        y = jax.lax.all_to_all(y, axis, split_axis=2, concat_axis=1, tiled=True)
        # y [b, n2, n1/s] -> contract n2 with the shared row matrix
        y = y.transpose(0, 2, 1)  # [b, n1/s, n2]
        return _pass(y, "F")

    def inv_local(x_loc, *e_loc):
        # x_loc [b, n1/s, n2] NTT domain -> row pass is local
        y = _pass(x_loc, "G", e_loc)
        # n1-sharding -> n2-sharding
        y = jax.lax.all_to_all(y, axis, split_axis=2, concat_axis=1, tiled=True)
        # y [b, n1, n2/s] -> contract n1
        y = y.transpose(0, 2, 1)  # [b, n2/s, n1]
        out = _pass(y, "Ainv")
        return out.transpose(0, 2, 1)  # [b, n1, n2/s] standard order

    fwd_sharded = shard_map(
        fwd_local,
        mesh=mesh,
        in_specs=(val_spec, *([P(axis, None)] * len(d_tabs))),
        out_specs=ntt_spec,
        check_vma=False,
    )
    inv_sharded = shard_map(
        inv_local,
        mesh=mesh,
        in_specs=(ntt_spec, *([P(axis, None)] * len(e_tabs))),
        out_specs=val_spec,
        check_vma=False,
    )

    d_dev = tuple(
        jax.device_put(a, NamedSharding(mesh, P(axis, None))) for a in d_tabs
    )
    e_dev = tuple(
        jax.device_put(a, NamedSharding(mesh, P(axis, None))) for a in e_tabs
    )

    def fwd(x):
        return fwd_sharded(x, *d_dev)

    def inv(x):
        return inv_sharded(x, *e_dev)

    def to_dist(x_flat):
        b = x_flat.shape[0]
        return jax.device_put(
            x_flat.reshape(b, n1, n2), NamedSharding(mesh, val_spec)
        )

    def from_dist(x_3d):
        b = x_3d.shape[0]
        gathered = jax.device_put(x_3d, NamedSharding(mesh, P(dp, None, None)))
        return gathered.reshape(b, n)

    return fwd, inv, to_dist, from_dist


def make_sharded_prime64_mxu(plan, mesh, axis: str = "sp", batch_axis=None):
    """(fwd, inv, to_dist, from_dist) for one prime64 channel (u64 limb-pair
    values) — the 64-bit twin of make_sharded_prime32_mxu, so Plan52 tiers
    and Goldilocks scale multi-chip too.

    fwd: [B, n1, n2, 2] values (P(dp, None, sp, None)) -> NTT domain
         (P(dp, sp, None, None)); inv mirrors. One all_to_all per transform.
    """
    n, p = plan.n, plan.p
    tbl = mxu64._tables(n, p)
    n1, n2 = tbl["n1"], tbl["n2"]
    s = mesh.shape[axis]
    if n2 % s or n1 % s:
        raise ValueError(f"mesh axis size {s} must divide n1={n1} and n2={n2}")

    dp = batch_axis
    val_spec = P(dp, None, axis, None)
    ntt_spec = P(dp, axis, None, None)

    d_tabs = tuple(np.asarray(a) for a in tbl["d"])  # [n2, n1] (fwd mid)
    e_tabs = tuple(np.asarray(a) for a in tbl["e"])  # [n1, n2] (inv mid)

    def _pass(pair, which, mont=(), scale=1):
        if mont:
            return mxu64._matmod_scaled_lazy(pair, tbl[which], tuple(mont), tbl)
        if scale != 1:
            mat = mxu64._scaled_ainv_planes(n, p, scale % p)
            return mxu64._matmod_canonical(pair, mat, tbl)
        return mxu64._matmod_canonical(pair, tbl[which], tbl)

    def fwd_local(x_loc, *d_loc):
        v = (x_loc[..., 0].transpose(0, 2, 1), x_loc[..., 1].transpose(0, 2, 1))
        y = _pass(v, "A", d_loc)  # [b, n2/s, n1] lazy pair
        y = jnp.stack(y, axis=-1)
        y = jax.lax.all_to_all(y, axis, split_axis=2, concat_axis=1, tiled=True)
        y = (y[..., 0].transpose(0, 2, 1), y[..., 1].transpose(0, 2, 1))
        lo, hi = _pass(y, "F")  # [b, n1/s, n2] canonical
        return jnp.stack([lo, hi], axis=-1)

    def inv_local(x_loc, *e_loc):
        v = (x_loc[..., 0], x_loc[..., 1])
        y = _pass(v, "G", e_loc)  # [b, n1/s, n2] lazy pair
        y = jnp.stack(y, axis=-1)
        y = jax.lax.all_to_all(y, axis, split_axis=2, concat_axis=1, tiled=True)
        y = (y[..., 0].transpose(0, 2, 1), y[..., 1].transpose(0, 2, 1))
        lo, hi = _pass(y, "Ainv")  # [b, n2/s, n1] canonical
        return jnp.stack([lo.transpose(0, 2, 1), hi.transpose(0, 2, 1)], axis=-1)

    fwd_sharded = shard_map(
        fwd_local,
        mesh=mesh,
        in_specs=(val_spec, *([P(axis, None)] * len(d_tabs))),
        out_specs=ntt_spec,
        check_vma=False,
    )
    inv_sharded = shard_map(
        inv_local,
        mesh=mesh,
        in_specs=(ntt_spec, *([P(axis, None)] * len(e_tabs))),
        out_specs=val_spec,
        check_vma=False,
    )

    d_dev = tuple(
        jax.device_put(a, NamedSharding(mesh, P(axis, None))) for a in d_tabs
    )
    e_dev = tuple(
        jax.device_put(a, NamedSharding(mesh, P(axis, None))) for a in e_tabs
    )

    def fwd(x):
        return fwd_sharded(x, *d_dev)

    def inv(x):
        return inv_sharded(x, *e_dev)

    def to_dist(limbs):
        b = limbs.shape[0]
        return jax.device_put(
            limbs.reshape(b, n1, n2, 2), NamedSharding(mesh, val_spec)
        )

    def from_dist(x):
        b = x.shape[0]
        gathered = jax.device_put(x, NamedSharding(mesh, P(dp, None, None, None)))
        return gathered.reshape(b, n, 2)

    return fwd, inv, to_dist, from_dist
