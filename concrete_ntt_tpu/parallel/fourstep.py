"""Four-step sharded negacyclic NTT: large transforms across a device mesh.

The reference scales within one core via depth-first cache blocking
(RECURSION_THRESHOLD, prime32.rs:12); across devices there is no reference
analogue (SURVEY.md §2.12) — this module is the invention the BASELINE.json
north star asks for: butterfly stages blocked per device with the
inter-stage transpose as an all-to-all.

Math: view the length-N array as [N1, N2] (row-major). CT stages
0..log2(N1)-1 of the *global* transform touch only elements whose indices
differ in the N1 coordinate (stride ≥ N2) and use one twiddle per row-block —
i.e. independent column transforms. Stages log2(N1).. touch only within rows,
where row i1 consumes the contiguous global twiddle slice
twid[(N1 + i1)·2^s' + j] at local stage s' (the bit-reversed table is
self-similar, so no separate twiddle-correction pass is needed — the twist
lives in the table, exactly as in the reference's single-core engine).

Sharding: pass 1 shards columns (N2/D per device, fully local); one
lax.all_to_all re-tiles to rows (N1/D per device); pass 2 is fully local.
Input/output layout matches the reference order: out[i1·N2 + j2], sharded
contiguously along the transform axis.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..ops import butterflies32 as bf32


def _col_stages(parts, twid_parts, bf, lbf, n1, first, last, final_stage):
    """Forward stages [first, last) along the N1 axis of [B, N1, C] parts."""
    b, _, c = parts[0].shape
    for s in range(first, last):
        m = 1 << s
        tr = n1 >> (s + 1)
        z0 = tuple(a.reshape(b, m, 2, tr, c)[:, :, 0] for a in parts)
        z1 = tuple(a.reshape(b, m, 2, tr, c)[:, :, 1] for a in parts)
        w = tuple(tw[m : 2 * m][None, :, None, None] for tw in twid_parts)
        use = lbf if s == final_stage else bf
        y0, y1 = use(z0, z1, w)
        parts = tuple(
            jnp.concatenate(
                [a.reshape(b, m, 1, tr, c), y.reshape(b, m, 1, tr, c)], axis=2
            ).reshape(b, n1, c)
            for a, y in zip(y0, y1)
        )
    return parts


def _col_stages_inv(parts, twid_parts, bf, lbf, n1, first, last):
    """Inverse stages from first-1 down to last along the N1 axis."""
    b, _, c = parts[0].shape
    for s in range(first - 1, last - 1, -1):
        m = 1 << s
        tr = n1 >> (s + 1)
        z0 = tuple(a.reshape(b, m, 2, tr, c)[:, :, 0] for a in parts)
        z1 = tuple(a.reshape(b, m, 2, tr, c)[:, :, 1] for a in parts)
        w = tuple(tw[m : 2 * m][None, :, None, None] for tw in twid_parts)
        use = lbf if s == 0 else bf
        y0, y1 = use(z0, z1, w)
        parts = tuple(
            jnp.concatenate(
                [a.reshape(b, m, 1, tr, c), y.reshape(b, m, 1, tr, c)], axis=2
            ).reshape(b, n1, c)
            for a, y in zip(y0, y1)
        )
    return parts


def _row_stages(parts, twid_parts, bf, lbf, n1, n2, r0, direction):
    """Row-local stages on [B, R, N2] parts; global row index = r0 + r.

    Twiddles for local stage s': twid[(n1 + r0 + r)·2^s' + j] — a contiguous
    dynamic slice of length R·2^s' starting at (n1 + r0)·2^s'.
    """
    b, r, _ = parts[0].shape
    log2n2 = n2.bit_length() - 1
    stages = range(log2n2) if direction == "fwd" else range(log2n2 - 1, -1, -1)
    for sp in stages:
        mp = 1 << sp
        tp = n2 >> (sp + 1)
        z0 = tuple(a.reshape(b, r, mp, 2, tp)[:, :, :, 0] for a in parts)
        z1 = tuple(a.reshape(b, r, mp, 2, tp)[:, :, :, 1] for a in parts)
        w = []
        for tw in twid_parts:
            start = (jnp.int32(n1) + r0) * mp
            sl = jax.lax.dynamic_slice(tw, (start,), (r * mp,))
            w.append(sl.reshape(1, r, mp, 1))
        w = tuple(w)
        is_final = (sp == log2n2 - 1) if direction == "fwd" else (sp == 0)
        use = lbf if is_final and direction == "fwd" else bf
        y0, y1 = use(z0, z1, w)
        parts = tuple(
            jnp.concatenate(
                [a.reshape(b, r, mp, 1, tp), y.reshape(b, r, mp, 1, tp)], axis=3
            ).reshape(b, r, n2)
            for a, y in zip(y0, y1)
        )
    return parts


def _split_n(n: int, n_devices: int) -> tuple[int, int]:
    """Choose N = N1·N2 with D | N1, D | N2, both powers of two, N1 ≈ √N."""
    log2n = n.bit_length() - 1
    log2d = n_devices.bit_length() - 1
    a = max(log2d, min(log2n - log2d, (log2n + 1) // 2))
    if a + log2d > log2n:
        raise ValueError(f"n={n} too small to shard over {n_devices} devices")
    return 1 << a, 1 << (log2n - a)


def make_sharded_prime32(plan, mesh, axis: str = "x", batch_axis: str | None = None):
    """Build (fwd, inv) callables for a prime32 plan, sharded over `mesh`'s
    `axis` (transform dimension) and optionally `batch_axis` (data parallel).
    Arguments/results: [B, N] uint32, sharded along N (and B).

    fwd: standard order → bit-reversed NTT values in [0,p) (reference
    convention preserved across the distributed transpose).
    """
    n = plan.n
    p = plan.p
    d = mesh.shape[axis]
    n1, n2 = _split_n(n, d)
    log2n1 = n1.bit_length() - 1

    if plan.variant == "lt30":
        fbf, flbf = bf32.make_fwd_lt30(p)
        ibf, ilbf = bf32.make_inv_lt30(p)
        fwd_tw = ("twid", "twid_shoup")
        inv_tw = ("inv_twid", "inv_twid_shoup")
    elif plan.variant == "lt31":
        fbf, flbf = bf32.make_fwd_lt31(p)
        ibf, ilbf = bf32.make_inv_lt31(p)
        fwd_tw = ("twid", "twid_shoup")
        inv_tw = ("inv_twid", "inv_twid_shoup")
    else:
        from ..ops.u32 import mont_neginv

        ninv = mont_neginv(p)
        fbf, flbf = bf32.make_fwd_generic32(p, ninv)
        ibf, ilbf = bf32.make_inv_generic32(p, ninv)
        fwd_tw = ("twid",)
        inv_tw = ("inv_twid",)

    tbl = plan._tbl
    ftw = tuple(jnp.asarray(tbl[k]) for k in fwd_tw)
    itw = tuple(jnp.asarray(tbl[k]) for k in inv_tw)

    def fwd_local(x_loc, *tw):
        # x_loc: [B, N1, N2/D]
        parts = _col_stages((x_loc,), tw, fbf, flbf, n1, 0, log2n1, -1)
        x_loc = jax.lax.all_to_all(parts[0], axis, split_axis=1, concat_axis=2, tiled=True)
        r0 = jax.lax.axis_index(axis) * (n1 // d)
        parts = _row_stages((x_loc,), tw, fbf, flbf, n1, n2, r0, "fwd")
        return parts[0]  # [B, N1/D, N2]

    def inv_local(x_loc, *tw):
        # x_loc: [B, N1/D, N2] (bit-reversed NTT domain, sharded rows)
        r0 = jax.lax.axis_index(axis) * (n1 // d)
        parts = _row_stages((x_loc,), tw, ibf, ilbf, n1, n2, r0, "inv")
        x_loc = jax.lax.all_to_all(parts[0], axis, split_axis=2, concat_axis=1, tiled=True)
        parts = _col_stages_inv((x_loc,), tw, ibf, ilbf, n1, log2n1, 0)
        return parts[0]  # [B, N1, N2/D]

    ba = batch_axis
    fwd_sm = jax.shard_map(
        lambda x, *tw: fwd_local(x, *tw),
        mesh=mesh,
        in_specs=(P(ba, None, axis),) + (P(),) * len(ftw),
        out_specs=P(ba, axis, None),
        check_vma=False,
    )
    inv_sm = jax.shard_map(
        lambda x, *tw: inv_local(x, *tw),
        mesh=mesh,
        in_specs=(P(ba, axis, None),) + (P(),) * len(itw),
        out_specs=P(ba, None, axis),
        check_vma=False,
    )

    @jax.jit
    def fwd(x):
        b = x.shape[0]
        out = fwd_sm(x.reshape(b, n1, n2), *ftw)
        return out.reshape(b, n)

    @jax.jit
    def inv(x):
        b = x.shape[0]
        out = inv_sm(x.reshape(b, n1, n2), *itw)
        return out.reshape(b, n)

    return fwd, inv
