"""Multi-device scaling harness.

Default mode: batched native64 CRT polymul with the sharded int8 four-step
transforms (dp x sp meshes) over increasing device counts, reporting
efficiency relative to linear scaling from the smallest mesh.

--north-star mode: the BASELINE.md target workload — batched native128
negacyclic polymul at N=2^16 with CRT channels sharded over a `ch` mesh
axis, batch over `dp`, and the four-step all-to-all stage exchange over
`sp` (parallel/channels.py).

On several cards the all-to-alls and the all-gather are NCCL collectives;
on one card only the 1-device row runs. The rate modes need a GPU; the
--virtual rows are correctness and collective-count rows on a virtual CPU
mesh and carry no rate.

Usage: python benches/scaling.py [--n 16384] [--batch-per-chip 8]
       python benches/scaling.py --north-star
Prints one JSON line per mesh configuration.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _chain_rate(step, lhs, rhs, batch, k, reps):
    """Chain-difference throughput of `step` (polymuls/s): per-call
    dispatch and launch costs cancel; every timing ends in
    block_until_ready.

    The chain is UNROLLED (not lax.scan): scan-of-shard_map compiles
    pathologically slowly (hours at n=2^16 on the CPU backend), while the
    unrolled body is near-linear in k. Keep k modest."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def chain(a, b):
        c, d_ = a, b
        for _ in range(k):
            c, d_ = step(c, d_), c
        return jnp.sum(c.reshape(-1)[:1].astype(jnp.float32))

    @jax.jit
    def one(a, b):
        return jnp.sum(step(a, b).reshape(-1)[:1].astype(jnp.float32))

    chain(lhs, rhs).block_until_ready()
    one(lhs, rhs).block_until_ready()
    bk = b1 = float("inf")
    for _i in range(reps):
        t0 = time.perf_counter()
        chain(lhs, rhs).block_until_ready()
        bk = min(bk, time.perf_counter() - t0)
        t0 = time.perf_counter()
        one(lhs, rhs).block_until_ready()
        b1 = min(b1, time.perf_counter() - t0)
    delta = bk - b1
    if delta <= 0:
        return float("nan")  # non-monotone chain delta: measurement invalid
    return batch / (delta / (k - 1))


def north_star(args, device):
    """Batched native128 @ N=2^16, dp x ch x sp (BASELINE.md target row)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from concrete_ntt_tpu import native128
    from concrete_ntt_tpu.parallel.channels import ChannelShardedNative

    n = args.n if args.n != (1 << 14) else (1 << 16)
    devs = len(jax.devices())
    plan = native128.Plan32.try_new(n)
    assert plan is not None
    rng = np.random.default_rng(0)
    base_rate = None

    d = 1
    while d <= min(devs, args.max_devices):
        ch = 2 if d % 2 == 0 else 1
        sp = 2 if (d // ch) % 2 == 0 else 1
        dp = d // (ch * sp)
        mesh = jax.make_mesh(
            (dp, ch, sp),
            ("dp", "ch", "sp"),
            axis_types=(jax.sharding.AxisType.Auto,) * 3,
        )
        sharded = ChannelShardedNative(
            plan, mesh, ch_axis="ch", batch_axis="dp", sp_axis="sp"
        )
        batch = args.batch_per_chip * d
        import jax.numpy as jnp

        lhs_np = rng.integers(0, 1 << 32, (batch, n, 4), dtype=np.uint32)
        a0 = jnp.asarray(lhs_np)
        b0 = jnp.asarray(lhs_np[::-1].copy())
        consts = sharded._consts
        val_sh = NamedSharding(mesh, sharded._val_spec)

        def step_flat(a, b):
            # full measured workload: reshard values onto the mesh, the
            # sharded split/fwd/pointwise/inv pipeline, then the
            # reconstruction all-gather
            def parts(x):
                return tuple(
                    jax.lax.with_sharding_constraint(
                        x[..., i].reshape(batch, sharded.n1, sharded.n2), val_sh
                    )
                    for i in range(4)
                )

            res = sharded._polymul_sharded(*parts(a), *parts(b), *consts)
            k = res.shape[0]
            res = jax.lax.with_sharding_constraint(
                res, NamedSharding(mesh, P(None, "dp", None, None))
            ).reshape(k, batch, n)
            out = plan._reconstruct([res[i] for i in range(k)])
            return jnp.stack(out, axis=-1)

        rate = _chain_rate(step_flat, a0, b0, batch, args.chain, args.reps)
        if base_rate is None:
            base_rate = rate / d
        print(
            json.dumps(
                {
                    "workload": "native128_polymul_n2^16",
                    "device": device,
                    "devices": d,
                    "mesh": {"dp": dp, "ch": ch, "sp": sp},
                    "batch": batch,
                    "polymul_per_sec": round(rate, 1),
                    "scaling_efficiency": round(rate / (base_rate * d), 4),
                }
            ),
            flush=True,
        )
        d *= 2


def virtual_mesh_rows(args):
    """2/4/8-device VIRTUAL-mesh rows for the north-star workload: bit-
    exactness vs the single-device plan plus the compiled collective count
    (the SCALING.md §1 model, machine-checked per mesh). These are
    correctness/structure rows, NOT performance — the CPU backend's
    'collectives' are shared-memory copies — and are labeled non_perf so
    no one mistakes them for a measurement on cards."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from concrete_ntt_tpu import native128
    from concrete_ntt_tpu.parallel.channels import ChannelShardedNative
    from concrete_ntt_tpu.utils.runtime import device_info

    n = args.n if args.n != (1 << 14) else (1 << 16)
    plan = native128.Plan32.try_new(n)
    assert plan is not None
    rng = np.random.default_rng(0)
    B = 2
    lhs = rng.integers(0, 1 << 32, (B, n, 4), dtype=np.uint32)
    rhs = rng.integers(0, 1 << 32, (B, n, 4), dtype=np.uint32)
    want = np.asarray(plan.negacyclic_polymul(lhs, rhs))

    rows = []
    for dp, ch, sp in ((1, 2, 1), (1, 2, 2), (2, 2, 2)):
        d = dp * ch * sp
        if d > len(jax.devices()):
            break
        mesh = jax.make_mesh((dp, ch, sp), ("dp", "ch", "sp"))
        sharded = ChannelShardedNative(
            plan, mesh, ch_axis="ch", batch_axis="dp", sp_axis="sp"
        )
        got = np.asarray(sharded.negacyclic_polymul(lhs, rhs))
        bit_exact = bool(np.array_equal(got, want))

        k = len(plan.primes)
        val = NamedSharding(mesh, sharded._val_spec)
        parts = tuple(
            jax.ShapeDtypeStruct((B, sharded.n1, sharded.n2), jnp.uint32,
                                 sharding=val)
            for _ in range(2 * sharded.n_limbs)
        )

        @jax.jit
        def full(*flat, sharded=sharded, mesh=mesh):
            res = sharded._polymul_sharded(*flat, *sharded._consts)
            res = jax.sharding.reshard(
                res, NamedSharding(mesh, P(None, "dp", None, None))
            )
            return plan._reconstruct([res.reshape(k, B, n)[i] for i in range(k)])

        txt = full.lower(*parts).compile().as_text()
        colls = {
            op: txt.count(f" {op}(") + txt.count(f" {op}-start(")
            for op in ("all-to-all", "all-gather", "all-reduce",
                       "collective-permute", "reduce-scatter")
        }
        row = {
            "workload": f"native128_polymul_n2^{n.bit_length() - 1}",
            "devices": d,
            "mesh": {"dp": dp, "ch": ch, "sp": sp},
            "device": device_info(),
            "non_perf": True,
            "bit_exact": bit_exact,
            "collectives": colls,
        }
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 14)
    ap.add_argument("--batch-per-chip", type=int, default=8)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--chain", type=int, default=8)
    ap.add_argument("--max-devices", type=int, default=1 << 20)
    ap.add_argument(
        "--north-star",
        action="store_true",
        help="batched native128 @ N=2^16, dp x ch x sp channel sharding",
    )
    ap.add_argument(
        "--virtual",
        action="store_true",
        help="2/4/8-device virtual-mesh correctness + collective-count rows "
        "(non-perf; run with JAX_PLATFORMS=cpu and an 8-device XLA_FLAGS)",
    )
    args = ap.parse_args()
    if args.virtual:
        return virtual_mesh_rows(args)
    from concrete_ntt_tpu.utils.runtime import enable_compile_cache, require_gpu

    device = require_gpu()
    enable_compile_cache()
    if args.north_star:
        return north_star(args, device)

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from concrete_ntt_tpu import native64
    from concrete_ntt_tpu.ops import crt as crt_ops
    from concrete_ntt_tpu.ops.u32 import np_u64_to_limbs
    from concrete_ntt_tpu.parallel.fourstep_mxu import make_sharded_prime32_mxu

    n = args.n
    devs = len(jax.devices())
    n1 = 1 << ((n.bit_length() - 1) // 2)
    n2 = n // n1

    # mesh configs: (dp, sp) per device count, sp sharding the transform
    configs = []
    d = 1
    while d <= devs:
        sp = 2 if (d % 2 == 0 and n2 % 2 == 0) else 1
        configs.append((d // sp, sp))
        d *= 2

    plan = native64.Plan32.try_new(n)
    assert plan is not None
    rng = np.random.default_rng(0)
    base_rate = None

    for dp, sp in configs:
        ndev = dp * sp
        mesh = jax.make_mesh(
            (dp, sp), ("dp", "sp"), axis_types=(jax.sharding.AxisType.Auto,) * 2
        )
        channels = [
            make_sharded_prime32_mxu(pl, mesh, axis="sp", batch_axis="dp")
            for pl in plan.plans
        ]
        batch = args.batch_per_chip * ndev
        val_sh = NamedSharding(mesh, P("dp", None, "sp", None))
        limbs = np_u64_to_limbs(
            rng.integers(0, 1 << 64, (batch, n), dtype=np.uint64)
        ).reshape(batch, n1, n2, 2)
        lhs = jax.device_put(jnp.asarray(limbs), val_sh)
        rhs = jax.device_put(jnp.asarray(limbs[::-1].copy()), val_sh)

        def step(a, b):
            ra = crt_ops.split_u64(a[..., 0], a[..., 1], plan.primes)
            rb = crt_ops.split_u64(b[..., 0], b[..., 1], plan.primes)
            prods = []
            for i, (fwd, inv, _, _) in enumerate(channels):
                fa, fb = fwd(ra[i]), fwd(rb[i])
                prods.append(inv(plan.plans[i].mul_assign_normalize(fa, fb)))
            lo, hi = crt_ops.rec_u64_from5(prods, plan.primes)
            return jnp.stack([lo, hi], axis=-1)

        k = 32

        @jax.jit
        def chain(a, b):
            def body(carry, _):
                c, d_ = carry
                return (step(c, d_), c), None

            (c, _), _ = jax.lax.scan(body, (a, b), None, length=k)
            return jnp.sum(c.reshape(-1)[:1].astype(jnp.float32))

        @jax.jit
        def one(a, b):
            return jnp.sum(step(a, b).reshape(-1)[:1].astype(jnp.float32))

        chain(lhs, rhs).block_until_ready()
        one(lhs, rhs).block_until_ready()
        bk = b1 = float("inf")
        for _i in range(args.reps):
            t0 = time.perf_counter()
            chain(lhs, rhs).block_until_ready()
            bk = min(bk, time.perf_counter() - t0)
            t0 = time.perf_counter()
            one(lhs, rhs).block_until_ready()
            b1 = min(b1, time.perf_counter() - t0)
        per_step = max(bk - b1, 1e-9) / (k - 1)
        rate = batch / per_step
        if base_rate is None:
            base_rate = rate / ndev
        eff = rate / (base_rate * ndev)
        print(
            json.dumps(
                {
                    "device": device,
                    "devices": ndev,
                    "mesh": {"dp": dp, "sp": sp},
                    "batch": batch,
                    "polymul_per_sec": round(rate, 1),
                    "scaling_efficiency": round(eff, 4),
                }
            ),
            flush=True,
        )


if __name__ == "__main__":
    main()
