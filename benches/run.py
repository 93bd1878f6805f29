"""Criterion-equivalent benchmark suite (reference: benches/ntt.rs).

Mirrors the reference's bench-id scheme exactly so results are comparable
row-by-row with its Slab database entries (benches/ntt.rs:95-233):

    fwd-32-{p}-{n}, inv-32-{p}-{n}         3 prime regimes x 8 sizes
    fwd-64-{p}-{n}, inv-64-{p}-{n}         6 prime regimes x 8 sizes
    native{32,64,128}-{32,52}-{n}          negacyclic_polymul per tier
    nativebinary{32,64,128}-{32,52}-{n}

The reference measures single-call latency on one core; the device's unit
of work is a batch, so each id reports amortized per-polynomial latency at
batch B (default 16) plus polys/sec — the per-device throughput analogue.
Timing uses on-device lax.scan chains with fresh operands per step, each
timed up to block_until_ready (chain-difference method: per-call dispatch
and launch costs cancel). Every row names the device it ran on; the run
fails when JAX finds no GPU.

Usage:
    python benches/run.py            # representative subset (~fast)
    python benches/run.py --full     # the reference's full grid
    python benches/run.py --ids native64-32-16384 fwd-32-1073479681-16384
Writes one JSON line per id to stdout and benches/results.jsonl.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

BATCH = 16
K = 64

FULL_NS = [256, 512, 1024, 2048, 4096, 8192, 16384, 32768]
QUICK_NS = [1024, 16384]


_K_CAP = 1 << 16  # tiny transforms need tens of thousands of chain steps


def _chain_time(step, args, k=K, reps=5):
    """Per-step time via the chain-difference method, with convergence
    enforcement: the chain is lengthened until (t_K - t_1) >= ~30 ms of
    device work (host-clock jitter is far smaller), and a non-positive
    delta is never floored — it raises so degenerate rows cannot be
    recorded.

    Returns (t_min, stats): t_min is the min-of-reps estimate; stats
    carries the dispersion of the per-rep interleaved estimates (criterion
    parity: the reference records mean + std_dev per id — here
    min/median/max over >= `reps` interleaved t_K/t_1 pairs)."""
    import jax
    import jax.numpy as jnp

    args = jax.tree_util.tree_map(jnp.asarray, args)  # on device BEFORE timing

    def make(kk):
        @jax.jit
        def f(ops):
            def body(carry, _):
                return step(carry), None

            out, _ = jax.lax.scan(body, ops, None, length=kk)
            # touch EVERY carry leaf: anything unreachable from the returned
            # value is dead code XLA will eliminate (observed: a step whose
            # first leaf didn't depend on the product timed only a roll)
            return sum(
                jnp.sum(leaf.reshape(-1)[:1].astype(jnp.float32))
                for leaf in jax.tree_util.tree_leaves(out)
            )

        return f

    f1 = make(1)
    f1(args).block_until_ready()

    def timed_pairs(fa, fb, r):
        """r interleaved (t_K, t_1) samples: A B A B …, so slow drift
        (clocks, power) hits both sides of each difference equally."""
        out = []
        for _i in range(r):
            t0 = time.perf_counter()
            fa(args).block_until_ready()
            ta = time.perf_counter() - t0
            t0 = time.perf_counter()
            fb(args).block_until_ready()
            out.append((ta, time.perf_counter() - t0))
        return out

    for _attempt in range(5):
        fK = make(k)
        fK(args).block_until_ready()
        pairs = timed_pairs(fK, f1, 2)
        bK = min(a for a, _ in pairs)
        b1 = min(b for _, b in pairs)
        if bK - b1 >= 0.03 or k >= _K_CAP:
            break
        est = (bK - b1) / (k - 1) if bK > b1 else 0.0
        k = min(_K_CAP, max(2 * k, int(0.05 / est) if est > 0 else 8 * k))
    pairs = timed_pairs(fK, f1, reps)
    delta = min(a for a, _ in pairs) - min(b for _, b in pairs)
    if delta <= 0:
        raise RuntimeError(
            f"non-monotone chain delta (t_{k}={min(a for a, _ in pairs):.4f}s"
            f" <= t_1={min(b for _, b in pairs):.4f}s)"
        )
    ests = sorted((a - b) / (k - 1) for a, b in pairs if a > b)
    if not ests:
        raise RuntimeError(f"no positive per-rep chain delta at k={k}")
    stats = {
        "t_med": ests[len(ests) // 2],
        "t_max": ests[-1],
        "reps": len(ests),
        "k": k,
    }
    return delta / (k - 1), stats


def _prime_benches(ns, want=lambda bid: True):
    """fwd/inv-32 and fwd/inv-64 ids (benches/ntt.rs:84-132)."""
    from concrete_ntt_tpu import prime32, prime64
    from concrete_ntt_tpu.utils.prime import (
        largest_prime_in_arithmetic_progression64 as prime_in_ap,
    )

    rng = np.random.default_rng(0)
    for n in ns:
        ps32 = [
            prime_in_ap(1 << 16, 1, 1 << 29, 1 << 30),
            prime_in_ap(1 << 16, 1, 1 << 30, 1 << 31),
            prime_in_ap(1 << 16, 1, 1 << 31, (1 << 32) - 1),
        ]
        def two_el(op):
            # two-element carry: both slots change every step,
            # so no transform input is ever loop-invariant for XLA to hoist
            def step(carry):
                a, b = carry
                return (op(b), a)

            return step

        for p in ps32:
            if not (want(f"fwd-32-{p}-{n}") or want(f"inv-32-{p}-{n}")
                    or want(f"fwd-32-{p}-{n}-b1")
                    or want(f"inv-32-{p}-{n}-b1")):
                continue
            plan = prime32.Plan.try_new(n, p)
            if plan is None:
                continue
            x = rng.integers(0, p, (BATCH, n), dtype=np.uint32)
            x2 = rng.integers(0, p, (BATCH, n), dtype=np.uint32)
            yield f"fwd-32-{p}-{n}", two_el(plan.fwd), (x, x2), BATCH
            yield f"inv-32-{p}-{n}", two_el(plan.inv), (x, x2), BATCH
            if n == 16384 and p == ps32[0]:
                # single-call latency rows (the reference's own metric class,
                # benches/ntt.rs:84-132 measures one poly per iteration)
                yield (f"fwd-32-{p}-{n}-b1", two_el(plan.fwd),
                       (x[:1], x2[:1]), 1)
                yield (f"inv-32-{p}-{n}-b1", two_el(plan.inv),
                       (x[:1], x2[:1]), 1)
        ps64 = [
            prime_in_ap(1 << 16, 1, 1 << 49, 1 << 50),
            prime_in_ap(1 << 16, 1, 1 << 50, 1 << 51),
            prime_in_ap(1 << 16, 1, 1 << 61, 1 << 62),
            prime_in_ap(1 << 16, 1, 1 << 62, 1 << 63),
            prime64.Solinas,
            prime_in_ap(1 << 16, 1, 1 << 63, (1 << 64) - 1),
        ]
        for p in ps64:
            if not (want(f"fwd-64-{p}-{n}") or want(f"inv-64-{p}-{n}")
                    or want(f"fwd-64-{p}-{n}-b1")
                    or want(f"inv-64-{p}-{n}-b1")):
                continue
            plan = prime64.Plan.try_new(n, p)
            if plan is None:
                continue
            from concrete_ntt_tpu.ops.u32 import np_u64_to_limbs

            x = np_u64_to_limbs(rng.integers(0, p, (BATCH, n), dtype=np.uint64))
            x2 = np_u64_to_limbs(rng.integers(0, p, (BATCH, n), dtype=np.uint64))
            yield f"fwd-64-{p}-{n}", two_el(plan.fwd), (x, x2), BATCH
            yield f"inv-64-{p}-{n}", two_el(plan.inv), (x, x2), BATCH
            if n == 16384 and p == prime64.Solinas:
                yield (f"fwd-64-{p}-{n}-b1", two_el(plan.fwd),
                       (x[:1], x2[:1]), 1)
                yield (f"inv-64-{p}-{n}-b1", two_el(plan.inv),
                       (x[:1], x2[:1]), 1)


def _native_benches(ns, want=lambda bid: True):
    """native*/nativebinary* polymul ids (benches/ntt.rs:134-233)."""
    from concrete_ntt_tpu import (
        native32,
        native64,
        native128,
        native_binary32,
        native_binary64,
        native_binary128,
    )
    from concrete_ntt_tpu.ops.u32 import np_u64_to_limbs, np_u128_to_limbs

    rng = np.random.default_rng(1)
    fams = [
        ("native32", native32, 32, False),
        ("nativebinary32", native_binary32, 32, True),
        ("native64", native64, 64, False),
        ("nativebinary64", native_binary64, 64, True),
        ("native128", native128, 128, False),
        ("nativebinary128", native_binary128, 128, True),
    ]
    for n in ns:
        for name, mod, width, binary in fams:
            for tier, cls in (("32", "Plan32"), ("52", "Plan52")):
                b1 = (name == "native64" and n == 16384)
                if not (want(f"{name}-{tier}-{n}")
                        or (b1 and want(f"{name}-{tier}-{n}-b1"))):
                    continue
                plan_cls = getattr(mod, cls, None)
                if plan_cls is None:
                    continue
                plan = plan_cls.try_new(n)
                if plan is None:
                    continue
                if width == 32:
                    lhs = rng.integers(0, 1 << 32, (BATCH, n), dtype=np.uint64).astype(
                        np.uint32
                    )
                    rhs_raw = rng.integers(0, 2 if binary else 1 << 32, (BATCH, n),
                                           dtype=np.uint64).astype(np.uint32)
                elif width == 64:
                    lhs = np_u64_to_limbs(
                        rng.integers(0, 1 << 64, (BATCH, n), dtype=np.uint64)
                    )
                    rhs_raw = np_u64_to_limbs(
                        rng.integers(0, 2 if binary else 1 << 64, (BATCH, n),
                                     dtype=np.uint64)
                    )
                else:
                    vals = [
                        [
                            int(v)
                            for v in rng.integers(0, 1 << 62, n, dtype=np.uint64)
                        ]
                        for _ in range(BATCH)
                    ]
                    lhs = np.stack([np_u128_to_limbs(v) for v in vals])
                    rb = rng.integers(0, 2 if binary else 1 << 62, (BATCH, n),
                                      dtype=np.uint64)
                    rhs_raw = np.stack(
                        [np_u128_to_limbs([int(v) for v in row]) for row in rb]
                    )

                def step(pl=plan, binary=binary):
                    # two-element carry: both operands fresh every iteration
                    # so XLA cannot hoist either fwd out of the scan. Binary
                    # rhs stays {0,1} by rotating instead of reusing output.
                    import jax.numpy as jnp

                    def fn(carry):
                        a, b = carry
                        prod = pl.negacyclic_polymul(a, b, rhs_binary=binary)
                        if binary:
                            b2 = jax.tree_util.tree_map(
                                lambda v: jnp.roll(v, 1, axis=1), b
                            )
                            return (prod, b2)
                        return (prod, a)

                    return fn

                import jax

                yield f"{name}-{tier}-{n}", step(), (lhs, rhs_raw), BATCH
                if b1:
                    # single-poly latency: the latency-sensitive floor
                    yield (f"{name}-{tier}-{n}-b1", step(),
                           (lhs[:1], rhs_raw[:1]), 1)


def _product_benches(ns, want=lambda bid: True):
    """product-* ids (no reference bench analogue — benches/ntt.rs stops at
    the native plans; these cover the tfhe-rs hot path, product.rs:444-445):
        product-2xu32-{n}       fused 2-channel polymul, Replace
        product-2xu32-acc-{n}   same with Accumulate into a standard buffer
    """
    from concrete_ntt_tpu import product
    from concrete_ntt_tpu.ops.u32 import np_u64_to_limbs
    from concrete_ntt_tpu.tables import PRIMES32

    rng = np.random.default_rng(2)
    f1, f2 = PRIMES32[0], PRIMES32[1]
    m = f1 * f2
    for n in ns:
        if not (want(f"product-2xu32-{n}") or want(f"product-2xu32-acc-{n}")
                or want(f"product-2xu32-bounded-{n}")):
            continue
        plan = product.Plan.try_new(n, m, (f1, f2))
        if plan is None:
            continue
        mk = lambda: np_u64_to_limbs(
            rng.integers(0, m, (BATCH, n), dtype=np.uint64)
        )
        a, b, c = mk(), mk(), mk()
        bound = 1 << 20
        signed = rng.integers(-(bound // 2), bound // 2, (BATCH, n))
        ab = np_u64_to_limbs(
            np.array([[int(v) % m for v in row] for row in signed],
                     dtype=np.uint64)
        )

        def step_rep(pl=plan):
            def fn(carry):
                x, y = carry
                return (pl.negacyclic_polymul(x, y), x)

            return fn

        def step_acc(pl=plan):
            def fn(carry):
                x, y, acc = carry
                out = pl.negacyclic_polymul(
                    x, y, mode=product.ACCUMULATE, standard=acc
                )
                return (out, x, y)

            return fn

        def step_bnd(pl=plan, bound=bound):
            # the PBS accumulator operand is centered (product.rs:303-322);
            # the output is full-range, so it feeds the rhs slot while the
            # bounded operand rotates (stays centered, never loop-invariant).
            # The product MUST be the first carry leaf: the chain harness
            # reads only leaf[0], and anything it cannot reach is dead code.
            import jax.numpy as jnp

            def fn(carry):
                y, x = carry  # (last product, bounded operand)
                out = pl.negacyclic_polymul(
                    x, y, lhs_fwd_mode=product.bounded(bound)
                )
                return (out, jnp.roll(x, 1, axis=1))

            return fn

        yield f"product-2xu32-{n}", step_rep(), (a, b), BATCH
        yield f"product-2xu32-acc-{n}", step_acc(), (a, b, c), BATCH
        yield f"product-2xu32-bounded-{n}", step_bnd(), (b, ab), BATCH


def _large_n_benches(want=lambda bid: True):
    """Beyond-reference sizes: the reference's tables cap transforms at
    n = 2^15 (lib.rs:767-769); the ≡ 1 (mod 2^18) prime family
    (tables.primes32_ext) unlocks n up to 2^17. These rows put measured
    numbers behind that capability (--full grid only)."""
    from concrete_ntt_tpu import native64, prime32
    from concrete_ntt_tpu.ops.u32 import np_u64_to_limbs
    from concrete_ntt_tpu.tables import primes32_ext

    rng = np.random.default_rng(2)

    def two_el(op):
        def fn(carry):
            a, b = carry
            return (op(b), a)

        return fn

    p = primes32_ext()[0]
    for n in (1 << 16, 1 << 17):
        if want(f"fwd-32-{p}-{n}") or want(f"inv-32-{p}-{n}"):
            plan = prime32.Plan.try_new(n, p)
            if plan is not None:
                x = rng.integers(0, p, (BATCH, n), dtype=np.uint32)
                x2 = rng.integers(0, p, (BATCH, n), dtype=np.uint32)
                yield f"fwd-32-{p}-{n}", two_el(plan.fwd), (x, x2), BATCH
                yield f"inv-32-{p}-{n}", two_el(plan.inv), (x, x2), BATCH

    # prime64 large sizes (stage-split hybrid tier; Goldilocks' 2-adic
    # valuation 32 supports any n here)
    from concrete_ntt_tpu import prime64
    from concrete_ntt_tpu.utils.prime import (
        largest_prime_in_arithmetic_progression64 as prime_in_ap,
    )

    for n in (1 << 16, 1 << 17):
        ps64 = [prime_in_ap(2 * n, 1, 0, 1 << 50), prime64.Solinas]
        for p64 in ps64:
            if not (want(f"fwd-64-{p64}-{n}") or want(f"inv-64-{p64}-{n}")):
                continue
            plan = prime64.Plan.try_new(n, p64)
            if plan is None:
                continue
            x = np_u64_to_limbs(rng.integers(0, p64, (BATCH, n), dtype=np.uint64))
            x2 = np_u64_to_limbs(rng.integers(0, p64, (BATCH, n), dtype=np.uint64))
            yield f"fwd-64-{p64}-{n}", two_el(plan.fwd), (x, x2), BATCH
            yield f"inv-64-{p64}-{n}", two_el(plan.inv), (x, x2), BATCH

    n = 1 << 16
    if want(f"native64-32-{n}"):
        plan = native64.Plan32.try_new(n)
        if plan is not None:
            lhs = np_u64_to_limbs(
                rng.integers(0, 1 << 64, (BATCH, n), dtype=np.uint64)
            )
            rhs = np_u64_to_limbs(
                rng.integers(0, 1 << 64, (BATCH, n), dtype=np.uint64)
            )

            def step(pl=plan):
                def fn(carry):
                    a, b = carry
                    return (pl.negacyclic_polymul(a, b), a)

                return fn

            yield f"native64-32-{n}", step(), (lhs, rhs), BATCH

    # north-star single-device shape (BASELINE.json configs[4] on one card):
    # full-width u128 polymul at N=2^16 over the ext-prime channels
    if want(f"native128-32-{n}"):
        from concrete_ntt_tpu import native128
        from concrete_ntt_tpu.ops.u32 import np_u128_to_limbs

        plan = native128.Plan32.try_new(n)
        if plan is not None:
            def mk128():
                vals = rng.integers(0, 1 << 62, (BATCH, n), dtype=np.uint64)
                return np.stack(
                    [np_u128_to_limbs([int(v) for v in row]) for row in vals]
                )

            lhs, rhs = mk128(), mk128()

            def step128(pl=plan):
                def fn(carry):
                    a, b = carry
                    return (pl.negacyclic_polymul(a, b), a)

                return fn

            yield f"native128-32-{n}", step128(), (lhs, rhs), BATCH

    # fused 2-channel product plan beyond the reference's size cap (the
    # tfhe-rs hot-path shape at 2^16; 2^15 rides the --full grid already)
    if want(f"product-2xu32-{n}"):
        from concrete_ntt_tpu import product
        from concrete_ntt_tpu.tables import primes32_ext

        f1, f2 = primes32_ext()[0], primes32_ext()[1]
        m = f1 * f2
        plan = product.Plan.try_new(n, m, (f1, f2))
        if plan is not None:
            a = np_u64_to_limbs(rng.integers(0, m, (BATCH, n), dtype=np.uint64))
            b = np_u64_to_limbs(rng.integers(0, m, (BATCH, n), dtype=np.uint64))

            def step_prod(pl=plan):
                def fn(carry):
                    x, y = carry
                    return (pl.negacyclic_polymul(x, y), x)

                return fn

            yield f"product-2xu32-{n}", step_prod(), (a, b), BATCH


def _roofline_floor_ns(args, kind: str, batch=BATCH) -> float:
    """Optimistic per-poly lower bound from ideal HBM traffic at the
    device's published peak: every chain step must at least read its
    operand leaves and write one output of the same order. A row measuring
    below this is physically impossible and is re-measured / flagged
    instead of recorded as-is."""
    import jax

    from concrete_ntt_tpu.utils.profiling import peaks

    # per chain step, traffic >= the carry size (operands in + output out
    # always meets or exceeds it) -> a conservative floor that never
    # overestimates
    nbytes = sum(int(np.prod(l.shape)) * l.dtype.itemsize
                 for l in jax.tree_util.tree_leaves(args))
    return (nbytes / batch) / peaks(kind)["hbm_bytes_per_s"] * 1e9


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true", help="reference's full n grid")
    ap.add_argument("--ids", nargs="*", help="only run these bench ids")
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "results.jsonl"))
    ap.add_argument("--resume", action="store_true",
                    help="skip ids already present in --out; append new ones")
    args = ap.parse_args()
    ns = FULL_NS if args.full else QUICK_NS

    from concrete_ntt_tpu.utils.runtime import enable_compile_cache, require_gpu

    device = require_gpu()
    enable_compile_cache()

    done = set()
    if args.resume and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    done.add(json.loads(line)["id"])
                except Exception:
                    pass
    mode = "a" if args.resume else "w"
    with open(args.out, mode) as f:
        def want(bid):
            if args.ids and bid not in args.ids:
                return False
            return bid not in done

        import itertools

        all_benches = itertools.chain(
            _prime_benches(ns, want), _native_benches(ns, want),
            _product_benches(ns, want),
            _large_n_benches(want) if args.full or args.ids else iter(()),
        )
        for bid, fn, x, batch in all_benches:
            if not want(bid):
                continue
            try:
                t, stats = _chain_time(fn, x)
                floor_ns = _roofline_floor_ns(x, device["kind"], batch)
                suspect = t / batch * 1e9 < floor_ns
                if suspect:  # impossible: below the HBM roofline — once more
                    t, stats = _chain_time(fn, x)
                    suspect = t / batch * 1e9 < floor_ns
            except Exception as exc:  # pragma: no cover - report and continue
                err = {"id": bid, "error": str(exc)[:200], "device": device}
                print(json.dumps(err), flush=True)
                # error rows go to the results file too, so missing grid ids
                # are auditable instead of silently vanishing
                f.write(json.dumps(err) + "\n")
                f.flush()
                continue
            rec = {
                "id": bid,
                "batch": batch,
                "ns_per_poly": round(t / batch * 1e9, 1),
                "polys_per_sec": round(batch / t, 1),
                # dispersion over interleaved reps (criterion mean+std_dev
                # parity; answers "is a cross-grid delta real or wobble?")
                "ns_per_poly_med": round(stats["t_med"] / batch * 1e9, 1),
                "ns_per_poly_max": round(stats["t_max"] / batch * 1e9, 1),
                "reps": stats["reps"],
                "type": "latency",  # parity: ci/benchmark_parser.py:151
                "device": device,
            }
            if suspect:
                rec["suspect"] = True  # still under the roofline floor
            print(json.dumps(rec), flush=True)
            f.write(json.dumps(rec) + "\n")
            f.flush()


if __name__ == "__main__":
    main()
