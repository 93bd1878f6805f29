"""Interleaved A/B of the Garner lift: elementwise u32 chains (ops/crt) vs the
int8 digit-plane accumulation (crt_mxu), in ONE process.

crt_mxu moves the mixed-radix accumulation (phase 2 of the lift) into an
int8 matmul; this tool measures both implementations of both lifts with
the chain-difference method, interleaved, min-of-reps. On the CPU backend
it runs one short round at small sizes (a smoke run, not a measurement).

Usage: python tools/ab_lift.py [--reps 5] [--length 64]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--length", type=int, default=None)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from concrete_ntt_tpu import crt_mxu
    from concrete_ntt_tpu.ops import crt
    from concrete_ntt_tpu.tables import native_channel_primes
    from concrete_ntt_tpu.utils.profiling import chain_time
    from concrete_ntt_tpu.utils.runtime import device_info

    rng = np.random.default_rng(0)
    on_cpu = jax.devices()[0].platform == "cpu"
    length = args.length or (2 if on_cpu else 64)

    def mk(c, b, n):
        return jnp.asarray(
            rng.integers(0, 1 << 30, (c, b, n), dtype=np.uint32)
        )

    def step64(rec):
        def step(carry):
            t, prev = carry
            mods = [t[i] for i in range(5)]
            lo, hi = rec(mods, primes5)
            nxt = jnp.stack(
                [lo, hi, lo + np.uint32(1), hi ^ lo, lo - hi], axis=0
            )
            return (nxt, t)

        return step

    def step128(rec):
        def step(carry):
            t, prev = carry
            mods = [t[i] for i in range(10)]
            l0, l1, l2, l3 = rec(mods, primes10)
            nxt = jnp.stack(
                [l0, l1, l2, l3, l0 ^ l1, l1 + l2, l2 - l3, l3 ^ l0,
                 l0 + np.uint32(1), l1 - np.uint32(1)], axis=0
            )
            return (nxt, t)

        return step

    n64, n128 = 1 << 14, (1 << 12 if on_cpu else 1 << 16)
    b = 8
    primes5 = native_channel_primes(5, n64)
    primes10 = native_channel_primes(10, n128)
    legs = [
        ("u64from5-crt", step64(crt.rec_u64_from5), (5, b, n64)),
        ("u64from5-mxu", step64(crt_mxu.rec_u64_from5), (5, b, n64)),
        ("u128from10-crt", step128(crt.rec_u128_from10), (10, b, n128)),
        ("u128from10-mxu", step128(crt_mxu.rec_u128_from10), (10, b, n128)),
    ]
    results = {}
    for _ in range(1 if on_cpu else args.rounds):
        for name, step, shape in legs:
            t0 = mk(*shape)
            t = chain_time(step, (t0, t0), length=length, reps=args.reps)
            per = t / b * 1e9
            results[name] = min(results.get(name, float("inf")), per)
            print(json.dumps({"leg": name, "ns_per_poly": round(per, 1),
                              "device": device_info()}), flush=True)
    for fam in ("u64from5", "u128from10"):
        a, m = results[f"{fam}-crt"], results[f"{fam}-mxu"]
        print(json.dumps({"family": fam, "crt_ns": round(a, 1),
                          "mxu_ns": round(m, 1),
                          "speedup": round(a / m, 3)}), flush=True)


if __name__ == "__main__":
    main()
