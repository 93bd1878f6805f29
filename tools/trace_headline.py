"""Trace the headline polymul on the card and reduce the trace to the top
device operations, the device's busy share and roofline shares.

The headline is native64.Plan32.negacyclic_polymul at N = 2^14, B = 8 with
planar (lo, hi) u32 limbs (bench.py). For each engine asked for, a short
window of calls is traced with jax.profiler after warm-up; the reduction
(utils/profiling.device_op_times) sums device time per operation, and
the optimized HLO gives each operation's bytes read + written
(utils/profiling.hlo_op_bytes) for its HBM roofline share. The int8 dot
operations are also set against the four-step's analytic int8 operation
count. Prints one JSON line per engine; traces go under --out.

Usage: python tools/trace_headline.py [--engines auto xla mxu] [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

N = 1 << 14
BATCH = 8
CALLS = 10


def headline_int8_ops(n: int, batch: int, channels: int) -> int:
    """int8 operations of one native64 Plan32 polymul on the four-step
    engine: per channel two wide forwards (u64 operand: 8 digit planes in
    the column pass) and one inverse (4 planes in both passes)."""
    from concrete_ntt_tpu.utils.profiling import fourstep_int8_ops

    fwd = fourstep_int8_ops(n, batch, e_col=8, e_row=4)
    inv = fourstep_int8_ops(n, batch, e_col=4, e_row=4)
    return channels * (2 * fwd + inv)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--engines", nargs="+", default=["auto"],
                    choices=["auto", "xla", "mxu"])
    ap.add_argument("--out", default="chiprun_out/traces")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()

    from concrete_ntt_tpu.utils.runtime import (
        card_name_and_power_limit,
        enable_compile_cache,
        require_gpu,
    )

    device = require_gpu()
    enable_compile_cache()
    card = card_name_and_power_limit()

    import jax

    from concrete_ntt_tpu import native64
    from concrete_ntt_tpu.utils.profiling import (
        Roofline,
        device_op_times,
        hlo_op_bytes,
        peaks,
        seconds_per_call,
    )

    peak = peaks(device["kind"])
    plan = native64.Plan32.try_new(N)
    rng = np.random.default_rng(0)

    def planar(v):
        return (jax.numpy.asarray((v & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
                jax.numpy.asarray((v >> np.uint64(32)).astype(np.uint32)))

    lhs = planar(rng.integers(0, 1 << 64, (BATCH, N), dtype=np.uint64))
    rhs = planar(rng.integers(0, 1 << 64, (BATCH, N), dtype=np.uint64))
    for eng in args.engines:
        os.environ["CONCRETE_NTT_TPU_ENGINE"] = eng
        compiled = jax.jit(
            lambda a, b: plan.negacyclic_polymul(a, b)).lower(lhs, rhs).compile()
        hlo = compiled.as_text()
        op_bytes = hlo_op_bytes(hlo)
        seconds_per_call(compiled, (lhs, rhs), CALLS, samples=2)  # warm-up
        t_call = seconds_per_call(compiled, (lhs, rhs), 50)
        out_dir = os.path.join(args.out, eng)
        jax.profiler.start_trace(out_dir)
        for _ in range(CALLS):
            jax.block_until_ready(compiled(lhs, rhs))
        jax.profiler.stop_trace()
        with open(os.path.join(out_dir, "hlo.txt"), "w") as f:
            f.write(hlo)
        ops, win = device_op_times(out_dir)
        total = sum(t for _, t in ops.values())
        is_dot = lambda name: "gemm" in name or "dot" in name or "cublas" in name
        dot_ns = sum(t for k, (_, t) in ops.items() if is_dot(k))
        dot = {}
        if dot_ns:
            roof = Roofline(
                seconds=dot_ns / CALLS * 1e-9,
                hbm_bytes=sum(op_bytes.get(k, 0) for k in ops if is_dot(k)),
                int8_ops=headline_int8_ops(N, BATCH, len(plan.primes)),
                kind=device["kind"])
            dot = {"int8_dot_int8_roofline_share": round(roof.int8_share, 4),
                   "int8_dot_hbm_roofline_share": round(roof.hbm_share, 4)}
        top = []
        for name, (count, ns) in sorted(ops.items(), key=lambda kv: -kv[1][1])[: args.top]:
            per_call = ns / CALLS * 1e-9
            nbytes = op_bytes.get(name, 0)
            top.append({
                "op": name, "count_per_call": count // CALLS,
                "us_per_call": round(per_call * 1e6, 2),
                "share_of_device_time": round(ns / total, 4),
                "bytes_per_call": nbytes,
                "hbm_roofline_share": round(nbytes / per_call / peak["hbm_bytes_per_s"], 4)
                if per_call else None,
            })
        step_bytes = 3 * BATCH * N * 8  # two u64 operands in, one out
        print(json.dumps({
            "engine": eng, "device": device, "card": card,
            "n": N, "batch": BATCH,
            "us_per_call_host": round(t_call * 1e6, 2),
            "device_us_per_call": round(total / CALLS / 1e3, 2),
            "ops_per_call": sum(c for c, _ in ops.values()) // CALLS,
            "busy_share_of_window": round(win["busy_ns"] / win["window_ns"], 4),
            "step_hbm_roofline_share": round(step_bytes / t_call / peak["hbm_bytes_per_s"], 5),
            "int8_dot_us_per_call": round(dot_ns / CALLS / 1e3, 2),
            "int8_dot_share_of_device_time": round(dot_ns / total, 4),
            **dot,
            "top_ops": top,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
