"""Smoke run of the main path on the card.

One card (no arguments): every Plan call of the headline path runs under
jit at full width, through the normal Plan APIs and the engines 'auto'
routes to, and is compared bit-exact with an independent plain reference
(concrete_ntt_tpu.golden). Then the interleaved engine A/B that sets the
GPU routing runs (stage engine vs four-step, turns A B B A).

Four cards (--four-cards): only the channel-sharded native128 polymul at
N = 2^16 on a ch = 2 x sp = 2 mesh, compared bit-exact with the one-card
native128.Plan32 result.

Earlier lines report the device, the card's name and power limit, whether
the native C++ host tier loaded, compile time and engine per phase, and the
A/B timings. The last line is exactly
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
It exits non-zero without that line when JAX finds no GPU or any phase
fails. One process drives the card(s).

Usage: python chip_smoke.py [--four-cards]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

N = 1 << 14  # the headline size
N128 = 1 << 16  # the native128 north-star size
BATCH = 8
BATCH128 = 2
N_COEFFS = 16  # coefficients checked per row by the O(n) bigint oracle
AB_CALLS = 50  # back-to-back calls per A/B sample


def _say(**fields):
    print(json.dumps(fields), flush=True)


def _compile_and_run(fn, *args):
    """Compile fn under jit, run it once; (numpy outputs, compile seconds)."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    t_compile = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(*args))
    return jax.tree_util.tree_map(np.asarray, out), t_compile


def _u64(pair_or_limbs):
    """(lo, hi) planar tuple or [..., 2] limb array -> numpy uint64."""
    if isinstance(pair_or_limbs, tuple):
        lo, hi = (np.asarray(a).astype(np.uint64) for a in pair_or_limbs)
    else:
        a = np.asarray(pair_or_limbs).astype(np.uint64)
        lo, hi = a[..., 0], a[..., 1]
    return lo | (hi << np.uint64(32))


def _planar64(v: np.ndarray):
    import jax.numpy as jnp

    return (
        jnp.asarray((v & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
        jnp.asarray((v >> np.uint64(32)).astype(np.uint32)),
    )


def _planar(limbs: np.ndarray):
    """[..., nlimbs] limb array -> planar tuple of device arrays, the
    performance format (the engines consume limbs planar)."""
    import jax.numpy as jnp

    return tuple(jnp.asarray(limbs[..., i]) for i in range(limbs.shape[-1]))


def _ints128(limbs: np.ndarray):
    """uint32 limb array [..., 4] -> Python ints (object array [...])."""
    l = np.asarray(limbs).astype(object)
    return l[..., 0] + (l[..., 1] << 32) + (l[..., 2] << 64) + (l[..., 3] << 96)


def _rows(batch):
    """Rows checked against the per-row oracles: the first and the last."""
    return sorted({0, batch - 1})


def _check(name, got, want):
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = int(np.sum(got != want)) if got.shape == want.shape else "shape"
        raise AssertionError(f"{name}: not bit-exact ({bad} mismatches)")


# ---------------------------------------------------------------------------
# Phases: each runs one Plan call under jit and checks it against golden/
# ---------------------------------------------------------------------------


def phase_prime32(rng, n, batch, p):
    from concrete_ntt_tpu import prime32
    from concrete_ntt_tpu.golden import ntt as golden

    plan = prime32.Plan.new(n, p)
    x = rng.integers(0, p, (batch, n), dtype=np.uint32)
    (y, z), t_c = _compile_and_run(lambda a: (plan.fwd(a), plan.inv(plan.fwd(a))), x)
    for r in _rows(batch):
        _check(f"prime32 fwd p={p} row {r}", y[r], golden.fwd([int(v) for v in x[r]], p))
        _check(f"prime32 inv p={p} row {r}", z[r], golden.inv([int(v) for v in y[r]], p))
    _check(f"prime32 inv(fwd) p={p}", z, (x.astype(np.uint64) * n % p).astype(np.uint32))
    return {"compile_s": t_c, "width": 32, "n": n, "p": p}


def phase_prime64(rng, n, batch, p):
    import jax.numpy as jnp

    from concrete_ntt_tpu import prime64
    from concrete_ntt_tpu.golden import ntt as golden
    from concrete_ntt_tpu.ops.u32 import np_u64_to_limbs

    plan = prime64.Plan.new(n, p)
    x = rng.integers(0, p, (batch, n), dtype=np.uint64)
    xl = jnp.asarray(np_u64_to_limbs(x))
    (y, z), t_c = _compile_and_run(lambda a: (plan.fwd(a), plan.inv(plan.fwd(a))), xl)
    y64, z64 = _u64(y), _u64(z)
    for r in _rows(batch):
        _check(f"prime64 fwd p={p} row {r}", y64[r],
               np.array(golden.fwd([int(v) for v in x[r]], p), dtype=np.uint64))
        _check(f"prime64 inv p={p} row {r}", z64[r],
               np.array(golden.inv([int(v) for v in y64[r]], p), dtype=np.uint64))
    want = np.array([[int(v) * n % p for v in row] for row in x], dtype=np.uint64)
    _check(f"prime64 inv(fwd) p={p}", z64, want)
    return {"compile_s": t_c, "width": 64, "n": n, "p": p}


def phase_native64(rng, n, batch, module, tier, binary=False):
    from concrete_ntt_tpu.golden.polymul import negacyclic_convolution_wrapping_np

    plan = getattr(module, tier).try_new(n)
    a = rng.integers(0, 1 << 64, (batch, n), dtype=np.uint64)
    b = rng.integers(0, 2 if binary else 1 << 64, (batch, n), dtype=np.uint64)
    out, t_c = _compile_and_run(
        lambda u, v: plan.negacyclic_polymul(u, v), _planar64(a), _planar64(b)
    )
    got = _u64(tuple(out))
    for r in _rows(batch):
        _check(f"{module.__name__}.{tier} row {r}", got[r],
               negacyclic_convolution_wrapping_np(a[r], b[r]))
    return {"compile_s": t_c, "width": 32 if tier == "Plan32" else 64, "n": n,
            "p": plan.primes[0]}


def phase_product(rng, n, batch):
    import jax.numpy as jnp

    from concrete_ntt_tpu import product
    from concrete_ntt_tpu.golden.polymul import negacyclic_coefficients
    from concrete_ntt_tpu.ops.u32 import np_u64_to_limbs
    from concrete_ntt_tpu.tables import PRIMES32

    f1, f2 = PRIMES32[0], PRIMES32[1]
    m = f1 * f2
    plan = product.Plan.new(n, m, (f1, f2))
    a = rng.integers(0, m, (batch, n), dtype=np.uint64)
    b = rng.integers(0, m, (batch, n), dtype=np.uint64)
    out, t_c = _compile_and_run(
        lambda u, v: plan.negacyclic_polymul(u, v, out_format="limbs"),
        jnp.asarray(np_u64_to_limbs(a)), jnp.asarray(np_u64_to_limbs(b)),
    )
    got = _u64(out)
    ks = _coeff_indices(rng, n)
    for r in _rows(batch):
        _check(f"product 2xu32 row {r}", got[r][ks],
               np.array(negacyclic_coefficients(a[r], b[r], ks, m), dtype=np.uint64))
    return {"compile_s": t_c, "width": 32, "n": n, "p": f1}


def phase_native128(rng, n, batch):
    from concrete_ntt_tpu import native128
    from concrete_ntt_tpu.golden.polymul import negacyclic_coefficients

    plan = native128.Plan32.try_new(n)
    la = rng.integers(0, 1 << 32, (batch, n, 4), dtype=np.uint64).astype(np.uint32)
    lb = rng.integers(0, 1 << 32, (batch, n, 4), dtype=np.uint64).astype(np.uint32)
    out, t_c = _compile_and_run(
        lambda u, v: plan.negacyclic_polymul(u, v), _planar(la), _planar(lb)
    )
    got = _ints128(np.stack(out, axis=-1))
    a, b = _ints128(la), _ints128(lb)
    ks = _coeff_indices(rng, n)
    for r in range(batch):
        want = negacyclic_coefficients(a[r], b[r], ks, 1 << 128)
        _check(f"native128.Plan32 row {r}", np.array(list(got[r][ks]), dtype=object),
               np.array(want, dtype=object))
    return {"compile_s": t_c, "width": 32, "n": n, "p": plan.primes[0]}


def _coeff_indices(rng, n):
    """N_COEFFS output indices: both ends (sign-flip boundary) + random."""
    ks = {0, 1, n - 2, n - 1}
    while len(ks) < min(N_COEFFS, n):
        ks.add(int(rng.integers(0, n)))
    return np.array(sorted(ks))


def main_phases(rng, n=N, batch=BATCH, n128=N128, batch128=BATCH128):
    """The one-card phases; yields (phase name, info dict) as each passes."""
    from concrete_ntt_tpu import native64, native_binary64, prime64
    from concrete_ntt_tpu.utils.prime import (
        largest_prime_in_arithmetic_progression64 as prime_in_ap,
    )

    step = 2 * max(n, 1 << 16)
    p_lt30 = prime_in_ap(step, 1, 1 << 29, 1 << 30)
    p_gen = prime_in_ap(step, 1, 1 << 31, (1 << 32) - 1)
    p50 = prime_in_ap(step, 1, 1 << 49, 1 << 50)
    yield "prime32-lt30", phase_prime32(rng, n, batch, p_lt30)
    yield "prime32-generic", phase_prime32(rng, n, batch, p_gen)
    yield "prime64-p50", phase_prime64(rng, n, batch, p50)
    yield "prime64-solinas", phase_prime64(rng, n, batch, prime64.Solinas)
    yield "native64-Plan32", phase_native64(rng, n, batch, native64, "Plan32")
    yield "native64-Plan52", phase_native64(rng, n, batch, native64, "Plan52")
    yield "native_binary64-Plan32", phase_native64(
        rng, n, batch, native_binary64, "Plan32", binary=True)
    yield "product-2xu32", phase_product(rng, n, batch)
    yield "native128-Plan32", phase_native128(rng, n128, batch128)


# ---------------------------------------------------------------------------
# Engine A/B: the measurement behind ntt_dispatch.ROUTES["gpu"]
# ---------------------------------------------------------------------------


def engine_ab(rng, n=N, batch=BATCH, calls=AB_CALLS):
    """Stage engine ('xla') vs four-step ('mxu') at n, batch, in one process,
    in turns A B B A. Each turn is the median of 5 samples of `calls`
    back-to-back calls timed on the host clock up to block_until_ready;
    warm-up excluded. Yields one dict per case."""
    import jax
    import jax.numpy as jnp

    from concrete_ntt_tpu import native64, prime32, prime64
    from concrete_ntt_tpu.ops.u32 import np_u64_to_limbs
    from concrete_ntt_tpu.utils.prime import (
        largest_prime_in_arithmetic_progression64 as prime_in_ap,
    )
    from concrete_ntt_tpu.utils.profiling import seconds_per_call

    p32 = prime_in_ap(2 * n, 1, 1 << 29, 1 << 30)
    p64 = prime_in_ap(2 * n, 1, 1 << 49, 1 << 50)
    pl32, pl64 = prime32.Plan.new(n, p32), prime64.Plan.new(n, p64)
    pn = native64.Plan32.try_new(n)
    x32 = jnp.asarray(rng.integers(0, p32, (batch, n), dtype=np.uint32))
    x64 = jnp.asarray(np_u64_to_limbs(rng.integers(0, p64, (batch, n), dtype=np.uint64)))
    lhs = _planar64(rng.integers(0, 1 << 64, (batch, n), dtype=np.uint64))
    rhs = _planar64(rng.integers(0, 1 << 64, (batch, n), dtype=np.uint64))
    cases = (
        ("prime32-fwd", lambda a: pl32.fwd(a), (x32,)),
        ("prime64-fwd", lambda a: pl64.fwd(a), (x64,)),
        ("native64-Plan32-polymul", lambda a, b: pn.negacyclic_polymul(a, b), (lhs, rhs)),
    )
    saved = os.environ.get("CONCRETE_NTT_TPU_ENGINE")
    try:
        for name, fn, args in cases:
            compiled, outs = {}, {}
            for eng in ("xla", "mxu"):
                os.environ["CONCRETE_NTT_TPU_ENGINE"] = eng
                compiled[eng] = jax.jit(lambda *a, fn=fn: fn(*a)).lower(*args).compile()
                outs[eng] = jax.block_until_ready(compiled[eng](*args))
            for lx, lm in zip(jax.tree_util.tree_leaves(outs["xla"]),
                              jax.tree_util.tree_leaves(outs["mxu"])):
                _check(f"A/B {name}: xla vs mxu", np.asarray(lx), np.asarray(lm))
            for eng in ("xla", "mxu"):  # warm-up
                seconds_per_call(compiled[eng], args, calls, samples=1)
            turns = {"xla": [], "mxu": []}
            for eng in ("xla", "mxu", "mxu", "xla"):
                turns[eng].append(seconds_per_call(compiled[eng], args, calls) * 1e6)
            yield {"case": name, "n": n, "batch": batch, "us_per_call": turns,
                   "faster": min(turns, key=lambda e: np.median(turns[e]))}
    finally:
        if saved is None:
            os.environ.pop("CONCRETE_NTT_TPU_ENGINE", None)
        else:
            os.environ["CONCRETE_NTT_TPU_ENGINE"] = saved


# ---------------------------------------------------------------------------
# Four cards: the channel-sharded native128 north-star path
# ---------------------------------------------------------------------------


def four_cards(rng, n=N128, batch=BATCH128):
    import jax

    from concrete_ntt_tpu import native128
    from concrete_ntt_tpu.parallel.channels import ChannelShardedNative

    devs = jax.devices()
    if len(devs) < 4:
        raise SystemExit(f"--four-cards needs 4 devices, found {len(devs)}")
    plan = native128.Plan32.try_new(n)
    lhs = rng.integers(0, 1 << 32, (batch, n, 4), dtype=np.uint32)
    rhs = rng.integers(0, 1 << 32, (batch, n, 4), dtype=np.uint32)
    mesh = jax.sharding.Mesh(np.array(devs[:4]).reshape(2, 2), ("ch", "sp"))
    sharded = ChannelShardedNative(plan, mesh, ch_axis="ch", sp_axis="sp")
    t0 = time.perf_counter()
    got = jax.block_until_ready(sharded.negacyclic_polymul(_planar(lhs), _planar(rhs)))
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(sharded.negacyclic_polymul(_planar(lhs), _planar(rhs)))
    t_second = time.perf_counter() - t0
    # per-device peaks before the one-card reference adds to device 0's
    peak = [(d.memory_stats() or {}).get("peak_bytes_in_use") for d in devs[:4]]
    # one card: the plain single-device plan on device 0
    with jax.default_device(devs[0]):
        want, t_one = _compile_and_run(
            lambda u, v: plan.negacyclic_polymul(u, v), _planar(lhs), _planar(rhs)
        )
    got, want = np.stack(got, axis=-1), np.stack(want, axis=-1)
    _check("native128 ch=2 x sp=2 vs one card", got, want)
    return {"n": n, "batch": batch, "mesh": {"ch": 2, "sp": 2},
            "four_card_first_call_s": t_first, "four_card_second_call_s": t_second,
            "one_card_compile_s": t_one, "peak_bytes_in_use": peak}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the channel-sharded native128 path on 4 cards")
    args = ap.parse_args(argv)

    from concrete_ntt_tpu.utils.runtime import (
        card_name_and_power_limit,
        enable_compile_cache,
        require_gpu,
    )

    device = require_gpu()
    _say(device=device, compile_cache=enable_compile_cache())
    print(card_name_and_power_limit(), flush=True)

    from concrete_ntt_tpu import _native
    from concrete_ntt_tpu.ops import ntt_dispatch

    _say(native_host_tier_loaded=_native.lib() is not None)
    rng = np.random.default_rng(2024)
    if args.four_cards:
        _say(phase="four-cards-native128", **four_cards(rng), **{"pass": True})
    else:
        for name, info in main_phases(rng):
            info["engine"] = ntt_dispatch.served_by(info["width"], info["n"], info["p"])
            _say(phase=name, **info, **{"pass": True})
        for row in engine_ab(rng):
            _say(ab=row)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
