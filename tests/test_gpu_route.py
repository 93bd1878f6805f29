"""The engine routing table (ops/ntt_dispatch.route) and every Plan driven
through the GPU route on the CPU backend, against the golden models.

The `gpu_route` fixture makes the router see a GPU, so these tests run the
exact engines 'auto' picks on the card (the four-step family), at n = 2048,
the smallest size they serve."""

import numpy as np
import pytest

import jax.numpy as jnp

from concrete_ntt_tpu import (
    native32,
    native64,
    native128,
    native_binary32,
    native_binary64,
    native_binary128,
    product,
)
from concrete_ntt_tpu.golden import polymul as gpoly
from concrete_ntt_tpu.ops import ntt_dispatch
from concrete_ntt_tpu.ops.u32 import np_u64_to_limbs
from concrete_ntt_tpu.tables import PRIMES32, PRIMES52

N = 2048
B = 2


# -- the routing table --------------------------------------------------------


def test_route_gpu_picks_the_four_step_family(gpu_route):
    assert ntt_dispatch.route(32, 1 << 14) == "mxu"
    assert ntt_dispatch.route(64, 1 << 14) == "mxu"
    assert ntt_dispatch.route(64, 1 << 15) == "hybrid"
    assert ntt_dispatch.served_by(32, 1 << 14, PRIMES32[0]) == "mxu"
    assert ntt_dispatch.served_by(64, 1 << 14, PRIMES52[0]) == "mxu"
    assert ntt_dispatch.served_by(64, 1 << 15, PRIMES52[0]) == "hybrid"


def test_route_gpu_falls_back_where_the_four_step_does_not_apply(gpu_route):
    # below the four-step floor (n >= 2048) the stage engine serves
    assert ntt_dispatch.served_by(32, 1024, PRIMES32[0]) == "xla"
    assert ntt_dispatch.served_by(64, 1024, PRIMES52[0]) == "xla"


def test_route_cpu_keeps_the_stage_engine(monkeypatch):
    monkeypatch.delenv("CONCRETE_NTT_TPU_ENGINE", raising=False)
    monkeypatch.setattr(ntt_dispatch, "_platform", lambda: "cpu")
    for width in (32, 64):
        for n in (1024, 1 << 14, 1 << 16):
            assert ntt_dispatch.route(width, n) == "xla"


@pytest.mark.parametrize("platform", ["rocm", "metal", "xpu"])
def test_route_unknown_platform_raises(monkeypatch, platform):
    monkeypatch.delenv("CONCRETE_NTT_TPU_ENGINE", raising=False)
    monkeypatch.setattr(ntt_dispatch, "_platform", lambda: platform)
    with pytest.raises(RuntimeError, match="no engine routing"):
        ntt_dispatch.route(32, 1 << 14)


def test_route_override(gpu_route, monkeypatch):
    monkeypatch.setenv("CONCRETE_NTT_TPU_ENGINE", "xla")
    assert ntt_dispatch.route(32, 1 << 14) == "xla"
    assert ntt_dispatch.served_by(64, 1 << 15, PRIMES52[0]) == "xla"
    monkeypatch.setattr(ntt_dispatch, "_platform", lambda: "cpu")
    monkeypatch.setenv("CONCRETE_NTT_TPU_ENGINE", "mxu")
    assert ntt_dispatch.route(32, 1 << 14) == "mxu"
    assert ntt_dispatch.route(64, 1 << 15) == "hybrid"


@pytest.mark.parametrize("value", ["pallas", "hybrid", "stage"])
def test_route_rejects_unknown_override(monkeypatch, value):
    monkeypatch.setenv("CONCRETE_NTT_TPU_ENGINE", value)
    with pytest.raises(ValueError, match="CONCRETE_NTT_TPU_ENGINE"):
        ntt_dispatch.route(32, 1 << 14)


# -- every Plan through the GPU route ---------------------------------------


def _u(rng, bits, binary=False):
    hi = 2 if binary else 1 << bits
    return rng.integers(0, hi, (B, N), dtype=np.uint64)


def _wrap_oracle(lhs, rhs, bits):
    dt = np.uint32 if bits == 32 else np.uint64
    return np.stack([
        gpoly.negacyclic_convolution_wrapping_np(a.astype(dt), b.astype(dt))
        for a, b in zip(lhs, rhs)
    ])


@pytest.mark.parametrize(
    "module,tier,bits,binary",
    [
        (native32, "Plan32", 32, False),
        (native32, "Plan52", 32, False),
        (native64, "Plan32", 64, False),
        (native64, "Plan52", 64, False),
        (native_binary32, "Plan32", 32, True),
        (native_binary32, "Plan52", 32, True),
        (native_binary64, "Plan32", 64, True),
        (native_binary64, "Plan52", 64, True),
    ],
)
def test_native_plan_polymul_gpu_route(rng, gpu_route, module, tier, bits, binary):
    plan = getattr(module, tier).try_new(N)
    assert plan is not None
    lhs, rhs = _u(rng, bits), _u(rng, bits, binary)
    if bits == 32:
        got = np.asarray(plan.negacyclic_polymul(
            jnp.asarray(lhs.astype(np.uint32)), jnp.asarray(rhs.astype(np.uint32))))
    else:
        got = plan.negacyclic_polymul(lhs, rhs)
    np.testing.assert_array_equal(got, _wrap_oracle(lhs, rhs, bits))


@pytest.mark.parametrize("module", [native128, native_binary128])
def test_native128_polymul_gpu_route(rng, gpu_route, module):
    plan = module.Plan32.try_new(N)
    assert plan is not None
    binary = module is native_binary128
    la = rng.integers(0, 1 << 32, (B, N, 4), dtype=np.uint64).astype(np.uint32)
    lb = rng.integers(0, 1 << 32, (B, N, 4), dtype=np.uint64).astype(np.uint32)
    if binary:
        lb = np.zeros_like(lb)
        lb[..., 0] = rng.integers(0, 2, (B, N), dtype=np.uint32)
    planar = lambda l: tuple(jnp.asarray(l[..., i]) for i in range(4))
    out = np.stack([np.asarray(a) for a in plan.negacyclic_polymul(
        planar(la), planar(lb))], axis=-1).astype(object)
    ints = lambda l: sum(l[..., i].astype(object) << (32 * i) for i in range(4))
    got, a, b = ints(out), ints(la), ints(lb)
    ks = [0, 1, 7, N // 2, N - 2, N - 1]
    for r in range(B):
        want = gpoly.negacyclic_coefficients(a[r], b[r], ks, 1 << 128)
        assert [got[r][k] for k in ks] == want


@pytest.mark.parametrize(
    "mode", ["generic-replace", "generic-accumulate", "bounded-replace"]
)
def test_product_polymul_gpu_route(rng, gpu_route, mode):
    f1, f2 = PRIMES32[0], PRIMES32[1]
    m = f1 * f2
    plan = product.Plan.new(N, m, (f1, f2))
    if mode.startswith("bounded"):
        bound = 1 << 20
        signed = rng.integers(-(bound // 2), bound // 2, (B, N))
        lhs = (signed % m).astype(np.uint64)
        kw = {"lhs_fwd_mode": product.bounded(bound)}
    else:
        lhs = rng.integers(0, m, (B, N), dtype=np.uint64)
        kw = {}
    rhs = rng.integers(0, m, (B, N), dtype=np.uint64)
    acc = rng.integers(0, m, (B, N), dtype=np.uint64)
    if mode.endswith("accumulate"):
        kw.update(mode=product.ACCUMULATE, standard=acc)
    got = plan.negacyclic_polymul(lhs, rhs, **kw)
    ks = [0, 1, N // 3, N - 1]
    for r in range(B):
        want = gpoly.negacyclic_coefficients(lhs[r], rhs[r], ks, m)
        if mode.endswith("accumulate"):
            want = [(w + int(acc[r][k])) % m for w, k in zip(want, ks)]
        assert [int(got[r][k]) for k in ks] == want


def test_product_fwd_inv_roundtrip_gpu_route(rng, gpu_route):
    f1, f2 = PRIMES32[0], PRIMES32[1]
    m = f1 * f2
    plan = product.Plan.new(N, m, (f1, f2))
    x = rng.integers(0, m, (B, N), dtype=np.uint64)
    dom = plan.fwd(jnp.asarray(np_u64_to_limbs(x)))
    back = plan.inv(plan.normalize(dom))
    np.testing.assert_array_equal(back, x)
