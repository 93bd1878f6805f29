"""Sharded x stage-split-hybrid composition (round-3 verdict item 4).

Round 3 landed the stage-split hybrid (ops/stagesplit.py) and the sharded
paths (parallel/), but no test exercised them TOGETHER: dryrun/mesh tests
ran at n <= 4096 where the hybrid never engages, and the channel-sharded
local sections bypass dispatch by construction. This suite makes the
composition *asserted*, the repo's standard:

* the hybrid engines actually engage INSIDE shard_map local sections
  (dp-sharded batch, dispatch-served transforms at n = 2^15), asserted
  both bit-exactly vs the unsharded path and via a trace-time call spy;
* the channel-sharded classes (ChannelShardedNative 32 + 52) run an
  n >= 2^15 config against the single-device plan served by the GPU
  route's engines, bit-exactly.

All on the virtual 8-device CPU mesh (conftest).
"""

import numpy as np

import jax
import jax.numpy as jnp
import pytest
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from concrete_ntt_tpu import native64, native128
from concrete_ntt_tpu.ops import ntt_dispatch as nd
from concrete_ntt_tpu.ops import stagesplit
from concrete_ntt_tpu.utils.prime import (
    largest_prime_in_arithmetic_progression64 as lpap,
)


def _dp_mesh(d):
    return jax.sharding.Mesh(np.array(jax.devices()[:d]), ("dp",))


def _limbs64(rng, b, n):
    x = rng.integers(0, 1 << 64, (b, n), dtype=np.uint64)
    return (
        jnp.asarray((x & 0xFFFFFFFF).astype(np.uint32)),
        jnp.asarray((x >> np.uint64(32)).astype(np.uint32)),
    )


def _hybrid_env(monkeypatch):
    monkeypatch.setattr(nd, "_platform", lambda: "gpu")


@pytest.mark.slow
def test_hybrid64_engages_inside_shard_map(rng, cpu_mesh_devices, monkeypatch):
    """prime64 fwd+inv at n=2^15 through ntt_dispatch INSIDE a dp-sharded
    shard_map local section: the hybrid tier must engage (call spy) and the
    sharded result must equal the unsharded dispatch result bit-for-bit."""
    _hybrid_env(monkeypatch)
    n = 1 << 15
    p = lpap(2 * n, 1, 0, 1 << 50)
    assert nd.served_by(64, n, p) == "hybrid"

    calls = {"fwd": 0, "inv": 0}
    real_fwd, real_inv = stagesplit.fwd64, stagesplit.inv64

    def spy_fwd(*a, **k):
        calls["fwd"] += 1
        return real_fwd(*a, **k)

    def spy_inv(*a, **k):
        calls["inv"] += 1
        return real_inv(*a, **k)

    monkeypatch.setattr(stagesplit, "fwd64", spy_fwd)
    monkeypatch.setattr(stagesplit, "inv64", spy_inv)

    limbs = _limbs64(rng, 4, n)
    want_f = nd.try_fwd64(limbs, n, p)
    assert want_f is not None and calls["fwd"] == 1
    want_i = nd.try_inv64(want_f, n, p, scale=7)
    assert calls["inv"] == 1

    mesh = _dp_mesh(4)
    sh = NamedSharding(mesh, P("dp", None))
    xd = tuple(jax.device_put(a, sh) for a in limbs)

    def local(lo, hi):
        f = nd.try_fwd64((lo, hi), n, p)
        i = nd.try_inv64(f, n, p, scale=7)
        return f + i

    sharded = jax.jit(
        shard_map(
            local, mesh=mesh,
            in_specs=(P("dp", None),) * 2,
            out_specs=(P("dp", None),) * 4,
            check_vma=False,
        )
    )
    got = sharded(*xd)
    # the spy counts trace-time calls: the local section engaged the hybrid
    assert calls["fwd"] == 2 and calls["inv"] == 2
    for g, w in zip(got, want_f + want_i):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.slow
def test_channel_sharded_52_at_2pow15_vs_hybrid_single_device(
    rng, cpu_mesh_devices, monkeypatch
):
    """ChannelShardedNative52 at n=2^15 (the first size the hybrid serves)
    vs the single-device Plan52 polymul served by the GPU route: the sharded
    traced-scalar local sections and the four-step engines must agree
    bit-for-bit end to end."""
    n = 1 << 15
    plan = native64.Plan52.try_new(n)
    assert plan is not None
    devs = np.array(jax.devices()[:6]).reshape(2, 3)
    mesh = jax.sharding.Mesh(devs, ("dp", "ch"))
    from concrete_ntt_tpu.parallel.channels import ChannelShardedNative52

    sharded = ChannelShardedNative52(plan, mesh, ch_axis="ch", batch_axis="dp")
    lhs = rng.integers(0, 1 << 64, (2, n), dtype=np.uint64)
    rhs = rng.integers(0, 1 << 64, (2, n), dtype=np.uint64)
    got = np.asarray(sharded.negacyclic_polymul(lhs, rhs))

    _hybrid_env(monkeypatch)
    want = np.asarray(plan.negacyclic_polymul(lhs, rhs))
    np.testing.assert_array_equal(got, want)


@pytest.mark.slow
def test_channel_sharded_32_sp_at_2pow15_vs_hybrid_single_device(
    rng, cpu_mesh_devices, monkeypatch
):
    """ChannelShardedNative (native128 Plan32, dp x ch x sp with the
    four-step all-to-all) at n=2^15 vs the single device served by the
    four-step dispatch tier (ntt_dispatch.try_fwd32_wide_all)."""
    n = 1 << 15
    plan = native128.Plan32.try_new(n)
    assert plan is not None
    mesh = jax.make_mesh((2, 2, 2), ("dp", "ch", "sp"))
    from concrete_ntt_tpu.parallel.channels import ChannelShardedNative

    sharded = ChannelShardedNative(
        plan, mesh, ch_axis="ch", batch_axis="dp", sp_axis="sp"
    )
    lhs = rng.integers(0, 1 << 32, (2, n, 4), dtype=np.uint32)
    rhs = rng.integers(0, 1 << 32, (2, n, 4), dtype=np.uint32)
    got = np.asarray(sharded.negacyclic_polymul(lhs, rhs))

    _hybrid_env(monkeypatch)
    want = np.asarray(plan.negacyclic_polymul(lhs, rhs))
    np.testing.assert_array_equal(got, want)
