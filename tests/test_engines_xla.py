"""The plain-XLA four-step engines (ops/mxu32.py, ops/mxu64.py) against the
stage engine, at the sizes and batches the GPU route serves them with:
every prime regime, n = 2048 and 4096, B in {1, 3, 8}. int8 dot_general
with int32 accumulation is exact on every backend, so equality is to the
bit."""

import numpy as np
import pytest

import jax.numpy as jnp

from concrete_ntt_tpu import prime32, prime64
from concrete_ntt_tpu.ops import mxu32, mxu64
from concrete_ntt_tpu.ops.u32 import np_u64_to_limbs
from concrete_ntt_tpu.tables import GOLDILOCKS
from concrete_ntt_tpu.utils.prime import (
    largest_prime_in_arithmetic_progression64 as lpap,
)

SIZES = [2048, 4096]
BATCHES = [1, 3, 8]


def _prime32(regime, n):
    lo, hi = {"lt30": (0, 1 << 30), "lt31": (1 << 30, 1 << 31),
              "generic": (1 << 31, (1 << 32) - 1)}[regime]
    return lpap(2 * n, 1, lo, hi)


def _prime64(regime, n):
    if regime == "goldilocks":
        return GOLDILOCKS
    lo, hi = {"p50": (0, 1 << 50), "p62": (1 << 61, 1 << 62)}[regime]
    return lpap(2 * n, 1, lo, hi)


def _pair(x):
    limbs = np_u64_to_limbs(x)
    return jnp.asarray(limbs[..., 0]), jnp.asarray(limbs[..., 1])


def _join(pair):
    return np.asarray(pair[0]).astype(np.uint64) | (
        np.asarray(pair[1]).astype(np.uint64) << np.uint64(32)
    )


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("regime", ["lt30", "lt31", "generic"])
def test_mxu32_matches_stage_engine(rng, monkeypatch, regime, n, b):
    p = _prime32(regime, n)
    monkeypatch.setenv("CONCRETE_NTT_TPU_ENGINE", "xla")
    plan = prime32.Plan.new(n, p)
    x = rng.integers(0, p, (b, n), dtype=np.uint32)
    np.testing.assert_array_equal(
        np.asarray(mxu32.fwd(jnp.asarray(x), n=n, p=p)), np.asarray(plan.fwd(x))
    )
    np.testing.assert_array_equal(
        np.asarray(mxu32.inv(jnp.asarray(x), n=n, p=p)), np.asarray(plan.inv(x))
    )
    # fwd_wide folds the residue split of a u64 operand into the matmul
    w = rng.integers(0, 1 << 64, (b, n), dtype=np.uint64)
    res = (w % np.uint64(p)).astype(np.uint32)
    np.testing.assert_array_equal(
        np.asarray(mxu32.fwd_wide(_pair(w), n=n, p=p)), np.asarray(plan.fwd(res))
    )


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("regime", ["p50", "p62", "goldilocks"])
def test_mxu64_matches_stage_engine(rng, monkeypatch, regime, n, b):
    p = _prime64(regime, n)
    monkeypatch.setenv("CONCRETE_NTT_TPU_ENGINE", "xla")
    plan = prime64.Plan.new(n, p)
    x = rng.integers(0, p, (b, n), dtype=np.uint64)
    np.testing.assert_array_equal(
        _join(mxu64.fwd(_pair(x), n=n, p=p)), plan.fwd(x)
    )
    np.testing.assert_array_equal(
        _join(mxu64.inv(_pair(x), n=n, p=p)), plan.inv(x)
    )
