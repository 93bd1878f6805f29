"""Four-step int8-matmul prime32 engine: bit-exactness vs golden.

The engine must be indistinguishable from the stage engines: same
bit-reversed output convention, canonical [0, p) outputs, inv(fwd(x)) = n*x
(reference semantics prime32.rs:704-761). Runs on the CPU backend — int8
dot_general is exact everywhere.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from concrete_ntt_tpu.golden import ntt as gntt
from concrete_ntt_tpu.ops import mxu32
from concrete_ntt_tpu.utils.prime import largest_prime_in_arithmetic_progression64


def _p30(n):
    return largest_prime_in_arithmetic_progression64(2 * n, 1, 0, 1 << 30)


def _p31(n):
    return largest_prime_in_arithmetic_progression64(2 * n, 1, 1 << 30, 1 << 31)


@pytest.mark.parametrize("n", [64, 256, 1024])
@pytest.mark.parametrize("regime", ["lt30", "lt31"])
def test_fwd_inv_bit_exact_vs_golden(rng, n, regime):
    p = _p30(n) if regime == "lt30" else _p31(n)
    x = rng.integers(0, p, (3, n), dtype=np.uint32)
    got_f = np.asarray(mxu32.fwd(jnp.asarray(x), n=n, p=p))
    want_f = np.array([gntt.fwd(list(map(int, r)), p, n) for r in x], dtype=np.uint32)
    np.testing.assert_array_equal(got_f, want_f)
    got_i = np.asarray(mxu32.inv(jnp.asarray(x), n=n, p=p))
    want_i = np.array([gntt.inv(list(map(int, r)), p, n) for r in x], dtype=np.uint32)
    np.testing.assert_array_equal(got_i, want_i)


@pytest.mark.parametrize("n", [128, 512])
def test_roundtrip_is_n_times_x(rng, n):
    p = _p30(n)
    x = rng.integers(0, p, (2, n), dtype=np.uint32)
    y = np.asarray(mxu32.inv(mxu32.fwd(jnp.asarray(x), n=n, p=p), n=n, p=p))
    want = (x.astype(np.uint64) * n % p).astype(np.uint32)
    np.testing.assert_array_equal(y, want)


def test_dispatch_forced_mxu_matches_xla(rng, monkeypatch):
    n = 2048
    p = _p30(n)
    from concrete_ntt_tpu import prime32

    x = rng.integers(0, p, (2, n), dtype=np.uint32)
    monkeypatch.setenv("CONCRETE_NTT_TPU_ENGINE", "xla")
    plan = prime32.Plan.new(n, p)
    want_f = np.asarray(plan.fwd(x))
    want_i = np.asarray(plan.inv(x))
    monkeypatch.setenv("CONCRETE_NTT_TPU_ENGINE", "mxu")
    np.testing.assert_array_equal(np.asarray(plan.fwd(x)), want_f)
    np.testing.assert_array_equal(np.asarray(plan.inv(x)), want_i)


def test_factorization_asserts_hold_for_table_primes():
    # plan-build for the first two hardcoded CRT primes exercises every
    # build-time factorization assertion (column independence, F.diag(d),
    # diag(e).G) at a realistic size
    from concrete_ntt_tpu.tables import PRIMES32

    for p in PRIMES32[:2]:
        tbl = mxu32._mxu_tables(512, p)
        assert tbl["n1"] * tbl["n2"] == 512
