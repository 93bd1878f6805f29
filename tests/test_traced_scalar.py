"""The traced-scalar helpers (ops/traced_scalar.py) that the channel-sharded
local sections run, against the engines' baked-constant epilogues and the
limb arithmetic of ops/u32.py: the same inputs give the same bits."""

import numpy as np
import pytest

import jax.numpy as jnp

from concrete_ntt_tpu.ops import mxu32, mxu64, traced_scalar as ts
from concrete_ntt_tpu.ops.u32 import const64_like, mont_mul64, mont_neginv, mont_neginv64
from concrete_ntt_tpu.tables import PRIMES32, PRIMES52

N = 256
SHAPE = (2, 16, 16)  # [B, n2, n1] at N = 256


def _u32(rng, shape=SHAPE, hi=1 << 32):
    return jnp.asarray(rng.integers(0, hi, shape, dtype=np.uint64).astype(np.uint32))


def _sc32(p):
    tbl = mxu32._mxu_tables(N, p)
    row = ts._multi_tables(N, (p,), 1, (1,))["scalars"][0]
    return tbl, tuple(jnp.asarray(v) for v in row)


def _sc64(p):
    tbl = mxu64._tables(N, p)
    row = jnp.asarray(np.array(ts._scal_vec64(N, p, tbl), dtype=np.uint32))
    return tbl, {name: (row[2 * j], row[2 * j + 1])
                 for j, name in enumerate(ts._SC_FIELDS)}


@pytest.mark.parametrize("p", PRIMES32[:3])
def test_sc_epilogue_canonical_matches_mxu32(rng, p):
    tbl, sc = _sc32(p)
    lo, hi = _u32(rng), _u32(rng, hi=1 << 28)
    np.testing.assert_array_equal(
        np.asarray(ts._sc_epilogue_canonical(lo, hi, sc)),
        np.asarray(mxu32._epilogue_canonical(lo, hi, tbl, p=p)),
    )


@pytest.mark.parametrize("p", PRIMES32[:3])
def test_sc_epilogue_scaled_lazy_matches_mxu32(rng, p):
    tbl, sc = _sc32(p)
    lo, hi = _u32(rng), _u32(rng, hi=1 << 28)
    dg = tuple(jnp.asarray(d)[None] for d in tbl["d"])
    np.testing.assert_array_equal(
        np.asarray(ts._sc_epilogue_scaled_lazy(lo, hi, dg, sc)),
        np.asarray(mxu32._epilogue_scaled_lazy(lo, hi, tbl["d"], tbl, p=p)),
    )


def test_sc_combine_matches_mxu32(rng):
    p = PRIMES32[0]
    tbl = mxu32._mxu_tables(N, p)
    planes, cvec = tbl["F"]
    o = planes.shape[1] // 4
    big = jnp.asarray(rng.integers(-(1 << 26), 1 << 26, (2, 16, 4 * o), dtype=np.int32))
    got = ts._sc_combine(big, jnp.asarray(cvec), o)
    want = mxu32._combine(big, (planes, cvec))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_digit8_and_dot8_match_mxu32(rng):
    x = _u32(rng)
    np.testing.assert_array_equal(
        np.asarray(ts._digit8(x)), np.asarray(mxu32._digit_cat(x))
    )
    planes = rng.integers(-128, 128, (64, 32), dtype=np.int8)
    xd = ts._digit8(x)
    want = np.asarray(xd).astype(np.int64) @ planes.astype(np.int64)
    np.testing.assert_array_equal(np.asarray(ts._dot8(xd, jnp.asarray(planes))), want)


def test_neginv_vec_matches_u32():
    primes = tuple(PRIMES32[:5])
    np.testing.assert_array_equal(
        ts._neginv_vec(primes), np.array([mont_neginv(p) for p in primes], np.uint32)
    )


@pytest.mark.parametrize("p", PRIMES52[:3])
def test_sc_mont_mul64_matches_u32(rng, p):
    a = (_u32(rng), _u32(rng, hi=1 << 18))  # canonical: < 2^50 < p
    b = (_u32(rng), _u32(rng, hi=1 << 18))
    pair = lambda v: tuple(jnp.asarray(x) for x in const64_like(v))
    got = ts._sc_mont_mul64(a, b, pair(p), pair(mont_neginv64(p)))
    want = mont_mul64(a, b, p, mont_neginv64(p))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("p", PRIMES52[:3])
def test_sc_canonical_matches_mxu64(rng, p):
    tbl, sc = _sc64(p)
    v = (_u32(rng), _u32(rng), _u32(rng, hi=1 << 24))
    got = ts._sc_canonical(*v, sc)
    want = mxu64._canonical(*v, tbl)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("p", PRIMES52[:3])
def test_sc_scaled_epilogue_matches_mxu64(rng, p):
    tbl, sc = _sc64(p)
    assert tbl["scale_mode"] == "shoup"
    v = (_u32(rng), _u32(rng), _u32(rng, hi=1 << 24))
    tab = tuple(jnp.asarray(t) for t in tbl["d"])
    got = ts._sc_scaled_epilogue(*v, tab, sc)
    want = mxu64._scaled_epilogue(*v, tbl["d"], tbl)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_multi_tables_stack_the_engine_tables():
    primes = tuple(PRIMES32[:2])
    scales = (1, 7)
    tabs = ts._multi_tables(N, primes, 2, scales)
    for c, p in enumerate(primes):
        tbl = mxu32._mxu_tables(N, p)
        np.testing.assert_array_equal(tabs["fwd"][0][c], mxu32._wide_col_planes(N, p, 2)[0])
        np.testing.assert_array_equal(tabs["fwd"][2][c], tbl["F"][0])
        np.testing.assert_array_equal(tabs["inv"][0][c], tbl["G"][0])
    np.testing.assert_array_equal(
        tabs["inv"][2][1], mxu32._scaled_ainv_planes(N, primes[1], 7)[0]
    )
    tabs64 = ts._multi_tables64(N, tuple(PRIMES52[:2]), (1, 1))
    assert tabs64["scalars"].shape == (2, 16)
    np.testing.assert_array_equal(tabs64["fwd"][0][1], mxu64._tables(N, PRIMES52[1])["A"][0])
