"""Committed dense-oracle fixture at a kernel-relevant size (N = 2048).

The wrapping-oracle polymul tests run at N = 64 (O(n^2) bigint cost); the
larger sizes rest on roundtrip + sparse oracles + cross-engine equality.
This test closes the remaining gap — "every engine agrees, but is the
agreed answer right?" — by asserting the full negacyclic_polymul pipeline
at N = 2048 (served by the four-step engines) against SHA-256 digests of the EXACT host-computed wrapping
convolution, committed in tests/fixtures/dense_oracle_2048.json
(regenerate with tools/make_dense_fixture.py; its oracle is cross-checked
against golden.polymul at small n).

Reference semantics anchor: native64.rs:1208-1213 (wrapping oracle, p=0).
"""

import hashlib
import json
import os

import numpy as np

from concrete_ntt_tpu import native32, native64, native128, native_binary64
from concrete_ntt_tpu.ops.u32 import np_u128_to_limbs

_FIX = os.path.join(os.path.dirname(__file__), "fixtures", "dense_oracle_2048.json")


def _fixture():
    with open(_FIX) as f:
        return json.load(f)


def _digest_u(vals, nbytes):
    h = hashlib.sha256()
    for v in vals:
        h.update(int(v).to_bytes(nbytes, "little"))
    return h.hexdigest()


def _inputs(fix):
    rng = np.random.default_rng(fix["seed"])
    n = fix["n"]
    a64 = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    b64 = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    a32 = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    b32 = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    a128 = [
        int(lo) | (int(hi) << 64)
        for lo, hi in zip(
            rng.integers(0, 1 << 64, n, dtype=np.uint64),
            rng.integers(0, 1 << 64, n, dtype=np.uint64),
        )
    ]
    b128 = [
        int(lo) | (int(hi) << 64)
        for lo, hi in zip(
            rng.integers(0, 1 << 64, n, dtype=np.uint64),
            rng.integers(0, 1 << 64, n, dtype=np.uint64),
        )
    ]
    bbin = rng.integers(0, 2, n, dtype=np.uint64)
    return a64, b64, a32, b32, a128, b128, bbin


def test_native32_dense_fixture():
    fix = _fixture()
    _, _, a32, b32, _, _, _ = _inputs(fix)
    plan = native32.Plan32.try_new(fix["n"])
    got = np.asarray(plan.negacyclic_polymul(a32[None], b32[None]))[0]
    assert _digest_u(got, 4) == fix["digests"]["native32"]


def test_native64_dense_fixture_both_tiers():
    fix = _fixture()
    a64, b64, *_ = _inputs(fix)
    for cls in (native64.Plan32, native64.Plan52):
        plan = cls.try_new(fix["n"])
        got = np.asarray(plan.negacyclic_polymul(a64[None], b64[None]))[0]
        assert _digest_u(got, 8) == fix["digests"]["native64"], cls.__name__


def test_native128_dense_fixture():
    fix = _fixture()
    *_, a128, b128, _ = _inputs(fix)
    plan = native128.Plan32.try_new(fix["n"])
    la = np_u128_to_limbs(a128)[None]
    lb = np_u128_to_limbs(b128)[None]
    out = np.asarray(plan.negacyclic_polymul(la, lb))[0]
    vals = [
        int(r[0]) | (int(r[1]) << 32) | (int(r[2]) << 64) | (int(r[3]) << 96)
        for r in out
    ]
    assert _digest_u(vals, 16) == fix["digests"]["native128"]


def test_native_binary64_dense_fixture():
    fix = _fixture()
    a64, _, _, _, _, _, bbin = _inputs(fix)
    plan = native_binary64.Plan32.try_new(fix["n"])
    got = np.asarray(plan.negacyclic_polymul(a64[None], bbin[None]))[0]
    assert _digest_u(got, 8) == fix["digests"]["native_binary64"]
