"""Generate the committed N=2048 dense-oracle fixture.

Computes the EXACT wrapping negacyclic polymul of fixed-seed operands at a
kernel-relevant size (N = 2048 — large enough that the four-step
engines, not small-n fallbacks, serve it) entirely on the host, and writes
SHA-256 digests of the expected outputs to tests/fixtures/dense_oracle_2048.json.
tests/test_dense_fixture.py then asserts the full device pipeline against
these digests — closing the gap between "every engine agrees" and "the
agreed answer is right" at a shape the O(n^2) bigint oracle cannot cover in
CI time.

Oracle method (exact, no bigints in the hot loop): split each operand into
16-bit digits; full convolution of digit polynomials has terms < 2^32 and
<= n summands, so int64 accumulators are exact (|sum| < 2^43); recombine
digit convolutions with shifts in Python ints, fold negacyclically
(c[i] - c[i+n]) and truncate mod 2^w.

Reference semantics anchor: negacyclic_polymul == schoolbook negacyclic
convolution in wrapping arithmetic (native64.rs:1208-1213 tests with p=0).
"""

import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

N = 2048
SEED = 0xD15EA5E


def digit_split(vals, width_bits):
    """list of ints -> [n_digits, n] int64 array of 16-bit digits."""
    nd = width_bits // 16
    out = np.zeros((nd, len(vals)), dtype=np.int64)
    for i, v in enumerate(vals):
        v = int(v)
        for d in range(nd):
            out[d, i] = (v >> (16 * d)) & 0xFFFF
    return out


def wrapping_negacyclic(a_vals, b_vals, width_bits):
    """Exact negacyclic convolution of two length-N int lists mod 2^width."""
    da = digit_split(a_vals, width_bits)
    db = digit_split(b_vals, width_bits)
    nd = width_bits // 16
    mask = (1 << width_bits) - 1
    # full linear convolution per digit pair (int64-exact: terms < 2^32,
    # <= N summands -> |sum| < 2^43)
    full = {}
    for i in range(nd):
        for j in range(nd):
            if 16 * (i + j) >= width_bits + 16 * nd:  # cannot affect result
                continue
            full[(i, j)] = np.convolve(da[i], db[j])
    conv = [0] * (2 * N - 1)
    for (i, j), c in full.items():
        shift = 16 * (i + j)
        for k, v in enumerate(c.tolist()):
            conv[k] += v << shift
    out = []
    for k in range(N):
        hi = conv[k + N] if k + N < 2 * N - 1 else 0
        out.append((conv[k] - hi) & mask)
    return out


def digest(vals, width_bits):
    nbytes = width_bits // 8
    h = hashlib.sha256()
    for v in vals:
        h.update(int(v).to_bytes(nbytes, "little"))
    return h.hexdigest()


def main():
    rng = np.random.default_rng(SEED)
    a64 = [int(v) for v in rng.integers(0, 1 << 64, N, dtype=np.uint64)]
    b64 = [int(v) for v in rng.integers(0, 1 << 64, N, dtype=np.uint64)]
    a32 = [int(v) for v in rng.integers(0, 1 << 32, N, dtype=np.uint64)]
    b32 = [int(v) for v in rng.integers(0, 1 << 32, N, dtype=np.uint64)]
    a128 = [
        int(lo) | (int(hi) << 64)
        for lo, hi in zip(
            rng.integers(0, 1 << 64, N, dtype=np.uint64),
            rng.integers(0, 1 << 64, N, dtype=np.uint64),
        )
    ]
    b128 = [
        int(lo) | (int(hi) << 64)
        for lo, hi in zip(
            rng.integers(0, 1 << 64, N, dtype=np.uint64),
            rng.integers(0, 1 << 64, N, dtype=np.uint64),
        )
    ]
    bbin = [int(v) for v in rng.integers(0, 2, N, dtype=np.uint64)]

    fix = {
        "n": N,
        "seed": SEED,
        "inputs": "a64,b64 then a32,b32 then a128(lo,hi),b128(lo,hi) then bbin — "
        "drawn in this order from default_rng(seed)",
        "digests": {
            "native32": digest(wrapping_negacyclic(a32, b32, 32), 32),
            "native64": digest(wrapping_negacyclic(a64, b64, 64), 64),
            "native128": digest(wrapping_negacyclic(a128, b128, 128), 128),
            "native_binary64": digest(wrapping_negacyclic(a64, bbin, 64), 64),
        },
    }
    out = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "tests", "fixtures", "dense_oracle_2048.json",
    )
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(fix, f, indent=1)
    print("wrote", out)
    for k, v in fix["digests"].items():
        print(f"  {k}: {v}")


if __name__ == "__main__":
    main()
