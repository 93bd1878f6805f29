"""Four-step int8 matmul engine for the prime32 NTT.

Motivation: the butterfly stage engine is bound by `mulhi_u32` (a
16-bit-split high multiply, ~16 elementwise ops), paying one per butterfly
per stage — 14 high-multiply sweeps for n = 2^14 — while int8 matrix
products run on the tensor cores. This engine moves the O(n log n)
multiply work into int8 matmuls by collapsing the stage loop into two modular
matrix products (the classical four-step/Bailey factorization, here derived
directly from the reference's stage structure so outputs are bit-identical
to the stage engine and therefore to the Rust reference):

  * stages [0, k)        — mix only rows of the [n1, n2] view (n1 = 2^k)
    and use row-only twiddle indices, so they form ONE shared n1 x n1
    matrix A applied to every column;
  * stages [k, log2 n)   — act within rows; row r's operator factors as
    B_r = F * diag(d_r) with a SHARED n2 x n2 matrix F (the decimation
    identity behind the four-step twiddle correction), so the pass is one
    elementwise Shoup multiply by the [n1, n2] table d plus one shared
    matmul. The inverse engine mirrors this: C_r = diag(e_r) * G, then the
    shared n1 x n1 column matrix A_inv.

Exact modular matmul in int8 arithmetic: operand x (any u32 representative of
the residue) is split into four unsigned radix-2^8 digit planes (shifted to
int8 by -128); the matrix M is pre-multiplied by 2^(8e) mod p for each
operand digit e, centered to (-p/2, p/2], and balanced-digit decomposed into
four int8 planes each. Grouping by matrix digit d gives four int8
contractions S_d = sum_e x_e . (2^(8e) M mod p)_d whose int32 accumulators
stay exact (|acc| < 2^26), and the result is recombined as
sum_d S_d 2^(8d) — a 52-bit value reduced with ONE Shoup high-multiply.
The -128 shift and the sign offsets fold into per-output additive constants
computed at plan-build time.

The matrices A, F, d, G, e, A_inv are built numerically by running the
exact host stage engine (golden semantics) on basis vectors, with the
factorization properties asserted — no re-derivation of twiddle algebra is
trusted without a bit-exactness check at build time.

Reference parity anchors: stage structure fwd_breadth_first_scalar
(prime32/shoup.rs:582-636), inv (shoup.rs:1355-1408); twiddle tables
(prime32.rs:223-246). The reference's cache-blocking recursion
(RECURSION_THRESHOLD, prime32.rs:12) is replaced by this matmul
factorization.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from .u32 import add_mod, mont_mul, mont_neginv, shoup_mul_lazy

_MIN_P = 1 << 26  # below this the cond-sub reduction chains get long; use the stage engine


# ---------------------------------------------------------------------------
# Host-side exact stage engine (numpy uint64) for building the matrices
# ---------------------------------------------------------------------------


def _fwd_stage_range(data: np.ndarray, twid: np.ndarray, p: int, s0: int, s1: int):
    """Run forward CT stages [s0, s1) on [rows, n] uint64 data (exact)."""
    rows, n = data.shape
    p64 = np.uint64(p)
    for s in range(s0, s1):
        m = 1 << s
        t = n >> (s + 1)
        v = data.reshape(rows, m, 2, t)
        z0 = v[:, :, 0, :].copy()
        z1 = v[:, :, 1, :]
        w = twid[m : 2 * m][None, :, None]
        wz1 = z1 * w % p64
        v[:, :, 0, :] = (z0 + wz1) % p64
        v[:, :, 1, :] = (z0 + p64 - wz1) % p64
    return data


def _inv_stage_range(data: np.ndarray, inv_twid: np.ndarray, p: int, s_hi: int, s_lo: int):
    """Run inverse GS stages s_hi-1 down to s_lo on [rows, n] uint64 data."""
    rows, n = data.shape
    p64 = np.uint64(p)
    for s in range(s_hi - 1, s_lo - 1, -1):
        m = 1 << s
        t = n >> (s + 1)
        v = data.reshape(rows, m, 2, t)
        z0 = v[:, :, 0, :].copy()
        z1 = v[:, :, 1, :]
        w = inv_twid[m : 2 * m][None, :, None]
        v[:, :, 0, :] = (z0 + z1) % p64
        v[:, :, 1, :] = (z0 + p64 - z1) % p64 * w % p64
    return data


def _col_matrix_fwd(n, n1, n2, twid, p):
    """A[n1, n1]: stages [0, k) as one matrix shared by all columns."""
    k = n1.bit_length() - 1
    basis = np.zeros((n1, n), dtype=np.uint64)
    for i in range(n1):
        basis[i, i * n2] = 1
        if n2 > 1:
            basis[i, i * n2 + 1] = 0  # placeholder; column-independence checked below
    out = _fwd_stage_range(basis, twid, p, 0, k)
    A = out[:, ::n2].T.copy()  # A[r, i]
    if n2 > 1:  # verify the operator is identical on a second column
        basis2 = np.zeros((n1, n), dtype=np.uint64)
        for i in range(n1):
            basis2[i, i * n2 + 1] = 1
        out2 = _fwd_stage_range(basis2, twid, p, 0, k)
        assert np.array_equal(out2[:, 1::n2].T, A), "column-dependence in stages [0,k)"
    return A


def _row_ops_fwd(n, n1, n2, twid, p):
    """F[n2, n2] shared row matrix + d[n1, n2] input-side diagonal:
    row r's stages-[k, log2n) operator is F @ diag(d[r])."""
    k = n1.bit_length() - 1
    log2n = n.bit_length() - 1
    # basis: row block r gets e_j in its row for all r at once
    B = np.zeros((n2, n1, n2), dtype=np.uint64)  # [j, r, kappa] = B_r[kappa, j]
    for j in range(n2):
        data = np.zeros((1, n), dtype=np.uint64)
        data[0].reshape(n1, n2)[:, j] = 1
        out = _fwd_stage_range(data, twid, p, k, log2n)
        B[j] = out[0].reshape(n1, n2)
    B = B.transpose(1, 2, 0)  # [r, kappa, j]
    F = B[0].copy()
    assert np.all(F != 0), "shared row matrix has zero entries"
    Finv = np.vectorize(lambda v: pow(int(v), p - 2, p), otypes=[object])(F)
    d = np.zeros((n1, n2), dtype=np.uint64)
    for r in range(n1):
        rat = (B[r].astype(object) * Finv) % p
        assert (rat == rat[0:1, :]).all(), "row operator does not factor as F.diag(d)"
        d[r] = rat[0].astype(np.uint64)
    return F, d


def _row_ops_inv(n, n1, n2, inv_twid, p):
    """G[n2, n2] shared inverse row matrix + e[n1, n2] OUTPUT-side diagonal:
    row r's inverse stages-[log2n, k) operator is diag(e[r]) @ G."""
    k = n1.bit_length() - 1
    log2n = n.bit_length() - 1
    C = np.zeros((n2, n1, n2), dtype=np.uint64)
    for j in range(n2):
        data = np.zeros((1, n), dtype=np.uint64)
        data[0].reshape(n1, n2)[:, j] = 1
        out = _inv_stage_range(data, inv_twid, p, log2n, k)
        C[j] = out[0].reshape(n1, n2)
    C = C.transpose(1, 2, 0)  # [r, kappa, j]
    G = C[0].copy()
    assert np.all(G != 0), "shared inverse row matrix has zero entries"
    Ginv = np.vectorize(lambda v: pow(int(v), p - 2, p), otypes=[object])(G)
    e = np.zeros((n1, n2), dtype=np.uint64)
    for r in range(n1):
        rat = (C[r].astype(object) * Ginv) % p
        assert (rat == rat[:, 0:1]).all(), "inverse row op does not factor as diag(e).G"
        e[r] = rat[:, 0].astype(np.uint64)
    return G, e


def _col_matrix_inv(n, n1, n2, inv_twid, p):
    """A_inv[n1, n1]: inverse stages [k, 0) as one shared column matrix."""
    k = n1.bit_length() - 1
    basis = np.zeros((n1, n), dtype=np.uint64)
    for i in range(n1):
        basis[i, i * n2] = 1
    out = _inv_stage_range(basis, inv_twid, p, k, 0)
    A = out[:, ::n2].T.copy()
    if n2 > 1:
        basis2 = np.zeros((n1, n), dtype=np.uint64)
        for i in range(n1):
            basis2[i, i * n2 + 1] = 1
        out2 = _inv_stage_range(basis2, inv_twid, p, k, 0)
        assert np.array_equal(out2[:, 1::n2].T, A), "column-dependence in inv stages"
    return A


# ---------------------------------------------------------------------------
# int8 digit-plane preparation (host)
# ---------------------------------------------------------------------------


def four_step_factors(n: int) -> tuple[int, int]:
    """The canonical four-step split n = n1·n2 (n1 = 2^(log2n//2)) — the
    ONE definition every table builder and kernel index map must share
    (mxu32/mxu64, ops/stagesplit, ops/traced_scalar)."""
    log2n = n.bit_length() - 1
    n1 = 1 << (log2n // 2)
    return n1, n // n1


def _n_dplanes32(p: int) -> int:
    """Matrix digit planes: centered entries |v| <= p/2 need 4 balanced
    radix-256 digits while p/2 <= 127*(256^4-1)/255, else 5 (primes near
    2^32, e.g. the reference's generic-regime bench prime 4293918721)."""
    return 4 if p // 2 <= 127 * ((1 << 32) - 1) // 255 else 5


def _balanced_digits(v: np.ndarray, n_d: int = 4) -> np.ndarray:
    """[n_d, ...] balanced radix-256 digits of centered int64 values."""
    digits = np.zeros((n_d,) + v.shape, dtype=np.int64)
    rem = v.astype(np.int64).copy()
    for dd in range(n_d):
        r = ((rem + 128) & 255) - 128
        digits[dd] = r
        rem = (rem - r) >> 8
    assert (rem == 0).all(), "balanced digit overflow"
    return digits


def _prep_matrix(M: np.ndarray, p: int, n_eplanes: int = 4, n_d: int = 4):
    """Pack M[K, O] (mod p) into fused int8 planes + epilogue constants.

    Returns (planes [E*K, D*O] int8 — ONE fused matmul computes all D
    matrix-digit accumulators S_d as O-wide column blocks —, cvec [D, O]
    int32 additive constants incl. the sign offsets).

    E = n_eplanes is the number of radix-2^8 digit planes of the OPERAND:
    4 for u32 inputs, 8 for u64 limb-pair inputs, 16 for u128 — the residue
    reduction of wide operands is linear mod p, so it folds into the matmul
    (the matmul answer to the reference's per-coefficient `% p` residue split,
    native64.rs:980-993).
    """
    K, O = M.shape
    Ms = [(M.astype(object) * (1 << (8 * ee))) % p for ee in range(n_eplanes)]
    # centered representative -> |entries| <= p/2, n_d balanced digits
    planes = np.zeros((n_eplanes * K, n_d * O), dtype=np.int8)
    csum = np.zeros((n_d, O), dtype=np.int64)
    for ee in range(n_eplanes):
        Mc = np.array(
            [[int(v) - p if int(v) > p // 2 else int(v) for v in row] for row in Ms[ee]],
            dtype=np.int64,
        )
        dig = _balanced_digits(Mc, n_d)  # [n_d, K, O]
        for dd in range(n_d):
            planes[ee * K : (ee + 1) * K, dd * O : (dd + 1) * O] = dig[dd].astype(
                np.int8
            )
            csum[dd] += 128 * dig[dd].sum(axis=0)  # the x(+128) shift correction
    cvec = csum + (1 << 27)  # sign offset making U_d nonnegative on device
    assert np.all(np.abs(csum) < (1 << 27)), "epilogue constant overflow"
    assert cvec.min() >= 0 and cvec.max() < (1 << 28)
    return planes, cvec.astype(np.int32)


def _reduce_chain(p: int) -> tuple[int, ...]:
    """Multiples of p to conditionally subtract to bring a u32 into [0, p)."""
    chain = []
    bound = (1 << 32) - 1
    while bound >= p:
        q = p
        while q * 2 <= bound and q * 2 < (1 << 32):
            q *= 2
        chain.append(q)
        bound = max(q - 1, bound - q)
    return tuple(chain)


@lru_cache(maxsize=64)
def _operators(n: int, p: int):
    """The six four-step operators A, F, d, G, e, Ainv (uint64 mod p).

    Native C++ builder when available (~100x faster plan construction);
    pure-numpy/Python fallback with identical outputs (tests assert).
    Results are disk-cached across processes (ops/table_cache.py)."""
    from .table_cache import cached_operators

    return cached_operators(n, p, lambda: _build_operators(n, p))


def _build_operators(n: int, p: int):
    n1, n2 = four_step_factors(n)
    from .. import _native

    ops = _native.fourstep_build(n, p, n1)
    if ops is not None:
        return ops
    from ..golden.ntt import negacyclic_twiddles

    twid_t, inv_twid_t = negacyclic_twiddles(p, n)
    twid = np.array(twid_t, dtype=np.uint64)
    inv_twid = np.array(inv_twid_t, dtype=np.uint64)
    A = _col_matrix_fwd(n, n1, n2, twid, p)
    F, d = _row_ops_fwd(n, n1, n2, twid, p)
    G, e = _row_ops_inv(n, n1, n2, inv_twid, p)
    Ainv = _col_matrix_inv(n, n1, n2, inv_twid, p)
    return {"A": A, "F": F, "d": d, "G": G, "e": e, "Ainv": Ainv}


def assert_accumulator_exact(planes: np.ndarray, cvec: np.ndarray):
    """Worst-case proof that the int8 matmul epilogue cannot wrap.

    The device computes U_d = (xd @ planes)[.., d*O:(d+1)*O] + cvec[d] and
    casts to uint32, relying on U_d in [0, 2^28). With operand digits in
    [-128, 127], |acc per column| <= 128 * sum(|plane column|), so it
    suffices that 128*colsum + |csum| < 2^27 for every output column
    (csum = cvec - 2^27). This catches any unsafe (n, p, E) combination at
    table-build time instead of silently wrapping (e.g. contraction extents
    E*K > 4096 at very large n)."""
    n_d, O = cvec.shape
    colsum = np.abs(planes.astype(np.int64)).sum(axis=0).reshape(n_d, O)
    csum = cvec.astype(np.int64) - (1 << 27)
    worst = 128 * colsum + np.abs(csum)
    assert worst.max() < (1 << 27), (
        f"int8 accumulator may wrap: worst-case |U_d - 2^27| = {worst.max()}"
        f" >= 2^27 (contraction extent {planes.shape[0]})"
    )


def off_delta(p: int, n_d: int) -> np.ndarray:
    """Per-digit additive corrections making the sign offset vanish mod p.

    The device computes V = Σ_d U_d·2^(8d) with U_d = S_d + csum_d + 2^27,
    i.e. V = true + OFF with OFF = Σ_d 2^27·2^(8d). Instead of subtracting
    OFF·(scale) in every epilogue, shift the offset to a multiple of p:
    pick δ = the balanced radix-256 digits of the CENTERED (−OFF) mod p
    (|centered| ≤ p/2, which n_d digits cover by the _n_dplanes criterion)
    and add δ_d into cvec_d — then Σ_d (2^27+δ_d)·2^(8d) ≡ 0 (mod p) and V
    is directly a representative of the true result. |δ_d| ≤ 128 perturbs
    the U_d ∈ [0, 2^28) bound negligibly (re-asserted on the adjusted
    cvec by assert_accumulator_exact)."""
    off = sum((1 << 27) << (8 * dd) for dd in range(n_d))
    r = (-off) % p
    if r > p // 2:
        r -= p  # centered representative of (−OFF) mod p
    delta = np.zeros(n_d, dtype=np.int64)
    rem = int(r)
    for dd in range(n_d):
        dig = ((rem + 128) & 255) - 128
        delta[dd] = dig
        rem = (rem - dig) >> 8
    assert rem == 0, "off_delta digits overflow (violates _n_dplanes bound)"
    return delta


def _prep(M: np.ndarray, p: int, n_eplanes: int = 4):
    """Digit-plane packing: native C++ when available, Python otherwise.
    cvec is adjusted by off_delta so the sign offset is ≡ 0 mod p."""
    from .. import _native

    n_d = _n_dplanes32(p)
    out = _native.prep_matrix(np.ascontiguousarray(M), p, n_eplanes, n_d)
    if out is None:
        out = _prep_matrix(np.ascontiguousarray(M), p, n_eplanes, n_d)
    planes, cvec = out
    cvec = (cvec.astype(np.int64) + off_delta(p, n_d)[:, None]).astype(np.int32)
    out = (planes, cvec)
    assert_accumulator_exact(*out)
    return out


@lru_cache(maxsize=64)
def _mxu_tables(n: int, p: int):
    n1, n2 = four_step_factors(n)
    return _mxu_tables_from_ops(n1, n2, p, _operators(n, p))


def _mxu_tables_from_ops(n1: int, n2: int, p: int, ops: dict):
    """Device table dict from an explicit operator set — the seam the
    stage-split hybrid engine (ops/stagesplit.py) uses for per-block
    operators extracted from a larger transform."""
    A, F, d = ops["A"], ops["F"], ops["d"]
    G, e, Ainv = ops["G"], ops["e"], ops["Ainv"]

    def shoup(tbl):
        return ((tbl.astype(object) << 32) // p).astype(np.uint64).astype(np.uint32)

    c32 = (1 << 32) % p
    c32_shoup = (c32 << 32) // p

    tables = {
        "n1": n1,
        "n2": n2,
        "c32": np.uint32(c32),
        "c32_shoup": np.uint32(c32_shoup),
        "chain": _reduce_chain(p),
        "lazy4": 4 * p < (1 << 32),  # a+b of two [0,2p) values fits u32
        # p >= 2^31: Shoup's [0, 2p) lazy bound overflows u32, so the
        # epilogues switch to Montgomery multiplies (canonical outputs) —
        # the tier covering the reference's fully-generic prime32 engine
        # (prime32/generic.rs:59-226, Lemire lanes there).
        "mont_regime": p >= (1 << 31),
        "p_neginv": mont_neginv(p),
        "c64_mont": np.uint32((1 << 64) % p),  # mont_mul(hi, ·) = hi*2^32 mod p
    }
    # _matmod computes x @ planes (contraction over the input index), while the
    # operators are defined as out[r] = sum_i M[r, i] x[i] — store M transposed.
    # The sign offset is folded to ≡ 0 mod p inside _prep (off_delta), so no
    # epilogue ever corrects for it.
    for name, M in (("A", A.T), ("F", F.T), ("G", G.T), ("Ainv", Ainv.T)):
        planes, cvec = _prep(M, p)
        tables[name] = (planes, cvec)

    def scale_tabs(W):
        """Tables for the fused lazy scale-by-W epilogue: result represents
        V*W mod p given limbs (lo, hi) of V: lo*W + hi*(2^32 W).
        Shoup pairs for p < 2^31; Montgomery'd multiplicands (W*2^32 mod p,
        W*2^64 mod p) for the generic p >= 2^31 regime."""
        W = W.astype(object)
        W32 = (W << 32) % p
        u32a = lambda a: a.astype(np.uint64).astype(np.uint32)
        if p >= (1 << 31):
            return (u32a(W32), u32a((W << 64) % p))
        return (
            u32a(W),
            shoup(W.astype(np.uint64)),
            u32a(W32),
            shoup(W32.astype(np.uint64)),
        )

    tables["d"] = scale_tabs(d.T)  # fwd mid-pass layout [n2, n1]
    tables["e"] = scale_tabs(e)  # inv mid-pass layout [n1, n2]
    return tables


# ---------------------------------------------------------------------------
# Device-side exact modular matmul + transform entry points
# ---------------------------------------------------------------------------


def _digit_cat(x):
    """int8 digit planes (value - 128) of x, concatenated along the last axis.

    x is a u32 array [..., K] (4 planes) or a little-endian limb tuple
    (lo, hi, ...) of u32 arrays (4 planes per limb, limb-major order matching
    the 2^(8e) weights of the wide matrix planes)."""
    limbs = x if isinstance(x, tuple) else (x,)
    parts = []
    for limb in limbs:
        for ee in range(4):
            # (d & 255) - 128 as an int8 BIT PATTERN equals (d ^ 128)'s low
            # byte (adding 128 mod 256 flips bit 7; the i8 convert truncates)
            # — 3 elementwise ops/plane instead of 5.
            dig = (limb >> np.uint32(8 * ee)) ^ np.uint32(128)
            parts.append(dig.astype(jnp.int8))
    return jnp.concatenate(parts, axis=-1)


def _reduce_u32(x, chain):
    for q in chain:
        x = jnp.where(x >= np.uint32(q), x - np.uint32(q), x)
    return x


def _dot_planes(x, mat):
    """Fused int8 digit dot contracting the LAST axis: u32 array (or limb
    tuple) [..., K] -> int32 accumulators [..., 4O]."""
    planes = jnp.asarray(mat[0])
    xd = _digit_cat(x)
    return jax.lax.dot_general(
        xd, planes, (((xd.ndim - 1,), (0,)), ((), ())), preferred_element_type=jnp.int32
    )


def _combine(big, mat):
    """int32 accumulators [..., D*O] -> (lo, hi) u32 limbs of
    V = (x @ M mod p) + OFF (exact). D = 4 matrix digit planes for most
    primes; a 5th (sitting exactly at bit 32 → added into hi) for primes
    near 2^32 (_n_dplanes32)."""
    cvec = jnp.asarray(mat[1])
    n_d = mat[1].shape[0]
    o = mat[0].shape[1] // n_d
    bshape = (1,) * (big.ndim - 1) + (-1,)
    u = [
        (big[..., dd * o : (dd + 1) * o] + cvec[dd].reshape(bshape)).astype(jnp.uint32)
        for dd in range(n_d)
    ]
    t1 = u[1] << np.uint32(8)
    t2 = u[2] << np.uint32(16)
    t3 = u[3] << np.uint32(24)
    s1 = u[0] + t1
    c1 = (s1 < t1).astype(jnp.uint32)
    s2 = s1 + t2
    c2 = (s2 < t2).astype(jnp.uint32)
    lo = s2 + t3
    c3 = (lo < t3).astype(jnp.uint32)
    hi = (u[1] >> np.uint32(24)) + (u[2] >> np.uint32(16)) + (u[3] >> np.uint32(8))
    hi = hi + c1 + c2 + c3
    if n_d == 5:
        hi = hi + u[4]  # digit 4 sits at bit 32 exactly; hi < 2^29
    return lo, hi


def _limbs(x, mat, tbl):
    """Fused int8 dot + limb combine: returns (lo, hi) u32 with
    hi*2^32 + lo = (x @ M mod p) + OFF exactly, contracting the LAST axis."""
    del tbl
    return _combine(_dot_planes(x, mat), mat)


def _epilogue_canonical(lo, hi, tbl, *, p: int):
    """(lo, hi) limbs of V (≡ true mod p; the sign offset is folded into
    cvec via off_delta) -> canonical true mod p in [0, p)."""
    if tbl["mont_regime"]:
        # hi*(2^64 mod p)*2^-32 = hi*2^32 mod p, canonical for any odd p
        r = mont_mul(hi, tbl["c64_mont"], p, tbl["p_neginv"])
    else:
        r = shoup_mul_lazy(hi, tbl["c32"], tbl["c32_shoup"], p)  # [0, 2p)
        r = jnp.where(r >= np.uint32(p), r - np.uint32(p), r)
    lo = _reduce_u32(lo, tbl["chain"])
    if tbl["mont_regime"]:
        return add_mod(r, lo, p)
    s = r + lo
    return jnp.where(s >= np.uint32(p), s - np.uint32(p), s)


def _epilogue_scaled_lazy(lo, hi, scale, tbl, *, p: int):
    """(lo, hi) limbs of V (≡ true mod p) -> true*W mod p as ANY u32
    representative: lo*W + hi*(2^32 W) via two Shoup multiplies (p < 2^31)
    or two Montgomery multiplies (generic p >= 2^31, where the Shoup
    [0, 2p) bound overflows u32; outputs canonical instead of lazy)."""
    if tbl["mont_regime"]:
        w32m, w64m = (jnp.asarray(x)[None] for x in scale)
        ninv = tbl["p_neginv"]
        a = mont_mul(lo, w32m, p, ninv)  # lo*W mod p, canonical
        b = mont_mul(hi, w64m, p, ninv)  # hi*2^32*W mod p, canonical
        return add_mod(a, b, p)
    w, w_sh, w32, w32_sh = (jnp.asarray(x)[None] for x in scale)
    a = shoup_mul_lazy(lo, w, w_sh, p)  # [0, 2p)
    b = shoup_mul_lazy(hi, w32, w32_sh, p)  # [0, 2p)
    if tbl["lazy4"]:
        s = a + b  # < 4p < 2^32: valid u32 representative
        return jnp.where(s >= np.uint32(2 * p), s - np.uint32(2 * p), s)
    a = jnp.where(a >= np.uint32(p), a - np.uint32(p), a)
    b = jnp.where(b >= np.uint32(p), b - np.uint32(p), b)
    s = a + b  # < 2p < 2^32
    return jnp.where(s >= np.uint32(p), s - np.uint32(p), s)


def _matmod(x, mat, tbl, *, p: int):
    """Exact canonical (x @ M) mod p in [0, p), contracting the LAST axis."""
    lo, hi = _limbs(x, mat, tbl)
    return _epilogue_canonical(lo, hi, tbl, p=p)


def _matmod_scaled_lazy(x, mat, scale, tbl, *, p: int):
    """(x @ M)*W mod p as ANY u32 representative (lazy), contracting last
    axis — the four-step twiddle correction fused into the reduction."""
    lo, hi = _limbs(x, mat, tbl)
    return _epilogue_scaled_lazy(lo, hi, scale, tbl, p=p)


def _fwd_core(x, tbl, *, p: int, mat1=None):
    """Four-step forward against an explicit table dict (any n1·n2)."""
    n1, n2 = tbl["n1"], tbl["n2"]
    b = x.shape[0]
    if mat1 is None:
        mat1 = tbl["A"]
    v = x.reshape(b, n1, n2).transpose(0, 2, 1)  # [B, n2, n1]
    # column pass + fused twiddle correction: contract n1 -> [B, n2, n1]
    y = _matmod_scaled_lazy(v, mat1, tbl["d"], tbl, p=p)
    y = y.transpose(0, 2, 1)  # [B, n1, n2]
    # row pass: contract n2 -> [B, n1, n2], canonical
    out = _matmod(y, tbl["F"], tbl, p=p)
    return out.reshape(b, n1 * n2)


def fwd(x, *, n: int, p: int):
    """[B, n] u32 -> forward negacyclic NTT, bit-reversed order, [0, p)."""
    return _fwd_core(x, _mxu_tables(n, p), p=p)


@lru_cache(maxsize=128)
def _wide_col_planes(n: int, p: int, n_limbs: int):
    """Column-pass planes consuming u{32*n_limbs} limb tuples directly: the
    residue split (value mod p) folds into the matmul as extra digit planes."""
    A = _operators(n, p)["A"]
    return _prep(A.T, p, n_eplanes=4 * n_limbs)


def fwd_wide(limbs: tuple, *, n: int, p: int):
    """Forward NTT of wide unsigned values given as little-endian u32 limb
    tuples (each [B, n]) — fuses the reference's per-coefficient residue
    split (native64.rs:980-993, native128.rs) into the column matmul."""
    tbl = _mxu_tables(n, p)
    n1, n2 = tbl["n1"], tbl["n2"]
    b = limbs[0].shape[0]
    wide_mat = _wide_col_planes(n, p, len(limbs))
    v = tuple(a.reshape(b, n1, n2).transpose(0, 2, 1) for a in limbs)
    y = _matmod_scaled_lazy(v, wide_mat, tbl["d"], tbl, p=p)
    y = y.transpose(0, 2, 1)
    out = _matmod(y, tbl["F"], tbl, p=p)
    return out.reshape(b, n)


@lru_cache(maxsize=128)
def _scaled_ainv_planes(n: int, p: int, scale: int):
    """A_inv pre-multiplied by a constant (e.g. n^-1 * 2^32 mod p, folding the
    normalization and a Montgomery factor of the pointwise product into the
    final matmul — the matmul analogue of the reference's fused
    mul_assign_normalize, prime32.rs:812-864)."""
    Ainv = _operators(n, p)["Ainv"]
    M = (Ainv.T.astype(object) * scale % p).astype(np.uint64)
    return _prep(M, p)


def inv(x, *, n: int, p: int, scale: int = 1):
    """[B, n] u32 bit-reversed NTT values -> standard order, [0, p).

    Unnormalized for scale=1 (reference semantics, inv(fwd(x)) == n*x); a
    non-unit scale multiplies every output by the constant for free (folded
    into the column matrix)."""
    tbl = _mxu_tables(n, p)
    mat = tbl["Ainv"] if scale == 1 else _scaled_ainv_planes(n, p, scale % p)
    return _inv_core(x, tbl, p=p, mat2=mat)


def _inv_core(x, tbl, *, p: int, mat2=None):
    """Four-step inverse against an explicit table dict (any n1·n2)."""
    n1, n2 = tbl["n1"], tbl["n2"]
    b = x.shape[0]
    v = x.reshape(b, n1, n2)
    # row pass + fused output diagonal: contract n2 -> [B, n1, n2]
    y = _matmod_scaled_lazy(v, tbl["G"], tbl["e"], tbl, p=p)
    y = y.transpose(0, 2, 1)  # [B, n2, n1]
    # column pass: contract n1 -> [B, n2, n1], canonical
    if mat2 is None:
        mat2 = tbl["Ainv"]
    out = _matmod(y, mat2, tbl, p=p)
    return out.transpose(0, 2, 1).reshape(b, n1 * n2)


def applicable(n: int, p: int, variant: str) -> bool:
    """All prime32 regimes (lt30/lt31 via Shoup epilogues; generic p >= 2^31
    via Montgomery epilogues — the reference SIMD-accelerates its generic
    engine too, prime32/generic.rs:59-226), n in [2048, 2^17]. Upper bound:
    the int8 matmul accumulators stay provably exact only while the
    contraction extent E*K <= 4096 (assert_accumulator_exact); the widest
    supported operand (u128, E=16) contracts 16*n1 in the column pass and
    4*n2 in the row pass, so n1 <= 256 and n2 <= 1024 -> n <= 2^17."""
    if variant not in ("lt30", "lt31", "generic") or p < _MIN_P:
        return False
    if p % 2 == 0:  # Montgomery epilogues need odd p (p = 2 is the only even prime)
        return False
    if n < 2048 or (n & (n - 1)) != 0:
        return False
    log2n = n.bit_length() - 1
    n1 = 1 << (log2n // 2)
    return n1 <= 256 and (n // n1) <= 1024
