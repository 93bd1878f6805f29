"""Four-step int8 matmul engine for the prime64 NTT.

Same architecture as ops/mxu32.py — the stage loop collapses into two shared
modular matrix products (column matrix A, input-side diagonal d, row matrix
F; inverse mirrored) — extended to 64-bit moduli:

  * matrix entries are centered to (-p/2, p/2] and balanced-decomposed into
    EIGHT radix-2^8 int8 digit planes (p < 2^63);
  * operands are u64 limb pairs split into 8 unsigned digit planes (wide
    u128 operands: 16), so the residue split folds into the matmul exactly
    as in the 32-bit engine;
  * the int32 accumulators recombine into a THREE-u32-limb value V
    (< 2^85), folded to a 64-bit representative with one Shoup multiply of
    the top limb by 2^64 mod p (Goldilocks: 2^64 ≡ 2^32 - 1, shift/adds
    only — generic_solinas.rs:103-128's fold, vectorized);
  * the four-step diagonal (and any user scale) applies via one Montgomery
    multiply against pre-Montgomery'd tables — representatives stay lazy
    (any u64) through the whole pipeline; only the final epilogue reduces
    canonically (Lemire magic division, screened exact — lib.rs:416-445).

Supported moduli: every odd p in (2^33, 2^64) — all five reference butterfly
regimes (prime64.rs:794-864) ride the same engine, with a cheap shift/add
top-limb fold for Goldilocks 2^64-2^32+1 (prime64::Solinas) and an
approximate-Barrett canonical epilogue that needs no exact magic constant.

Results are bit-identical to prime64.Plan's stage engine (tests).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..tables import GOLDILOCKS
from .u32 import (
    add64,
    add64c,
    cond_sub64,
    const64_like,
    gl_mul_lazy,
    mont_mul64,
    mont_neginv64,
    mulhi64,
    mullo64,
    shoup_mul_lazy64,
    shoup_mul_u32_lazy64,
    sub64,
)

def four_step_factors(n: int) -> tuple[int, int]:
    from .mxu32 import four_step_factors as f

    return f(n)


def _n_dplanes(p: int) -> int:
    """Matrix digit planes: smallest D whose balanced radix-256 digits cover
    the centered entries |v| <= p/2 (max positive = 127*(256^D-1)/255).
    7 for the ~50-bit Plan52 table primes, 8 up to ~2^62.99, 9 for
    Goldilocks — fewer planes mean proportionally less matmul work and table
    traffic (the "plane diet")."""
    d = 1
    while p // 2 > 127 * ((1 << (8 * d)) - 1) // 255:
        d += 1
    return d


def _n_eplanes_lazy(p: int) -> int:
    """Operand digit planes for MID-PASS values (bounded by our own scaled
    epilogue): "shoup" mode emits < 4p -> ceil(bits(4p)/8) planes (7 for the
    Plan52 primes); gl/mont modes emit arbitrary u64 representatives -> 8.
    Raw user inputs always use the full 8 planes per limb pair."""
    if _scale_mode(p) != "shoup":
        return 8
    return min(8, ((4 * p - 1).bit_length() + 7) // 8)


def applicable(n: int, p: int) -> bool:
    """All odd moduli in (2^33, 2^64) — the canonical epilogue uses an
    approximate Barrett quotient + conditional subtractions, so no exact
    magic constant is required.

    Upper bound on n: the int8 accumulators are provably exact only while
    the contraction extent E*K <= 4096 (mxu32.assert_accumulator_exact runs
    on every prepared matrix); limb-pair operands contract 8*n2 in the
    row pass, so n2 <= 512 -> n <= 2^18."""
    if n < 2048 or (n & (n - 1)) != 0:
        return False
    log2n = n.bit_length() - 1
    n2 = n >> (log2n // 2)
    if 8 * n2 > 4096:
        return False
    return p % 2 == 1 and (1 << 33) < p < (1 << 64)


# ---------------------------------------------------------------------------
# Table construction (native C++ builder; object-dtype Python fallback)
# ---------------------------------------------------------------------------


def _fwd_stage_range_obj(data, twid, p, s0, s1):
    rows, n = data.shape
    for s in range(s0, s1):
        m = 1 << s
        t = n >> (s + 1)
        v = data.reshape(rows, m, 2, t)
        z0 = v[:, :, 0, :].copy()
        z1 = v[:, :, 1, :]
        wz1 = z1 * twid[m : 2 * m][None, :, None] % p
        v[:, :, 0, :] = (z0 + wz1) % p
        v[:, :, 1, :] = (z0 - wz1) % p
    return data


def _inv_stage_range_obj(data, inv_twid, p, s_hi, s_lo):
    rows, n = data.shape
    for s in range(s_hi - 1, s_lo - 1, -1):
        m = 1 << s
        t = n >> (s + 1)
        v = data.reshape(rows, m, 2, t)
        z0 = v[:, :, 0, :].copy()
        z1 = v[:, :, 1, :]
        v[:, :, 0, :] = (z0 + z1) % p
        v[:, :, 1, :] = (z0 - z1) * inv_twid[m : 2 * m][None, :, None] % p
    return data


@lru_cache(maxsize=32)
def _operators(n: int, p: int):
    """Four-step operators, disk-cached across processes (table_cache)."""
    from .table_cache import cached_operators

    return cached_operators(n, p, lambda: _build_operators(n, p))


def _build_operators(n: int, p: int, n1: int | None = None):
    from .mxu32 import four_step_factors

    log2n = n.bit_length() - 1
    if n1 is None:
        n1, _ = four_step_factors(n)
    n2 = n // n1
    from .. import _native

    ops = _native.fourstep_build(n, p, n1)
    if ops is not None:
        return ops
    # object-dtype fallback (exact bigints; small n / tests only)
    from ..golden.ntt import negacyclic_twiddles

    twid_t, inv_twid_t = negacyclic_twiddles(p, n)
    twid = np.array(twid_t, dtype=object)
    inv_twid = np.array(inv_twid_t, dtype=object)
    k = n1.bit_length() - 1

    def basis_cols(stages_fn):
        out = np.zeros((n1, n1), dtype=object)
        for col in range(2):
            basis = np.zeros((n1, n), dtype=object)
            for i in range(n1):
                basis[i, i * n2 + col] = 1
            res = stages_fn(basis)
            cur = res[:, col::n2].T
            if col == 0:
                out = cur.copy()
            else:
                assert (cur == out).all(), "column dependence"
        return out.astype(np.uint64)

    A = basis_cols(lambda b: _fwd_stage_range_obj(b, twid, p, 0, k))
    Ainv = basis_cols(lambda b: _inv_stage_range_obj(b, inv_twid, p, k, 0))

    def row_ops(stages_fn, out_diag_side):
        B = np.zeros((n1, n2, n2), dtype=object)  # [r, kappa, j]
        for j in range(n2):
            data = np.zeros((1, n), dtype=object)
            data[0].reshape(n1, n2)[:, j] = 1
            res = stages_fn(data)
            B[:, :, j] = res[0].reshape(n1, n2)
        M = B[0].copy()
        diag = np.zeros((n1, n2), dtype=object)
        for r in range(n1):
            if out_diag_side == "input":
                for j in range(n2):
                    diag[r, j] = B[r, 0, j] * pow(int(M[0, j]), p - 2, p) % p
                    for kap in range(n2):
                        assert B[r, kap, j] == M[kap, j] * diag[r, j] % p
            else:
                for kap in range(n2):
                    diag[r, kap] = B[r, kap, 0] * pow(int(M[kap, 0]), p - 2, p) % p
                    for j in range(n2):
                        assert B[r, kap, j] == diag[r, kap] * M[kap, j] % p
        return M.astype(np.uint64), diag.astype(np.uint64)

    F, d = row_ops(lambda b: _fwd_stage_range_obj(b, twid, p, k, log2n), "input")
    G, e = row_ops(
        lambda b: _inv_stage_range_obj(b, inv_twid, p, log2n, k), "output"
    )
    return {"A": A, "F": F, "d": d, "G": G, "e": e, "Ainv": Ainv}


def _prep_matrix64_py(M: np.ndarray, p: int, n_eplanes: int, n_d: int):
    """Python fallback of the wide digit-plane packer (exact, slow)."""
    K, O = M.shape
    planes = np.zeros((n_eplanes * K, n_d * O), dtype=np.int8)
    csum = np.zeros((n_d, O), dtype=np.int64)
    Me = M.astype(object)
    for ee in range(n_eplanes):
        if ee > 0:
            Me = (Me << 8) % p
        Mc = np.array(
            [[int(v) - p if int(v) > p // 2 else int(v) for v in row] for row in Me],
            dtype=np.int64,
        )
        rem = Mc.copy()
        for dd in range(n_d):
            r = ((rem + 128) & 255) - 128
            planes[ee * K : (ee + 1) * K, dd * O : (dd + 1) * O] = r.astype(np.int8)
            csum[dd] += 128 * r.sum(axis=0)
            rem = (rem - r) >> 8
        assert (rem == 0).all()
    cvec = (csum + (1 << 27)).astype(np.int32)
    assert np.abs(csum).max() < (1 << 27)
    return planes, cvec


def _prep64(M: np.ndarray, p: int, n_eplanes: int = 8):
    n_d = _n_dplanes(p)
    from .. import _native
    from .mxu32 import assert_accumulator_exact, off_delta

    out = _native.prep_matrix(
        np.ascontiguousarray(M, dtype=np.uint64), p, n_eplanes, n_d
    )
    if out is None:
        out = _prep_matrix64_py(np.ascontiguousarray(M), p, n_eplanes, n_d)
    planes, cvec = out
    # fold the 2^27 sign offsets to ≡ 0 mod p (see mxu32.off_delta) so no
    # epilogue carries an OFF correction
    cvec = (cvec.astype(np.int64) + off_delta(p, n_d)[:, None]).astype(np.int32)
    out = (planes, cvec)
    assert_accumulator_exact(*out)
    return out


def _scale_mode(p: int) -> str:
    """Static regime of the fused scaled epilogue:
      * "shoup" (2^33 < p < 2^62) — (v0,v1)·W + v2·(2^64·W) + (−OFF·W) as
        two lazy Shoup multiplies (the designed fold3to2+scale fusion; the
        [0,2p) lazy bounds need 4p < 2^64);
      * "gl" (Goldilocks) — cheap shift/add 3→2 fold, then one gl_mul_lazy
        (4 wide multiplies; Shoup laziness is unrepresentable at 2p > 2^64);
      * "mont" (2^62 ≤ p < 2^64, other) — 3→2 fold + Montgomery multiply
        against the pre-Montgomery'd diagonal (the conservative fallback)."""
    if p == GOLDILOCKS:
        return "gl"
    return "shoup" if p < (1 << 62) else "mont"


def _scale_tables64(W: np.ndarray, p: int):
    """Per-element device tables for the fused scaled epilogue, as
    little-endian u32 limb-pair arrays (the sign offset is folded into
    cvec, so no K/OFF tables exist). Layout depends on _scale_mode:
      shoup: (W, ⌊W·2^64/p⌋, W2=2^64·W mod p, ⌊W2·2^64/p⌋) → 8 u32 arrays;
      gl:    (W,) → 2 arrays;
      mont:  (Wt=W·2^64 mod p,) → 2 arrays."""
    Wo = W.astype(object)

    def split(a):
        a = a.astype(object)
        return (
            (a & 0xFFFFFFFF).astype(np.uint64).astype(np.uint32),
            (a >> 32).astype(np.uint64).astype(np.uint32),
        )

    mode = _scale_mode(p)
    if mode == "shoup":
        W2 = (Wo << 64) % p
        Wsh = (Wo << 64) // p
        W2sh = (W2 << 64) // p
        return split(Wo) + split(Wsh) + split(W2) + split(W2sh)
    if mode == "gl":
        return split(Wo)
    return split((Wo << 64) % p)


@lru_cache(maxsize=32)
def _tables(n: int, p: int):
    from .mxu32 import four_step_factors

    n1, n2 = four_step_factors(n)
    return _tables_from_ops(n1, n2, p, _operators(n, p))


def _tables_from_ops(n1: int, n2: int, p: int, ops: dict):
    """Device table dict from an explicit operator set — the seam the
    stage-split hybrid engine (ops/stagesplit.py) uses to run the four-step
    core with per-block operators extracted from a larger transform."""
    c64 = (1 << 64) % p
    tbl = {
        "n1": n1,
        "n2": n2,
        "p": p,
        "goldilocks": p == GOLDILOCKS,
        "c64": c64,
        "c64_shoup": (c64 << 64) // p,
        "p_neginv": mont_neginv64(p),
        "n_d": _n_dplanes(p),
        "scale_mode": _scale_mode(p),
        # A/G consume raw u64 representatives (8 operand planes); F/Ainv
        # consume OUR mid-pass outputs, bounded < 4p in shoup mode, so they
        # need only _n_eplanes_lazy planes (7 for the Plan52 primes) — the
        # operand plane count is recovered downstream from planes.shape.
        "A": _prep64(ops["A"].T, p, 8),
        "F": _prep64(ops["F"].T, p, _n_eplanes_lazy(p)),
        "Ainv": _prep64(ops["Ainv"].T, p, _n_eplanes_lazy(p)),
        "G": _prep64(ops["G"].T, p, 8),
        "d": _scale_tables64(ops["d"].T, p),  # fwd mid layout [n2, n1]
        "e": _scale_tables64(ops["e"], p),  # inv mid layout [n1, n2]
    }
    tbl["barrett"] = (1 << 64) // p  # floor(2^64/p); quotient error <= 2
    if p >= (1 << 63):
        # 2^64 mod p = 2^64 - p: Montgomery fold for the top limb
        tbl["c64_mont"] = (c64 << 64) % p
    return tbl


@lru_cache(maxsize=32)
def _wide_col_planes(n: int, p: int, n_limbs: int):
    ops = _operators(n, p)
    return _prep64(ops["A"].T, p, 4 * n_limbs)


@lru_cache(maxsize=64)
def _scaled_ainv_planes(n: int, p: int, scale: int):
    ops = _operators(n, p)
    M = (ops["Ainv"].T.astype(object) * scale % p).astype(np.uint64)
    return _prep64(M, p, _n_eplanes_lazy(p))


# ---------------------------------------------------------------------------
# Device pipeline
# ---------------------------------------------------------------------------


def _digit_cat(limbs: tuple, n_planes: int | None = None):
    """int8 digit planes of the little-endian u32 limb tuple, concatenated
    on the last axis. n_planes < 4*len(limbs) skips the top bytes — valid
    only when the value bound guarantees they are zero (the F/Ainv mid-pass
    operands, < 4p; see _n_eplanes_lazy)."""
    if n_planes is None:
        n_planes = 4 * len(limbs)
    parts = []
    for ee in range(n_planes):
        limb = limbs[ee // 4]
        # (d & 255) - 128 == low byte of (d ^ 128) as an int8 bit pattern
        # (see mxu32._digit_cat) — 2 fewer elementwise ops per plane.
        dig = (limb >> np.uint32(8 * (ee % 4))) ^ np.uint32(128)
        parts.append(dig.astype(jnp.int8))
    return jnp.concatenate(parts, axis=-1)


def _dot(xd, planes):
    return jax.lax.dot_general(
        xd, planes, (((xd.ndim - 1,), (0,)), ((), ())), preferred_element_type=jnp.int32
    )


def _combine8(big, cvec, o, n_d=8):
    """int32 accumulators [..., D*O] -> 3 u32 limbs of the exact value
    V = Σ_d U_d·2^(8d), for D in [5, 9] matrix digit planes (5-7 for small
    p — the plane diet; 8 up to ~2^63; 9 for Goldilocks)."""
    assert 5 <= n_d <= 9, n_d
    bshape = (1,) * (big.ndim - 1) + (-1,)
    u = [
        (big[..., dd * o : (dd + 1) * o] + cvec[dd].reshape(bshape)).astype(jnp.uint32)
        for dd in range(n_d)
    ]
    t1, t2, t3 = u[1] << np.uint32(8), u[2] << np.uint32(16), u[3] << np.uint32(24)
    s1 = u[0] + t1
    c1 = (s1 < t1).astype(jnp.uint32)
    s2 = s1 + t2
    c2 = (s2 < t2).astype(jnp.uint32)
    v0 = s2 + t3
    c3 = (v0 < t3).astype(jnp.uint32)
    h0 = (u[1] >> np.uint32(24)) + (u[2] >> np.uint32(16)) + (u[3] >> np.uint32(8))
    s = h0 + c1 + c2 + c3 + u[4]  # < 2^28 + 2^23: no wrap
    v2 = jnp.zeros_like(v0)
    for idx, sh in zip(range(5, min(n_d, 8)), (8, 16, 24)):
        t = u[idx] << np.uint32(sh)
        s2h = s + t
        carry = (s2h < t).astype(jnp.uint32)
        s = s2h
        v2 = v2 + (u[idx] >> np.uint32(32 - sh)) + carry
    v1 = s
    if n_d == 9:
        v2 = v2 + u[8]  # digit 8 sits at bit 64 exactly
    return v0, v1, v2


def _fold3to2(v0, v1, v2, tbl):
    """(v0, v1, v2) -> 64-bit limb-pair representative of the same residue."""
    p = tbl["p"]
    if tbl["goldilocks"]:
        # v2 * 2^64 ≡ v2 * (2^32 - 1): t = (v2 << 32) - v2
        nz = (v2 != 0).astype(jnp.uint32)
        t = (jnp.zeros_like(v2) - v2, v2 - nz)
        s, carry = add64c((v0, v1), t)
        # + carry * (2^32 - 1)
        comp = (carry * np.uint32(0xFFFFFFFF), jnp.zeros_like(carry))
        s = add64(s, comp)
        return s
    if p < (1 << 63):
        t = shoup_mul_u32_lazy64(
            v2,
            const64_like(tbl["c64"]),
            const64_like(tbl["c64_shoup"]),
            p,
        )  # [0, 2p); v2 < 2^32 → 2-wide-multiply quotient
    else:
        # p >= 2^63 (non-Goldilocks): Shoup's 2p bound exceeds 2^64; use a
        # Montgomery multiply of the top limb by 2^64*2^64 mod p instead.
        t = mont_mul64(
            (v2, jnp.zeros_like(v2)),
            const64_like(tbl["c64_mont"]),
            p,
            tbl["p_neginv"],
        )
    s, carry = add64c((v0, v1), t)
    comp = (
        carry * np.uint32(tbl["c64"] & 0xFFFFFFFF),
        carry * np.uint32(tbl["c64"] >> 32),
    )
    if 3 * p < (1 << 64):
        return add64(s, comp)  # wrapped s < 2p, + c64 < 3p < 2^64
    s, carry2 = add64c(s, comp)
    comp2 = (
        carry2 * np.uint32(tbl["c64"] & 0xFFFFFFFF),
        carry2 * np.uint32(tbl["c64"] >> 32),
    )
    return add64(s, comp2)  # second round cannot re-wrap (s < p after wrap)


def _scale_mont(rep, mont_tab, tbl):
    """rep * W mod p as a lazy 64-bit representative ("mont"/"gl" scale
    modes). mont_tab = (X_lo, X_hi) with X = W*2^64 mod p (mont: the
    Montgomery factor cancels) or X = W itself (gl: gl_mul_lazy needs no
    factor)."""
    x_lo, x_hi = (jnp.asarray(a) for a in mont_tab)
    if tbl["goldilocks"]:
        return gl_mul_lazy(rep, (x_lo, x_hi))
    return mont_mul64(rep, (x_lo, x_hi), tbl["p"], tbl["p_neginv"])


def _scaled_epilogue(v0, v1, v2, tab, tbl):
    """3-limb combine output -> V·W mod p as a lazy limb pair (the sign
    offset is folded into cvec, so V ≡ true directly).

    "shoup" mode is the fused fold+scale epilogue: with V = v0 + v1·2^32 +
    v2·2^64, the result is (v0,v1)·W + v2·(2^64·W mod p) — two lazy Shoup
    multiplies (the v2 one u32-specialized) replacing the previous top-limb
    fold *plus* Montgomery scale. Bounds (p < 2^62): t1, t2 ∈ [0, 2p)
    → t1+t2 < 4p < 2^64 exact — a valid lazy representative."""
    tab = tuple(jnp.asarray(a) for a in tab)
    if tbl["scale_mode"] == "shoup":
        p = tbl["p"]
        t1 = shoup_mul_lazy64((v0, v1), (tab[0], tab[1]), (tab[2], tab[3]), p)
        t2 = shoup_mul_u32_lazy64(v2, (tab[4], tab[5]), (tab[6], tab[7]), p)
        return add64(t1, t2)  # < 4p < 2^64
    rep = _fold3to2(v0, v1, v2, tbl)
    return _scale_mont(rep, tab, tbl)


def _canonical(v0, v1, v2, tbl):
    """3-limb V (≡ true mod p; offset folded into cvec) -> canonical
    (true mod p) as a limb pair."""
    p = tbl["p"]
    rep = _fold3to2(v0, v1, v2, tbl)
    if p >= (1 << 63):
        return cond_sub64(rep, p)  # rep < 2^64 < 2p
    if p >= (1 << 62):
        return cond_sub64(cond_sub64(rep, 2 * p), p)  # rep < 2^64 < 4p
    # approximate Barrett: q in [floor(rep/p)-2, floor(rep/p)],
    # so rep - q*p < 3p < 2^64 and two conditional subtracts finish.
    q = mulhi64(rep, const64_like(tbl["barrett"]))
    r = sub64(rep, mullo64(q, const64_like(p)))
    return cond_sub64(cond_sub64(r, 2 * p), p)


def _matmod_scaled_lazy(limbs, mat, scale_tab, tbl):
    planes, cvec = (jnp.asarray(a) for a in mat)
    n_d = cvec.shape[0]
    o = planes.shape[1] // n_d
    n_e = planes.shape[0] // limbs[0].shape[-1]  # operand planes (plane diet)
    big = _dot(_digit_cat(limbs, n_e), planes)
    v0, v1, v2 = _combine8(big, cvec, o, n_d)
    return _scaled_epilogue(v0, v1, v2, scale_tab, tbl)


def _matmod_canonical(limbs, mat, tbl):
    planes, cvec = (jnp.asarray(a) for a in mat)
    n_d = cvec.shape[0]
    o = planes.shape[1] // n_d
    n_e = planes.shape[0] // limbs[0].shape[-1]
    big = _dot(_digit_cat(limbs, n_e), planes)
    v0, v1, v2 = _combine8(big, cvec, o, n_d)
    return _canonical(v0, v1, v2, tbl)


def _t(pair):
    return tuple(a.transpose(0, 2, 1) for a in pair)


def _fwd_core(limbs: tuple, tbl: dict, mat1=None):
    """Four-step forward against an explicit table dict (any n1·n2)."""
    n1, n2 = tbl["n1"], tbl["n2"]
    b = limbs[0].shape[0]
    if mat1 is None:
        mat1 = tbl["A"]
    v = tuple(a.reshape(b, n1, n2).transpose(0, 2, 1) for a in limbs)
    y = _matmod_scaled_lazy(v, mat1, tbl["d"], tbl)  # [B, n2, n1] lazy u64
    y = _t(y)  # [B, n1, n2]
    out = _matmod_canonical(y, tbl["F"], tbl)
    return tuple(a.reshape(b, n1 * n2) for a in out)


def _inv_core(limbs: tuple, tbl: dict, mat2=None):
    """Four-step inverse against an explicit table dict (any n1·n2)."""
    n1, n2 = tbl["n1"], tbl["n2"]
    b = limbs[0].shape[0]
    v = tuple(a.reshape(b, n1, n2) for a in limbs)
    y = _matmod_scaled_lazy(v, tbl["G"], tbl["e"], tbl)  # [B, n1, n2] lazy
    y = _t(y)  # [B, n2, n1]
    if mat2 is None:
        mat2 = tbl["Ainv"]
    out = _matmod_canonical(y, mat2, tbl)
    return tuple(a.transpose(0, 2, 1).reshape(b, n1 * n2) for a in out)


def fwd(limbs: tuple, *, n: int, p: int):
    """Forward negacyclic NTT of u64 limb-pair [B, n] arrays (or wider limb
    tuples — the residue split folds into the column matmul). Returns
    (lo, hi) canonical [0, p) limb pairs in bit-reversed order."""
    tbl = _tables(n, p)
    mat1 = tbl["A"] if len(limbs) == 2 else _wide_col_planes(n, p, len(limbs))
    return _fwd_core(limbs, tbl, mat1)


def inv(limbs: tuple, *, n: int, p: int, scale: int = 1):
    """Inverse negacyclic NTT (unnormalized; optional folded scale)."""
    tbl = _tables(n, p)
    mat2 = tbl["Ainv"] if scale == 1 else _scaled_ainv_planes(n, p, scale % p)
    return _inv_core(limbs, tbl, mat2)
