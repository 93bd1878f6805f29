"""Stage-split hybrid NTT engine: butterfly prefix + blockwise four-steps.

Why: the four-step engine pays n·(n1+n2)·E·D int8 MACs per polynomial
(docs/MXU_ENGINE.md §5), so its per-element cost grows as n^0.5 past
n = 2^14 (n = 2^15 → n1+n2 = 384; 2^17 → 768). This engine runs
ℓ = log2(n) − 14 Cooley–Tukey stages as elementwise XLA butterfly layers
and then 2^ℓ INDEPENDENT size-2^14 four-step transforms — n·256·E·D MACs
+ ℓ·O(n) elementwise work for any n, i.e. the same per-element matmul cost
as the engine at 2^14.

Correctness is by construction + complete structural proof, no new twiddle
algebra:

* After stages [0, ℓ) of the exact CT stage engine, the remaining stages
  act independently on 2^ℓ contiguous coefficient blocks (stage s pairs
  stride n/2^(s+1) < n_h for s ≥ ℓ). Block b's stages are a size-n_h
  transform whose operators come from the parent transform built with
  n1 = 2^ℓ·n1_h (native builder, its own factorization asserts):
  - the prefix acts on the n1 row space as M_fwd ⊗ I (M_fwd the exact
    2^ℓ×2^ℓ block-index matrix of stages [0, ℓ), built from the exact
    stage engine), so A_parent[b-block, t-block] = M_fwd[b,t]·A_b and the
    per-block column matrices A_b are SLICES of A_parent — asserted for
    every (b, t) block entry, a complete proof of the factorization;
  - the row operators are untouched by the split: F, G are shared and
    d_b, e_b are row-slices of the parent's diagonals;
  - inversely, Ainv_parent[b-block, t-block] = M_inv[b,t]·Ainv_t, asserted
    the same way.
* The device prefix/suffix butterflies implement M ⊗ I with
  representative-safe limb arithmetic: lazy Shoup multiplies (Montgomery
  for p ≥ 2^62) plus wrap corrections by 2^64 mod p, so the four-step
  cores' any-representative contract is preserved; the inverse suffix is
  canonical-in/canonical-out, preserving inv()'s canonical contract.

Reference relation: the reference handles large n with depth-first cache
blocking (RECURSION_THRESHOLD, prime32.rs:12) — same recursive CT split,
applied here to keep the four-step matmuls at their 2^14 operating point
instead of the L1 cache. No reference code is reused.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

import jax.numpy as jnp

from . import mxu64
from .u32 import (
    add64,
    add64c,
    add_mod64,
    cond_sub64,
    const64_like,
    mont_mul64,
    mont_neginv64,
    select64,
    shoup_mul_lazy64,
    sub64,
    sub64b,
)

N_H = 1 << 14  # block transform size


def applicable64(n: int, p: int, n_h: int = N_H) -> bool:
    """Hybrid applies above the block size (odd p; any regime)."""
    return n > n_h and (n & (n - 1)) == 0 and mxu64.applicable(n_h, p)


# ---------------------------------------------------------------------------
# Host build: per-block operators by slicing the parent transform
# ---------------------------------------------------------------------------


def _cross_mats(l: int, twid, inv_twid, p: int):
    """Exact 2^ℓ×2^ℓ block-index matrices of stages [0, ℓ) (fwd) and the
    matching inverse stages. The cross stages pair whole blocks with
    per-pair twiddles twid[m + i], which on the block index is literally a
    size-2^ℓ stage engine run over the global table's first entries."""
    nb = 1 << l
    tw = np.array(twid[:nb], dtype=object)
    itw = np.array(inv_twid[:nb], dtype=object)
    Mf = np.zeros((nb, nb), dtype=object)
    Mi = np.zeros((nb, nb), dtype=object)
    for i in range(nb):
        basis = np.zeros((1, nb), dtype=object)
        basis[0, i] = 1
        Mf[:, i] = mxu64._fwd_stage_range_obj(basis.copy(), tw, p, 0, l)[0]
        basis = np.zeros((1, nb), dtype=object)
        basis[0, i] = 1
        Mi[:, i] = mxu64._inv_stage_range_obj(basis.copy(), itw, p, l, 0)[0]
    return Mf, Mi


def _extract_blocks(par_mat: np.ndarray, M: np.ndarray, n1h: int, p: int,
                    which: str, side: str):
    """Per-block n1h×n1h matrices from the parent column operator.

    side="row"  (fwd A, applied AFTER the prefix — block-diagonal on the
    output side): parent[b-block, t-block] = M[b, t]·B_b.
    side="col"  (inv Ainv, applied BEFORE the suffix — block-diagonal on
    the input side): parent[b-block, t-block] = M[b, t]·B_t.
    Every block entry is asserted — a complete factorization proof."""
    nb = M.shape[0]
    A = par_mat.astype(object)

    def blk(b, t):
        return A[b * n1h : (b + 1) * n1h, t * n1h : (t + 1) * n1h]

    blocks = []
    for i in range(nb):
        if side == "row":
            j = next(t for t in range(nb) if int(M[i, t]) != 0)
            raw, m0 = blk(i, j), int(M[i, j])
        else:
            j = next(b for b in range(nb) if int(M[b, i]) != 0)
            raw, m0 = blk(j, i), int(M[j, i])
        blocks.append(raw * pow(m0, p - 2, p) % p)
    for b in range(nb):
        for t in range(nb):
            base = blocks[b] if side == "row" else blocks[t]
            expect = base * int(M[b, t]) % p
            assert (blk(b, t) == expect).all(), (
                f"stage-split {which} factorization fails at block ({b},{t})"
            )
    return [b.astype(np.uint64) for b in blocks]


def _build_hybrid_ops(n: int, p: int, n_h: int):
    from ..golden.ntt import negacyclic_twiddles

    l = (n // n_h).bit_length() - 1
    nb = 1 << l
    n1h, n2 = mxu64.four_step_factors(n_h)
    par = mxu64._build_operators(n, p, n1=nb * n1h)
    twid, inv_twid = negacyclic_twiddles(p, n)
    Mf, Mi = _cross_mats(l, twid, inv_twid, p)
    A_blocks = _extract_blocks(par["A"], Mf, n1h, p, "fwd", "row")
    Ainv_blocks = _extract_blocks(par["Ainv"], Mi, n1h, p, "inv", "col")
    out = {
        "F": par["F"],
        "G": par["G"],
        # canonical stage twiddles for the device prefix/suffix butterflies
        "tw": np.array([int(t) for t in twid[:nb]], dtype=np.uint64),
        "itw": np.array([int(t) for t in inv_twid[:nb]], dtype=np.uint64),
    }
    for b in range(nb):
        out[f"A{b}"] = A_blocks[b]
        out[f"Ainv{b}"] = Ainv_blocks[b]
        out[f"d{b}"] = par["d"][b * n1h : (b + 1) * n1h]
        out[f"e{b}"] = par["e"][b * n1h : (b + 1) * n1h]
    assert out["F"].shape == (n2, n2) and out[f"d{nb-1}"].shape == (n1h, n2)
    return out


@lru_cache(maxsize=16)
def _hybrid_ops(n: int, p: int, n_h: int):
    from .table_cache import cached_arrays

    return cached_arrays(
        f"stagesplit_{n}_{p}_{n_h}", lambda: _build_hybrid_ops(n, p, n_h)
    )


# ---------------------------------------------------------------------------
# Device stage butterflies (representative-safe limb arithmetic)
# ---------------------------------------------------------------------------


def _add_rep64(a, b, c64):
    """a + b as a valid u64 representative for ANY representatives a, b:
    each 2^64 wrap is compensated by adding 2^64 mod p (< 2^63, so the
    second correction cannot wrap again)."""
    s, c = add64c(a, b)
    s, c2 = add64c(s, (c * c64[0], c * c64[1]))
    return add64(s, (c2 * c64[0], c2 * c64[1]))


def _sub_rep64(a, b, c64):
    """a − b as a valid u64 representative for ANY representatives a, b."""
    d, bo = sub64b(a, b)
    bo = bo.astype(jnp.uint32)
    d, bo2 = sub64b(d, (bo * c64[0], bo * c64[1]))
    bo2 = bo2.astype(jnp.uint32)
    return sub64(d, (bo2 * c64[0], bo2 * c64[1]))


def _sub_mod64_canon(a, b, p: int):
    """(a − b) mod p canonical for canonical a, b in [0, p)."""
    d, bo = sub64b(a, b)
    return select64(bo, add64(d, const64_like(p)), d)


def _stage_fwd64(parts, w_tab, sc):
    """One forward CT stage on [B, n] limb pairs; any-representative in/out.
    w_tab: per-block twiddle constant pairs shaped [1, m, 1]."""
    lo, hi = parts
    b, n = lo.shape
    m = w_tab[0][0].shape[1]
    t = n // (2 * m)
    v = tuple(a.reshape(b, m, 2, t) for a in (lo, hi))
    z0 = tuple(a[:, :, 0, :] for a in v)
    z1 = tuple(a[:, :, 1, :] for a in v)
    if sc["mont"]:
        wz1 = mont_mul64(z1, w_tab[0], sc["p"], sc["neginv"])
    else:
        wz1 = shoup_mul_lazy64(z1, w_tab[0], w_tab[1], sc["p"])
    top = _add_rep64(z0, wz1, sc["c64"])
    bot = _sub_rep64(z0, wz1, sc["c64"])
    return tuple(
        jnp.stack([a, c], axis=2).reshape(b, n) for a, c in zip(top, bot)
    )


def _stage_inv64(parts, w_tab, sc):
    """One inverse GS stage; canonical [0, p) in and out."""
    lo, hi = parts
    b, n = lo.shape
    m = w_tab[0][0].shape[1]
    t = n // (2 * m)
    p = sc["p"]
    v = tuple(a.reshape(b, m, 2, t) for a in (lo, hi))
    y0 = tuple(a[:, :, 0, :] for a in v)
    y1 = tuple(a[:, :, 1, :] for a in v)
    top = add_mod64(y0, y1, p)
    d = _sub_mod64_canon(y0, y1, p)
    if sc["mont"]:
        bot = mont_mul64(d, w_tab[0], p, sc["neginv"])  # canonical: d < p
    else:
        bot = cond_sub64(shoup_mul_lazy64(d, w_tab[0], w_tab[1], p), p)
    return tuple(
        jnp.stack([a, c], axis=2).reshape(b, n) for a, c in zip(top, bot)
    )


# ---------------------------------------------------------------------------
# Device tables + entry points
# ---------------------------------------------------------------------------


def _split_u64(vals: np.ndarray, shape):
    lo = (vals & np.uint64(0xFFFFFFFF)).astype(np.uint32).reshape(shape)
    hi = (vals >> np.uint64(32)).astype(np.uint32).reshape(shape)
    return lo, hi


def _stage_tabs(tw: np.ndarray, p: int, mont: bool):
    """Per-stage device twiddle tables: stage s uses entries [2^s, 2^(s+1))
    shaped [1, m, 1]. Shoup pairs for p < 2^62; W·2^64 mod p for mont."""
    l = tw.shape[0].bit_length() - 1
    tabs = []
    for s in range(l):
        w = [int(x) for x in tw[1 << s : 2 << s]]
        shape = (1, 1 << s, 1)
        if mont:
            wt = np.array([(x << 64) % p for x in w], dtype=np.uint64)
            tabs.append((_split_u64(wt, shape),))
        else:
            w64 = np.array(w, dtype=np.uint64)
            wsh = np.array([(x << 64) // p for x in w], dtype=np.uint64)
            tabs.append((_split_u64(w64, shape), _split_u64(wsh, shape)))
    return tabs


@lru_cache(maxsize=16)
def _dev64(n: int, p: int, n_h: int):
    ops = _hybrid_ops(n, p, n_h)
    l = (n // n_h).bit_length() - 1
    nb = 1 << l
    n1h, n2 = mxu64.four_step_factors(n_h)
    mont = p >= (1 << 62)
    blocks = tuple(
        mxu64._tables_from_ops(
            n1h,
            n2,
            p,
            {
                "A": ops[f"A{b}"],
                "F": ops["F"],
                "d": ops[f"d{b}"],
                "G": ops["G"],
                "e": ops[f"e{b}"],
                "Ainv": ops[f"Ainv{b}"],
            },
        )
        for b in range(nb)
    )
    sc = {
        "p": p,
        "mont": mont,
        "neginv": mont_neginv64(p),
        "c64": const64_like((1 << 64) % p),
    }
    return {
        "l": l,
        "blocks": blocks,
        "sc": sc,
        "fwd_tw": _stage_tabs(ops["tw"], p, mont),
        "inv_tw": _stage_tabs(ops["itw"], p, mont),
    }


@lru_cache(maxsize=32)
def _scaled_ainv_blocks64(n: int, p: int, n_h: int, scale: int):
    ops = _hybrid_ops(n, p, n_h)
    nb = n // n_h
    out = []
    for b in range(nb):
        M = (ops[f"Ainv{b}"].T.astype(object) * scale % p).astype(np.uint64)
        out.append(mxu64._prep64(M, p, mxu64._n_eplanes_lazy(p)))
    return tuple(out)


def fwd64(limbs: tuple, *, n: int, p: int, n_h: int = N_H):
    """Hybrid forward: ℓ XLA butterfly stages + 2^ℓ blockwise four-steps.
    Bit-identical to mxu64.fwd (tests, chip_smoke.py)."""
    dv = _dev64(n, p, n_h)
    x = tuple(jnp.asarray(a) for a in limbs)
    for s in range(dv["l"]):
        x = _stage_fwd64(x, dv["fwd_tw"][s], dv["sc"])
    b = x[0].shape[0]
    nb = 1 << dv["l"]
    xb = tuple(a.reshape(b, nb, n_h) for a in x)
    outs = [
        mxu64._fwd_core(tuple(a[:, i, :] for a in xb), dv["blocks"][i])
        for i in range(nb)
    ]
    return tuple(
        jnp.concatenate([o[j] for o in outs], axis=-1) for j in range(2)
    )


def inv64(limbs: tuple, *, n: int, p: int, scale: int = 1, n_h: int = N_H):
    """Hybrid inverse: blockwise four-steps + ℓ canonical suffix stages.
    Bit-identical to mxu64.inv (optional folded scale)."""
    dv = _dev64(n, p, n_h)
    x = tuple(jnp.asarray(a) for a in limbs)
    b = x[0].shape[0]
    nb = 1 << dv["l"]
    mats = (
        [None] * nb
        if scale == 1
        else _scaled_ainv_blocks64(n, p, n_h, scale % p)
    )
    xb = tuple(a.reshape(b, nb, n_h) for a in x)
    outs = [
        mxu64._inv_core(tuple(a[:, i, :] for a in xb), dv["blocks"][i], mats[i])
        for i in range(nb)
    ]
    x = tuple(
        jnp.concatenate([o[j] for o in outs], axis=-1) for j in range(2)
    )
    for s in range(dv["l"] - 1, -1, -1):
        x = _stage_inv64(x, dv["inv_tw"][s], dv["sc"])
    return x


class _Engine64:
    """Dispatch shim with the mxu64 engine surface (u64 limb pairs only —
    the dispatcher keeps wide limb tuples on the direct four-step)."""

    def fwd(self, limbs, *, n, p):
        assert len(limbs) == 2, "hybrid engine is u64-pair only"
        return fwd64(limbs, n=n, p=p)

    def inv(self, limbs, *, n, p, scale=1):
        assert len(limbs) == 2, "hybrid engine is u64-pair only"
        return inv64(limbs, n=n, p=p, scale=scale)


engine64 = _Engine64()


# ---------------------------------------------------------------------------
# 32-bit hybrid (prime32): same host build, u32 stage butterflies
# ---------------------------------------------------------------------------


def _stage_tabs32(tw: np.ndarray, p: int, mont: bool):
    l = tw.shape[0].bit_length() - 1
    tabs = []
    for s in range(l):
        w = [int(x) for x in tw[1 << s : 2 << s]]
        shape = (1, 1 << s, 1)
        if mont:
            tabs.append(
                (np.array([(x << 32) % p for x in w], np.uint32).reshape(shape),)
            )
        else:
            tabs.append((
                np.array(w, np.uint32).reshape(shape),
                np.array([(x << 32) // p for x in w], np.uint32).reshape(shape),
            ))
    return tabs


def _add_rep32(a, b, c32):
    """a + b as a valid u32 representative for ANY representatives (each
    2^32 wrap compensated by +2^32 mod p; c32 < 2^31, so at most two)."""
    s = a + b
    c = (s < a).astype(jnp.uint32)
    s2 = s + c * c32
    c2 = (s2 < s).astype(jnp.uint32)
    return s2 + c2 * c32


def _sub_rep32(a, b, c32):
    d = a - b
    bo = (a < b).astype(jnp.uint32)
    d2 = d - bo * c32
    bo2 = (d2 > d).astype(jnp.uint32)
    return d2 - bo2 * c32


def _stage_fwd32(x, w_tab, sc):
    from .u32 import mont_mul, shoup_mul_lazy

    b, n = x.shape
    m = w_tab[0].shape[1]
    t = n // (2 * m)
    v = x.reshape(b, m, 2, t)
    z0, z1 = v[:, :, 0, :], v[:, :, 1, :]
    if sc["mont"]:
        wz1 = mont_mul(z1, jnp.asarray(w_tab[0]), sc["p"], sc["neginv"])
    else:
        wz1 = shoup_mul_lazy(
            z1, jnp.asarray(w_tab[0]), jnp.asarray(w_tab[1]), sc["p"]
        )
    top = _add_rep32(z0, wz1, sc["c32"])
    bot = _sub_rep32(z0, wz1, sc["c32"])
    return jnp.stack([top, bot], axis=2).reshape(b, n)


def _stage_inv32(x, w_tab, sc):
    from .u32 import add_mod, mont_mul, shoup_mul_lazy

    b, n = x.shape
    m = w_tab[0].shape[1]
    t = n // (2 * m)
    p = sc["p"]
    v = x.reshape(b, m, 2, t)
    y0, y1 = v[:, :, 0, :], v[:, :, 1, :]
    top = add_mod(y0, y1, p)
    d0 = y0 - y1
    d = jnp.where(y0 >= y1, d0, d0 + np.uint32(p))
    if sc["mont"]:
        bot = mont_mul(d, jnp.asarray(w_tab[0]), p, sc["neginv"])
    else:
        tl = shoup_mul_lazy(
            d, jnp.asarray(w_tab[0]), jnp.asarray(w_tab[1]), p
        )
        bot = jnp.where(tl >= np.uint32(p), tl - np.uint32(p), tl)
    return jnp.stack([top, bot], axis=2).reshape(b, n)


@lru_cache(maxsize=16)
def _dev32(n: int, p: int, n_h: int):
    from . import mxu32
    from .u32 import mont_neginv

    ops = _hybrid_ops(n, p, n_h)
    l = (n // n_h).bit_length() - 1
    nb = 1 << l
    n1h, n2 = mxu64.four_step_factors(n_h)
    mont = p >= (1 << 31)
    blocks = tuple(
        mxu32._mxu_tables_from_ops(
            n1h,
            n2,
            p,
            {
                "A": ops[f"A{b}"],
                "F": ops["F"],
                "d": ops[f"d{b}"],
                "G": ops["G"],
                "e": ops[f"e{b}"],
                "Ainv": ops[f"Ainv{b}"],
            },
        )
        for b in range(nb)
    )
    sc = {
        "p": p,
        "mont": mont,
        "neginv": mont_neginv(p),
        "c32": np.uint32((1 << 32) % p),
    }
    return {
        "l": l,
        "blocks": blocks,
        "sc": sc,
        "fwd_tw": _stage_tabs32(ops["tw"], p, mont),
        "inv_tw": _stage_tabs32(ops["itw"], p, mont),
    }


@lru_cache(maxsize=32)
def _scaled_ainv_blocks32(n: int, p: int, n_h: int, scale: int):
    from . import mxu32

    ops = _hybrid_ops(n, p, n_h)
    nb = n // n_h
    out = []
    for b in range(nb):
        M = (ops[f"Ainv{b}"].T.astype(object) * scale % p).astype(np.uint64)
        out.append(mxu32._prep(M, p))
    return tuple(out)


def _hybrid32_run(x, n, p, n_h, direction, scale):
    from . import mxu32

    dv = _dev32(n, p, n_h)
    x = jnp.asarray(x)
    nb = 1 << dv["l"]
    if direction == "fwd":
        for s in range(dv["l"]):
            x = _stage_fwd32(x, dv["fwd_tw"][s], dv["sc"])
    b = x.shape[0]
    xb = x.reshape(b, nb, n_h)
    if direction == "fwd":
        outs = [
            mxu32._fwd_core(xb[:, i, :], dv["blocks"][i], p=p)
            for i in range(nb)
        ]
    else:
        mats = (
            [None] * nb
            if scale == 1
            else _scaled_ainv_blocks32(n, p, n_h, scale % p)
        )
        outs = [
            mxu32._inv_core(xb[:, i, :], dv["blocks"][i], p=p, mat2=mats[i])
            for i in range(nb)
        ]
    x = jnp.concatenate(outs, axis=-1)
    if direction == "inv":
        for s in range(dv["l"] - 1, -1, -1):
            x = _stage_inv32(x, dv["inv_tw"][s], dv["sc"])
    return x


def fwd32(x, *, n: int, p: int, n_h: int = N_H):
    return _hybrid32_run(x, n, p, n_h, "fwd", 1)


def inv32(x, *, n: int, p: int, scale: int = 1, n_h: int = N_H):
    return _hybrid32_run(x, n, p, n_h, "inv", scale)
