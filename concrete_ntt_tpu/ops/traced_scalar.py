"""Traced-scalar four-step algebra for per-channel operands.

The four-step engines (ops/mxu32.py, ops/mxu64.py) bake the prime and its
reduction constants into the trace as Python ints. Where one program serves
several CRT channels whose primes differ per shard — the channel-sharded
local sections of parallel/channels.py — the same epilogues run with the
constants as traced per-channel arrays. These helpers are that traced-scalar
twin, bit-identical to the engines (asserted by tests), plus the stacked
per-channel tables they read.

32-bit helpers serve 2^29 < p < 2^30 (the native plans' table primes): for
every such prime the canonical reduction chain is cond_sub(4p), cond_sub(2p),
cond_sub(p) — asserted at table-build time. 64-bit helpers serve the
p < 2^62 "shoup" scale mode of mxu64 (the ~50-bit Plan52 primes).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from . import mxu32, mxu64
from .u32 import (
    add64,
    add64c,
    geq64,
    mulhi64,
    mullo64,
    mulwide64,
    select64,
    sub64,
)

# ---------------------------------------------------------------------------
# 32-bit channels
# ---------------------------------------------------------------------------


def _sc_epilogue_scaled_lazy(lo, hi, dg, sc):
    """Traced-scalar version of mxu32._epilogue_scaled_lazy (lazy4 regime;
    the sign offset is folded into cvec so no pad term exists)."""
    p, c32, c32_sh, _unused, two_p = sc
    w, w_sh, w32, w32_sh = dg
    from .u32 import mulhi_u32

    a = lo * w - mulhi_u32(lo, w_sh) * p
    b = hi * w32 - mulhi_u32(hi, w32_sh) * p
    s = a + b  # < 4p < 2^32 (p < 2^30)
    return jnp.where(s >= two_p, s - two_p, s)  # < 2p: valid representative


def _sc_epilogue_canonical(lo, hi, sc):
    """Traced-scalar version of mxu32._epilogue_canonical for 2^29 < p < 2^30."""
    p, c32, c32_sh, _unused, two_p = sc
    from .u32 import mulhi_u32

    r = hi * c32 - mulhi_u32(hi, c32_sh) * p  # [0, 2p)
    r = jnp.where(r >= p, r - p, r)
    four_p = two_p + two_p  # < 2^32 for p < 2^30
    lo = jnp.where(lo >= four_p, lo - four_p, lo)
    lo = jnp.where(lo >= two_p, lo - two_p, lo)
    lo = jnp.where(lo >= p, lo - p, lo)
    s = r + lo
    return jnp.where(s >= p, s - p, s)


def _sc_combine(big, cvec, o):
    u = [
        (big[..., dd * o : (dd + 1) * o] + cvec[dd][None, None, :]).astype(jnp.uint32)
        for dd in range(4)
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
    return lo, hi


def _dot8(xd, planes):
    return jax.lax.dot_general(
        xd, planes, (((xd.ndim - 1,), (0,)), ((), ())), preferred_element_type=jnp.int32
    )


def _multi_tables(n: int, primes: tuple, n_limbs: int, scales: tuple):
    """Stacked per-channel tables [C, ...] of the 32-bit four-step engine,
    consumed as traced per-channel operands (parallel/channels.py)."""
    n1, n2 = mxu32.four_step_factors(n)
    p1f, c1f, p2f, c2f, dgf = [], [], [], [], []
    p1i, c1i, p2i, c2i, dgi = [], [], [], [], []
    scal = []
    for ch, p in enumerate(primes):
        assert (1 << 29) < p < (1 << 30), "channel tables need 30-bit primes"
        tbl = mxu32._mxu_tables(n, p)
        mat1 = mxu32._wide_col_planes(n, p, n_limbs) if n_limbs > 1 else tbl["A"]
        assert tbl["chain"] == (4 * p, 2 * p, p), "unexpected reduction chain"
        p1f.append(mat1[0])
        c1f.append(mat1[1])
        p2f.append(tbl["F"][0])
        c2f.append(tbl["F"][1])
        dgf.append(tbl["d"])
        p1i.append(tbl["G"][0])
        c1i.append(tbl["G"][1])
        if scales[ch] == 1:
            mat2 = tbl["Ainv"]
        else:
            mat2 = mxu32._scaled_ainv_planes(n, p, scales[ch] % p)
        p2i.append(mat2[0])
        c2i.append(mat2[1])
        dgi.append(tbl["e"])
        # slot 3 is reserved-zero (formerly off_mod_p, now folded into cvec)
        scal.append(
            [p, int(tbl["c32"]), int(tbl["c32_shoup"]), 0, 2 * p]
        )
    stack = lambda xs: np.ascontiguousarray(np.stack(xs, axis=0))
    n_dg = len(dgf[0])  # 4 scale-table arrays per channel
    return {
        "n1": n1,
        "n2": n2,
        "fwd": (
            stack(p1f),
            stack(c1f),
            stack(p2f),
            stack(c2f),
            tuple(stack([d[j] for d in dgf]) for j in range(n_dg)),
        ),
        "inv": (
            stack(p1i),
            stack(c1i),
            stack(p2i),
            stack(c2i),
            tuple(stack([d[j] for d in dgi]) for j in range(n_dg)),
        ),
        "scalars": np.array(scal, dtype=np.uint32),  # [C, 5]
    }


def _digit8(x):
    parts = []
    for ee in range(4):
        # xor-128 digit trick (see mxu32._digit_cat): same int8 bit pattern
        # as (d & 255) - 128, two fewer elementwise ops per plane.
        dig = (x >> np.uint32(8 * ee)) ^ np.uint32(128)
        parts.append(dig.astype(jnp.int8))
    return jnp.concatenate(parts, axis=-1)


def _neginv_vec(primes):
    from .u32 import mont_neginv

    return np.array([mont_neginv(p) for p in primes], dtype=np.uint32)


# ---------------------------------------------------------------------------
# 64-bit channels
# ---------------------------------------------------------------------------


def _sc_cond_sub64(x, m):
    return select64(geq64(x, m), sub64(x, m), x)


def _sc_shoup_lazy64(z, w, wsh, p):
    q = mulhi64(z, wsh)
    return sub64(mullo64(z, w), mullo64(q, p))


def _sc_mont_mul64(a, b, p, ninv):
    """u32.mont_mul64 with traced limb-pair scalars (p, -p^-1 mod 2^64)."""
    l0, l1, l2, l3 = mulwide64(a, b)
    t_lo, t_hi = (l0, l1), (l2, l3)
    m = mullo64(t_lo, ninv)
    mp_hi = mulhi64(m, p)
    carry = ((l0 != 0) | (l1 != 0)).astype(jnp.uint32)
    s, c1 = add64c(t_hi, mp_hi)
    s2, c2 = add64c(s, (carry, np.uint32(0)))
    over = (c1 | c2).astype(bool)
    neg_p = sub64((np.uint32(0), np.uint32(0)), p)
    return select64(over, add64(s2, neg_p), _sc_cond_sub64(s2, p))


def _sc_fold3to2(v0, v1, v2, sc):
    """3-limb V -> 64-bit representative; p < 2^62 regime (3p < 2^64)."""
    from .u32 import shoup_mul_u32_lazy64

    c64, c64sh, p = sc["c64"], sc["c64_shoup"], sc["p"]
    t = shoup_mul_u32_lazy64(v2, c64, c64sh, p)  # [0, 2p); u32-specialized
    s, carry = add64c((v0, v1), t)
    comp = (carry * c64[0], carry * c64[1])
    return add64(s, comp)  # wrapped s < 2p, + c64 < 3p < 2^64


def _sc_scaled_epilogue(v0, v1, v2, tab, sc):
    """Traced-scalar twin of mxu64._scaled_epilogue ("shoup" mode only —
    _multi_tables64 restricts the channels to p < 2^62):
    (v0,v1)·W + v2·(2^64·W), two lazy Shoup multiplies (< 4p < 2^64; the
    sign offset is folded into cvec so no correction term exists)."""
    from .u32 import shoup_mul_u32_lazy64

    p = sc["p"]
    t1 = _sc_shoup_lazy64((v0, v1), (tab[0], tab[1]), (tab[2], tab[3]), p)
    t2 = shoup_mul_u32_lazy64(v2, (tab[4], tab[5]), (tab[6], tab[7]), p)
    return add64(t1, t2)


def _sc_canonical(v0, v1, v2, sc):
    """3-limb V (≡ true mod p; offset folded into cvec) -> canonical limb
    pair; p < 2^62 (Barrett)."""
    p = sc["p"]
    rep = _sc_fold3to2(v0, v1, v2, sc)
    q = mulhi64(rep, sc["barrett"])
    r = sub64(rep, mullo64(q, p))
    return _sc_cond_sub64(_sc_cond_sub64(r, sc["two_p"]), p)


_SC_FIELDS = ("p", "c64", "c64_shoup", "p_neginv", "barrett", "two_p")


def _scal_vec64(n: int, p: int, tbl: dict | None = None) -> list[int]:
    if tbl is None:
        tbl = mxu64._tables(n, p)
    vals = (p, tbl["c64"], tbl["c64_shoup"], tbl["p_neginv"], tbl["barrett"],
            2 * p)
    out = []
    for v in vals:
        out += [v & 0xFFFFFFFF, (v >> 32) & 0xFFFFFFFF]
    return out


def _multi_tables64(n: int, primes: tuple, scales: tuple):
    """Stacked per-channel tables [C, ...] of the 64-bit four-step engine
    (p < 2^62 "shoup" mode), consumed as traced per-channel operands."""
    n1, n2 = mxu64.four_step_factors(n)
    stk = lambda xs: np.ascontiguousarray(np.stack(xs, axis=0))
    p1f, c1f, p2f, c2f = [], [], [], []
    p1i, c1i, p2i, c2i = [], [], [], []
    dm, em, scal = [], [], []
    for ch, p in enumerate(primes):
        assert (1 << 33) < p < (1 << 62), "channel tables need p in (2^33, 2^62)"
        tbl = mxu64._tables(n, p)
        p1f.append(tbl["A"][0]); c1f.append(tbl["A"][1])
        p2f.append(tbl["F"][0]); c2f.append(tbl["F"][1])
        p1i.append(tbl["G"][0]); c1i.append(tbl["G"][1])
        if scales[ch] % p == 1:
            m2 = tbl["Ainv"]
        else:
            m2 = mxu64._scaled_ainv_planes(n, p, scales[ch] % p)
        p2i.append(m2[0]); c2i.append(m2[1])
        dm.append(tbl["d"]); em.append(tbl["e"])
        scal.append(_scal_vec64(n, p, tbl) + [0, 0, 0, 0])  # pad to 16
    n_tab = len(dm[0])  # 10 ("shoup" scale mode — guaranteed by p < 2^62)
    return {
        "n1": n1, "n2": n2,
        "fwd": (stk(p1f), stk(c1f), stk(p2f), stk(c2f),
                tuple(stk([d[j] for d in dm]) for j in range(n_tab))),
        "inv": (stk(p1i), stk(c1i), stk(p2i), stk(c2i),
                tuple(stk([e[j] for e in em]) for j in range(n_tab))),
        "scalars": np.array(scal, dtype=np.uint32),  # [C, 16]
    }
