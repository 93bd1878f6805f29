"""Prime32 butterfly regimes (u32 elementwise algebra).

Three regimes selected by the modulus size, mirroring the reference's
dispatch (prime32.rs:713-755):

  * p < 2^30  — Harvey lazy reduction in [0, 4p)   (less_than_30bit.rs)
  * p < 2^31  — lazy reduction in [0, 2p)          (less_than_31bit.rs)
  * p >= 2^31 — fully-reduced Montgomery-domain twiddles (replaces the
    reference's Lemire-reciprocal `generic` engine, generic.rs:9-127, which
    needs native u64 lanes; Montgomery achieves the same canonical-per-stage
    semantics in pure u32)

All butterflies take/return 1-tuples of uint32 arrays (engine convention)
and produce *canonical* [0, p) outputs after the final stage, which is what
makes outputs bit-exact against the golden model and the Rust reference.

The reference's wrapping `min` trick `z0.min(z0.wrapping_sub(2p))`
(less_than_30bit.rs:125-128) relies on two's-complement compare semantics;
here we use an explicit select (`cond_sub`) — SURVEY.md §7 hard part 1.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .u32 import cond_sub, mont_mul, shoup_mul_lazy


def make_fwd_lt30(p: int):
    two_p = 2 * p

    def butterfly(z0, z1, w):
        (x0,), (x1,), (wv, ws) = z0, z1, w
        x0 = cond_sub(x0, np.uint32(two_p))  # [0,4p) -> [0,2p)
        t = shoup_mul_lazy(x1, wv, ws, p)  # [0,2p)
        return (x0 + t,), (x0 - t + np.uint32(two_p),)  # both [0,4p)

    def last_butterfly(z0, z1, w):
        (x0,), (x1,), (wv, ws) = z0, z1, w
        x0 = cond_sub(cond_sub(x0, np.uint32(two_p)), np.uint32(p))  # [0,p)
        t = cond_sub(shoup_mul_lazy(x1, wv, ws, p), np.uint32(p))  # [0,p)
        y0 = cond_sub(x0 + t, np.uint32(p))
        y1 = cond_sub(x0 - t + np.uint32(p), np.uint32(p))
        return (y0,), (y1,)

    return butterfly, last_butterfly


def make_inv_lt30(p: int):
    two_p = 2 * p

    def butterfly(z0, z1, w):
        # Inputs in [0,2p): y0 = (z0+z1) reduced to [0,2p);
        # y1 = (z0-z1+2p)·w via Shoup, lazy [0,2p)  (less_than_30bit.rs:265-282).
        (x0,), (x1,), (wv, ws) = z0, z1, w
        y0 = cond_sub(x0 + x1, np.uint32(two_p))
        t = x0 - x1 + np.uint32(two_p)  # [0,4p) < 2^32
        y1 = shoup_mul_lazy(t, wv, ws, p)
        return (y0,), (y1,)

    def last_butterfly(z0, z1, w):
        (x0,), (x1,), (wv, ws) = z0, z1, w
        y0 = cond_sub(x0 + x1, np.uint32(two_p))
        t = x0 - x1 + np.uint32(two_p)
        y1 = shoup_mul_lazy(t, wv, ws, p)
        return (cond_sub(y0, np.uint32(p)),), (cond_sub(y1, np.uint32(p)),)

    return butterfly, last_butterfly


def make_fwd_lt31(p: int):
    """[0,2p)-invariant variant for 2^30 <= p < 2^31 (less_than_31bit.rs)."""

    def butterfly(z0, z1, w):
        (x0,), (x1,), (wv, ws) = z0, z1, w
        x0 = cond_sub(x0, np.uint32(p))  # [0,2p) -> [0,p)
        t = cond_sub(shoup_mul_lazy(x1, wv, ws, p), np.uint32(p))  # [0,p)
        return (x0 + t,), (x0 - t + np.uint32(p),)  # both [0,2p)

    def last_butterfly(z0, z1, w):
        (y0,), (y1,) = butterfly(z0, z1, w)
        return (cond_sub(y0, np.uint32(p)),), (cond_sub(y1, np.uint32(p)),)

    return butterfly, last_butterfly


def make_inv_lt31(p: int):
    def butterfly(z0, z1, w):
        # Inputs in [0,p): y0 = cond_sub(z0+z1), y1 = (z0-z1+p)·w canonical.
        (x0,), (x1,), (wv, ws) = z0, z1, w
        y0 = cond_sub(x0 + x1, np.uint32(p))
        t = x0 - x1 + np.uint32(p)  # [0,2p) < 2^32
        y1 = cond_sub(shoup_mul_lazy(t, wv, ws, p), np.uint32(p))
        return (y0,), (y1,)

    return butterfly, butterfly  # already canonical per stage


def make_fwd_generic32(p: int, p_neginv: int):
    """p >= 2^31: Montgomery-form twiddles, canonical [0,p) every stage.

    Twiddle tables store w·2^32 mod p so mont_mul(z1, w_mont) = z1·w mod p.
    """

    def butterfly(z0, z1, w):
        (x0,), (x1,), (wm,) = z0, z1, w
        t = mont_mul(x1, wm, p, p_neginv)
        y0 = x0 + t
        ovf = y0 < x0
        y0 = jnp.where(ovf, y0 - np.uint32(p), cond_sub(y0, np.uint32(p)))
        y1 = jnp.where(x0 >= t, x0 - t, x0 - t + np.uint32(p))
        return (y0,), (y1,)

    return butterfly, butterfly


def make_inv_generic32(p: int, p_neginv: int):
    def butterfly(z0, z1, w):
        (x0,), (x1,), (wm,) = z0, z1, w
        s = x0 + x1
        ovf = s < x0
        y0 = jnp.where(ovf, s - np.uint32(p), cond_sub(s, np.uint32(p)))
        d = jnp.where(x0 >= x1, x0 - x1, x0 - x1 + np.uint32(p))
        y1 = mont_mul(d, wm, p, p_neginv)
        return (y0,), (y1,)

    return butterfly, butterfly
