"""Generic radix-2 NTT stage engine (pure jnp, XLA path).

Batched re-design of the reference's breadth-first engines
(fwd_breadth_first_* / inv_breadth_first_*, prime32/shoup.rs:53-160,
prime64/shoup.rs): instead of strided scalar loops + in-register interleave
networks, every stage is a whole-array reshape + slice + vectorized butterfly
over a batch of polynomials. XLA fuses the elementwise algebra; data movement
between stages is tile reshuffling the compiler schedules.

The engine is generic over the value representation: a value is a tuple of
uint32 arrays (1-tuple for u32 fields, (lo, hi) limb pairs for u64 fields),
and a butterfly is a callable on such tuples — the analogue of the
reference's `Butterfly` closure trait (lib.rs:114-116).

Stage structure (identical twiddle indexing to the reference):
  fwd: m blocks doubling 1→n/2, block width 2t halving; block i uses
       twid[m + i]; output bit-reversed (fwd_breadth_first_scalar,
       prime32/shoup.rs:582-636).
  inv: m halving n/2→1, t doubling 1→n/2; block i uses inv_twid[m + i]
       (inv_breadth_first_scalar, prime32/shoup.rs:1355-1408).

The depth-first cache-blocking recursion of the reference
(RECURSION_THRESHOLD, prime32.rs:12) has no analogue here: the
equivalent locality control is the four-step decomposition (ops/mxu32.py,
parallel/fourstep.py).
"""

from __future__ import annotations

from typing import Callable

import jax.numpy as jnp

Parts = tuple  # tuple of [B, n] uint32 arrays
Butterfly = Callable[[Parts, Parts, Parts], tuple[Parts, Parts]]


def fwd_stages(
    parts: Parts,
    twid_parts: Parts,
    butterfly: Butterfly,
    last_butterfly: Butterfly,
    *,
    first_stage: int = 0,
    last_stage: int | None = None,
) -> Parts:
    """Run forward CT stages [first_stage, last_stage) on [B, n] value parts.

    Stage s has m = 2^s blocks. Running a sub-range of stages is the seam the
    four-step distributed transform uses (stage twiddles only depend on the
    global table, so partial runs compose exactly).
    """
    b, n = parts[0].shape
    log2n = n.bit_length() - 1
    stop = log2n if last_stage is None else last_stage
    for s in range(first_stage, stop):
        m = 1 << s
        t = n >> (s + 1)
        z0 = tuple(a.reshape(b, m, 2, t)[:, :, 0, :] for a in parts)
        z1 = tuple(a.reshape(b, m, 2, t)[:, :, 1, :] for a in parts)
        w = tuple(tw[m : 2 * m][None, :, None] for tw in twid_parts)
        bf = last_butterfly if s == log2n - 1 else butterfly
        y0, y1 = bf(z0, z1, w)
        parts = tuple(
            jnp.stack([a, c], axis=2).reshape(b, n) for a, c in zip(y0, y1)
        )
    return parts


def inv_stages(
    parts: Parts,
    twid_parts: Parts,
    butterfly: Butterfly,
    last_butterfly: Butterfly,
    *,
    first_stage: int | None = None,
    last_stage: int = 0,
) -> Parts:
    """Run inverse GS stages from stage first_stage-1 down to last_stage.

    Inverse stage s undoes forward stage s: m = 2^s blocks, t = n/2^(s+1),
    butterfly (z0,z1) → (z0+z1, (z0-z1)·w) with w = inv_twid[m + i].
    """
    b, n = parts[0].shape
    log2n = n.bit_length() - 1
    start = log2n if first_stage is None else first_stage
    for s in range(start - 1, last_stage - 1, -1):
        m = 1 << s
        t = n >> (s + 1)
        z0 = tuple(a.reshape(b, m, 2, t)[:, :, 0, :] for a in parts)
        z1 = tuple(a.reshape(b, m, 2, t)[:, :, 1, :] for a in parts)
        w = tuple(tw[m : 2 * m][None, :, None] for tw in twid_parts)
        bf = last_butterfly if s == 0 else butterfly
        y0, y1 = bf(z0, z1, w)
        parts = tuple(
            jnp.stack([a, c], axis=2).reshape(b, n) for a, c in zip(y0, y1)
        )
    return parts
