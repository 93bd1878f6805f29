"""Engine routing for the prime NTTs.

Three plain-XLA engines compute bit-identical results (enforced by tests):

  * "xla"    — the radix-2 stage engine (ops/engine.py), any n;
  * "mxu"    — the four-step int8 digit-plane engine (ops/mxu32.py,
               ops/mxu64.py), n >= 2048;
  * "hybrid" — the stage-split engine (ops/stagesplit.py): butterfly
               prefix stages + blockwise 2^14 four-steps, 64-bit n > 2^14.

`route()` is the one routing decision, keyed by the platform of the default
device. The environment variable CONCRETE_NTT_TPU_ENGINE=auto|mxu|xla
overrides it ("mxu" selects the four-step family, hybrid included).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

# Engine family 'auto' picks per platform and transform width.
#   cpu: the stage engine everywhere (the CPU test suite's reference path).
#   gpu: the four-step family, set by the interleaved engine A/B that
#        chip_smoke.py runs at n = 2^14, B = 8 (PERF.md, "Findings").
ROUTES = {
    "cpu": {32: "xla", 64: "xla"},
    "gpu": {32: "mxu", 64: "mxu"},
}

_ENGINES = ("auto", "mxu", "xla")


def _platform() -> str:
    return jax.devices()[0].platform


def _override() -> str:
    eng = os.environ.get("CONCRETE_NTT_TPU_ENGINE", "auto").lower()
    if eng not in _ENGINES:
        raise ValueError(
            f"CONCRETE_NTT_TPU_ENGINE must be one of {_ENGINES}, got {eng!r}"
        )
    return eng


def route(width: int, n: int) -> str:
    """Engine family for a `width`-bit prime transform of size n: 'xla',
    'mxu' or 'hybrid'. Callers still check that the engine applies to
    (n, p) and fall back to the stage engine when it does not."""
    eng = _override()
    if eng == "auto":
        platform = _platform()
        if platform not in ROUTES:
            raise RuntimeError(f"no engine routing for platform {platform!r}")
        eng = ROUTES[platform][width]
    if eng == "mxu" and width == 64:
        from .stagesplit import N_H

        if n > N_H:
            return "hybrid"
    return eng


def _mxu_wanted(n, p, variant) -> bool:
    from . import mxu32

    return mxu32.applicable(n, p, variant) and route(32, n) != "xla"


def _mxu64_wanted(n, p) -> bool:
    from . import mxu64

    return mxu64.applicable(n, p) and route(64, n) != "xla"


def _mxu64_impl(n, p, pair: bool):
    """Stage-split hybrid above 2^14 for u64 pairs, else the four-step mxu64
    engine (the CRT channel paths keep the direct four-step). Bit-identical."""
    from . import stagesplit

    if pair and route(64, n) == "hybrid" and stagesplit.applicable64(n, p):
        return stagesplit.engine64
    from . import mxu64

    return mxu64


def served_by(width: int, n: int, p: int) -> str:
    """The engine that serves a `width`-bit prime-p transform of size n
    (u64 limb pairs at width 64): 'xla', 'mxu' or 'hybrid'."""
    if width == 32:
        from ..prime32 import _variant

        return "mxu" if _mxu_wanted(n, p, _variant(p)) else "xla"
    if not _mxu64_wanted(n, p):
        return "xla"
    from . import stagesplit

    return "hybrid" if _mxu64_impl(n, p, pair=True) is stagesplit.engine64 else "mxu"


def try_fwd32_wide_all(parts, plans):
    """Fused residue-split + forward NTT for a CRT plan's prime32 channels.

    `parts` is the little-endian u32 limb tuple of the wide operand. On the
    four-step engine the per-coefficient `% p` residue split
    (native64.rs:980-993) folds into the column matmul as extra digit
    planes, so the split stage disappears from the pipeline. Returns a list
    of per-channel NTT-domain residues, or None when the four-step engine
    does not serve these channels (caller falls back to split + per-channel
    fwd)."""
    n = parts[0].shape[-1]
    if not all(_mxu_wanted(n, pl.p, pl.variant) for pl in plans):
        return None
    from . import mxu32

    if len(parts) == 1:  # u32 values: any u32 is a valid residue representative
        return [mxu32.fwd(parts[0], n=n, p=pl.p) for pl in plans]
    return [mxu32.fwd_wide(parts, n=n, p=pl.p) for pl in plans]


def try_fwd32_perchannel_all(stacked, plans):
    """Forward NTTs for all prime32 channels with per-channel residue
    arrays ([k, B, n], any u32 representatives). Serves the Bounded product
    fwd (centered residues differ per channel). Returns a list of
    NTT-domain residues, or None when the four-step engine does not apply."""
    n = stacked.shape[-1]
    if not all(_mxu_wanted(n, pl.p, pl.variant) for pl in plans):
        return None
    from . import mxu32

    return [mxu32.fwd(stacked[i], n=n, p=pl.p) for i, pl in enumerate(plans)]


def try_pointwise_inv32_all(fl, fr, plans):
    """Pointwise multiply + normalize + inverse NTT for a CRT plan's prime32
    channels on the four-step engine.

    The pointwise product is a bare Montgomery multiply (a*b*2^-32); the
    2^32 compensation and the n^-1 normalization fold into the inverse
    column matrix — the matmul analogue of the reference's fused
    mul_assign_normalize + inv pipeline (native64.rs:1062-1069). Returns a
    list of standard-order per-channel residues, or None if inapplicable."""
    n = fl.shape[-1]
    if not all(_mxu_wanted(n, pl.p, pl.variant) for pl in plans):
        return None
    from . import mxu32
    from .u32 import mont_mul

    outs = []
    for i, pl in enumerate(plans):
        scale = pow(n, pl.p - 2, pl.p) * pow(2, 32, pl.p) % pl.p
        prod = mont_mul(fl[i], fr[i], pl.p, pl.p_neginv)
        outs.append(mxu32.inv(prod, n=n, p=pl.p, scale=scale))
    return outs


def try_inv32_all(stacked, plans, scales=None):
    """Plain (unnormalized unless scaled) inverse NTTs for all prime32
    channels of a CRT plan. stacked: [k, B, n] any-u32 representatives ->
    list of standard-order canonical residues. Returns None when the
    four-step engine does not apply."""
    n = stacked.shape[-1]
    if not all(_mxu_wanted(n, pl.p, pl.variant) for pl in plans):
        return None
    from . import mxu32

    if scales is None:
        scales = (1,) * len(plans)
    return [
        mxu32.inv(stacked[i], n=n, p=pl.p, scale=scales[i])
        for i, pl in enumerate(plans)
    ]


def try_fwd64(limbs, n, p):
    """Four-step forward for prime64 (u64 limb pairs); None if N/A."""
    if not _mxu64_wanted(n, p):
        return None
    return _mxu64_impl(n, p, pair=len(limbs) == 2).fwd(limbs, n=n, p=p)


def try_inv64(limbs, n, p, scale: int = 1):
    if not _mxu64_wanted(n, p):
        return None
    return _mxu64_impl(n, p, pair=len(limbs) == 2).inv(
        limbs, n=n, p=p, scale=scale
    )


def try_fwd64_wide_all(parts, plans):
    """Fused residue-split + forward NTT for a CRT plan's prime64 (Plan52)
    channels: mxu64 accepts ANY u64 representative, so the per-coefficient
    `mod p` split (split_u64_to_p50) disappears. Returns a list of
    per-channel (lo, hi) NTT-domain residues, or None."""
    n = parts[0].shape[-1]
    if not all(_mxu64_wanted(n, pl.p) for pl in plans):
        return None
    if len(parts) > 2:
        return None  # u128 inputs keep the explicit split path
    from . import mxu64

    limbs = tuple(parts) if len(parts) == 2 else (parts[0], jnp.zeros_like(parts[0]))
    return [mxu64.fwd(limbs, n=n, p=pl.p) for pl in plans]


def try_pointwise_inv64_all(fl, fr, plans):
    """Montgomery pointwise + scaled inverse for Plan52 channels.
    fl, fr: [k, B, n, 2] stacked limb arrays. Returns per-channel (lo, hi)
    standard-order residues, or None."""
    n = fl.shape[-2]
    if not all(_mxu64_wanted(n, pl.p) for pl in plans):
        return None
    from . import mxu64
    from .u32 import mont_mul64, mont_neginv64

    outs = []
    for i, pl in enumerate(plans):
        scale = pow(n, pl.p - 2, pl.p) * pow(2, 64, pl.p) % pl.p
        prod = mont_mul64(
            (fl[i, ..., 0], fl[i, ..., 1]),
            (fr[i, ..., 0], fr[i, ..., 1]),
            pl.p,
            mont_neginv64(pl.p),
        )
        outs.append(mxu64.inv(prod, n=n, p=pl.p, scale=scale))
    return outs


def fwd32(x, tbl, *, p, variant, p_neginv):
    n = x.shape[-1]
    if _mxu_wanted(n, p, variant):
        from . import mxu32

        return mxu32.fwd(x, n=n, p=p)
    from .. import prime32

    shoup = (
        jnp.zeros(0, jnp.uint32) if variant == "generic" else jnp.asarray(tbl["twid_shoup"])
    )
    return prime32._fwd_xla(
        x, jnp.asarray(tbl["twid"]), shoup, p=p, variant=variant, p_neginv=p_neginv
    )


def inv32(x, tbl, *, p, variant, p_neginv):
    n = x.shape[-1]
    if _mxu_wanted(n, p, variant):
        from . import mxu32

        return mxu32.inv(x, n=n, p=p)
    from .. import prime32

    shoup = (
        jnp.zeros(0, jnp.uint32)
        if variant == "generic"
        else jnp.asarray(tbl["inv_twid_shoup"])
    )
    return prime32._inv_xla(
        x, jnp.asarray(tbl["inv_twid"]), shoup, p=p, variant=variant, p_neginv=p_neginv
    )
