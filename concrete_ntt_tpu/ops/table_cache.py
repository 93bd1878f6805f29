"""On-disk cache for the four-step operator matrices.

Plan construction cost is dominated by building the six four-step operators
(A, F, d, G, e, Ainv) per (n, p) — ~2s per prime at n=2^16 even with the
native C++ builder. The matrices are pure functions of (n, p), so they are
cached as .npz files across processes (tests, benches, the driver's compile
checks). Set CONCRETE_NTT_TPU_NO_TABLE_CACHE=1 to disable, or
CONCRETE_NTT_TPU_CACHE_DIR to relocate (default: .cache/tables in the
checkout).

The reference has no analogue (its plans are cheap: twiddle tables only,
prime32.rs:630-686); this is derived-state caching for the matmul engines'
much larger precomputation (SURVEY.md §5 checkpoint/derived-state note).
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

_FORMAT = 1  # bump to invalidate all cached operator files
_KEYS = ("A", "F", "d", "G", "e", "Ainv")


def _cache_dir() -> str | None:
    if os.environ.get("CONCRETE_NTT_TPU_NO_TABLE_CACHE"):
        return None
    d = os.environ.get("CONCRETE_NTT_TPU_CACHE_DIR")
    if not d:
        from ..utils.runtime import CACHE_ROOT

        d = os.path.join(CACHE_ROOT, "tables")
    try:
        os.makedirs(d, exist_ok=True)
        return d
    except OSError:
        return None


def cached_arrays(key: str, build_fn):
    """Generic variant: memoize build_fn()'s {name: uint64 array} dict under
    an arbitrary key (the stage-split hybrid's per-block operator sets)."""
    d = _cache_dir()
    if d is None:
        return build_fn()
    path = os.path.join(d, f"arrays_v{_FORMAT}_{key}.npz")
    if os.path.exists(path):
        try:
            with np.load(path) as z:
                out = {k: z[k] for k in z.files}
            if out and all(v.dtype == np.uint64 for v in out.values()):
                return out
        except Exception:
            pass  # corrupt/partial file: rebuild below
    out = build_fn()
    try:
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz")
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **{k: np.ascontiguousarray(v) for k, v in out.items()})
        os.replace(tmp, path)
    except OSError:
        pass
    return out


def cached_operators(n: int, p: int, build_fn):
    """Return build_fn()'s {A,F,d,G,e,Ainv} dict, memoized on disk."""
    d = _cache_dir()
    if d is None:
        return build_fn()
    path = os.path.join(d, f"fourstep_v{_FORMAT}_{n}_{p}.npz")
    if os.path.exists(path):
        try:
            with np.load(path) as z:
                ops = {k: z[k] for k in _KEYS}
            if all(ops[k].dtype == np.uint64 for k in _KEYS):
                return ops
        except Exception:
            pass  # corrupt/partial file: rebuild below
    ops = build_fn()
    try:
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz")
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **{k: np.ascontiguousarray(ops[k]) for k in _KEYS})
        os.replace(tmp, path)  # atomic: concurrent builders race benignly
    except OSError:
        pass
    return ops
