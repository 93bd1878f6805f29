"""Native (C++) host-math runtime: lazy g++ build + ctypes bindings.

The device path is JAX/XLA; this module is the native tier for
host-side plan construction (the reference's const-eval prime/roots layer and
plan builders run in native Rust — src/prime.rs, src/roots.rs,
prime32.rs:630-686). Falls back to the pure-Python implementations when the
toolchain is unavailable or CONCRETE_NTT_TPU_NO_NATIVE=1 is set; all outputs
are bit-identical to the Python builders (tests/test_native_ext.py).

The library is built from the committed hostmath.cpp only: its file name
carries a hash of that source, so a library built from other source (one
copied along with a tree, say) is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "hostmath.cpp")

_lock = threading.Lock()
_lib = None
_lib_failed = False


def so_path(src: str = _SRC) -> str:
    """Where the library built from `src` lives: keyed by the source hash."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(os.path.dirname(src), f"hostmath-{digest}.so")


def _build(src: str, so: str) -> bool:
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-o", tmp, src],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, so)  # atomic: concurrent builders never see a partial file
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def lib():
    """The loaded CDLL, or None when native is unavailable/disabled."""
    global _lib, _lib_failed
    if os.environ.get("CONCRETE_NTT_TPU_NO_NATIVE"):
        return None
    if _lib is not None:
        return _lib
    if _lib_failed:
        return None
    with _lock:
        if _lib is not None:
            return _lib
        so = so_path()
        if not os.path.exists(so) and not _build(_SRC, so):
            _lib_failed = True
            return None
        try:
            L = ctypes.CDLL(so)
        except OSError:
            _lib_failed = True
            return None
        u64p = ctypes.POINTER(ctypes.c_uint64)
        L.ntt_is_prime64.restype = ctypes.c_int
        L.ntt_is_prime64.argtypes = [ctypes.c_uint64]
        L.ntt_prime_in_ap.restype = ctypes.c_uint64
        L.ntt_prime_in_ap.argtypes = [ctypes.c_uint64] * 4
        L.ntt_find_primitive_root64.restype = ctypes.c_uint64
        L.ntt_find_primitive_root64.argtypes = [ctypes.c_uint64, ctypes.c_uint64]
        L.ntt_twiddles.restype = ctypes.c_int
        L.ntt_twiddles.argtypes = [ctypes.c_uint64, ctypes.c_uint64, u64p, u64p]
        L.ntt_fourstep_build.restype = ctypes.c_int
        L.ntt_fourstep_build.argtypes = [
            ctypes.c_uint64,
            ctypes.c_int64,
            ctypes.c_int64,
            u64p,
            u64p,
            u64p,
            u64p,
            u64p,
            u64p,
        ]
        L.ntt_prep_matrix.restype = ctypes.c_int
        L.ntt_prep_matrix.argtypes = [
            u64p,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_uint64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int8),
            ctypes.POINTER(ctypes.c_int32),
        ]
        L.ntt_prep_matrix_d.restype = ctypes.c_int
        L.ntt_prep_matrix_d.argtypes = [
            u64p,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_uint64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int8),
            ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = L
        return _lib


def _u64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def is_prime64(n: int):
    L = lib()
    return None if L is None else bool(L.ntt_is_prime64(n))


def prime_in_ap(factor: int, offset: int, lo: int, hi: int):
    L = lib()
    if L is None:
        return None
    r = L.ntt_prime_in_ap(factor, offset, lo, hi)
    return int(r) if r else None


def find_primitive_root64(p: int, degree: int):
    L = lib()
    if L is None:
        return None
    r = L.ntt_find_primitive_root64(p, degree)
    return int(r) if r else None


def twiddles(p: int, n: int):
    """(twid, inv_twid) uint64 arrays, or None if native unavailable."""
    L = lib()
    if L is None:
        return None
    tw = np.zeros(n, dtype=np.uint64)
    itw = np.zeros(n, dtype=np.uint64)
    if not L.ntt_twiddles(p, n, _u64p(tw), _u64p(itw)):
        raise ValueError(f"no primitive {2 * n}-th root of unity mod {p}")
    return tw, itw


def fourstep_build(n: int, p: int, n1: int):
    """dict of the six four-step operators (uint64), or None if unavailable."""
    L = lib()
    if L is None:
        return None
    n2 = n // n1
    A = np.zeros((n1, n1), dtype=np.uint64)
    F = np.zeros((n2, n2), dtype=np.uint64)
    d = np.zeros((n1, n2), dtype=np.uint64)
    G = np.zeros((n2, n2), dtype=np.uint64)
    e = np.zeros((n1, n2), dtype=np.uint64)
    Ainv = np.zeros((n1, n1), dtype=np.uint64)
    st = L.ntt_fourstep_build(
        p, n, n1, _u64p(A), _u64p(F), _u64p(d), _u64p(G), _u64p(e), _u64p(Ainv)
    )
    if st != 0:
        raise AssertionError(f"four-step factorization check failed (status {st})")
    return {"A": A, "F": F, "d": d, "G": G, "e": e, "Ainv": Ainv}


def prep_matrix(M: np.ndarray, p: int, n_eplanes: int = 4, n_dplanes: int = 4):
    """(planes int8 [E*K, D*O], cvec int32 [D, O]), or None if unavailable."""
    L = lib()
    if L is None:
        return None
    K, O = M.shape
    M = np.ascontiguousarray(M, dtype=np.uint64)
    planes = np.zeros((n_eplanes * K, n_dplanes * O), dtype=np.int8)
    cvec = np.zeros((n_dplanes, O), dtype=np.int32)
    st = L.ntt_prep_matrix_d(
        _u64p(M),
        K,
        O,
        p,
        n_eplanes,
        n_dplanes,
        planes.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        cvec.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if st != 0:
        raise AssertionError(f"digit-plane packing overflow (status {st})")
    return planes, cvec
