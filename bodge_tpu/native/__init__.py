"""Native (C++) host-runtime tier, bound via ctypes.

The device compute path is JAX/XLA; this package provides the native
host-side runtime around it — the parts the reference delegates to SciPy's
C internals plus the assembly hot loop it runs in pure Python
(``bodge/hamiltonian.py:92-126``):

- :func:`assemble_scatter` — fused symmetry-autofill writes over the whole
  ELL array in one parallel pass (vs. ~10 full-array NumPy passes).
- :func:`herm_error` — max \\|H − H†\\| without leaving the host.
- :func:`mirror_slots` — Hermitian-mirror slot resolution for generic
  (non-cubic) skeletons, replacing an O(nnz) Python dict loop.

The shared library is compiled on demand with g++ (cached under
``~/.cache/bodge_tpu``); every caller must handle :func:`available` being
False (pure-NumPy fallbacks live at the call sites).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "src", "bodge_native.cpp")
_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def _cache_dir() -> str:
    d = os.environ.get(
        "BODGE_NATIVE_CACHE", os.path.expanduser("~/.cache/bodge_tpu")
    )
    os.makedirs(d, exist_ok=True)
    return d


def _build() -> str | None:
    """Compile the shared library, keyed by source hash; None on failure."""
    try:
        with open(_SRC, "rb") as f:
            tag = hashlib.sha256(f.read()).hexdigest()[:16]
        out = os.path.join(_cache_dir(), f"libbodge_native_{tag}.so")
        if os.path.exists(out):
            return out
        cmd = [
            "g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
            "-std=c++17", _SRC, "-o", out + ".tmp",
        ]
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(out + ".tmp", out)
        return out
    except Exception as e:  # toolchain missing, sandboxed, etc.
        print(f"[bodge_tpu.native] build failed ({e}); using NumPy fallbacks",
              file=sys.stderr)
        return None


def _load():
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            print(f"[bodge_tpu.native] dlopen failed ({e})", file=sys.stderr)
            return None
        c_p = ctypes.c_void_p
        i32_p = ctypes.POINTER(ctypes.c_int32)
        for suffix in ("c64", "c128"):
            fn = getattr(lib, f"bodge_assemble_{suffix}")
            fn.argtypes = [c_p, i32_p, ctypes.c_int64, ctypes.c_int32,
                           c_p, c_p, c_p, c_p, c_p, ctypes.c_int]
            fn.restype = None
            fe = getattr(lib, f"bodge_herm_error_{suffix}")
            fe.argtypes = [c_p, i32_p, i32_p, ctypes.c_int64, ctypes.c_int32,
                           ctypes.c_int]
            fe.restype = ctypes.c_double
        lib.bodge_mirror_slots.argtypes = [i32_p, ctypes.c_int64,
                                           ctypes.c_int32, i32_p]
        lib.bodge_mirror_slots.restype = ctypes.c_int
        _LIB = lib
        return _LIB


def available() -> bool:
    return _load() is not None


def _suffix(dtype) -> str:
    dt = np.dtype(dtype)
    if dt == np.complex64:
        return "c64"
    if dt == np.complex128:
        return "c128"
    raise TypeError(f"native tier supports complex64/128, got {dt}")


def _ptr(arr):
    return ctypes.c_void_p(0) if arr is None else arr.ctypes.data_as(ctypes.c_void_p)


def _i32ptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def assemble_scatter(data, cols, *, onsite=None, pair_onsite=None,
                     hop=None, pair=None, pair_rev=None, reset=False) -> None:
    """In-place fused symmetry scatter on host ELL data ``[N, S, 4, 4]``.

    ``onsite``/``pair_onsite``: ``[N, 2, 2]``; ``hop``/``pair``/``pair_rev``:
    ``[S-1, N, 2, 2]`` — all C-contiguous, same complex dtype as ``data``.
    """
    lib = _load()
    assert lib is not None
    N, S = cols.shape
    assert data.flags.c_contiguous
    args = []
    for a in (onsite, pair_onsite, hop, pair, pair_rev):
        if a is not None:
            assert a.flags.c_contiguous and a.dtype == data.dtype
        args.append(_ptr(a))
    if (pair is None) != (pair_rev is None):
        raise ValueError("pair and pair_rev must be given together")
    fn = getattr(lib, f"bodge_assemble_{_suffix(data.dtype)}")
    fn(_ptr(data), _i32ptr(cols), N, S, *args, int(reset))


def herm_error(data, cols, trans) -> float:
    """Max \\|H − H†\\| over structural blocks of host ELL data."""
    lib = _load()
    assert lib is not None
    N, S = cols.shape
    trans = np.ascontiguousarray(trans, dtype=np.int32)
    fn = getattr(lib, f"bodge_herm_error_{_suffix(data.dtype)}")
    return float(fn(_ptr(np.ascontiguousarray(data)), _i32ptr(cols),
                    _i32ptr(trans), N, S, int(trans.ndim == 2)))


def mirror_slots(cols) -> np.ndarray:
    """Per-entry Hermitian-mirror slots; raises if structurally asymmetric."""
    lib = _load()
    assert lib is not None
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    N, S = cols.shape
    out = np.zeros((N, S), dtype=np.int32)
    rc = lib.bodge_mirror_slots(_i32ptr(cols), N, S, _i32ptr(out))
    if rc != 0:
        raise ValueError(
            "Structurally asymmetric skeleton: some block (i,j) has no (j,i) mirror"
        )
    return out
