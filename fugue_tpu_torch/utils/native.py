"""ctypes bindings for the C++ host runtime (``csrc/fugue_host.cpp``).

The port of ``fugue_tpu/utils/native.py``: an independent implementation of
the convergence estimators (direct O(n·lag) compensated-sum ESS,
split-R-hat and quantiles) that the tests hold against the port's
``inference/mcmc_utils`` and that host-side tooling can run on large sample
dumps without the card. It is a host backend, not a card kernel.

The package carries its own copy of the source,
``fugue_tpu_torch/csrc/fugue_host.cpp``. At first use it is built with
``g++`` into ``fugue_tpu_torch/_build/`` under a name that carries a hash of
the source and the flags, through a temporary file unique to the process
and an atomic rename, as ``ops/_build.py`` builds the CUDA kernels: workers
that build at once each get the whole library. ``available()`` is False
when there is no ``g++`` or the build fails; every estimator then raises
``RuntimeError``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..ops._build import BUILD_DIR, CSRC

_SRC = CSRC / "fugue_host.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def library_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libfugue_host_{h.hexdigest()[:16]}.so"


def _build() -> Optional[Path]:
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)], check=True,
                       capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):  # no g++, or it failed
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        so = _build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        dp = ctypes.POINTER(ctypes.c_double)
        lib.ft_ess.restype = ctypes.c_double
        lib.ft_ess.argtypes = [dp, ctypes.c_int64]
        lib.ft_ess_batch.restype = None
        lib.ft_ess_batch.argtypes = [dp, ctypes.c_int64, ctypes.c_int64, dp]
        lib.ft_rhat.restype = ctypes.c_double
        lib.ft_rhat.argtypes = [dp, ctypes.c_int64, ctypes.c_int64]
        lib.ft_split_rhat.restype = ctypes.c_double
        lib.ft_split_rhat.argtypes = [dp, ctypes.c_int64, ctypes.c_int64]
        lib.ft_ess_multichain.restype = ctypes.c_double
        lib.ft_ess_multichain.argtypes = [dp, ctypes.c_int64, ctypes.c_int64]
        lib.ft_quantiles.restype = None
        lib.ft_quantiles.argtypes = [dp, ctypes.c_int64, dp, ctypes.c_int64, dp]
        lib.ft_abi_version.restype = ctypes.c_int
        lib.ft_abi_version.argtypes = []
        if lib.ft_abi_version() != 1:
            return None
        _LIB = lib
        return _LIB


def available() -> bool:
    return _load() is not None


def _lib() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native backend unavailable")
    return lib


def _as_c(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, dtype=np.float64))


def _as_c2(x) -> np.ndarray:
    a = _as_c(x)
    if a.ndim != 2:
        raise ValueError("expected (m, n)")
    return a


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def ess(x) -> float:
    lib = _lib()
    a = _as_c(x).ravel()
    return float(lib.ft_ess(_ptr(a), a.size))


def ess_batch(x) -> np.ndarray:
    lib = _lib()
    a = _as_c2(x)
    out = np.empty(a.shape[0], dtype=np.float64)
    lib.ft_ess_batch(_ptr(a), a.shape[0], a.shape[1], _ptr(out))
    return out


def ess_multichain(chains) -> float:
    lib = _lib()
    a = _as_c2(chains)
    return float(lib.ft_ess_multichain(_ptr(a), a.shape[0], a.shape[1]))


def r_hat(chains) -> float:
    lib = _lib()
    a = _as_c2(chains)
    return float(lib.ft_rhat(_ptr(a), a.shape[0], a.shape[1]))


def split_r_hat(chains) -> float:
    lib = _lib()
    a = _as_c2(chains)
    return float(lib.ft_split_rhat(_ptr(a), a.shape[0], a.shape[1]))


def quantiles(x, qs) -> np.ndarray:
    lib = _lib()
    a = _as_c(x).ravel()
    q = _as_c(qs).ravel()
    out = np.empty(q.size, dtype=np.float64)
    lib.ft_quantiles(_ptr(a), a.size, _ptr(q), q.size, _ptr(out))
    return out
