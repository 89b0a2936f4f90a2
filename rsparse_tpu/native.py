"""ctypes bindings for the native host runtime (native/rsparse_host.cpp).

Replaces the reference's Rcpp/C++ host glue (src/RcppExports.cpp,
src/utils.cpp:58-128) with a plain C ABI: padded-bucket fill, parallel
interaction-log parsing, CSR transpose.  Auto-builds with ``make`` on first
use (serially, without OpenMP, when the compiler has no OpenMP runtime);
every caller has a numpy fallback, so a missing toolchain degrades
gracefully.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

from .config import logger

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "librsparse_host.so")

_lib = None
_tried = False


def _build() -> bool:
    for extra in ([], ["OPENMP="]):
        try:
            out = subprocess.run(["make", "-C", _NATIVE_DIR, *extra],
                                 check=False, capture_output=True, text=True,
                                 timeout=120)
        except (OSError, subprocess.SubprocessError) as e:
            logger.warning("native build error: %s", e)
            return False
        if out.returncode == 0:
            return True
        logger.warning("native build %s failed: %s", extra or "(OpenMP)",
                       out.stderr[-500:])
    return False


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, building it if needed (None on failure)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_SO_PATH) and not _build():
        return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError as e:
        logger.warning("native library load failed: %s", e)
        return None

    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64

    lib.fill_bucket_f32.argtypes = [i64p, i32p, f64p, i64p, i64, i64, i64,
                                    i64, i32p, f32p, i32p, i32p]
    lib.fill_bucket_f64.argtypes = [i64p, i32p, f64p, i64p, i64, i64, i64,
                                    i64, i32p, f64p, i32p, i32p]
    lib.parse_interactions.argtypes = [
        ctypes.c_char_p, i64, ctypes.c_char, ctypes.c_int,
        i32p, i32p, f32p, i64]
    lib.parse_interactions.restype = i64
    lib.csr_transpose.argtypes = [i64p, i32p, f64p, i64, i64, i64,
                                  i64p, i32p, f64p]
    lib.omp_threads.restype = ctypes.c_int
    _lib = lib
    logger.info("native host runtime loaded (%d threads)",
                lib.omp_threads())
    return _lib


def fill_bucket(indptr, indices, data, rows, B: int, L: int,
                n_rows_total: int, val_dtype) -> Optional[tuple]:
    """Native padded-bucket fill; returns None if the library is missing."""
    lib = get_lib()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    data = np.ascontiguousarray(data, np.float64)
    rows = np.ascontiguousarray(rows, np.int64)
    col_idx = np.empty((B, L), np.int32)
    nnz = np.empty((B,), np.int32)
    row_ids = np.empty((B,), np.int32)
    if np.dtype(val_dtype) == np.float64:
        values = np.empty((B, L), np.float64)
        lib.fill_bucket_f64(indptr, indices, data, rows, len(rows), B, L,
                            n_rows_total, col_idx, values, nnz, row_ids)
    else:
        values = np.empty((B, L), np.float32)
        lib.fill_bucket_f32(indptr, indices, data, rows, len(rows), B, L,
                            n_rows_total, col_idx, values, nnz, row_ids)
    return col_idx, values, nnz, row_ids


def parse_interactions_bytes(buf: bytes, sep: str = ",",
                             skip_header: bool = True):
    """Parse 'user<sep>item[<sep>rating]' lines into COO arrays (native,
    falls back to numpy.loadtxt-style parsing)."""
    lib = get_lib()
    n_lines = buf.count(b"\n") + 1
    if lib is not None:
        users = np.empty(n_lines, np.int32)
        items = np.empty(n_lines, np.int32)
        ratings = np.empty(n_lines, np.float32)
        n = lib.parse_interactions(buf, len(buf), sep.encode()[0],
                                   int(skip_header), users, items, ratings,
                                   n_lines)
        if n >= 0:
            return users[:n].copy(), items[:n].copy(), ratings[:n].copy()
    import io
    arr = np.genfromtxt(io.BytesIO(buf), delimiter=sep,
                        skip_header=1 if skip_header else 0)
    if arr.ndim == 1:
        arr = arr[None, :]
    r = (arr[:, 2] if arr.shape[1] > 2
         else np.ones(len(arr))).astype(np.float32)
    return (arr[:, 0].astype(np.int32), arr[:, 1].astype(np.int32), r)
