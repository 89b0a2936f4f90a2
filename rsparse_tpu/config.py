"""Global configuration for rsparse_tpu.

The reference package carries a precision axis ("double" vs "float" via the R
`float` package, reference R/model_WRMF.R:68-70,102) and a global OpenMP
thread-count option (reference R/zzz.R:25-44).  Here the analog is a dtype
axis (float32 default, bfloat16 for bandwidth-bound workloads, float64) and
JAX device/mesh discovery instead of thread counts.
"""

from __future__ import annotations

import logging
import os
from typing import Union

import jax
import jax.numpy as jnp
import numpy as np

logger = logging.getLogger("rsparse_tpu")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[%(levelname)s] [%(asctime)s] %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(os.environ.get("RSPARSE_TPU_LOGLEVEL", "WARNING").upper())

#: precision name -> jnp dtype. "double"/"float" mirror the reference's
#: precision vocabulary (reference R/model_WRMF.R:102); the native names are
#: also accepted.
_PRECISIONS = {
    "double": jnp.float64,
    "float": jnp.float32,
    "float64": jnp.float64,
    "float32": jnp.float32,
    "bfloat16": jnp.bfloat16,
    "bf16": jnp.bfloat16,
}


def resolve_dtype(precision: Union[str, jnp.dtype]) -> jnp.dtype:
    """Resolve a precision name or dtype to a jnp dtype.

    Requesting float64 enables JAX x64 mode.  GPUs and CPUs run float64
    natively; "float" stays the faster option the reference recommends
    (R/model_WRMF.R:68-70).
    """
    if isinstance(precision, str):
        try:
            dt = _PRECISIONS[precision]
        except KeyError:
            raise ValueError(
                f"unknown precision {precision!r}; one of {sorted(_PRECISIONS)}"
            ) from None
    else:
        dt = jnp.dtype(precision)
    if dt == jnp.float64 and not jax.config.jax_enable_x64:
        jax.config.update("jax_enable_x64", True)
    return dt


def accum_dtype(dtype) -> jnp.dtype:
    """Accumulation dtype for losses/Grams: never below float32."""
    return jnp.float64 if jnp.dtype(dtype) == jnp.float64 else jnp.float32


def default_device_count() -> int:
    """Number of local accelerator devices (replaces OpenMP thread detection,
    reference src/utils.cpp:84-91)."""
    return jax.local_device_count()


def use_compile_cache() -> str:
    """Point JAX's persistent compilation cache at a fixed directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is changed; otherwise the cache lives in ``.jax_cache`` at the
    root of this checkout (a fixed path: the path is part of the cache key).
    Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def np_dtype(dtype) -> np.dtype:
    d = jnp.dtype(dtype)
    if d == jnp.bfloat16:
        return np.dtype(np.float32)
    return np.dtype(d)
