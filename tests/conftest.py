"""Test configuration: force a virtual 8-device CPU mesh.

Multi-device sharding is validated on virtual CPU devices; tests marked
``gpu`` need a card and skip without one (``chip_smoke.py`` drives the
library on the card).  Must run before jax is imported anywhere.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

from rsparse_tpu.config import use_compile_cache  # noqa: E402

# the suite runs on virtual CPU devices unless JAX_PLATFORMS names the
# platforms (``JAX_PLATFORMS=cuda,cpu`` for the ``gpu``-marked tests)
if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
# persistent compile cache: the suite compiles hundreds of per-shape
# programs; warm reruns skip nearly all of it
use_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import scipy.sparse as sp  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at test time,
    never at import: every xdist worker must collect the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run with JAX_PLATFORMS=cuda,cpu on a card")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    """Drop compiled executables between modules: one long process
    accumulating 1000+ XLA-CPU JIT programs can segfault inside LLVM
    (observed on the full suite around the 25-minute mark)."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="session")
def ml100k():
    from rsparse_tpu import load_movielens100k
    return load_movielens100k()


@pytest.fixture(scope="session")
def ml100k_split(ml100k):
    """train/cv split used throughout the reference test-suite
    (reference tests/testthat/test-wrmf.R:6-7)."""
    train = sp.csr_matrix(ml100k)[:900]
    cv = sp.csr_matrix(ml100k)[900:]
    train.row_names = ml100k.row_names[:900]
    train.col_names = ml100k.col_names
    cv.row_names = ml100k.row_names[900:]
    cv.col_names = ml100k.col_names
    return train, cv
