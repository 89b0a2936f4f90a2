"""Soft-SVD / Soft-Impute via fast alternating least squares (Hastie et al.).

Re-design of the reference SoftALS core (R/SoftALS.R:107-245):
the per-iteration B-step/A-step become jitted dense pipelines — sparse
products ride the bucketed-gather SpMM (ops/spmm.py), tall-skinny SVDs are
``crossprod + eigh`` on rank x rank matrices (R/SoftALS.R:250-257), and the
soft-impute sparse-residual trick evaluates ``X - u diag(d) v'`` only at the
nnz pattern (R/SoftALS.R:68-94 over src/utils.cpp:5-56).

``soft_svd`` / ``soft_impute`` mirror R/SoftALS.R:40-63; ``final_svd``
cleanup soft-thresholds the singular values ``max(d - lambda, 0)`` and trims
the rank (R/SoftALS.R:214-243).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from ..config import logger, resolve_dtype
from ..ops.spmm import (residual_values, spmm_buckets,
                        spmm_residual_buckets)
from ..sparse.device import bucket_rows


class SVDResult(NamedTuple):
    """An svd-like triple (u: (n, r), d: (r,), v: (m, r))."""

    u: jax.Array
    d: jax.Array
    v: jax.Array


class SoftALSFit(NamedTuple):
    """Result of :func:`soft_als`: the SVD triple plus the per-iteration
    convergence trace as a first-class field (the reference attaches it as
    a matrix attribute, R/SoftALS.R:145-147,192-209; a function attribute
    would be process-global and racy)."""

    u: jax.Array
    d: jax.Array
    v: jax.Array
    trace: tuple

    @property
    def svd(self) -> SVDResult:
        return SVDResult(self.u, self.d, self.v)


def svd_tall_skinny(x: jax.Array) -> SVDResult:
    """SVD of a tall-skinny matrix via Gram + symmetric eigendecomposition
    (the reference's crossprod + small-SVD, R/SoftALS.R:250-257)."""
    xtx = x.T @ x
    w, vecs = jnp.linalg.eigh(xtx)          # ascending
    w = jnp.maximum(w[::-1], 0.0)
    vecs = vecs[:, ::-1]
    d = jnp.sqrt(w)
    u = (x @ vecs) / jnp.maximum(d, 1e-12)[None, :]
    return SVDResult(u, d, vecs)


def calc_frobenius_norm_delta(old: SVDResult, new: SVDResult) -> jax.Array:
    """Relative Frobenius change between two SVD triples
    (reference R/utils_SoftALS.R:24-34)."""
    denom = jnp.sum(old.d ** 2)
    utu = new.d[:, None] * (new.u.T @ old.u)
    vtv = old.d[:, None] * (old.v.T @ new.v)
    uvprod = jnp.trace(utu @ vtv)
    num = denom + jnp.sum(new.d ** 2) - 2 * uvprod
    return num / jnp.maximum(denom, 1e-9)


def pad_svd(init: SVDResult, rank: int,
            rng: np.random.Generator) -> SVDResult:
    """Pad a warm-start SVD to ``rank`` with orthogonalized random columns
    (reference R/utils_SoftALS.R:36-60)."""
    r0 = init.d.shape[0]
    if r0 > rank:
        raise ValueError("provided init has bigger rank than model rank")
    if r0 == rank:
        return init
    n_pad = rank - r0
    d = jnp.concatenate([init.d, jnp.full((n_pad,), init.d[-1])])

    def pad_orth(m):
        pad = jnp.asarray(rng.standard_normal((m.shape[0], n_pad)), m.dtype)
        pad = pad - m @ (m.T @ pad)
        q, _ = jnp.linalg.qr(pad)
        return jnp.concatenate([m, q], axis=1)

    return SVDResult(pad_orth(init.u), d, pad_orth(init.v))


def _b_step(buckets, n_rows, svd: SVDResult, lam, target: str,
            update_side: str, compute_dtype=None) -> Tuple[SVDResult,
                                                           jax.Array]:
    """One half-iteration: re-solve one side and re-orthogonalize.

    ``buckets`` hold the matrix oriented with the *solved* side as rows
    (x^T for the item/B step, x for the user/A step).
    """
    u, d, v = svd
    shrink = d / (d + lam)
    loss = jnp.asarray(jnp.nan, jnp.float32)
    if target == "soft_impute":
        # residual of (rows x cols) pattern against  rowfac diag(d) colfac',
        # fused with the residual-SpMM (one gather of colfac per bucket)
        rowfac, colfac = (v, u) if update_side == "v" else (u, v)
        proj, sqn = spmm_residual_buckets(buckets, n_rows, rowfac, colfac, d,
                                          compute_dtype=compute_dtype)
        # un-normalized loss; the caller divides by nnz
        # (reference R/SoftALS.R:83)
        loss = sqn + lam * jnp.sum(d)
        hat = (proj + rowfac * d[None, :]) * shrink[None, :]
    else:
        colfac = u if update_side == "v" else v
        proj = spmm_buckets(buckets, n_rows, colfac,
                            compute_dtype=compute_dtype)
        hat = proj * shrink[None, :]

    hsvd = svd_tall_skinny(hat)
    if update_side == "v":
        new = SVDResult(u @ hsvd.v, hsvd.d, hsvd.u)
    else:
        new = SVDResult(hsvd.u, hsvd.d, v @ hsvd.v)
    return new, loss


@partial(jax.jit, static_argnames=("n_rows", "target"))
def _final_svd_m(x_buckets, u, d, v, n_rows: int, target: str):
    """Final-cleanup SVD input ``m`` + its SVD as ONE jitted program (the
    eager form is ~20 op dispatches, each a compile + round-trip on a
    remote-compile link; reference R/SoftALS.R:214-243)."""
    if target == "soft_impute":
        delta = residual_values(x_buckets, u, v, d)
        m = (spmm_buckets(x_buckets, n_rows, v, values_list=delta)
             + (u * d[None, :]) @ (v.T @ v))
    else:
        m = spmm_buckets(x_buckets, n_rows, v)
    return jnp.linalg.svd(m, full_matrices=False)


@partial(jax.jit, static_argnames=("target", "n_rows", "n_cols",
                                   "compute_dtype"))
def _soft_als_iter(tx_buckets, x_buckets, n_rows: int, n_cols: int,
                   svd: SVDResult, lam, target: str, compute_dtype=None):
    svd1, _ = _b_step(tx_buckets, n_cols, svd, lam, target, "v",
                      compute_dtype)
    svd2, loss = _b_step(x_buckets, n_rows, svd1, lam, target, "u",
                         compute_dtype)
    delta = calc_frobenius_norm_delta(svd, svd2)
    return svd2, delta, loss


def soft_als(
    x: sp.spmatrix,
    rank: int = 10,
    lambda_: float = 0.0,
    n_iter: int = 100,
    convergence_tol: float = 1e-3,
    init: Optional[SVDResult] = None,
    final_svd: bool = True,
    target: str = "svd",
    precision: str = "float32",
    seed: Optional[int] = None,
    compute_dtype: Optional[str] = None,
) -> SVDResult:
    """Core EM-like algorithm for soft-svd / soft-impute
    (reference R/SoftALS.R:107-245).

    ``compute_dtype="bfloat16"`` gathers the factor blocks at half width
    (f32 accumulation, f32 orthogonalization) — the iteration is
    random-row-gather bound; the final SVD cleanup stays full precision.
    """
    if target not in ("svd", "soft_impute"):
        raise ValueError("target must be 'svd' or 'soft_impute'")
    dtype = resolve_dtype(precision)
    rng = np.random.default_rng(seed)
    csr = sp.csr_matrix(x).astype(np.float64)
    n_rows, n_cols = csr.shape

    # content-cached staging, shared across models: LinearFlow's
    # closed-form step buckets the SAME matrix right after soft-impute
    # (the transpose build alone is seconds at ML-20M scale)
    from ..sparse.device import staged_cached
    dt_key = (str(jnp.dtype(dtype)),)
    x_b = staged_cached(
        "spmm_x", csr,
        lambda: bucket_rows(csr, dtype, include_empty=False), extra=dt_key)
    tx_b = staged_cached(
        "spmm_tx", csr,
        lambda: bucket_rows(csr.T.tocsr(), dtype, include_empty=False),
        extra=dt_key)

    if init is None:
        u0 = jnp.asarray(rng.standard_normal((n_rows, rank)), dtype)
        q, _ = jnp.linalg.qr(u0)
        svd_cur = SVDResult(q, jnp.ones((rank,), dtype),
                            jnp.zeros((n_cols, rank), dtype))
    else:
        if hasattr(init, "u"):       # SVDResult / SoftALSFit warm start
            init = (init.u, init.d, init.v)
        svd_cur = pad_svd(SVDResult(*(jnp.asarray(a, dtype) for a in init)),
                          rank, rng)

    trace = []
    converged = False
    for i in range(n_iter):
        svd_cur, delta, loss = _soft_als_iter(
            tx_b.buckets, x_b.buckets, n_rows, n_cols, svd_cur,
            jnp.asarray(lambda_, dtype), target, compute_dtype)
        delta = float(delta)
        trace.append({"iter": i + 1, "frob_delta": delta,
                      "loss": float(loss) / max(x_b.nnz, 1)})
        logger.info("soft_als: iter %03d, frobenius norm change %.5f", i + 1,
                    delta)
        if delta < convergence_tol:
            converged = True
            break
    if not converged:
        logger.warning("soft_als hasn't converged with tol %f after %d "
                       "iterations", convergence_tol, n_iter)

    if final_svd:
        u, d, v = svd_cur
        mu, md, mvh = _final_svd_m(x_b.buckets, u, d, v, n_rows, target)
        d_final = np.maximum(np.asarray(md, np.float64) - lambda_, 0.0)
        n_keep = int((d_final > 0).sum())
        if n_keep == 0:
            raise ValueError(
                f"regularization lambda={lambda_} is too high - all "
                "singular values are zero")
        svd_cur = SVDResult(
            mu[:, :n_keep],
            jnp.asarray(d_final[:n_keep], dtype),
            (v @ mvh.T)[:, :n_keep])
    svd_cur.u.block_until_ready()
    return SoftALSFit(svd_cur.u, svd_cur.d, svd_cur.v, tuple(trace))


def soft_impute(x, rank=10, lambda_=0.0, n_iter=100, convergence_tol=1e-3,
                init=None, final_svd=True, precision="float32", seed=None,
                compute_dtype=None):
    """Matrix completion on observed entries (reference R/SoftALS.R:40-49)."""
    return soft_als(x, rank, lambda_, n_iter, convergence_tol, init,
                    final_svd, "soft_impute", precision, seed, compute_dtype)


def soft_svd(x, rank=10, lambda_=0.0, n_iter=100, convergence_tol=1e-3,
             init=None, final_svd=True, precision="float32", seed=None,
             compute_dtype=None):
    """Regularized truncated SVD (reference R/SoftALS.R:54-63)."""
    return soft_als(x, rank, lambda_, n_iter, convergence_tol, init,
                    final_svd, "svd", precision, seed, compute_dtype)
