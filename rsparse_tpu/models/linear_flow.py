"""Linear-Flow: low-rank item-item similarity for one-class CF.

Reference R/model_LinearFlow.R:22-200 ("Practical Linear Models for
Large-Scale One-Class Collaborative Filtering").  The closed form: get right
singular vectors V of the interaction matrix, then solve the ridge system

    (V' G'G V + lambda I) W_r = V' G'G        (G = interactions)

with ``rhs = (x V)' x`` and ``lhs = rhs V`` — two sparse-dense matrix
products and one rank x rank solve.  ``components = W_r`` maps user vectors
``x V`` to item scores.  ``cross_validate_lambda`` re-solves along a lambda
path with the warm lhs/rhs reused and an "auto@n" grid derived from
diag(lhs) (R/model_LinearFlow.R:96-165).
"""

from __future__ import annotations

import re
from functools import partial
from typing import Callable, Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from ..config import logger, resolve_dtype
from ..ops.spmm import spmm_buckets
from ..ops.topk import top_product
from ..sparse.device import bucket_rows
from ..utils.metrics import ap_k, ndcg_k
from .base import MatrixFactorizationRecommender, get_names
from .soft_als import soft_impute, soft_svd


@jax.jit
def _solve_ridge(lhs: jax.Array, rhs: jax.Array, lam) -> jax.Array:
    """(lhs + lam I) W = rhs (reference R/model_LinearFlow.R:194-198)."""
    r = lhs.shape[0]
    return jnp.linalg.solve(lhs + lam * jnp.eye(r, dtype=lhs.dtype), rhs)


@partial(jax.jit, static_argnames=("n_rows", "n_cols"))
def _lhs_rhs_jit(x_buckets, tx_buckets, v, n_rows: int, n_cols: int):
    """rhs = (x v)' x, lhs = rhs v as ONE program: eagerly, the two
    bucketed SpMM chains are ~40 op-by-op dispatches (each a compile +
    round-trip on a remote-compile link); jitted they fuse into a single
    executable."""
    xv = spmm_buckets(x_buckets, n_rows, v)              # (n_u, r)
    rhs = spmm_buckets(tx_buckets, n_cols, xv).T         # (r, n_i)
    lhs = rhs @ v                                        # (r, r)
    return lhs, rhs, xv


@partial(jax.jit, static_argnames=("n_rows",))
def _spmm_jit(buckets, v, n_rows: int):
    return spmm_buckets(buckets, n_rows, v)


class LinearFlow(MatrixFactorizationRecommender):
    def __init__(
        self,
        rank: int = 8,
        lambda_: float = 0.0,
        init: Optional[np.ndarray] = None,
        preprocess: Optional[Callable] = None,
        solve_right_singular_vectors: str = "soft_impute",
        precision: str = "float32",
        seed: Optional[int] = None,
    ):
        super().__init__()
        if solve_right_singular_vectors not in ("soft_impute", "svd"):
            raise ValueError(
                "solve_right_singular_vectors must be 'soft_impute' or 'svd'")
        self.rank = int(rank)
        self.lambda_ = float(lambda_)
        self._custom_preprocess = preprocess is not None
        self.preprocess = preprocess or (lambda m: m)
        self.solve_right_singular_vectors = solve_right_singular_vectors
        self.precision = precision
        self.dtype = resolve_dtype(precision)
        self.seed = seed
        self.v: Optional[jax.Array] = init if init is None else jnp.asarray(
            init)

    # -- internals ---------------------------------------------------------

    def _get_v_splr(self, x, n_iter: int = 30) -> jax.Array:
        """Right singular vectors of a SparsePlusLowRank input by subspace
        iteration on its lazy matmuls (the reference accepts splr for x,
        R/model_LinearFlow.R:55, via softImpute's splr methods — here the
        rank is small, so orthogonalized power iteration on ``x'x`` is
        exact enough and never materializes the dense sum)."""
        rng = np.random.default_rng(self.seed)
        r = min(self.rank + 4, min(x.shape))
        Q = np.linalg.qr(rng.standard_normal((x.shape[1], r)))[0]
        for _ in range(max(n_iter, 8)):
            Q = np.linalg.qr(x.crossprod(x @ Q))[0]
        B = x @ Q                                    # (n_rows, r)
        _, s, wt = np.linalg.svd(B, full_matrices=False)
        v = (Q @ wt.T)[:, :self.rank]
        if v.shape[1] < self.rank:
            v = np.pad(v, ((0, 0), (0, self.rank - v.shape[1])))
        return jnp.asarray(v, self.dtype)

    def _get_v(self, x: sp.spmatrix, n_iter: int = 30) -> jax.Array:
        if self.v is not None:
            v = jnp.asarray(self.v, self.dtype)
            if v.shape != (x.shape[1], self.rank):
                raise ValueError("init v has wrong shape")
            return v
        fn = (soft_impute if self.solve_right_singular_vectors == "soft_impute"
              else soft_svd)
        tsvd = fn(x, rank=self.rank, lambda_=0.0, n_iter=n_iter,
                  precision=self.precision, seed=self.seed)
        v = tsvd.v
        if v.shape[1] < self.rank:  # final_svd may trim; pad back with zeros
            v = jnp.pad(v, ((0, 0), (0, self.rank - v.shape[1])))
        return v.astype(self.dtype)

    def _lhs_rhs(self, csr: sp.csr_matrix):
        """rhs = (x v)' x, lhs = rhs v — two bucketed SpMMs in one jitted
        program (reference R/model_LinearFlow.R:59-67)."""
        from ..sparse.device import staged_cached
        dt_key = (str(jnp.dtype(self.dtype)),)
        xb = staged_cached(
            "spmm_x", csr,
            lambda: bucket_rows(csr, self.dtype, include_empty=False),
            extra=dt_key)
        txb = staged_cached(
            "spmm_tx", csr,
            lambda: bucket_rows(csr.T.tocsr(), self.dtype,
                                include_empty=False), extra=dt_key)
        return _lhs_rhs_jit(xb.buckets, txb.buckets, self.v,
                            csr.shape[0], csr.shape[1])

    # -- public API --------------------------------------------------------

    def fit_transform(self, x, n_iter: int = 30):
        """``x``: scipy sparse matrix or :class:`SparsePlusLowRank`
        (``x + a b'`` accepted lazily, matching the reference's splr input
        contract R/model_LinearFlow.R:55)."""
        from ..sparse.splr import SparsePlusLowRank
        if isinstance(x, SparsePlusLowRank):
            if self._custom_preprocess:
                raise ValueError(
                    "a custom preprocess hook is not supported with "
                    "SparsePlusLowRank input (it operates on CSR matrices)")
            self.item_ids = None      # splr carries no dimnames
            self.user_ids = None
            if self.v is None:
                self.v = self._get_v_splr(x, n_iter)
            v_np = np.asarray(self.v, np.float64)
            xv = x @ v_np                                # (n_u, r)
            rhs = jnp.asarray(x.crossprod(xv).T, self.dtype)   # (r, n_i)
            lhs = rhs @ jnp.asarray(v_np, self.dtype)
            self.components = np.asarray(
                _solve_ridge(lhs, rhs, self.lambda_))
            self._components_l2 = None
            return jnp.asarray(xv, self.dtype)
        self.item_ids = get_names(x, 1)
        self.user_ids = get_names(x, 0)
        csr = sp.csr_matrix(x).astype(np.float64)
        csr = self.preprocess(csr)
        self.v = self._get_v(csr, n_iter)
        lhs, rhs, xv = self._lhs_rhs(csr)
        self.components = np.asarray(_solve_ridge(lhs, rhs, self.lambda_))
        self._components_l2 = None
        return xv

    def transform(self, x):
        if self.v is None:
            raise RuntimeError("model is not fitted")
        from ..sparse.splr import SparsePlusLowRank
        if isinstance(x, SparsePlusLowRank):
            return jnp.asarray(x @ np.asarray(self.v, np.float64),
                               self.dtype)
        csr = sp.csr_matrix(x).astype(np.float64)
        csr = self.preprocess(csr)
        from ..sparse.device import staged_cached
        xb = staged_cached(
            "spmm_x", csr,
            lambda: bucket_rows(csr, self.dtype, include_empty=False),
            extra=(str(jnp.dtype(self.dtype)),))
        return _spmm_jit(xb.buckets, self.v, csr.shape[0])

    def cross_validate_lambda(
        self,
        x: sp.spmatrix,
        x_train: sp.spmatrix,
        x_test: sp.spmatrix,
        lambda_: Union[str, Sequence[float]] = "auto@10",
        metric: str = "map@10",
        not_recommend: Union[sp.spmatrix, None, str] = "x_train",
        n_iter: int = 30,
    ):
        """Tune lambda with warm restarts of the rank x rank ridge solve
        (reference R/model_LinearFlow.R:96-165).  Returns a list of
        ``{"lambda": l, "score": s}`` and keeps the best components."""
        self.item_ids = get_names(x, 1)
        if isinstance(not_recommend, str) and not_recommend == "x_train":
            not_recommend = x_train
        csr = sp.csr_matrix(self.preprocess(
            sp.csr_matrix(x).astype(np.float64)))
        train_csr = sp.csr_matrix(self.preprocess(
            sp.csr_matrix(x_train).astype(np.float64)))

        m = re.fullmatch(r"(ndcg|map)@(\d+)", metric)
        if not m:
            raise ValueError(f"unsupported metric {metric!r}; use map@k/ndcg@k")
        metric_name, metric_k = m.group(1), int(m.group(2))

        self.v = self._get_v(csr, n_iter)
        lhs, rhs, _ = self._lhs_rhs(csr)

        if isinstance(lambda_, str):
            am = re.fullmatch(r"auto@(\d+)", lambda_)
            if not am:
                raise ValueError(f"unsupported lambda spec {lambda_!r}")
            k = int(am.group(1))
            ridge = np.asarray(jnp.diagonal(lhs), np.float64)
            lambdas = np.logspace(np.log10(0.1 * ridge.min()),
                                  np.log10(10 * ridge.max()), k)
        else:
            lambdas = np.asarray(lambda_, np.float64)
        if lambdas.size == 0:
            raise ValueError("lambda_ grid is empty")

        xb_train = bucket_rows(train_csr, self.dtype)
        xq = _spmm_jit(xb_train.buckets, self.v, train_csr.shape[0])

        results = []
        best = -np.inf
        best_y = None
        for lam in lambdas:
            Y = _solve_ridge(lhs, rhs, jnp.asarray(lam, lhs.dtype))
            # xq / Y stay device-resident through the retrieval kernel (no
            # host round-trip of the (r, n_items) components per lambda)
            idx, _ = top_product(xq, Y, metric_k,
                                 not_recommend=not_recommend)
            scorer = ap_k if metric_name == "map" else ndcg_k
            score = float(np.nanmean(scorer(idx, x_test)))
            results.append({"lambda": float(lam), "score": score})
            # NaN scores never win (and never poison ``best``: a NaN
            # fallback records components without updating the bar); an
            # unfitted model still records the first solve so
            # cross-validate-then-predict works
            if not np.isnan(score) and score >= best:
                best = score
                best_y = Y          # device-resident; materialized once
                self.lambda_ = float(lam)
            elif best_y is None and self.components is None:
                best_y = Y
                self.lambda_ = float(lam)
            logger.info("lambda %.4f score %.4f", lam, score)
        if best_y is not None:      # all-NaN scores keep prior components
            self.components = np.asarray(best_y)
        return results
