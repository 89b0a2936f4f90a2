"""Sparse-dense products and sparse-approximation over bucketed rows.

Replaces (a) the reference's CSR*dense products used by SoftALS
(R/SoftALS.R:86,101 via the Matrix package) and (b) the
``cpp_make_sparse_approximation`` kernel that evaluates a low-rank product
only at the nnz pattern of a template matrix
(reference src/utils.cpp:5-56, R/utils_SoftALS.R:3-22).

Both are expressed over the padded-bucket substrate: gathers + masked
einsums that XLA maps onto matrix units, instead of per-row OpenMP loops.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..config import accum_dtype


def _gather_table(dense: jax.Array, compute_dtype) -> jax.Array:
    """Shadow copy of a factor table in the gather/compute dtype.

    The barrier pins the cast BEFORE the gathers so XLA cannot commute it
    onto the gather outputs (which would re-read full-width rows); with
    ``compute_dtype="bfloat16"`` the random row reads — the dominant cost
    of the soft-ALS iteration — halve (same trick as ops/als.py)."""
    if compute_dtype is None or jnp.dtype(compute_dtype) == dense.dtype:
        return dense
    return jax.lax.optimization_barrier(dense.astype(compute_dtype))


def spmm_buckets(br_buckets, n_rows: int, dense: jax.Array,
                 values_list=None, compute_dtype=None) -> jax.Array:
    """Sparse @ dense: (n_rows, n_cols) x (n_cols, k) -> (n_rows, k).

    ``values_list`` optionally overrides each bucket's values (e.g. residual
    values from :func:`sparse_approx_buckets`).
    """
    k = dense.shape[1]
    dtype = dense.dtype
    sdt = accum_dtype(dtype)
    dg = _gather_table(dense, compute_dtype)
    out = jnp.zeros((n_rows + 1, k), dtype=dtype)
    for bi, b in enumerate(br_buckets):
        vals = b.values if values_list is None else values_list[bi]
        mask = b.mask()
        vm = jnp.where(mask, vals.astype(sdt), 0.0)
        G = dense[b.col_idx].astype(sdt) if compute_dtype is None \
            else dg[b.col_idx]                        # (B, L, k)
        rows = jnp.einsum("bl,blk->bk", vm.astype(G.dtype), G,
                          preferred_element_type=sdt)  # (B, k)
        out = out.at[b.row_ids].add(rows.astype(dtype))
    return out[:n_rows]


def sparse_approx_buckets(br_buckets, left: jax.Array, right: jax.Array,
                          scale: jax.Array | None = None):
    """Evaluate ``(left @ diag(scale) @ right.T)`` at each bucket's nnz
    pattern: returns a list of (B, L) value arrays (aligned with buckets).

    left: (n_rows, r) row factors, right: (n_cols, r) column factors.
    This is the projection step of soft-impute — the reference computes it
    with a per-row OpenMP loop of dot products (src/utils.cpp:5-56).
    """
    sdt = accum_dtype(left.dtype)
    if scale is not None:
        left = left * scale[None, :].astype(left.dtype)
    out = []
    for b in br_buckets:
        lf = left[jnp.minimum(b.row_ids, left.shape[0] - 1)].astype(sdt)
        rf = right[b.col_idx].astype(sdt)             # (B, L, r)
        vals = jnp.einsum("br,blr->bl", lf, rf,
                          preferred_element_type=sdt)
        out.append(vals.astype(left.dtype))
    return out


def spmm_residual_buckets(br_buckets, n_rows: int, rowfac: jax.Array,
                          colfac: jax.Array, scale: jax.Array,
                          compute_dtype=None):
    """Fused soft-impute projection: residual at the nnz pattern, its
    squared norm, and the residual-SpMM against ``colfac`` — in ONE gather
    of ``colfac`` per bucket.

    Equivalent to ``residual_values`` + ``sq_norm_values`` +
    ``spmm_buckets(..., values_list=delta)``, which gather the SAME
    ``colfac[col_idx]`` block twice; at soft-impute scale the two (B, L, r)
    gathers are the dominant cost of an iteration (PERF.md).

    Returns ``(proj (n_rows, k), sq_norm scalar)``.
    """
    k = colfac.shape[1]
    dtype = colfac.dtype
    sdt = accum_dtype(dtype)
    left = rowfac * scale[None, :].astype(rowfac.dtype)
    cg = _gather_table(colfac, compute_dtype)
    gdt = cg.dtype
    out = jnp.zeros((n_rows + 1, k), dtype=dtype)
    sqn = jnp.zeros((), jnp.float32)
    for b in br_buckets:
        mask = b.mask()
        lf = left[jnp.minimum(b.row_ids, left.shape[0] - 1)].astype(gdt)
        rf = cg[b.col_idx]                            # (B, L, r) one gather
        approx = jnp.einsum("br,blr->bl", lf, rf,
                            preferred_element_type=sdt)
        delta = jnp.where(mask, b.values.astype(sdt) - approx, 0.0)
        sqn = sqn + jnp.sum((delta * delta).astype(jnp.float32))
        rows = jnp.einsum("bl,blr->br", delta.astype(gdt), rf,
                          preferred_element_type=sdt)
        out = out.at[b.row_ids].add(rows.astype(dtype))
    return out[:n_rows], sqn


def residual_values(br_buckets, left, right, scale=None):
    """Bucket values minus the low-rank approximation at the nnz pattern
    (the ``x_delta`` of soft-impute, reference R/SoftALS.R:79-82)."""
    approx = sparse_approx_buckets(br_buckets, left, right, scale)
    return [b.values - a for b, a in zip(br_buckets, approx)]


def sq_norm_values(br_buckets, values_list=None) -> jax.Array:
    """Sum of squared (masked) values across buckets."""
    tot = jnp.zeros((), jnp.float32)
    for bi, b in enumerate(br_buckets):
        vals = b.values if values_list is None else values_list[bi]
        vm = jnp.where(b.mask(), vals.astype(jnp.float32), 0.0)
        tot = tot + jnp.sum(vm * vm)
    return tot
