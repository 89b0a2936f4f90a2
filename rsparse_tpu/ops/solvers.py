"""Batched dense linear solvers.

The reference solves one rank-dim system per entity inside an OpenMP loop
(Cholesky `arma::solve(...likely_sympd)` inst/include/wrmf_implicit.hpp:236,
3-step CG `cg_solver_implicit` :9-32, NNLS coordinate descent
inst/include/nnls.hpp:11-48).  Here every solver is *batched over entities*:
one (B, d, d) Cholesky / CG / NNLS per nnz-bucket, so the device sees large
batched matmuls instead of rank-10 scalar loops.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax

# Constants mirrored from the reference (inst/include/wrmf.hpp:20-22,
# nnls.hpp:8) — same stopping semantics, batched.
CG_TOL = 1e-10
SCD_MAX_ITER = 10_000
SCD_TOL = 1e-4
NNLS_EPS = 1e-16


def batched_spd_solve(lhs: jax.Array, rhs: jax.Array) -> jax.Array:
    """Solve ``lhs @ x = rhs`` for a batch of SPD systems.

    lhs: (B, d, d), rhs: (B, d) -> (B, d).  Batched Cholesky plus two
    triangular solves through ``lax.linalg``, which XLA hands to cuSOLVER
    and cuBLAS on the GPU (3.8 ms per 8192 systems at d=128 in f32 on an
    H100, 3.5x faster than a blocked formulation in plain JAX; PERF.md
    "Kernel decisions").
    """
    chol = lax.linalg.cholesky(lhs)
    y = lax.linalg.triangular_solve(
        chol, rhs[..., None], left_side=True, lower=True)
    x = lax.linalg.triangular_solve(
        chol, y, left_side=True, lower=True, transpose_a=True)
    return x[..., 0]


def batched_cg(
    matvec: Callable[[jax.Array], jax.Array],
    rhs: jax.Array,
    x0: jax.Array,
    n_steps: int,
    tol: float = CG_TOL,
) -> jax.Array:
    """Batched fixed-step conjugate gradient with per-entity early freeze.

    Mirrors the math of ``cg_solver_implicit`` (reference
    inst/include/wrmf_implicit.hpp:9-32): warm start ``x0``, ``n_steps``
    iterations, per-entity stop when the squared residual drops below
    ``tol``.  All entities run in lockstep; converged ones are masked out
    (the batched analog of the reference's per-thread ``break``).

    matvec maps (B, d) -> (B, d); rhs, x0: (B, d).
    """
    acc = jnp.float64 if rhs.dtype == jnp.float64 else jnp.float32

    def dot(a, b):
        return jnp.sum(a.astype(acc) * b.astype(acc), axis=-1)

    r = rhs - matvec(x0)
    p = r
    rsold = dot(r, r)

    def body(carry, _):
        x, r, p, rsold = carry
        live = rsold >= tol
        Ap = matvec(p)
        pAp = dot(p, Ap)
        denom = jnp.where(pAp == 0, 1.0, pAp)
        alpha = jnp.where(live, rsold / denom, 0.0).astype(x.dtype)[..., None]
        x = x + alpha * p
        r = r - alpha * Ap
        rsnew = dot(r, r)
        beta = jnp.where(live, rsnew / jnp.where(rsold == 0, 1.0, rsold), 0.0)
        p = r + beta.astype(p.dtype)[..., None] * p
        rsold = jnp.where(live, rsnew, rsold)
        return (x, r, p, rsold), None

    (x, _, _, _), _ = lax.scan(body, (x0, r, p, rsold), None, length=n_steps)
    return x


@partial(jax.jit, static_argnames=("max_iter",))
def batched_nnls(
    lhs: jax.Array,
    rhs: jax.Array,
    init: jax.Array,
    max_iter: int = SCD_MAX_ITER,
    rel_tol: float = SCD_TOL,
) -> jax.Array:
    """Batched sequential-coordinate-descent NNLS (Franc et al.).

    Solves ``min_{x>=0} ||lhs @ x - rhs||`` for each batch entry — the same
    squared-system formulation as the reference ``c_nnls``
    (inst/include/nnls.hpp:37-48): ``G = lhs' lhs + eps*I``,
    ``mu = G @ init - lhs' rhs``, then coordinate sweeps with clamping at 0
    (nnls.hpp:11-34).  Coordinates are swept sequentially (the algorithm is
    inherently sequential in d) but the batch axis is fully vectorized.

    lhs: (B, d, d), rhs: (B, d), init: (B, d) -> (B, d).
    """
    d = lhs.shape[-1]
    # exact solver: f32 products must not drop to TF32 (or one bf16 pass)
    hi = lax.Precision.HIGHEST
    G = jnp.einsum("bki,bkj->bij", lhs, lhs,
                   preferred_element_type=lhs.dtype, precision=hi)
    G = G + NNLS_EPS * jnp.eye(d, dtype=lhs.dtype)
    Gdiag = jnp.diagonal(G, axis1=-2, axis2=-1)  # (B, d)
    mu0 = jnp.einsum("bij,bj->bi", G, init, precision=hi) - jnp.einsum(
        "bji,bj->bi", lhs, rhs, precision=hi)

    def coord_body(k, state):
        x, mu, rel = state
        old = lax.dynamic_index_in_dim(x, k, axis=1, keepdims=False)
        gd = lax.dynamic_index_in_dim(Gdiag, k, axis=1, keepdims=False)
        mk = lax.dynamic_index_in_dim(mu, k, axis=1, keepdims=False)
        new = jnp.maximum(old - mk / gd, 0.0)
        diff = new - old
        gcol = lax.dynamic_index_in_dim(G, k, axis=2, keepdims=False)  # (B, d)
        mu = mu + diff[:, None] * gcol
        x = lax.dynamic_update_index_in_dim(x, new, k, axis=1)
        rel = jnp.maximum(rel, jnp.abs(diff) / (jnp.abs(old) + NNLS_EPS))
        return x, mu, rel

    def sweep_cond(state):
        t, _, _, rel = state
        return jnp.logical_and(t < max_iter, jnp.max(rel) > rel_tol)

    def sweep_body(state):
        t, x, mu, _ = state
        rel = jnp.zeros(x.shape[0], dtype=x.dtype)
        x, mu, rel = lax.fori_loop(0, d, coord_body, (x, mu, rel))
        return t + 1, x, mu, rel

    rel0 = jnp.full((init.shape[0],), jnp.inf, dtype=init.dtype)
    _, x, _, _ = lax.while_loop(
        sweep_cond, sweep_body, (jnp.int32(0), init, mu0, rel0))
    return x
