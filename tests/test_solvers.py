"""Batched dense solver kernels vs. numpy/scipy oracles."""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.optimize

from rsparse_tpu.ops.solvers import batched_cg, batched_nnls, batched_spd_solve


def _spd_batch(rng, B, d, jitter=1.0):
    A = rng.standard_normal((B, d, d))
    lhs = A @ A.transpose(0, 2, 1) + jitter * np.eye(d)
    rhs = rng.standard_normal((B, d))
    return lhs, rhs


def test_batched_spd_solve():
    rng = np.random.default_rng(0)
    lhs, rhs = _spd_batch(rng, 17, 12)
    x = np.asarray(batched_spd_solve(jnp.asarray(lhs), jnp.asarray(rhs)))
    expect = np.linalg.solve(lhs, rhs[..., None])[..., 0]
    np.testing.assert_allclose(x, expect, rtol=1e-5, atol=1e-8)


def test_batched_cg_matches_exact():
    rng = np.random.default_rng(1)
    lhs, rhs = _spd_batch(rng, 9, 8, jitter=5.0)
    matvec = lambda p: jnp.einsum("bij,bj->bi", jnp.asarray(lhs), p)
    x = np.asarray(batched_cg(matvec, jnp.asarray(rhs),
                              jnp.zeros_like(jnp.asarray(rhs)), n_steps=50))
    expect = np.linalg.solve(lhs, rhs[..., None])[..., 0]
    np.testing.assert_allclose(x, expect, rtol=1e-4, atol=1e-6)


def test_batched_cg_warm_start_early_freeze():
    # already-converged entries must not move (per-entity freeze mirrors the
    # reference's CG_TOL break, inst/include/wrmf_implicit.hpp:27)
    rng = np.random.default_rng(2)
    lhs, rhs = _spd_batch(rng, 4, 6, jitter=3.0)
    exact = np.linalg.solve(lhs, rhs[..., None])[..., 0]
    matvec = lambda p: jnp.einsum("bij,bj->bi", jnp.asarray(lhs), p)
    x = np.asarray(batched_cg(matvec, jnp.asarray(rhs), jnp.asarray(exact),
                              n_steps=3))
    np.testing.assert_allclose(x, exact, rtol=1e-5, atol=1e-7)


def test_batched_nnls():
    rng = np.random.default_rng(3)
    B, d = 12, 7
    lhs, rhs = _spd_batch(rng, B, d, jitter=2.0)
    init = np.abs(rng.standard_normal((B, d)))
    x = np.asarray(batched_nnls(jnp.asarray(lhs), jnp.asarray(rhs),
                                jnp.asarray(init), max_iter=2000))
    assert (x >= 0).all()
    for b in range(B):
        expect, _ = scipy.optimize.nnls(lhs[b], rhs[b])
        np.testing.assert_allclose(x[b], expect, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("B,d", [(3, 4), (70, 32), (513, 128)])
def test_batched_spd_solve_matches_numpy(B, d, dtype):
    """The plain lax.linalg Cholesky path at every batch size and width
    (cuSOLVER/cuBLAS on the GPU) against a float64 numpy solve."""
    rng = np.random.default_rng(B + d)
    A = rng.standard_normal((B, d, d))
    lhs = A @ A.transpose(0, 2, 1) / d + np.eye(d)
    rhs = rng.standard_normal((B, d))
    x = np.asarray(batched_spd_solve(jnp.asarray(lhs, dtype),
                                     jnp.asarray(rhs, dtype)))
    assert x.dtype == dtype
    expect = np.linalg.solve(lhs, rhs[..., None])[..., 0]
    tol = 1e-10 if dtype == np.float64 else 1e-4
    np.testing.assert_allclose(x, expect, rtol=tol, atol=tol)


def test_exact_solvers_pin_matmul_precision():
    """The exact solve paths must pin HIGHEST matmul precision: with f32
    operands the default lets XLA run products in TF32 on the GPU (about
    three decimal digits), silently breaking the exact-solver contract.
    CPU runs are exact either way, so this asserts on the jaxprs of the
    Cholesky and NNLS lhs builds and of the NNLS squared system."""
    import jax
    from rsparse_tpu.ops.als import ALSConfig, wrmf_sweep, solver_code
    from rsparse_tpu.sparse.device import bucket_rows
    import scipy.sparse as sp
    rng = np.random.default_rng(0)
    x = sp.random(64, 32, 0.2, random_state=0, format="csr")
    br = bucket_rows(x, jnp.float32)
    U = jnp.asarray(rng.standard_normal((64, 8)), jnp.float32)
    V = jnp.asarray(rng.standard_normal((32, 8)), jnp.float32)
    for solver in ("cholesky", "nnls"):
        cfg = ALSConfig(feedback="implicit", solver=solver_code(solver))
        jaxpr = str(jax.make_jaxpr(
            lambda u, v: wrmf_sweep(u, v, br.buckets, None, 0.1, 0.0,
                                    cfg))(U, V))
        assert "HIGHEST" in jaxpr, solver
    lhs = jnp.eye(8, dtype=jnp.float32)[None].repeat(4, 0)
    jaxpr = str(jax.make_jaxpr(
        lambda a, b, c: batched_nnls(a, b, c, max_iter=3))(
            lhs, jnp.ones((4, 8), jnp.float32), jnp.ones((4, 8),
                                                         jnp.float32)))
    assert jaxpr.count("HIGHEST") >= 3


@pytest.mark.gpu
def test_spd_solve_on_gpu_matches_numpy(gpu):
    """At the closing transform's width on the card: f32 Cholesky through
    cuSOLVER within the smoke run's 1e-4 exact-transform tolerance."""
    rng = np.random.default_rng(3)
    B, d = 4096, 128
    A = rng.standard_normal((B, d, d)).astype(np.float32)
    lhs = A @ A.transpose(0, 2, 1) / d + np.eye(d, dtype=np.float32)
    rhs = rng.standard_normal((B, d)).astype(np.float32)
    x = np.asarray(batched_spd_solve(jnp.asarray(lhs), jnp.asarray(rhs)))
    expect = np.linalg.solve(lhs.astype(np.float64),
                             rhs.astype(np.float64)[..., None])[..., 0]
    err = np.linalg.norm(x - expect, axis=1) / np.linalg.norm(expect, axis=1)
    assert err.max() < 1e-4, err.max()
