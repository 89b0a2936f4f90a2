"""Auxiliary components: checkpointing, k-means, splr, native runtime."""

import numpy as np
import pytest
import scipy.sparse as sp

from rsparse_tpu import WRMF, FTRL, GloVe
from rsparse_tpu.models.kmeans import kmeans
from rsparse_tpu.sparse.splr import SparsePlusLowRank
from rsparse_tpu.utils import checkpoint


def test_checkpoint_wrmf_roundtrip(tmp_path, ml100k_split):
    train, cv = ml100k_split
    m = WRMF(rank=5, lambda_=0.5, feedback="implicit", solver="cholesky",
             precision="double", seed=0)
    emb = m.fit_transform(train, n_iter=2, convergence_tol=-1)
    p1 = m.predict(cv, k=5)

    path = str(tmp_path / "wrmf")
    checkpoint.save(m, path)
    m2 = checkpoint.load(path)
    assert isinstance(m2, WRMF)
    np.testing.assert_allclose(m2.components, m.components)
    emb2 = m2.transform(train)
    np.testing.assert_allclose(np.asarray(emb2), np.asarray(emb),
                               rtol=1e-7, atol=1e-10)
    p2 = m2.predict(cv, k=5)
    np.testing.assert_array_equal(p1.indices, p2.indices)


def test_checkpoint_warm_start(tmp_path, ml100k_split):
    """Saved components warm-start a new model (reference init semantics,
    R/model_WRMF.R:245-249)."""
    train, _ = ml100k_split
    m = WRMF(rank=5, lambda_=0.5, solver="cholesky", precision="double",
             seed=0)
    m.fit_transform(train, n_iter=2, convergence_tol=-1)
    path = str(tmp_path / "w")
    checkpoint.save(m, path)
    m2 = checkpoint.load(path)
    warm_a = WRMF(rank=5, lambda_=0.5, solver="cholesky", precision="double",
                  init=m2.components, seed=1)
    ea = warm_a.fit_transform(train, n_iter=1, convergence_tol=-1)
    # same seed + same init => byte-identical restart (deterministic resume)
    warm_b = WRMF(rank=5, lambda_=0.5, solver="cholesky", precision="double",
                  init=m2.components, seed=1)
    eb = warm_b.fit_transform(train, n_iter=1, convergence_tol=-1)
    np.testing.assert_allclose(np.asarray(ea), np.asarray(eb))
    np.testing.assert_allclose(warm_a.loss_history, warm_b.loss_history)


def test_checkpoint_orbax_roundtrip(tmp_path, ml100k_split):
    """Explicit orbax store round-trips identically to the npz store."""
    train, cv = ml100k_split
    m = WRMF(rank=5, lambda_=0.5, feedback="implicit", solver="cholesky",
             precision="double", seed=0)
    m.fit_transform(train, n_iter=2, convergence_tol=-1)
    p1 = m.predict(cv, k=5)
    path = str(tmp_path / "wrmf_orbax")
    checkpoint.save(m, path, store="orbax")
    import os
    assert os.path.isdir(os.path.join(path, "arrays_orbax"))
    m2 = checkpoint.load(path)
    np.testing.assert_allclose(np.asarray(m2.components),
                               np.asarray(m.components))
    p2 = m2.predict(cv, k=5)
    np.testing.assert_array_equal(p1.indices, p2.indices)


def test_checkpoint_sharded_save_restore(tmp_path, ml100k_split):
    """Mesh-sharded factor tables: save writes per-device shards (no host
    gather; store auto-selects orbax) and load(..., sharding=...) restores
    straight into the requested sharding."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    train, _ = ml100k_split
    m = WRMF(rank=5, lambda_=0.5, feedback="implicit", solver="cholesky",
             precision="double", seed=0)
    m.fit_transform(train, n_iter=2, convergence_tol=-1)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(4), ("model",))
    sh = NamedSharding(mesh, P("model"))
    # commit the user table to the mesh (rows pad to a multiple of 4? use
    # replicated for the odd-shaped arrays: shard only the evenly-divisible)
    n = (m._U.shape[0] // 4) * 4
    m._U = jax.device_put(np.asarray(m._U)[:n], sh)
    path = str(tmp_path / "wrmf_sharded")
    checkpoint.save(m, path)            # auto -> orbax (multi-device array)
    import os
    assert os.path.isdir(os.path.join(path, "arrays_orbax"))
    m2 = checkpoint.load(path, sharding=sh)
    assert isinstance(m2._U, jax.Array)
    assert m2._U.sharding == sh
    np.testing.assert_allclose(np.asarray(m2._U), np.asarray(m._U))
    np.testing.assert_allclose(np.asarray(m2.components),
                               np.asarray(m.components))


def test_checkpoint_auto_without_orbax(tmp_path, monkeypatch):
    """store="auto" picks orbax only when it imports: without it a sharded
    table is saved to npz (host gather), and an explicit store="orbax"
    raises an error naming the package."""
    import os
    import sys
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    class _State:
        pass

    st = _State()
    mesh = Mesh(np.array(jax.devices()[:4]), ("model",))
    st.U = jax.device_put(np.arange(32.0).reshape(8, 4),
                          NamedSharding(mesh, P("model")))
    for name in [n for n in sys.modules
                 if n == "orbax" or n.startswith("orbax.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "orbax", None)
    path = str(tmp_path / "auto")
    checkpoint.save(st, path)
    assert os.path.exists(os.path.join(path, "arrays.npz"))
    back = checkpoint.load(path, cls=_State)
    np.testing.assert_array_equal(np.asarray(back.U), np.asarray(st.U))
    with pytest.raises(ImportError, match="orbax"):
        checkpoint.save(st, str(tmp_path / "explicit"), store="orbax")


def test_checkpoint_midfit_resume_exact(tmp_path, ml100k_split):
    """Interrupted fit + resume must be bit-identical to an uninterrupted
    one: the ALS loop is deterministic given (U, V), and the fit state
    carries everything else (iteration counter, loss history, biases)."""
    train, _ = ml100k_split
    kw = dict(rank=5, lambda_=0.5, feedback="implicit",
              solver="conjugate_gradient", precision="double", seed=0,
              with_global_bias=True)
    full = WRMF(**kw)
    e_full = np.asarray(full.fit_transform(train, n_iter=6,
                                           convergence_tol=-1))

    path = str(tmp_path / "fit_state")
    part = WRMF(**kw)
    part.fit_transform(train, n_iter=3, convergence_tol=-1,
                       checkpoint_path=path, checkpoint_every=1)
    resumed = WRMF(**kw)
    e_res = np.asarray(resumed.fit_transform(
        train, n_iter=6, convergence_tol=-1,
        checkpoint_path=path, resume=True))
    np.testing.assert_array_equal(e_res, e_full)
    np.testing.assert_allclose(resumed.loss_history, full.loss_history,
                               rtol=1e-12)
    # resume with no checkpoint on disk falls back to a fresh fit
    fresh = WRMF(**kw)
    e_fresh = np.asarray(fresh.fit_transform(
        train, n_iter=6, convergence_tol=-1,
        checkpoint_path=str(tmp_path / "nope"), resume=True))
    np.testing.assert_array_equal(e_fresh, e_full)


def test_checkpoint_ftrl(tmp_path):
    rs = np.random.RandomState(0)
    x = sp.random(200, 50, density=0.2, random_state=rs, format="csr")
    y = rs.randint(0, 2, 200).astype(float)
    m = FTRL(learning_rate=0.1, seed=0)
    m.partial_fit(x, y)
    path = str(tmp_path / "ftrl")
    checkpoint.save(m, path)
    m2 = checkpoint.load(path)
    np.testing.assert_allclose(m2.coef(), m.coef())
    np.testing.assert_allclose(m2.predict(x), m.predict(x), rtol=1e-6)


def test_kmeans_separates_blobs():
    rng = np.random.default_rng(0)
    blobs = np.concatenate([
        rng.standard_normal((50, 3)) * 0.2 + c
        for c in ([0, 0, 0], [5, 5, 5], [-5, 5, 0])])
    cent, assign = kmeans(blobs, 3, n_iter=20, seed=0,
                          seed_mode="random_spread")
    assert cent.shape == (3, 3)
    # all members of a blob share a label
    for b in range(3):
        labels = assign[b * 50:(b + 1) * 50]
        assert len(set(labels.tolist())) == 1
    # three distinct labels
    assert len(set(assign.tolist())) == 3
    with pytest.raises(ValueError):
        kmeans(blobs[:2], 5)


def test_splr_ops():
    rng = np.random.default_rng(0)
    x = sp.random(20, 15, density=0.3, random_state=np.random.RandomState(1),
                  format="csr")
    a = rng.standard_normal((20, 4))
    b = rng.standard_normal((15, 4))
    m = SparsePlusLowRank(x, a, b)
    dense = x.toarray() + a @ b.T
    v = rng.standard_normal((15, 3))
    np.testing.assert_allclose(m @ v, dense @ v, rtol=1e-10)
    u = rng.standard_normal((5, 20))
    np.testing.assert_allclose(m.rmatmul(u), u @ dense, rtol=1e-10)
    w = rng.standard_normal((20, 2))
    np.testing.assert_allclose(m.crossprod(w), dense.T @ w, rtol=1e-10)
    np.testing.assert_allclose(m.crossprod(), dense.T @ dense, rtol=1e-10)
    np.testing.assert_allclose(m.row_sums(), dense.sum(1), rtol=1e-10)
    np.testing.assert_allclose(m.col_sums(), dense.sum(0), rtol=1e-10)
    np.testing.assert_allclose(m.T.toarray(), dense.T, rtol=1e-10)
    with pytest.raises(ValueError):
        SparsePlusLowRank(x, a[:5], b)


def test_linear_flow_accepts_splr():
    """LinearFlow must consume a SparsePlusLowRank input lazily (reference
    R/model_LinearFlow.R:55 accepts splr) and produce the same model as the
    materialized dense-equivalent sparse matrix."""
    import scipy.sparse as sp
    from rsparse_tpu.models.linear_flow import LinearFlow

    rng = np.random.default_rng(0)
    x = sp.random(60, 40, density=0.2, random_state=1, format="csr")
    a = rng.standard_normal((60, 3)) * 0.1
    b = rng.standard_normal((40, 3)) * 0.1
    m = SparsePlusLowRank(x, a, b)
    dense_eq = sp.csr_matrix(m.toarray())

    # same init v for both so only the lhs/rhs path differs
    v0 = np.linalg.qr(rng.standard_normal((40, 6)))[0]
    lf1 = LinearFlow(rank=6, lambda_=0.5, init=v0, precision="double")
    e1 = np.asarray(lf1.fit_transform(dense_eq))
    lf2 = LinearFlow(rank=6, lambda_=0.5, init=v0, precision="double")
    e2 = np.asarray(lf2.fit_transform(m))
    np.testing.assert_allclose(e2, e1, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(lf2.components, lf1.components,
                               rtol=1e-8, atol=1e-10)
    t2 = np.asarray(lf2.transform(m))
    np.testing.assert_allclose(t2, e2, rtol=1e-10)

    # splr with no init: subspace-iteration v, model still sane + predict
    lf3 = LinearFlow(rank=6, lambda_=0.5, precision="double", seed=0)
    lf3.fit_transform(m)
    p = lf3.predict(m, k=5)
    assert p.indices.shape == (60, 5)
