"""Sharded SGD family: mesh-parity vs single-device (SURVEY §2.4).

The reference parallelizes GloVe/RankMF/FTRL/FM with shared-memory hogwild
(reference src/GloVe.cpp:91-94, src/rankmf.cpp:133-140, src/FTRL.cpp:122-125,
src/factorization_machine.cpp:124-127); this package row-shards their state
tables over the mesh (parallel/sgd_sharded.py).  Because the sharded ops
replay the exact single-device minibatch math (same samples, same scatter
aggregation), parity is to f32 reduction-order noise — these tests pin it.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from rsparse_tpu.parallel.mesh import make_mesh


@pytest.fixture(scope="module")
def mesh():
    return make_mesh()  # all 8 virtual CPU devices, ("data",)


def _interactions(n_rows=120, n_cols=60, density=0.1, seed=1):
    x = (sp.random(n_rows, n_cols, density=density, random_state=seed)
         > 0).astype(np.float64).tocsr()
    return x


# -- primitives ---------------------------------------------------------------


def test_sharded_gather_scatter_roundtrip(mesh):
    """ShardedOps.gather/scatter_add vs plain indexing on a padded table."""
    from jax.sharding import PartitionSpec as P
    from rsparse_tpu.parallel.sgd_sharded import (
        ShardedOps, shard_table, unshard)

    rng = np.random.default_rng(0)
    n, r = 43, 5                       # deliberately not divisible by 8
    table = rng.standard_normal((n, r)).astype(np.float32)
    ids = rng.integers(0, n, (7, 11)).astype(np.int32)
    upd = rng.standard_normal(ids.shape + (r,)).astype(np.float32)

    ops = ShardedOps(("data",))

    def body(t, i, u):
        g = ops.gather(t, i)
        t2 = ops.scatter_add(t, i, u)
        return g, t2

    fn = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P("data"), P(), P()),
        out_specs=(P(), P("data")), check_vma=False))
    ts = shard_table(table, mesh)
    g, t2 = fn(ts, jnp.asarray(ids), jnp.asarray(upd))

    np.testing.assert_allclose(np.asarray(g), table[ids], rtol=1e-6)
    expect = table.copy()
    np.add.at(expect, ids.reshape(-1),
              upd.reshape(-1, r).astype(np.float32))
    np.testing.assert_allclose(unshard(t2, n), expect, rtol=1e-5)
    # padding rows stay zero (never scattered into)
    assert np.abs(np.asarray(t2)[n:]).max() == 0.0


# -- models -------------------------------------------------------------------


def test_glove_mesh_parity(mesh):
    from rsparse_tpu.models.glove import GloVe

    rng = np.random.default_rng(0)
    n = 100
    rows = rng.integers(0, n, 3000)
    cols = rng.integers(0, n, 3000)
    keep = rows <= cols                    # triangular (two-pass path)
    coo = sp.coo_matrix(
        (rng.uniform(1, 5, keep.sum()), (rows[keep], cols[keep])),
        shape=(n, n))
    coo.sum_duplicates()

    kw = dict(rank=8, x_max=10, learning_rate=0.05, seed=42,
              batch_size=256, n_hot=32)
    m1 = GloVe(**kw)
    w1 = np.asarray(m1.fit_transform(coo, n_iter=3))
    m2 = GloVe(**kw, mesh=mesh)
    w2 = np.asarray(m2.fit_transform(coo, n_iter=3))

    assert w2.shape == (n, 8)              # padding sliced off
    np.testing.assert_allclose(w1, w2, atol=2e-6)
    np.testing.assert_allclose(m1.components, m2.components, atol=2e-6)
    np.testing.assert_allclose(m1.cost_history, m2.cost_history, rtol=1e-5)


def test_ftrl_mesh_parity(mesh):
    from rsparse_tpu.models.ftrl import FTRL

    rng = np.random.default_rng(0)
    X = sp.random(500, 80, density=0.1, random_state=1, format="csr")
    y = rng.integers(0, 2, 500).astype(float)

    kw = dict(learning_rate=0.1, lambda_=0.01, l1_ratio=0.5, dropout=0.2,
              seed=7)
    m1 = FTRL(**kw)
    m1.fit(X, y, n_iter=2)
    m2 = FTRL(**kw, mesh=mesh)
    m2.fit(X, y, n_iter=2)

    np.testing.assert_allclose(m1.predict(X), m2.predict(X), atol=1e-6)
    np.testing.assert_allclose(m1.coef(), m2.coef(), atol=1e-6)
    # dumps are mesh-independent (padding sliced off) and cross-load
    d = m2.dump()
    assert len(d["z"]) == X.shape[1] + 1
    m3 = FTRL.load(d)
    np.testing.assert_allclose(m3.predict(X), m2.predict(X), atol=1e-6)


def test_fm_mesh_parity(mesh):
    from rsparse_tpu.models.fm import FactorizationMachine

    rng = np.random.default_rng(0)
    X = sp.random(400, 60, density=0.15, random_state=1, format="csr")
    y = rng.integers(0, 2, 400).astype(float)

    kw = dict(learning_rate_w=0.2, rank=4, lambda_w=0.001, lambda_v=0.001,
              seed=7)
    m1 = FactorizationMachine(**kw)
    m1.fit(X, y, n_iter=2)
    m2 = FactorizationMachine(**kw, mesh=mesh)
    m2.fit(X, y, n_iter=2)
    np.testing.assert_allclose(m1.predict(X), m2.predict(X), atol=1e-6)


@pytest.mark.parametrize("optimizer,loss", [("adagrad", "warp"),
                                            ("rmsprop", "bpr")])
def test_rankmf_mesh_parity(mesh, optimizer, loss):
    from rsparse_tpu.models.rankmf import RankMF

    X = _interactions()
    kw = dict(rank=8, optimizer=optimizer, gamma=0.9, loss=loss, seed=7,
              batch_size=64, max_negative_samples=10, lambda_=0.01)
    m1 = RankMF(**kw)
    w1 = np.asarray(m1.partial_fit_transform(X, n_iter=3))
    m2 = RankMF(**kw, mesh=mesh)
    w2 = np.asarray(m2.partial_fit_transform(X, n_iter=3))

    assert w2.shape == (X.shape[0], 8)
    np.testing.assert_allclose(w1, w2, atol=1e-6)
    np.testing.assert_allclose(m1.components, m2.components, atol=1e-6)
    assert m1.auc_history == m2.auc_history


def test_rankmf_mesh_side_features(mesh):
    from rsparse_tpu.models.rankmf import RankMF

    X = _interactions()
    uf = sp.random(120, 30, density=0.2, random_state=2, format="csr")
    uf.data[:] = 1.0
    itf = sp.random(60, 25, density=0.3, random_state=3, format="csr")
    itf.data[:] = 1.0

    kw = dict(rank=8, seed=3, batch_size=64, max_negative_samples=8)
    m1 = RankMF(**kw)
    w1 = np.asarray(m1.partial_fit_transform(
        X, user_features=uf, item_features=itf, n_iter=2))
    m2 = RankMF(**kw, mesh=mesh)
    w2 = np.asarray(m2.partial_fit_transform(
        X, user_features=uf, item_features=itf, n_iter=2))
    np.testing.assert_allclose(w1, w2, atol=1e-6)
    np.testing.assert_allclose(np.asarray(m1.transform(X)),
                               np.asarray(m2.transform(X)), atol=1e-6)


def test_glove_mesh_multihost_axes():
    """The ("dcn","ici") hierarchical mesh shards tables over both axes."""
    from rsparse_tpu.models.glove import GloVe
    from rsparse_tpu.parallel.mesh import make_mesh as mm

    mesh2d = mm((2, 4), ("dcn", "ici"))
    rng = np.random.default_rng(1)
    n = 40
    coo = sp.coo_matrix(
        (rng.uniform(1, 5, 300), (rng.integers(0, n, 300),
                                  rng.integers(0, n, 300))), shape=(n, n))
    coo.sum_duplicates()
    m1 = GloVe(rank=4, x_max=10, learning_rate=0.05, seed=0,
               batch_size=128, n_hot=0)
    w1 = np.asarray(m1.fit_transform(coo, n_iter=2))
    m2 = GloVe(rank=4, x_max=10, learning_rate=0.05, seed=0,
               batch_size=128, n_hot=0, mesh=mesh2d)
    w2 = np.asarray(m2.fit_transform(coo, n_iter=2))
    np.testing.assert_allclose(w1, w2, atol=2e-6)


def test_ftrl_fm_mesh_parity_sparse_schedule(mesh):
    """Row-sharded tables WITH sparse-mode schedules (hashed-feature
    regime: table_rows >> scheduled rows): the active-rows scatter path of
    ops/segsum.py must agree with the single-device fit, and with the
    dense-mode result on the equivalent compacted problem."""
    from rsparse_tpu.models.fm import FactorizationMachine
    from rsparse_tpu.models.ftrl import FTRL
    from rsparse_tpu.ops.segsum import staged_blocks_with_layouts

    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    F = 300_000                       # >> nnz -> sparse mode
    X_small = sp.random(400, 60, density=0.15, random_state=1,
                        format="csr")
    coo = X_small.tocoo()
    X = sp.csr_matrix((coo.data, (coo.row, coo.col * (F // 60))),
                      shape=(400, F))
    _, layouts = staged_blocks_with_layouts(X, jnp.float32, F, None,
                                            "paritycheck")
    assert all(lay.inv is None for lay in layouts), "expected sparse mode"
    y = rng.integers(0, 2, 400).astype(float)

    m1 = FTRL(learning_rate=0.1, lambda_=0.01, seed=7)
    m1.fit(X, y, n_iter=2)
    m2 = FTRL(learning_rate=0.1, lambda_=0.01, seed=7, mesh=mesh)
    m2.fit(X, y, n_iter=2)
    np.testing.assert_allclose(m1.predict(X), m2.predict(X), atol=1e-6)

    f1 = FactorizationMachine(learning_rate_w=0.2, rank=4, seed=7)
    f1.fit(X, y, n_iter=2)
    f2 = FactorizationMachine(learning_rate_w=0.2, rank=4, seed=7,
                              mesh=mesh)
    f2.fit(X, y, n_iter=2)
    np.testing.assert_allclose(f1.predict(X), f2.predict(X), atol=1e-6)
