"""Per-sample trajectory replicas for the SGD family.

Each test feeds the model ONE sample per step and compares the full state
trajectory against an independent numpy replica of the reference per-sample
loop (reference src/FTRL.cpp:104-169, src/factorization_machine.cpp:112-194,
src/GloVe.cpp:81-158).

Two kinds of assertions:

- EXACT (double precision, atol ~1e-10): where the batched kernel's
  per-sample semantics coincide with the reference's (FTRL: the reference
  precomputes the row's lazy weights from the (z, n) snapshot, so one row
  per call is bit-equivalent math).
- DOCUMENTED DEVIATION, bounded: the kernels use accumulator-first AdaGrad
  (fold g^2 into the accumulator BEFORE scaling) while the reference
  scales by the stale accumulator and folds after
  (src/GloVe.cpp:134-155, src/factorization_machine.cpp:150-190); FM's
  reference additionally uses LIVE v within a row (earlier features'
  updates feed later features' s1).  For these, the model must match a
  replica of ITS OWN ordering exactly, and stay within a measured bound of
  the reference-ordering replica.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from rsparse_tpu.models.fm import FactorizationMachine
from rsparse_tpu.models.ftrl import FTRL
from rsparse_tpu.models.glove import GloVe


def _rand_problem(n_rows=24, n_feat=30, seed=0, max_nnz=6):
    """Rows with DISTINCT features (duplicate features in one row are
    order-dependent in the reference loops)."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for i in range(n_rows):
        k = int(rng.integers(1, max_nnz))
        f = rng.choice(n_feat, size=k, replace=False)
        rows += [i] * k
        cols += list(f)
        vals += list(rng.standard_normal(k))
    X = sp.csr_matrix((vals, (rows, cols)), shape=(n_rows, n_feat))
    y = rng.integers(0, 2, n_rows).astype(float)
    w = rng.uniform(0.5, 1.5, n_rows)
    return X, y, w


# ---------------------------------------------------------------- FTRL --


def _ftrl_replica(X, y, wts, lr, decay, lam, l1r, family="binomial"):
    """Reference src/FTRL.cpp:104-169 per-row loop (dropout=0)."""
    l1, l2 = lam * l1r, lam * (1 - l1r)
    F = X.shape[1]
    z = np.zeros(F)
    n = np.zeros(F)
    y_hat = np.zeros(X.shape[0])
    for i in range(X.shape[0]):
        p1, p2 = X.indptr[i], X.indptr[i + 1]
        idx, xv = X.indices[p1:p2], X.data[p1:p2]
        ww = np.where(
            np.abs(z[idx]) > l1,
            -(z[idx] - np.sign(z[idx]) * l1)
            / ((decay + np.sqrt(n[idx])) / lr + l2), 0.0)
        raw = np.sum(ww * xv)
        y_hat[i] = 1.0 / (1.0 + np.exp(-raw)) if family == "binomial" \
            else raw
        d = wts[i] * (y_hat[i] - y[i])
        g = np.clip(d * xv, -1000.0, 1000.0)
        n_new = n[idx] + g * g
        sigma = (np.sqrt(n_new) - np.sqrt(n[idx])) / lr
        z[idx] += g - sigma * ww
        n[idx] = n_new
    return z, n, y_hat


def test_ftrl_per_sample_matches_reference_replica():
    X, y, wts = _rand_problem(seed=1)
    lr, decay, lam, l1r = 0.2, 0.7, 0.4, 0.6
    m = FTRL(learning_rate=lr, learning_rate_decay=decay, lambda_=lam,
             l1_ratio=l1r, precision="double", seed=0)
    got_yh = []
    for i in range(X.shape[0]):
        got_yh.append(float(m.partial_fit(X[i], [y[i]], [wts[i]])[0]))
    z, n, y_hat = _ftrl_replica(X, y, wts, lr, decay, lam, l1r)
    np.testing.assert_allclose(got_yh, y_hat, atol=1e-12)
    np.testing.assert_allclose(np.asarray(m.z)[:X.shape[1]], z, atol=1e-12)
    np.testing.assert_allclose(np.asarray(m.n)[:X.shape[1]], n, atol=1e-12)


# ------------------------------------------------------------------ FM --


def _fm_replica(X, y01, wts, v0, lr_w, lr_v, lam_w, lam_v,
                ordering="batched", intercept=True):
    """FM per-sample loop.  ``ordering="reference"`` follows
    src/factorization_machine.cpp:147-190 exactly (w0 without AdaGrad,
    scale-then-accumulate, LIVE v within the row);
    ``ordering="batched"`` replicates the batched kernel's per-sample
    semantics (accumulator-first, snapshot s1, accumulated w0)."""
    F, r = v0.shape
    y = np.where(y01 == 1, 1.0, -1.0)
    w0, acc_w0 = 0.0, 1.0
    w = np.zeros(F)
    v = v0.copy()
    acc_w = np.ones(F)
    acc_v = np.ones((F, r))
    for i in range(X.shape[0]):
        p1, p2 = X.indptr[i], X.indptr[i + 1]
        idx, xv = X.indices[p1:p2], X.data[p1:p2]
        vx = v[idx] * xv[:, None]
        s1 = vx.sum(axis=0)
        raw = (w0 + np.sum(w[idx] * xv)
               + 0.5 * np.sum(s1 * s1 - np.sum(vx * vx, axis=0)))
        dL = (1.0 / (1.0 + np.exp(-raw * y[i])) - 1.0) * y[i] * wts[i]
        if ordering == "reference":
            if intercept:
                w0 -= lr_w * dL
            for k in range(len(idx)):
                j, x = idx[k], xv[k]
                g_w = np.clip(x * dL + 2 * lam_w, -100, 100)
                w[j] -= lr_w * g_w / np.sqrt(acc_w[j])
                acc_w[j] += g_w * g_w
                s1_live = (v[idx] * xv[:, None]).sum(axis=0)
                g_v = np.clip(dL * x * (s1_live - v[j] * x)
                              + 2 * lam_v * v[j], -100, 100)
                v[j] -= lr_v * g_v / np.sqrt(acc_v[j])
                acc_v[j] += g_v * g_v
        else:
            if intercept:
                acc_w0 += dL * dL
                w0 -= lr_w * dL / np.sqrt(acc_w0)
            g_w = np.clip(xv * dL + 2 * lam_w, -100, 100)
            aw = acc_w[idx] + g_w * g_w
            w[idx] -= lr_w * g_w / np.sqrt(aw)
            acc_w[idx] = aw
            g_v = np.clip(dL * xv[:, None] * (s1[None, :] - vx)
                          + 2 * lam_v * v[idx], -100, 100)
            av = acc_v[idx] + g_v * g_v
            v[idx] -= lr_v * g_v / np.sqrt(av)
            acc_v[idx] = av
    return w0, w, v


def test_fm_per_sample_matches_own_ordering_exactly():
    X, y, wts = _rand_problem(seed=2)
    lr_w, lr_v, lam_w, lam_v = 0.15, 0.1, 0.02, 0.01
    m = FactorizationMachine(learning_rate_w=lr_w, learning_rate_v=lr_v,
                             rank=3, lambda_w=lam_w, lambda_v=lam_v,
                             precision="double", seed=5)
    m._ensure_state(X.shape[1])
    v0 = np.asarray(m.v)[: X.shape[1]].copy()
    for i in range(X.shape[0]):
        m.partial_fit(X[i], [y[i]], [wts[i]])
    w0, w, v = _fm_replica(X, y, wts, v0, lr_w, lr_v, lam_w, lam_v,
                           ordering="batched")
    np.testing.assert_allclose(float(m.w0), w0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(m.w)[:X.shape[1]], w, atol=1e-12)
    np.testing.assert_allclose(np.asarray(m.v)[:X.shape[1]], v, atol=1e-12)


def test_fm_per_sample_close_to_reference_ordering():
    """Documented deviation (accumulator-first AdaGrad + snapshot s1)
    stays small against the exact reference ordering.  intercept=False
    isolates those two: the intercept rule itself is a LARGER documented
    deviation (the reference steps w0 by a bare lr*dL per sample,
    src/factorization_machine.cpp:147-149; the batched kernel needs an
    accumulator to keep summed steps stable, models/fm.py)."""
    X, y, wts = _rand_problem(seed=3)
    lr_w, lr_v, lam_w, lam_v = 0.15, 0.1, 0.02, 0.01
    m = FactorizationMachine(learning_rate_w=lr_w, learning_rate_v=lr_v,
                             rank=3, lambda_w=lam_w, lambda_v=lam_v,
                             intercept=False,
                             precision="double", seed=5)
    m._ensure_state(X.shape[1])
    v0 = np.asarray(m.v)[: X.shape[1]].copy()
    # several epochs: the per-step deviation is bounded by
    # sqrt(acc / (acc + g^2)) (largest at acc = 1, the very first step of
    # each feature) and decays as the accumulators grow
    n_epochs = 6
    for _ in range(n_epochs):
        for i in range(X.shape[0]):
            m.partial_fit(X[i], [y[i]], [wts[i]])
    Xr = sp.vstack([X] * n_epochs).tocsr()
    yr, wr = np.tile(y, n_epochs), np.tile(wts, n_epochs)
    _, w_ref, v_ref = _fm_replica(Xr, yr, wr, v0, lr_w, lr_v, lam_w,
                                  lam_v, ordering="reference",
                                  intercept=False)
    w_got = np.asarray(m.w)[: X.shape[1]]
    rel = np.linalg.norm(w_got - w_ref) / max(np.linalg.norm(w_ref), 1e-12)
    assert rel < 0.15, rel
    # directions agree where the reference moved materially
    big = np.abs(w_ref) > 0.05
    assert (np.sign(w_got[big]) == np.sign(w_ref[big])).all()


# --------------------------------------------------------------- GloVe --


def _glove_replica(coo, init, x_max, alpha, lr, n_iter,
                   ordering="batched"):
    """GloVe per-triplet loop (src/GloVe.cpp:81-158).  ``ordering``
    chooses the reference's scale-then-accumulate or the batched kernel's
    accumulator-first AdaGrad."""
    w_i = init["w_i"].copy()
    w_j = init["w_j"].copy()
    b_i = init["b_i"].copy()
    b_j = init["b_j"].copy()
    a_wi = np.ones_like(w_i)
    a_wj = np.ones_like(w_j)
    a_bi = np.ones_like(b_i)
    a_bj = np.ones_like(b_j)
    costs = []
    for _ in range(n_iter):
        total = 0.0
        for t in range(coo.nnz):
            i, j, x = coo.row[t], coo.col[t], coo.data[t]
            weight = min((x / x_max) ** alpha, 1.0)
            ci = np.clip(w_i[i] @ w_j[j] + b_i[i] + b_j[j] - np.log(x),
                         -100.0, 100.0)
            cost = weight * ci
            total += cost * ci
            g_wi = cost * w_j[j].copy()
            g_wj = cost * w_i[i].copy()
            if ordering == "reference":
                w_i[i] -= lr * g_wi / np.sqrt(a_wi[i])
                w_j[j] -= lr * g_wj / np.sqrt(a_wj[j])
                a_wi[i] += g_wi * g_wi
                a_wj[j] += g_wj * g_wj
                b_i[i] -= lr * cost / np.sqrt(a_bi[i])
                b_j[j] -= lr * cost / np.sqrt(a_bj[j])
                a_bi[i] += cost * cost
                a_bj[j] += cost * cost
            else:
                a_wi[i] += g_wi * g_wi
                a_wj[j] += g_wj * g_wj
                w_i[i] -= lr * g_wi / np.sqrt(a_wi[i])
                w_j[j] -= lr * g_wj / np.sqrt(a_wj[j])
                a_bi[i] += cost * cost
                a_bj[j] += cost * cost
                b_i[i] -= lr * cost / np.sqrt(a_bi[i])
                b_j[j] -= lr * cost / np.sqrt(a_bj[j])
        costs.append(0.5 * total / coo.nnz)
    return w_i, w_j, b_i, b_j, costs


@pytest.fixture(scope="module")
def glove_problem():
    rng = np.random.default_rng(4)
    n, nnz = 25, 60
    i = rng.integers(0, n, nnz)
    j = rng.integers(0, n, nnz)
    x = rng.uniform(1.0, 4.0, nnz)
    coo = sp.coo_matrix((x, (i, j)), shape=(n, n))
    coo.sum_duplicates()
    coo = sp.coo_matrix(coo)
    # make sure it's NOT triangular (avoid the transposed second pass)
    assert not ((coo.row <= coo.col).all() or (coo.row >= coo.col).all())
    init = {
        "w_i": rng.uniform(-0.5, 0.5, (n, 4)),
        "w_j": rng.uniform(-0.5, 0.5, (n, 4)),
        "b_i": rng.uniform(-0.5, 0.5, n),
        "b_j": rng.uniform(-0.5, 0.5, n),
    }
    return coo, init


def test_glove_per_sample_matches_own_ordering_exactly(glove_problem):
    """batch_size=1: every scan step is one triplet, so the kernel's
    trajectory must equal the accumulator-first per-sample replica."""
    coo, init = glove_problem
    g = GloVe(rank=4, x_max=10.0, learning_rate=0.05, batch_size=1,
              precision="float64", n_hot=0, seed=0,
              init={k: v.copy() for k, v in init.items()})
    emb = g.fit_transform(coo, n_iter=3, convergence_tol=-1.0)
    w_i, w_j, b_i, b_j, costs = _glove_replica(
        coo, init, 10.0, 0.75, 0.05, 3, ordering="batched")
    np.testing.assert_allclose(np.asarray(emb), w_i, atol=1e-10)
    np.testing.assert_allclose(np.asarray(g.components).T, w_j, atol=1e-10)
    np.testing.assert_allclose(np.asarray(g.bias_i), b_i, atol=1e-10)
    np.testing.assert_allclose(np.asarray(g.bias_j), b_j, atol=1e-10)
    np.testing.assert_allclose(g.cost_history, costs, atol=1e-10)


def test_glove_per_sample_close_to_reference_ordering(glove_problem):
    """The accumulator-first deviation (denominator gains the current g^2,
    models/glove.py) stays small vs the exact reference ordering."""
    coo, init = glove_problem
    g = GloVe(rank=4, x_max=10.0, learning_rate=0.05, batch_size=1,
              precision="float64", n_hot=0, seed=0,
              init={k: v.copy() for k, v in init.items()})
    emb = np.asarray(g.fit_transform(coo, n_iter=3, convergence_tol=-1.0))
    w_i, _, _, _, costs = _glove_replica(
        coo, init, 10.0, 0.75, 0.05, 3, ordering="reference")
    rel = np.linalg.norm(emb - w_i) / np.linalg.norm(w_i)
    assert rel < 0.02, rel
    np.testing.assert_allclose(g.cost_history, costs, rtol=0.05)
