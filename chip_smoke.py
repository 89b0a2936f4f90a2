#!/usr/bin/env python
"""Smoke run of rsparse_tpu on an NVIDIA GPU, through the public API.

    python chip_smoke.py              # one card: the phases below
    python chip_smoke.py --multi 4    # four cards: the mesh paths only

One card runs four phases, each printing its numbers on its own lines:

- ``main``: WRMF (rank 128, implicit, CG, bf16 compute, ``n_hot="auto"``)
  ``fit_transform`` for 3 iterations on a synthetic matrix of GroupLens
  ML-20M's published shape (138,493 users x 26,744 items, 20,000,263
  interactions), then ``predict(x, k=10, not_recommend=x)`` for every user.
- ``reference``: the exact transform, one f32 CG sweep and the masked top-k
  against float64 numpy references (:func:`ref_normal_equations`,
  :func:`ref_cg`, :func:`ref_masked_topk`).
- ``quality``: the ML-100k NDCG@10 / MAP@10 gates (``bench.py``).
- ``families``: every other model family once at a small size, compared
  with the per-sample numpy replicas of ``tests/test_sgd_replica.py`` where
  they exist.

``--multi N`` runs only the mesh paths (2x2 WRMF mesh, ALX routing, sharded
predict, row-sharded RankMF) and compares each with the one-card result.

The last line of stdout is ``{"ok": true, "device": {...}}``; it is printed
only when every phase passed.  Without a GPU the script exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import scipy.sparse as sp

REPO = os.path.dirname(os.path.abspath(__file__))

# GroupLens ML-20M (ratings.csv): users, movies, ratings
ML20M_USERS, ML20M_ITEMS, ML20M_NNZ = 138_493, 26_744, 20_000_263

# -- tolerances ------------------------------------------------------------
# f32 Cholesky at HIGHEST against a float64 solve of the same equations:
# backward error ~ d * 2^-24 times the condition number of V'V + lam I
# (O(10) for fitted rank-128 factors) -> ~1e-5; 1e-4 leaves a 10x margin.
TOL_EXACT = 1e-4
# three f32 CG steps against the same recurrence in float64: rounding of
# one f32 matvec (~1e-6 relative), carried through three steps.
TOL_CG = 1e-4
# bf16 vs f32 CG sweep loss on the sampled users: bf16 keeps 8 mantissa
# bits (3.9e-3 relative per gathered factor), and the loss sums ~10^5
# terms whose rounding errors have random signs.
TOL_BF16_LOSS = 1e-3
# mesh paths vs one card (f32, matmuls at HIGHEST): the same per-row math
# with other reduction orders, amplified over three unconverged CG-ALS
# iterations (3e-5 on four virtual CPU devices; the GPU sums in yet
# another order).
TOL_MESH_EMB = 5e-4
TOL_MESH_LOSS = 1e-5
# row-sharded SGD vs one card: the same updates, but GPU scatter-adds
# accumulate duplicate rows in no fixed order.
TOL_MESH_SGD = 1e-4


def say(phase: str, **kv) -> None:
    print(phase + ": " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def synth_implicit(n_users: int, n_items: int, nnz: int, seed: int
                   ) -> sp.csr_matrix:
    """Implicit-feedback matrix with exactly ``nnz`` distinct interactions:
    log-normal row lengths, Zipf-like item popularity (1 / (rank + 10)),
    confidences ``1 + Exp(3)``.  Drawn pairs that repeat are re-drawn
    until ``nnz`` distinct pairs exist."""
    rng = np.random.default_rng(seed)
    lengths = rng.lognormal(np.log(0.6 * nnz / n_users), 0.9, n_users)
    lengths = np.clip(lengths * (nnz / lengths.sum()), 1,
                      n_items // 2).astype(np.int64)
    rows = np.repeat(np.arange(n_users, dtype=np.int64), lengths)
    cdf = np.cumsum(1.0 / (np.arange(n_items) + 10.0))
    cdf /= cdf[-1]
    keys = np.empty(0, np.int64)
    draw = rows
    while True:
        cols = np.minimum(np.searchsorted(cdf, rng.random(draw.size)),
                          n_items - 1)
        keys = np.unique(np.concatenate([keys, draw * n_items + cols]))
        if keys.size >= nnz:
            break
        draw = rng.choice(rows, int(1.3 * (nnz - keys.size)) + 1000)
    keys = np.sort(rng.choice(keys, nnz, replace=False))
    vals = 1.0 + rng.exponential(3.0, nnz)
    return sp.csr_matrix((vals, (keys // n_items, keys % n_items)),
                         shape=(n_users, n_items))


def spread_rows(csr: sp.csr_matrix, n: int) -> np.ndarray:
    """``n`` non-empty rows at evenly spaced quantiles of row length, so
    that every bucket of the length-bucketed layout is sampled."""
    lengths = np.diff(csr.indptr)
    order = np.argsort(lengths, kind="stable")
    order = order[lengths[order] > 0]
    return np.sort(order[np.linspace(0, len(order) - 1, n).astype(int)])


# -- float64 numpy references ----------------------------------------------


def ref_normal_equations(V, csr: sp.csr_matrix, lam: float):
    """Implicit-feedback normal equations of every row of ``csr`` given
    item factors ``V`` (n_items, d): ``lhs = V'V + lam I + V_u' diag(c - 1)
    V_u`` and ``rhs = V_u' c`` (Hu, Koren and Volinsky; reference
    inst/include/wrmf_implicit.hpp:206-237)."""
    V = np.asarray(V, np.float64)
    d = V.shape[1]
    gram = V.T @ V + lam * np.eye(d)
    n = csr.shape[0]
    lhs = np.empty((n, d, d))
    rhs = np.empty((n, d))
    for u in range(n):
        lo, hi = csr.indptr[u], csr.indptr[u + 1]
        Vu, c = V[csr.indices[lo:hi]], csr.data[lo:hi]
        lhs[u] = gram + (Vu * (c - 1.0)[:, None]).T @ Vu
        rhs[u] = Vu.T @ c
    return lhs, rhs


def ref_exact_transform(V, csr: sp.csr_matrix, lam: float) -> np.ndarray:
    """Exact per-row solve of :func:`ref_normal_equations`."""
    lhs, rhs = ref_normal_equations(V, csr, lam)
    return np.linalg.solve(lhs, rhs[..., None])[..., 0]


def ref_cg(V, csr: sp.csr_matrix, lam: float, x0, n_steps: int = 3,
           tol: float = 1e-10) -> np.ndarray:
    """Fixed-step conjugate gradient on :func:`ref_normal_equations` from
    ``x0``, freezing a row once its squared residual is below ``tol``
    (reference ``cg_solver_implicit``, inst/include/wrmf_implicit.hpp:9-32)."""
    lhs, rhs = ref_normal_equations(V, csr, lam)
    x = np.asarray(x0, np.float64).copy()
    r = rhs - np.einsum("bij,bj->bi", lhs, x)
    p = r.copy()
    rs = np.sum(r * r, -1)
    for _ in range(n_steps):
        live = rs >= tol
        Ap = np.einsum("bij,bj->bi", lhs, p)
        pAp = np.sum(p * Ap, -1)
        alpha = np.where(live, rs / np.where(pAp == 0, 1.0, pAp), 0.0)
        x += alpha[:, None] * p
        r -= alpha[:, None] * Ap
        rs_new = np.sum(r * r, -1)
        beta = np.where(live, rs_new / np.where(rs == 0, 1.0, rs), 0.0)
        p = r + beta[:, None] * p
        rs = np.where(live, rs_new, rs)
    return x


def ref_masked_topk(U, comps, mask: sp.csr_matrix, k: int):
    """Dense float64 oracle: scores ``U @ comps`` with masked entries at
    -inf; returns (top-k indices, full score matrix)."""
    s = np.asarray(U, np.float64) @ np.asarray(comps, np.float64)
    s[mask.toarray() != 0] = -np.inf
    return np.argsort(-s, axis=1, kind="stable")[:, :k], s


def check_topk_by_score(idx, scores_ref, U, comps, mask: sp.csr_matrix,
                        k: int, rel_eps: float) -> float:
    """Every returned item is distinct and unmasked, and its oracle score
    is at least the oracle's k-th score minus ``rel_eps * max_i sum_j
    |u_j v_ji|`` (the bound on the scoring product's rounding).  Returns
    the share of returned indices equal to the oracle's."""
    dense_mask = mask.toarray() != 0
    absdot = np.abs(np.asarray(U, np.float64)) @ np.abs(
        np.asarray(comps, np.float64))
    order = np.argsort(-scores_ref, axis=1, kind="stable")[:, :k]
    kth = np.take_along_axis(scores_ref, order[:, -1:], 1)[:, 0]
    for u in range(idx.shape[0]):
        row = idx[u]
        check(len(set(row.tolist())) == k, f"duplicate indices in row {u}")
        check(not dense_mask[u, row].any(), f"masked item returned, row {u}")
        slack = rel_eps * absdot[u].max()
        check(bool((scores_ref[u, row] >= kth[u] - slack).all()),
              f"row {u}: returned item below the k-th oracle score")
    return float((idx == order).mean())


# -- phases ------------------------------------------------------------------


def phase_main(seed: int, state: dict) -> None:
    import jax
    import rsparse_tpu as rt

    t0 = time.perf_counter()
    x = synth_implicit(ML20M_USERS, ML20M_ITEMS, ML20M_NNZ, seed)
    say("main", shape=x.shape, nnz=x.nnz,
        synth_s=round(time.perf_counter() - t0, 3))
    m = rt.WRMF(rank=128, lambda_=0.1, feedback="implicit",
                solver="conjugate_gradient", compute_dtype="bfloat16",
                n_hot="auto", seed=seed)
    t_fit = time.perf_counter()
    emb = jax.block_until_ready(m.fit_transform(x, n_iter=3,
                                                convergence_tol=-1))
    t_end = time.perf_counter()
    recs = list(m.fit_trace)
    iters = {}
    for r in recs:
        iters[r["iter"]] = iters.get(r["iter"], 0.0) + r["wall_s"]
    last = recs[-1]
    losses = [float(v) for v in m.loss_history]
    say("main", staging_s=round(recs[0]["start_s"] - t_fit, 3),
        first_iter_s=round(iters[1], 3),
        warm_iter_s=round(float(np.mean([iters[i] for i in (2, 3)])), 3),
        closing_transform_s=round(t_end - last["start_s"] - last["wall_s"],
                                  3),
        fit_transform_s=round(t_end - t_fit, 3), loss_history=losses)
    check(emb.shape == (ML20M_USERS, 128), f"embedding shape {emb.shape}")
    check(bool(np.isfinite(np.asarray(emb)).all()), "non-finite embedding")
    check(all(np.isfinite(losses)), "non-finite loss")
    check(all(b <= a * (1 + 1e-6) for a, b in zip(losses, losses[1:])),
          f"loss increased: {losses}")

    n_scores = ML20M_USERS * ML20M_ITEMS
    t0 = time.perf_counter()
    pred = m.predict(x, k=10, not_recommend=x)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred = m.predict(x, k=10, not_recommend=x)
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx, _ = rt.top_product(m._U, m.components, 10, not_recommend=x)
    topk_s = time.perf_counter() - t0
    say("main", predict_first_s=round(first, 3), predict_warm_s=round(warm, 3),
        predict_item_scores_per_s=round(n_scores / warm),
        topk_only_s=round(topk_s, 3),
        topk_item_scores_per_s=round(n_scores / topk_s))
    check(pred.indices.shape == (ML20M_USERS, 10), "predict shape")
    check(bool(np.isfinite(pred.scores).all()), "non-finite predict scores")
    check(bool((idx == pred.indices).all()), "top_product != predict")
    stats = jax.devices()[0].memory_stats() or {}
    say("main", peak_device_bytes=stats.get("peak_bytes_in_use"))

    # the dense-head split off: one warm user sweep over all nnz
    from rsparse_tpu.ops.als import ALSConfig, CONJUGATE_GRADIENT, \
        wrmf_sweep_streamed
    cfg = ALSConfig(feedback="implicit", solver=CONJUGATE_GRADIENT,
                    compute_dtype="bfloat16")
    V = m._V
    buckets = m._train_ui.buckets
    t0 = time.perf_counter()
    jax.block_until_ready(wrmf_sweep_streamed(V, m._U, buckets, None,
                                              m.lambda_, 0.0, cfg))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, loss = jax.block_until_ready(wrmf_sweep_streamed(
        V, m._U, buckets, None, m.lambda_, 0.0, cfg))
    say("main", n_hot0_user_sweep_first_s=round(first, 3),
        n_hot0_user_sweep_warm_s=round(time.perf_counter() - t0, 3),
        n_hot_auto_user_sweep_warm_s=round(float(np.mean(
            [r["wall_s"] for r in recs
             if r["phase"] == "users" and r["iter"] > 1])), 3),
        n_hot0_sweep_loss=float(loss))
    state.update(x=x, model=m, pred=pred)


def phase_reference(seed: int, state: dict) -> None:
    import jax
    import jax.numpy as jnp
    from rsparse_tpu.ops.als import ALSConfig, CONJUGATE_GRADIENT, \
        wrmf_sweep_streamed
    from rsparse_tpu.sparse.device import bucket_rows

    x, m, pred = state["x"], state["model"], state["pred"]
    lam = m.lambda_
    V = np.asarray(m.components, np.float64).T           # (n_items, 128)

    # (a) exact transform, f32 at HIGHEST, on every user; 512 checked
    rows = spread_rows(x, 512)
    m.compute_dtype = "float32"
    t0 = time.perf_counter()
    u32 = np.asarray(m.transform(x))
    dt = time.perf_counter() - t0
    m.compute_dtype = "bfloat16"
    ref = ref_exact_transform(V, x[rows], lam)
    err = np.linalg.norm(u32[rows] - ref, axis=1) / np.maximum(
        np.linalg.norm(ref, axis=1), 1e-30)
    say("reference", exact_transform_f32_s=round(dt, 3),
        exact_max_rel_err=float(err.max()), tol=TOL_EXACT)
    check(float(err.max()) <= TOL_EXACT, "exact transform vs float64")

    # (b) one CG sweep (f32, HIGHEST) vs the float64 CG recurrence, and
    # the bf16 sweep's loss vs the f32 sweep's, on the sampled users (four
    # padded buckets keep the compile count down)
    xs = sp.csr_matrix(x[rows])
    buckets = bucket_rows(xs, jnp.float32, max_buckets=4).buckets
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((len(rows), 128)) * 0.01
    Vd = jnp.asarray(V, jnp.float32)
    x0d = jnp.asarray(x0, jnp.float32)
    cfg32 = ALSConfig(feedback="implicit", solver=CONJUGATE_GRADIENT)
    cfg16 = ALSConfig(feedback="implicit", solver=CONJUGATE_GRADIENT,
                      compute_dtype="bfloat16")
    with jax.default_matmul_precision("highest"):
        got, l32 = wrmf_sweep_streamed(Vd, x0d, buckets, None, lam, 0.0,
                                       cfg32)
    _, l16 = wrmf_sweep_streamed(Vd, x0d, buckets, None, lam, 0.0, cfg16)
    want = ref_cg(V, xs, lam, x0, n_steps=3)
    err = np.linalg.norm(np.asarray(got, np.float64) - want, axis=1) / \
        np.maximum(np.linalg.norm(want, axis=1), 1e-30)
    rel = abs(float(l16) - float(l32)) / abs(float(l32))
    say("reference", cg_max_rel_err=float(err.max()), tol=TOL_CG,
        sweep_loss_bf16=float(l16), sweep_loss_f32=float(l32),
        loss_rel_diff=rel, loss_tol=TOL_BF16_LOSS)
    check(float(err.max()) <= TOL_CG, "CG sweep vs float64 replica")
    check(rel <= TOL_BF16_LOSS, "bf16 sweep loss vs f32")

    # (c) masked top-10 vs a dense float64 oracle on 1,024 users
    rows = spread_rows(x, 1024)
    Uh = np.asarray(m._U, np.float64)[rows]
    _, s_ref = ref_masked_topk(Uh, m.components, x[rows], 10)
    agree = check_topk_by_score(pred.indices[rows], s_ref, Uh, m.components,
                                x[rows], 10, rel_eps=SCORE_REL_EPS)
    say("reference", topk_users=len(rows), topk_index_agreement=agree,
        score_rel_eps=SCORE_REL_EPS)


# predict's scoring product runs at HIGHEST precision (ops/topk.py), so a
# returned item may trail the oracle's k-th score by f32 rounding only
SCORE_REL_EPS = 2.0 ** -20


def phase_quality(seed: int, state: dict) -> None:
    sys.path.insert(0, REPO)
    import bench
    ndcg, mapk, ok = bench.measure_quality_ml100k()
    say("quality", ndcg10=round(ndcg, 4), map10=round(mapk, 4),
        gates=[bench.QUALITY_GATE_NDCG, bench.QUALITY_GATE_MAP])
    check(ok, "ML-100k quality gates")


def _finite(*arrays) -> bool:
    return all(bool(np.isfinite(np.asarray(a, np.float64)).all())
               for a in arrays)


def phase_families(seed: int, state: dict) -> None:
    import rsparse_tpu as rt
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import test_sgd_replica as rep

    ml = rt.load_movielens100k()
    train, test = rt.train_test_split(ml, 0.2, np.random.default_rng(seed))
    rng = np.random.default_rng(seed)

    t0 = time.perf_counter()
    svd = rt.PureSVD(rank=16, seed=seed)
    e = svd.fit_transform(train, n_iter=10)
    check(_finite(e, svd.components), "PureSVD")
    p = svd.predict(train, k=10)
    say("families", puresvd_ndcg10=round(float(np.nanmean(
        rt.ndcg_k(p.indices, test))), 4))

    lf = rt.LinearFlow(rank=16, lambda_=1.0, seed=seed)
    e = lf.fit_transform(train, n_iter=10)
    check(_finite(e, lf.components), "LinearFlow")
    tr, te = rt.train_test_split(train, 0.5, np.random.default_rng(seed))
    res = rt.LinearFlow(rank=16, seed=seed).cross_validate_lambda(
        train, tr, te, lambda_="auto@3", n_iter=10)
    check(all(np.isfinite(r["score"]) for r in res), "LinearFlow CV")
    say("families", linearflow_cv=[round(r["score"], 4) for r in res])

    si = rt.soft_impute(train, rank=16, lambda_=1.0, n_iter=10, seed=seed)
    check(_finite(si.u, si.d, si.v), "soft_impute")

    km_c, km_a = rt.kmeans(rng.standard_normal((4096, 16)), 8, seed=seed)
    check(_finite(km_c) and km_a.shape == (4096,), "kmeans")

    sn = rt.ScaleNormalize(scale=0.5).fit_transform(train)
    check(_finite(sn.data), "ScaleNormalize")

    inter = sp.csr_matrix((train > 0).astype(np.float64))
    rmf = rt.RankMF(rank=16, learning_rate=0.5, loss="warp", seed=seed,
                    batch_size=1024, max_negative_samples=20)
    w = rmf.partial_fit_transform(inter, n_iter=2)
    check(_finite(w, rmf.components, rmf.auc_history), "RankMF")
    say("families", rankmf_auc=round(float(rmf.auc_history[-1]), 4))

    cm = sp.random(512, 512, density=0.05, random_state=seed, format="coo")
    cm.data = 1.0 + 5.0 * cm.data
    g = rt.GloVe(rank=16, x_max=10.0, learning_rate=0.05, seed=seed)
    e = g.fit_transform(cm, n_iter=3)
    check(_finite(e, g.cost_history), "GloVe")

    Xg = sp.random(4096, 1000, density=0.01, random_state=seed, format="csr")
    yg = rng.integers(0, 2, 4096).astype(float)
    ftrl = rt.FTRL(learning_rate=0.1, lambda_=0.1, seed=seed)
    ftrl.fit(Xg, yg, n_iter=2)
    fm = rt.FactorizationMachine(rank=4, learning_rate_w=0.2, seed=seed)
    fm.fit(Xg, yg, n_iter=2)
    check(_finite(ftrl.predict(Xg), fm.predict(Xg)), "FTRL / FM")

    # per-sample trajectories against the numpy replicas (float64 on the
    # card; the same math as the replicas, in another summation order)
    X, y, wts = rep._rand_problem(seed=1)
    m = rt.FTRL(learning_rate=0.2, learning_rate_decay=0.7, lambda_=0.4,
                l1_ratio=0.6, precision="double", seed=0)
    yh = [float(m.partial_fit(X[i], [y[i]], [wts[i]])[0])
          for i in range(X.shape[0])]
    z, n, yr = rep._ftrl_replica(X, y, wts, 0.2, 0.7, 0.4, 0.6)
    d_ftrl = max(np.abs(np.asarray(yh) - yr).max(),
                 np.abs(np.asarray(m.z)[:X.shape[1]] - z).max())

    X, y, wts = rep._rand_problem(seed=2)
    m = rt.FactorizationMachine(learning_rate_w=0.15, learning_rate_v=0.1,
                                rank=3, lambda_w=0.02, lambda_v=0.01,
                                precision="double", seed=5)
    m._ensure_state(X.shape[1])
    v0 = np.asarray(m.v)[:X.shape[1]].copy()
    for i in range(X.shape[0]):
        m.partial_fit(X[i], [y[i]], [wts[i]])
    w0, wr, vr = rep._fm_replica(X, y, wts, v0, 0.15, 0.1, 0.02, 0.01)
    d_fm = max(abs(float(m.w0) - w0),
               np.abs(np.asarray(m.w)[:X.shape[1]] - wr).max(),
               np.abs(np.asarray(m.v)[:X.shape[1]] - vr).max())

    r = np.random.default_rng(4)
    nv, nz = 25, 60
    coo = sp.coo_matrix((r.uniform(1.0, 4.0, nz),
                         (r.integers(0, nv, nz), r.integers(0, nv, nz))),
                        shape=(nv, nv))
    coo.sum_duplicates()
    coo = sp.coo_matrix(coo)
    init = {"w_i": r.uniform(-0.5, 0.5, (nv, 4)),
            "w_j": r.uniform(-0.5, 0.5, (nv, 4)),
            "b_i": r.uniform(-0.5, 0.5, nv), "b_j": r.uniform(-0.5, 0.5, nv)}
    g = rt.GloVe(rank=4, x_max=10.0, learning_rate=0.05, batch_size=1,
                 precision="float64", n_hot=0, seed=0,
                 init={k: v.copy() for k, v in init.items()})
    e = g.fit_transform(coo, n_iter=3, convergence_tol=-1.0)
    wi, _, _, _, costs = rep._glove_replica(coo, init, 10.0, 0.75, 0.05, 3)
    d_glove = max(np.abs(np.asarray(e) - wi).max(),
                  np.abs(np.asarray(g.cost_history) - costs).max())
    say("families", ftrl_replica_max_abs=float(d_ftrl),
        fm_replica_max_abs=float(d_fm), glove_replica_max_abs=float(d_glove),
        tol=TOL_REPLICA, seconds=round(time.perf_counter() - t0, 3))
    check(max(d_ftrl, d_fm, d_glove) <= TOL_REPLICA, "SGD replicas")


# float64 per-sample trajectories: the CPU tests hold them to 1e-10-1e-12;
# the card sums in another order, so allow 1e-9
TOL_REPLICA = 1e-9


def phase_multi(seed: int, n_dev: int) -> None:
    import jax
    import rsparse_tpu as rt
    from rsparse_tpu.parallel.mesh import make_mesh

    devs = jax.devices()
    check(len(devs) >= n_dev, f"{n_dev} devices wanted, {len(devs)} found")
    devs = devs[:n_dev]
    mesh22 = make_mesh((2, n_dev // 2), ("data", "model"), devs)
    data4 = make_mesh((n_dev,), ("data",), devs)
    # every user has 64 items drawn uniformly: near-equal row lengths in
    # both orientations keep the number of bucket shapes (= compilations
    # per path) small
    rng = np.random.default_rng(seed)
    n_users, n_items, per_row = 16_384, 2_048, 64
    cols = np.argsort(rng.random((n_users, n_items)), axis=1)[:, :per_row]
    x = sp.csr_matrix((1.0 + rng.exponential(3.0, n_users * per_row),
                       (np.repeat(np.arange(n_users), per_row),
                        cols.ravel())), shape=(n_users, n_items))
    kw = dict(rank=64, lambda_=0.1, feedback="implicit",
              solver="conjugate_gradient", seed=seed)

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))

    with jax.default_matmul_precision("highest"):
        t0 = time.perf_counter()
        m1 = rt.WRMF(**kw)
        e1 = m1.fit_transform(x, n_iter=3, convergence_tol=-1)
        p1 = m1.predict(x, k=10, not_recommend=x)
        say("multi", one_card_fit_predict_s=round(time.perf_counter() - t0,
                                                   3),
            loss_history=[float(v) for v in m1.loss_history])
        for name, mesh, routing in (("mesh2x2", mesh22, None),
                                    ("alx", data4, "alx"),
                                    ("alx_ragged", data4, "alx_ragged")):
            t0 = time.perf_counter()
            try:
                m2 = rt.WRMF(**kw, mesh=mesh, routing=routing)
                e2 = m2.fit_transform(x, n_iter=3, convergence_tol=-1)
            except Exception as e:  # noqa: BLE001
                # where the ragged path is refused it must fail loudly,
                # never emulate: record the reason and go on
                if name != "alx_ragged" or "ragged" not in str(e).lower():
                    raise
                say("multi", path=name, failed_loudly=repr(str(e)[:500]))
                continue
            d_emb = rel(e2, e1)
            d_loss = max(abs(a - b) / abs(b) for a, b in
                         zip(m2.loss_history, m1.loss_history))
            say("multi", path=name, seconds=round(time.perf_counter() - t0,
                                                  3),
                emb_rel=d_emb, loss_rel=d_loss, tol_emb=TOL_MESH_EMB,
                tol_loss=TOL_MESH_LOSS)
            check(d_emb <= TOL_MESH_EMB and d_loss <= TOL_MESH_LOSS, name)
            if name == "mesh2x2":
                # the sharded retrieval against the one-card kernel on the
                # same embeddings: equal up to f32 summation order
                t0 = time.perf_counter()
                p2 = m2.predict(x, k=10, not_recommend=x)
                dt = time.perf_counter() - t0
                i1, s1 = rt.top_product(np.asarray(m2.transform(x)),
                                        m2.components, 10, not_recommend=x)
                agree = float((p2.indices == i1).mean())
                d_sc = float(np.abs(p2.scores - s1).max())
                say("multi", path="sharded_predict", seconds=round(dt, 3),
                    index_agreement=agree, max_abs_score_diff=d_sc,
                    one_card_index_agreement=float(
                        (p2.indices == p1.indices).mean()))
                check(agree >= 0.9999 and d_sc <= 1e-5, "sharded predict")

        inter = sp.csr_matrix(x > 0, dtype=np.float64)
        rkw = dict(rank=32, learning_rate=0.5, loss="warp", seed=seed,
                   batch_size=2048, max_negative_samples=20)
        r1 = rt.RankMF(**rkw)
        w1 = r1.partial_fit_transform(inter, n_iter=1)
        t0 = time.perf_counter()
        r2 = rt.RankMF(**rkw, mesh=data4)
        w2 = r2.partial_fit_transform(inter, n_iter=1)
        d = max(float(np.abs(np.asarray(w1) - np.asarray(w2)).max()),
                float(np.abs(r1.components - r2.components).max()))
        say("multi", path="rankmf_rowsharded",
            seconds=round(time.perf_counter() - t0, 3), max_abs=d,
            tol=TOL_MESH_SGD)
        check(d <= TOL_MESH_SGD, "row-sharded RankMF")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--multi", type=int, default=0,
                    help="run only the mesh paths on this many cards")
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    from rsparse_tpu.config import use_compile_cache
    use_compile_cache()
    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU (backend {jax.default_backend()!r})",
              file=sys.stderr)
        return 2
    dev = jax.devices()[0]
    count = args.multi or 1
    say("device", platform=dev.platform, kind=repr(dev.device_kind),
        count=len(jax.devices()))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)

    if args.multi:
        phases = [("multi", lambda s, st: phase_multi(s, args.multi))]
    else:
        phases = [("main", phase_main), ("reference", phase_reference),
                  ("quality", phase_quality), ("families", phase_families)]
    state: dict = {}
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn(args.seed, state)
        except Exception:  # noqa: BLE001 - report every phase, then fail
            traceback.print_exc()
            failed.append(name)
        say(name, phase_s=round(time.perf_counter() - t0, 3),
            ok=name not in failed)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
