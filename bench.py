#!/usr/bin/env python
"""Benchmark driver: WRMF-implicit user-update throughput at rank 128.

Prints ONE JSON line on stdout:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

Headline metric (BASELINE.md): WRMF user-updates/s per chip at rank 128 on an
ML-20M-shaped implicit problem (log-normal row lengths, zipf item
popularity), conjugate-gradient solver with bfloat16 gather/compute and
float32 accumulation (equal loss to the f32 path within 1e-5 relative).

``vs_baseline``: the reference publishes no numbers (BASELINE.md), so the
baseline is the same CG-ALS math executed on the host CPU via XLA-CPU,
measured here and linearly scaled to the 16 threads named by the driver
target (this container exposes fewer cores).  XLA-CPU vectorizes at least as
well as the reference's Armadillo/OpenMP loops, so this is a *conservative*
(strong) baseline.  Details go to stderr; stdout carries only the JSON line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import scipy.sparse as sp

RANK = 128
N_USERS = 65_536
N_ITEMS = 32_768
MEAN_NNZ = 144          # ML-20M-ish interactions per user
LAM = 0.1
REPS = 10
BASELINE_THREADS = 16
# dense zipf-head size for the headline sweep (carried over from an
# earlier chip; not tuned on the H100)
N_HOT = 4096


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def synth_ml20m_like(n_users=N_USERS, n_items=N_ITEMS, mean_nnz=MEAN_NNZ,
                     seed=0):
    """Implicit interaction matrix with log-normal row lengths and
    popularity-skewed item choice (ML-20M-like shape)."""
    rng = np.random.default_rng(seed)
    row_nnz = np.clip(rng.lognormal(np.log(mean_nnz * 0.6), 0.9,
                                    n_users).astype(np.int64), 4, 4096)
    total = int(row_nnz.sum())
    pop = 1.0 / (np.arange(n_items) + 10.0)
    pop /= pop.sum()
    cols = rng.choice(n_items, size=total, p=pop)
    rows = np.repeat(np.arange(n_users), row_nnz)
    vals = 1.0 + rng.exponential(3.0, size=total)
    m = sp.csr_matrix((vals, (rows, cols)), shape=(n_users, n_items))
    m.sum_duplicates()
    return m


def measure_sweep(csr, rank, reps, platform=None, compute_dtype="bfloat16",
                  solver="conjugate_gradient",
                  max_buckets=24, n_hot=0, feedback="implicit",
                  hot_dtype=None, max_elems=1 << 21):
    """Sustained user-updates/s: ``reps`` chained warm sweeps, one final
    scalar readback forcing the dependency chain.

    ``n_hot > 0`` enables the dense zipf-head split: the hottest ``n_hot``
    items are handled as a dense (users x n_hot) matmul block with zero
    per-nnz gathers; only the long tail goes through the bucketed gather
    path.
    """
    import jax
    if platform:
        jax.config.update("jax_platforms", platform)
    from rsparse_tpu.config import use_compile_cache
    use_compile_cache()
    import jax.numpy as jnp
    from functools import partial
    from rsparse_tpu.ops.als import ALSConfig, solver_code, wrmf_sweep
    from rsparse_tpu.sparse.device import (bucket_rows, hot_bucket_rows,
                                           split_hot_cold)

    n_users, n_items = csr.shape
    t0 = time.time()
    hot = None
    cold = csr
    if n_hot:
        if hot_dtype is not None:
            w_dt = jnp.dtype(hot_dtype)
        else:
            w_dt = (jnp.bfloat16 if compute_dtype == "bfloat16"
                    else jnp.float32)
        hot, cold = split_hot_cold(csr, n_hot, jnp.float32, w_dtype=w_dt,
                                   with_presence=(feedback == "explicit"))
    ui = bucket_rows(cold, jnp.float32, max_buckets=max_buckets,
                     include_empty=bool(n_hot), max_elems=max_elems)
    padded = sum(B * L for B, L in ui.shapes)
    hot_nnz = csr.nnz - cold.nnz
    log(f"bucket build: {time.time()-t0:.1f}s {len(ui.shapes)} buckets, "
        f"padding waste {padded/max(cold.nnz,1):.2f}x"
        + (f", hot block {n_hot} items / {hot_nnz} nnz "
           f"({100*hot_nnz/csr.nnz:.0f}%)" if n_hot else ""))
    rng = np.random.default_rng(0)
    U = jnp.asarray(rng.standard_normal((n_users, rank)) * 0.01, jnp.float32)
    V = jnp.asarray(rng.standard_normal((n_items, rank)) * 0.01, jnp.float32)
    cfg = ALSConfig(feedback=feedback, solver=solver_code(solver),
                    compute_dtype=compute_dtype)
    # bucket order is fixed: pre-gather the hot rows once
    hot_rows = hot_bucket_rows(hot, ui.buckets, n_users)
    sweep = partial(jax.jit, static_argnames=("cfg",))(wrmf_sweep)

    t0 = time.time()
    U2, loss = sweep(V, U, ui.buckets, None, LAM, 0.0, cfg, hot, hot_rows)
    log(f"first call (compile): {time.time()-t0:.1f}s loss={float(loss):.1f}")

    # sustained throughput: chained sweeps, one final scalar readback (the
    # loss value forces the whole dependency chain); best of two groups
    times = []
    for _ in range(2):
        t0 = time.time()
        for _ in range(reps):
            U2, loss = sweep(V, U2, ui.buckets, None, LAM, 0.0, cfg,
                             hot, hot_rows)
        final_loss = float(loss)
        times.append(time.time() - t0)
    dt = min(times) / reps
    ups = n_users / dt
    log(f"sustained sweep ({feedback}/{solver}/{compute_dtype}"
        + (f"/hot{n_hot}" if n_hot else "") + f"): {dt*1e3:.1f} ms -> "
        f"{ups:,.0f} user-updates/s ({csr.nnz} nnz, loss {final_loss:.0f})")
    return ups


def measure_topk(csr, rank, k=10, user_chunk=256):
    """Device-resident masked top-k throughput (host->device staging of
    the embeddings is not part of the metric)."""
    import jax
    import jax.numpy as jnp
    from rsparse_tpu.ops import topk as tk
    rng = np.random.default_rng(0)
    n_users, n_items = csr.shape
    x = rng.standard_normal((n_users, rank)).astype(np.float32)
    y = jnp.asarray(rng.standard_normal((rank, n_items)), jnp.float32)

    C = user_chunk
    n_chunks = -(-n_users // C)
    group = 256
    n_pad = -(-n_items // group) * group
    y_pad = jnp.concatenate(
        [y, jnp.zeros((rank, n_pad - n_items), jnp.float32)], 1) \
        if n_pad > n_items else y
    xs = np.zeros((n_chunks, C, rank), np.float32)
    bits = np.empty((n_chunks, C, n_pad // 8), np.uint8)
    for ci, s in enumerate(range(0, n_users, C)):
        e = min(s + C, n_users)
        xs[ci, : e - s] = x[s:e]
        bits[ci, : e - s] = tk.pack_mask_bits(
            n_pad, csr=csr, rows=slice(s, e), n_rows=e - s)
        bits[ci, e - s:] = 0
    xs_d, bits_d = jnp.asarray(xs), jnp.asarray(bits)
    reps = 10

    @jax.jit
    def chained(xs_d, bits_d):
        # sustained: chained repetitions, one scalar readback
        def step(c, _):
            ts, _ = tk._topk_scan(xs_d + c * 1e-30, y_pad, bits_d,
                                  jnp.float32(0.0), k)
            return ts[0, 0, 0], None
        c, _ = jax.lax.scan(step, jnp.float32(0), None, length=reps)
        return c

    float(chained(xs_d, bits_d))  # warm + compile
    t0 = time.time()
    float(chained(xs_d, bits_d))
    dt = (time.time() - t0) / reps
    log(f"top-k: {dt*1e3:.1f} ms -> {n_users*n_items/dt/1e9:.2f} G "
        f"item-scores/s ({n_users/dt:,.0f} users/s, masked, k={k})")


def measure_glove(vocab=50_000, nnz=8_000_000, rank=128, seed=0, reps=3):
    """Config #4: GloVe on a text8-scale synthetic co-occurrence.
    Returns sustained triplets/s."""
    import scipy.sparse as sp
    from rsparse_tpu.models.glove import GloVe
    rng = np.random.default_rng(seed)
    pop = 1.0 / (np.arange(vocab) + 5.0)
    pop /= pop.sum()
    i = rng.choice(vocab, nnz, p=pop)
    j = rng.choice(vocab, nnz, p=pop)
    v = 1.0 + rng.exponential(5.0, nnz)
    tcm = sp.coo_matrix((v, (i, j)), shape=(vocab, vocab))
    tcm.sum_duplicates()
    # time warm epochs against device-resident shards + dense head block
    # (host->device transfer is not part of the metric)
    import jax.numpy as jnp
    from rsparse_tpu.models.glove import (GloveState, _glove_dense_step,
                                          _glove_epoch_sched, _head_grids,
                                          _split_head, _stack_coo_host)
    from rsparse_tpu.ops.segsum import build_stacked_col_schedule
    hot_ids, X_hh, rem = _split_head(tcm, int((1 << 29) ** 0.5))
    grids = None
    if hot_ids is not None:
        # bf16 head: matmuls + cost grids at half width, f32 accumulation
        # (identical convergence traces, models/glove.py compute_dtype)
        grids = _head_grids(X_hh, hot_ids, jnp.bfloat16, 1 << 16)
        log(f"glove head block: {len(hot_ids)} tokens, "
            f"{tcm.nnz - rem.nnz}/{tcm.nnz} nnz dense, "
            f"{grids[0].shape[0]} tiles")
    r_np, c_np, v_np, m_np = _stack_coo_host(rem, 1 << 16)
    shards = (jnp.asarray(r_np), jnp.asarray(c_np),
              jnp.asarray(v_np, jnp.float32), jnp.asarray(m_np))
    sched_r = build_stacked_col_schedule(r_np, m_np, vocab)
    sched_c = build_stacked_col_schedule(c_np, m_np, vocab)
    r2 = np.random.default_rng(seed)
    st = GloveState(
        w_i=jnp.asarray(r2.uniform(-0.5, 0.5, (vocab, rank)), jnp.float32),
        w_j=jnp.asarray(r2.uniform(-0.5, 0.5, (vocab, rank)), jnp.float32),
        b_i=jnp.asarray(r2.uniform(-0.5, 0.5, (vocab,)), jnp.float32),
        b_j=jnp.asarray(r2.uniform(-0.5, 0.5, (vocab,)), jnp.float32),
        acc_w_i=jnp.ones((vocab, rank), jnp.float32),
        acc_w_j=jnp.ones((vocab, rank), jnp.float32),
        acc_b_i=jnp.ones((vocab,), jnp.float32),
        acc_b_j=jnp.ones((vocab,), jnp.float32))

    def epoch(st):
        c = 0.0
        if grids is not None:
            st, ch = _glove_dense_step(st, *grids,
                                       x_max=100.0, alpha=0.75, lr=0.05,
                                       compute_dtype="bfloat16")
            c = ch
        st, ce = _glove_epoch_sched(st, *shards, sched_r, sched_c,
                                    x_max=100.0, alpha=0.75, lr=0.05)
        return st, c + ce

    t0 = time.time()
    st, c = epoch(st)
    float(c)
    log(f"glove first epoch (compile): {time.time()-t0:.1f}s")
    times = []
    for _ in range(reps):
        t0 = time.time()
        st, c = epoch(st)
        float(c)
        times.append(time.time() - t0)
    dt = min(times)
    log(f"glove: {dt*1e3:.0f} ms/epoch -> {tcm.nnz/dt/1e6:.1f} M triplets/s "
        f"(vocab={vocab}, nnz={tcm.nnz}, loss/nnz {float(c)/tcm.nnz:.3f})")
    return tcm.nnz / dt


def measure_soft_impute(csr, rank=256):
    """Config #3: soft-impute ALS iteration at LinearFlow-scale rank.

    Times warm device-resident iterations (staging the bucketed nnz is not
    part of the metric)."""
    import jax
    import jax.numpy as jnp
    from rsparse_tpu.models.soft_als import SVDResult, _soft_als_iter
    from rsparse_tpu.sparse.device import bucket_rows
    n_rows, n_cols = csr.shape
    x_b = bucket_rows(sp.csr_matrix(csr), jnp.float32, include_empty=False)
    tx_b = bucket_rows(csr.T.tocsr(), jnp.float32, include_empty=False)
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.standard_normal((n_rows, rank)))
    svd = SVDResult(jnp.asarray(q, jnp.float32),
                    jnp.ones((rank,), jnp.float32),
                    jnp.zeros((n_cols, rank), jnp.float32))
    lam = jnp.asarray(1.0, jnp.float32)
    t0 = time.time()
    svd, delta, loss = _soft_als_iter(tx_b.buckets, x_b.buckets, n_rows,
                                      n_cols, svd, lam, "soft_impute")
    float(loss)   # scalar readback forces the chain
    log(f"soft_impute first iter (compile): {time.time()-t0:.1f}s")
    n = 5
    t0 = time.time()
    for _ in range(n):
        svd, delta, loss = _soft_als_iter(tx_b.buckets, x_b.buckets, n_rows,
                                          n_cols, svd, lam, "soft_impute")
    final = float(loss)   # forces the chained dependency tree
    dt = (time.time() - t0) / n
    log(f"soft_impute rank-{rank}: {dt*1e3:.0f} ms/iter "
        f"({csr.nnz} nnz, loss {final/max(csr.nnz,1):.4f})")
    return 1.0 / dt       # iters/s (bigger = better, like every ratio here)


def measure_rankmf(csr, rank=128, n_iter=48, mesh=None):
    """Config #5: RankMF WARP pairwise updates/s.

    The model returns device-resident embeddings (identity features); the
    AUC scalar readback + block_until_ready bound the full update chain.
    """
    import jax
    from rsparse_tpu.models.rankmf import RankMF
    # lr=0.5: the tiny-init + unit-AdaGrad dynamics (reference semantics)
    # need a large rate to move at all — 0.05 leaves AUC ~0.51 at this
    # update budget, 0.5 reaches ~0.8+ (tests/test_fm_rankmf.py gate)
    m = RankMF(rank=rank, learning_rate=0.5, loss="warp", seed=0,
               batch_size=8192, max_negative_samples=20, mesh=mesh)
    t0 = time.time()
    jax.block_until_ready(m.partial_fit_transform(csr, n_iter=1))
    log(f"rankmf first pass (compile): {time.time()-t0:.1f}s")
    n_updates = n_iter * csr.shape[0]
    t0 = time.time()
    jax.block_until_ready(m.partial_fit_transform(csr, n_iter=n_iter))
    dt = time.time() - t0
    log(f"rankmf warp: {n_updates/dt:,.0f} pairwise updates/s "
        f"(AUC~{m.auc_history[-1]:.3f})")
    return n_updates / dt


def measure_config5_10m(n_users=10_000_000, n_items=131_072,
                        nnz_per_user=5, fm_rows=2_000_000, seed=0):
    """BASELINE config #5: RankMF (WARP) + FM on a 10M-user synthetic
    implicit matrix with factor tables ROW-SHARDED over the device mesh
    (1 chip here; the same sharded programs span hosts on a ("dcn","ici")
    mesh — proven by tests/test_multihost.py::test_two_process_sharded_sgd).

    RankMF: W table 10M x 8 rows sharded; one epoch = 10M pairwise updates.
    FM: one-hot user+item CF rows (2 nnz each); v table (10M + n_items) x 4.
    Returns {"rankmf_updates_per_s": ..., "fm_rows_per_s": ...}.
    """
    import jax
    from rsparse_tpu.models.fm import FactorizationMachine
    from rsparse_tpu.models.rankmf import RankMF
    from rsparse_tpu.parallel.mesh import make_mesh

    mesh = make_mesh()
    rng = np.random.default_rng(seed)
    out = {}

    # --- RankMF at 10M users -------------------------------------------
    t0 = time.time()
    cols = rng.integers(0, n_items, n_users * nnz_per_user, dtype=np.int64)
    indptr = np.arange(0, n_users * nnz_per_user + 1, nnz_per_user,
                       dtype=np.int64)
    # sort each row's items (the model would re-sort; keep staging cheap)
    cols = np.sort(cols.reshape(n_users, nnz_per_user), axis=1).reshape(-1)
    x = sp.csr_matrix((np.ones(len(cols), np.float32),
                       cols.astype(np.int32), indptr),
                      shape=(n_users, n_items))
    log(f"config5 synth build: {time.time()-t0:.1f}s "
        f"({n_users} users, {x.nnz} nnz)")
    m = RankMF(rank=8, learning_rate=0.5, loss="warp", seed=0,
               batch_size=8192, max_negative_samples=20, mesh=mesh)
    t0 = time.time()
    jax.block_until_ready(m.partial_fit_transform(x, n_iter=0))
    log(f"config5 rankmf staging+compile: {time.time()-t0:.1f}s")
    t0 = time.time()
    jax.block_until_ready(m.partial_fit_transform(x, n_iter=1))
    dt = time.time() - t0
    out["rankmf_updates_per_s"] = round(n_users / dt)
    log(f"config5 rankmf (10M users, row-sharded tables): "
        f"{n_users/dt:,.0f} pairwise updates/s (AUC~{m.auc_history[-1]:.3f})")
    del m, x

    # --- FM on one-hot CF rows -----------------------------------------
    u = rng.integers(0, n_users, fm_rows, dtype=np.int64)
    i = rng.integers(0, n_items, fm_rows, dtype=np.int64)
    n_feat = n_users + n_items
    fmx = sp.csr_matrix(
        (np.ones(2 * fm_rows, np.float32),
         np.stack([u, n_users + i], 1).astype(np.int64).reshape(-1),
         np.arange(0, 2 * fm_rows + 1, 2, dtype=np.int64)),
        shape=(fm_rows, n_feat))
    y = (u % 3 == 0).astype(np.float64)
    fm = FactorizationMachine(rank=4, learning_rate_w=0.2, seed=0,
                              mesh=mesh)
    t0 = time.time()
    fm.partial_fit(fmx, y)
    log(f"config5 fm staging+compile: {time.time()-t0:.1f}s")
    t0 = time.time()
    fm.partial_fit(fmx, y)
    dt = time.time() - t0
    out["fm_rows_per_s"] = round(fm_rows / dt)
    log(f"config5 fm ({n_feat} features, row-sharded v): "
        f"{fm_rows/dt:,.0f} rows/s")
    return out


def measure_ftrl_fm(n_rows=100_000, n_feat=10_000, nnz_per_row=32, seed=0,
                    reps=3, families=("ftrl", "fm")):
    """FTRL / FM online-learning rows/s on a synthetic CSR problem
    (reference-scale: test-ftrl.R uses 5k x 1k; this is 20x that).
    Returns {"ftrl": rows/s, "fm": rows/s}."""
    from rsparse_tpu.models.ftrl import FTRL
    from rsparse_tpu.models.fm import FactorizationMachine
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n_rows), nnz_per_row)
    cols = rng.integers(0, n_feat, n_rows * nnz_per_row)
    vals = rng.standard_normal(n_rows * nnz_per_row).astype(np.float32)
    x = sp.csr_matrix((vals, (rows, cols)), shape=(n_rows, n_feat))
    x.sum_duplicates()
    truth = (np.asarray(x[:, :64].sum(axis=1)).ravel() > 0).astype(np.float64)

    out = {}
    models = {"ftrl": lambda: FTRL(learning_rate=0.1, lambda_=1.0),
              "fm": lambda: FactorizationMachine(rank=8,
                                                 learning_rate_w=0.2)}
    for name in families:
        m = models[name]()
        t0 = time.time()
        m.partial_fit(x, truth)
        log(f"{name} first pass (compile): {time.time()-t0:.1f}s")
        # sustained: fit() materializes only the final pass's in-pass
        # predictions
        t0 = time.time()
        m.fit(x, truth, n_iter=reps)
        dt = (time.time() - t0) / reps
        acc = float(((m.predict(x) > 0.5) == truth).mean())
        log(f"{name}: {n_rows/dt:,.0f} rows/s "
            f"({x.nnz} nnz, train acc {acc:.3f})")
        out[name] = n_rows / dt
    return out


# quality gates: ~90% of the repo's earlier measured values (NDCG 0.3465 /
# MAP 0.4120; quality is device-independent) — a regression below these
# marks the bench run as failing quality (``quality_ok: 0``)
QUALITY_GATE_NDCG = 0.31
QUALITY_GATE_MAP = 0.37


def measure_quality_ml100k():
    """Driver config #1 quality gate: WRMF implicit CG rank 10 on the
    bundled real ML-100k, NDCG@10 / MAP@10 on held-out interactions.
    Returns (ndcg, map, ok)."""
    import rsparse_tpu as rt
    x = rt.load_movielens100k()
    rng = np.random.default_rng(0)
    train, test = rt.train_test_split(x, 0.2, rng)
    model = rt.WRMF(rank=10, lambda_=1.0, feedback="implicit",
                    solver="conjugate_gradient", seed=0)
    t0 = time.time()
    model.fit_transform(train, n_iter=10)
    preds = model.predict(train, k=10, not_recommend=train)
    ndcg = float(np.nanmean(rt.ndcg_k(preds.indices, test)))
    mapk = float(np.nanmean(rt.ap_k(preds.indices, test)))
    ok = ndcg > QUALITY_GATE_NDCG and mapk > QUALITY_GATE_MAP
    log(f"ml100k quality (rank-10 implicit CG, {time.time()-t0:.1f}s): "
        f"NDCG@10={ndcg:.4f} MAP@10={mapk:.4f} "
        f"(gates {QUALITY_GATE_NDCG}/{QUALITY_GATE_MAP}: "
        f"{'ok' if ok else 'FAIL'})")
    return ndcg, mapk, ok


def measure_linear_flow(csr, rank=256, cv_users=16_384):
    """Config #3: Linear-Flow rank-256 on the ML-20M-shaped synthetic —
    full closed-form fit (soft-impute right-singular-vectors + two SpMMs +
    ridge solve) and a 5-point ``cross_validate_lambda`` sweep with warm
    lhs/rhs reuse.  Returns {"fit_s": ..., "cv_s": ..., "per_lambda_s": ...}.
    """
    from rsparse_tpu.models.linear_flow import LinearFlow
    from rsparse_tpu.utils.split import train_test_split

    m = LinearFlow(rank=rank, lambda_=1.0, precision="float32", seed=0)
    t0 = time.time()
    xv = m.fit_transform(csr, n_iter=10)
    assert np.isfinite(float(np.asarray(xv).sum()))   # force the chain
    fit_s = time.time() - t0
    log(f"linear_flow rank-{rank} fit_transform ({csr.shape[0]} users, "
        f"{csr.nnz} nnz): {fit_s:.1f}s")
    # warm re-fit: staging is content-cached and executables are loaded
    m_w = LinearFlow(rank=rank, lambda_=1.0, precision="float32", seed=0)
    t0 = time.time()
    xv = m_w.fit_transform(csr, n_iter=10)
    assert np.isfinite(float(np.asarray(xv).sum()))
    fit_warm_s = time.time() - t0
    log(f"linear_flow warm re-fit: {fit_warm_s:.1f}s")

    sub = sp.csr_matrix(csr[:cv_users])
    rng = np.random.default_rng(0)
    tr, te = train_test_split(sub, 0.5, rng)
    m2 = LinearFlow(rank=rank, precision="float32", seed=0)
    t0 = time.time()
    res = m2.cross_validate_lambda(sub, tr, te, lambda_="auto@5",
                                   metric="map@10", n_iter=10)
    cv_s = time.time() - t0
    best = max(r["score"] for r in res)
    log(f"linear_flow cross_validate_lambda (5 lambdas, {cv_users} users): "
        f"{cv_s:.1f}s total, best map@10={best:.4f}")
    return {"fit_s": fit_s, "fit_warm_s": fit_warm_s, "cv_s": cv_s,
            "per_lambda_s": cv_s / 5,
            "budget": "fixed 10 soft-als iters (V not converged at "
                      "tol 1e-3; timings and CV quality are "
                      "fixed-budget, not converged-V numbers)"}


def measure_fit_e2e(csr, rank):
    """End-to-end ``WRMF.fit_transform`` at rank 128 on the device —
    exercises the full staging + training + mandatory closing Cholesky
    half-sweep (models/wrmf.py _transform_buckets)."""
    from rsparse_tpu import WRMF

    n_users = csr.shape[0]
    m = WRMF(rank=rank, lambda_=LAM, feedback="implicit",
             solver="conjugate_gradient", seed=0,
             compute_dtype="bfloat16")
    t0 = time.time()
    emb = m.fit_transform(csr, n_iter=2, convergence_tol=-1)
    dt = time.time() - t0
    assert emb.shape == (n_users, rank)
    assert np.isfinite(m.loss_history).all()
    log(f"fit_transform e2e (rank {rank}, {n_users} users, 2 iters + "
        f"exact transform): {dt:.1f}s, loss {m.loss_history[-1]:.4f}")
    # warm re-fit: staging is content-cached and the per-bucket-shape
    # executables are loaded
    m2 = WRMF(rank=rank, lambda_=LAM, feedback="implicit",
              solver="conjugate_gradient", seed=0,
              compute_dtype="bfloat16")
    t0 = time.time()
    emb = m2.fit_transform(csr, n_iter=2, convergence_tol=-1)
    dt_warm = time.time() - t0
    assert emb.shape == (n_users, rank)
    log(f"fit_transform e2e warm re-fit: {dt_warm:.1f}s")
    return dt


def measure_sharded_predict(csr, rank, k=10):
    """Mesh-path retrieval: predict() through sharded_top_product on a
    1-chip data mesh (the same program a pod would run per shard)."""
    import jax
    import jax.numpy as jnp
    from rsparse_tpu.parallel.mesh import make_mesh
    from rsparse_tpu.parallel.topk_sharded import sharded_top_product

    n_users, n_items = 8192, csr.shape[1]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n_users, rank)).astype(np.float32)
    y = rng.standard_normal((rank, n_items)).astype(np.float32)
    mesh = make_mesh((jax.device_count(),), ("data",))
    nr = csr[:n_users]
    idx, _ = sharded_top_product(mesh, x, y, k, not_recommend=nr)  # warm
    t0 = time.time()
    idx, scores = sharded_top_product(mesh, x, y, k, not_recommend=nr)
    dt = time.time() - t0
    rate = n_users * n_items / dt
    log(f"sharded predict ({jax.device_count()} dev, warm): {dt*1e3:.0f} ms "
        f"-> {rate/1e9:.2f} G item-scores/s (k={k}, masked, incl. per-call "
        f"mask staging + readback)")

    # device-resident variant: queries/masks/factors staged once, chained
    # sharded_top_k calls — the per-shard rate a pod serves at
    from jax.sharding import NamedSharding, PartitionSpec as P
    from rsparse_tpu.ops.topk import pack_mask_bits
    from rsparse_tpu.parallel.topk_sharded import sharded_top_k
    import jax.numpy as jnp
    n_dev = jax.device_count()
    n_pad = -(-n_items // (256 * n_dev)) * 256 * n_dev
    yp = np.concatenate([y, np.zeros((rank, n_pad - n_items), y.dtype)], 1) \
        if n_pad > n_items else y
    y_dev = jax.device_put(jnp.asarray(yp),
                           NamedSharding(mesh, P(None, "data")))
    C = 4096
    xs = [jnp.asarray(x[s:s + C]) for s in range(0, n_users, C)]
    bts = [jax.device_put(jnp.asarray(pack_mask_bits(
               n_pad, csr=nr, rows=slice(s, min(s + C, n_users)),
               n_rows=min(C, n_users - s))),
           NamedSharding(mesh, P(None, "data")))
           for s in range(0, n_users, C)]
    reps = 10

    @jax.jit
    def chained(xc, bc):
        # chain reps inside ONE program with a single scalar readback
        # (same method as the single-device top-k bench above)
        def step(c, _):
            s, _i = sharded_top_k(mesh, xc + c * 1e-30, y_dev, k,
                                  mask_bits=bc)
            return s[0, 0], None
        c, _ = jax.lax.scan(step, jnp.float32(0), None, length=reps)
        return c

    float(chained(xs[0], bts[0]))                     # warm + compile
    t0 = time.time()
    float(chained(xs[0], bts[0]))
    dt = (time.time() - t0) / reps
    rate = C * n_items / dt
    log(f"sharded predict device-resident: {dt*1e3:.1f} ms per {C} users "
        f"-> {rate/1e9:.2f} G item-scores/s")
    return idx


_BASELINE_STORE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "BASELINE_CPU.json")


# Per-family CPU probe snippets.  Same code on XLA-CPU, sized favorably to
# the CPU (smaller, cache-friendlier problems; the per-unit metric is
# size-insensitive at these scales).  Each prints ``CPU_VAL <rate>``.
CPU_PROBES = {
    "wrmf": (
        "csr = bench.synth_ml20m_like(n_users=16384, n_items=bench.N_ITEMS)\n"
        "v = bench.measure_sweep(csr, bench.RANK, 2, "
        "compute_dtype='float32')\n"),
    "glove": "v = bench.measure_glove(vocab=20_000, nnz=2_000_000, reps=2)\n",
    "rankmf": (
        "csr = bench.synth_ml20m_like(n_users=8192, n_items=8192)\n"
        "v = bench.measure_rankmf(csr.tocsr(), n_iter=2)\n"),
    "ftrl": ("v = bench.measure_ftrl_fm(n_rows=50_000, reps=2, "
             "families=('ftrl',))['ftrl']\n"),
    "fm": ("v = bench.measure_ftrl_fm(n_rows=50_000, reps=2, "
           "families=('fm',))['fm']\n"),
    # production-scale GLMs: FTRL's canonical workload is 1e7-1e9 hashed
    # features (McMahan et al.); rates are table-size-sensitive on both
    # sides (tables leave the caches), so the denominator runs the EXACT
    # numerator workload
    # (n_rows/n_feat/reps all match run_ftrl_fm_hashed)
    "ftrl_hashed": ("v = bench.measure_ftrl_fm(n_rows=100_000, "
                    "n_feat=40_000_000, reps=3, "
                    "families=('ftrl',))['ftrl']\n"),
    "fm_hashed": ("v = bench.measure_ftrl_fm(n_rows=100_000, "
                  "n_feat=40_000_000, reps=3, "
                  "families=('fm',))['fm']\n"),
}


def cpu_baseline_subprocess(family: str = "wrmf", n_runs: int = 3):
    """Measure a family's CPU rate in fresh subprocesses, each held to
    the CPU by ``JAX_PLATFORMS=cpu`` (the parent holds the GPU).

    Runs ``n_runs`` times and keeps the MAX (most favorable to the CPU):
    the container shares the box, and single-run numbers swung 2.6x
    between rounds (r01: 8,234 vs r02: 3,131 on identical code).  The best
    observed baseline per family is persisted to BASELINE_CPU.json so the
    speedup denominator can only tighten, never flatter, across rounds.

    NOTE this is a PROXY baseline: R is not installed in the image, so the
    reference itself cannot run; the denominator is our own JAX code on
    XLA-CPU, linearly extrapolated to 16 threads by the caller."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import bench\n" % os.path.dirname(os.path.abspath(__file__))
    ) + CPU_PROBES[family] + "print('CPU_VAL', v)\n"
    runs = []
    for i in range(n_runs):
        try:
            out = subprocess.run([sys.executable, "-c", code],
                                 capture_output=True, text=True, timeout=1800,
                                 env=_CPU_ENV)
            for line in out.stdout.splitlines():
                if line.startswith("CPU_VAL"):
                    runs.append(float(line.split()[1]))
                    break
            else:
                log(f"cpu {family} baseline run {i}: no output;",
                    out.stderr[-1000:])
        except Exception as e:  # noqa: BLE001
            log(f"cpu {family} baseline run {i} error:", e)
    if not runs:
        return None
    best = max(runs)
    log(f"cpu {family} baseline runs: {[f'{r:,.0f}' for r in runs]} "
        f"-> max {best:,.0f}")
    try:
        stored = {}
        if os.path.exists(_BASELINE_STORE):
            with open(_BASELINE_STORE) as f:
                stored = json.load(f)
        fams = stored.setdefault("families", {})
        # migrate the round-3 single-metric layout
        if "cpu_updates_per_s" in stored and "wrmf" not in fams:
            fams["wrmf"] = {"value": stored["cpu_updates_per_s"],
                            "runs": stored.get("runs", []),
                            "cores": stored.get("cores")}
        if best > fams.get(family, {}).get("value", 0):
            fams[family] = {"value": best, "runs": runs,
                            "cores": os.cpu_count()}
            if family == "wrmf":
                stored["cpu_updates_per_s"] = best   # keep legacy key fresh
            with open(_BASELINE_STORE, "w") as f:
                json.dump(stored, f)
        else:
            log(f"using stored best-known {family} baseline "
                f"{fams[family]['value']:,.0f} (this round's {best:,.0f})")
        best = fams[family]["value"]
    except Exception as e:  # noqa: BLE001
        log("baseline store error:", e)
    return best


def _vs16(dev_value, cpu_value):
    """Speedup vs the 16-thread-extrapolated CPU proxy (linear scaling
    from the container's cores — optimistic for the CPU)."""
    if not dev_value or not cpu_value:
        return None
    ncpu = os.cpu_count() or 1
    cpu16 = cpu_value * BASELINE_THREADS / min(ncpu, BASELINE_THREADS)
    return dev_value / cpu16


def measure_scaling_virtual():
    """Functional-relative scaling curve on 1/2/4/8 virtual CPU devices
    (scripts/scaling_bench.py --cpu).  NOT wall-clock-meaningful on an
    oversubscribed shared host — recorded as the measured precursor to the
    BASELINE.md >=80%-at-2-hosts target, which needs real multi-chip
    hardware this environment does not provide."""
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "scripts", "scaling_bench.py")
    try:
        out = subprocess.run(
            [sys.executable, script, "--cpu", "--devices", "1", "2", "4",
             "8", "--users", "8192", "--items", "4096"],
            capture_output=True, text=True, timeout=3600, env=_CPU_ENV)
        rows = []
        for line in out.stdout.splitlines():
            line = line.strip()
            if line.startswith("{"):
                rows.append(json.loads(line))
        log("scaling (virtual cpu):", rows)
        return rows
    except Exception as e:  # noqa: BLE001
        log("scaling bench failed:", e)
        return None


# child processes stay off the card the parent holds
_CPU_ENV = dict(os.environ, JAX_PLATFORMS="cpu")


def main():
    quick = "--quick" in sys.argv
    import jax
    if jax.default_backend() != "gpu":
        log(f"bench.py measures a GPU; JAX found {jax.default_backend()!r}")
        sys.exit(2)
    csr = synth_ml20m_like(8192 if quick else N_USERS,
                           4096 if quick else N_ITEMS)
    log(f"problem: {csr.shape} nnz={csr.nnz}")
    ups = measure_sweep(csr, RANK, 3 if quick else REPS,
                        n_hot=512 if quick else N_HOT)
    dev = {"wrmf": ups}
    quality = None
    lf = None
    cfg5 = None
    failed = []

    def run_glove():
        dev["glove"] = measure_glove()

    def run_rankmf():
        dev["rankmf"] = measure_rankmf(sp.csr_matrix(csr[:16384]))

    def run_ftrl_fm():
        dev.update(measure_ftrl_fm())

    def run_ftrl_fm_hashed():
        # hashed-feature scale (40M features): the scatter-free schedule
        # runs in sparse mode (active-rows-only scatter, ops/segsum.py)
        out = measure_ftrl_fm(n_rows=100_000, n_feat=40_000_000, reps=3)
        dev["ftrl_hashed"] = out["ftrl"]
        dev["fm_hashed"] = out["fm"]

    def run_soft_impute():
        dev["soft_impute"] = measure_soft_impute(sp.csr_matrix(csr[:16384]))

    def run_quality():
        nonlocal quality
        quality = measure_quality_ml100k()

    def run_linear_flow():
        nonlocal lf
        lf = measure_linear_flow(csr)

    def run_config5():
        nonlocal cfg5
        cfg5 = measure_config5_10m()

    for name, fn in [
        ("explicit_sweep", lambda: None if quick else measure_sweep(
            csr, RANK, 5, n_hot=N_HOT, feedback="explicit")),
        # driver config #2's solver axis: exact Cholesky vs CG at rank 128
        ("cholesky_sweep", lambda: None if quick else measure_sweep(
            csr, RANK, 3, solver="cholesky", max_elems=1 << 22)),
        # full model path incl. the closing exact transform half-sweep,
        # at the FULL problem size
        ("fit_e2e", lambda: measure_fit_e2e(
            sp.csr_matrix(csr[:8192]) if quick else csr, RANK)),
        ("topk", lambda: measure_topk(sp.csr_matrix(csr[:8192]), RANK)),
        ("sharded_predict", lambda: None if quick else
            measure_sharded_predict(csr, RANK)),
        ("glove", lambda: None if quick else run_glove()),
        ("linear_flow", lambda: None if quick else run_linear_flow()),
        ("soft_impute", lambda: None if quick else run_soft_impute()),
        ("rankmf", lambda: None if quick else run_rankmf()),
        ("ftrl_fm", lambda: None if quick else run_ftrl_fm()),
        ("ftrl_fm_hashed", lambda: None if quick else run_ftrl_fm_hashed()),
        ("config5_10m", lambda: None if quick else run_config5()),
        ("quality", lambda: None if quick else run_quality()),
    ]:
        try:
            fn()
        except Exception:  # noqa: BLE001 - run the rest, then fail
            log(f"{name} bench failed:\n{traceback.format_exc()}")
            failed.append(name)

    families = {}
    scaling = None
    if not quick:
        units = {"wrmf": "user-updates/s", "glove": "triplets/s",
                 "rankmf": "pairwise-updates/s", "ftrl": "rows/s",
                 "fm": "rows/s", "ftrl_hashed": "rows/s",
                 "fm_hashed": "rows/s"}
        for fam in ("wrmf", "glove", "rankmf", "ftrl", "fm",
                    "ftrl_hashed", "fm_hashed"):
            if fam not in dev:
                continue
            cpu_v = cpu_baseline_subprocess(
                fam, n_runs=3 if fam == "wrmf" else 2)
            r = _vs16(dev[fam], cpu_v)
            families[fam] = {
                "value": round(dev[fam]), "unit": units[fam],
                "vs_baseline": None if r is None else round(r, 2)}
            if r is not None:
                log(f"{fam}: {dev[fam]:,.0f} {units[fam]} "
                    f"= {r:.1f}x the 16-thread CPU proxy")
        if "soft_impute" in dev:
            families["soft_impute"] = {
                "value": round(dev["soft_impute"], 2), "unit": "iters/s",
                "vs_baseline": None}
        scaling = measure_scaling_virtual()

    vs = families.get("wrmf", {}).get("vs_baseline")
    out = {
        "metric": "wrmf_implicit_user_updates_per_s_chip_rank128",
        "value": round(ups),
        "unit": "updates/s",
        "vs_baseline": vs,
        # 1 = quality gates passed (or not run in --quick); 0 = REGRESSION
        "quality_ok": 1 if (quality is None or quality[2]) else 0,
        "extra": {
            "families": families,
            "linear_flow": lf,
            "config5_10m_rowsharded": cfg5,
            "quality_ml100k": None if quality is None else {
                "ndcg10": round(quality[0], 4), "map10": round(quality[1], 4),
                "gates": [QUALITY_GATE_NDCG, QUALITY_GATE_MAP]},
            "scaling_virtual_cpu": scaling,
            "notes": [
                "vs_baseline is a PROXY: R absent from image, so baseline "
                "= same JAX code on XLA-CPU x linear 16-thread "
                "extrapolation (optimistic for CPU); best-of-runs "
                "persisted in BASELINE_CPU.json",
                "ML-20M itself unavailable (zero-egress image); problems "
                "are ML-20M-shaped synthetics; quality is gated on the "
                "bundled real ML-100k",
                "scaling_virtual_cpu is functional-relative on "
                "oversubscribed virtual CPU devices, not wall-clock "
                "scaling; real multi-chip hardware is unavailable",
                "the proxy is a treadmill: kernel redesigns speed the "
                "XLA-CPU baseline too (it runs the same code), so a "
                "family's ratio can FALL while its absolute throughput "
                "rises; absolute per-family values are the stable "
                "comparison",
            ],
        },
    }
    print(json.dumps(out), flush=True)
    if quality is not None and not quality[2]:
        failed.append("quality_gates")
    if failed:
        log(f"failed measurements: {failed}")
        sys.exit(1)


if __name__ == "__main__":
    main()
