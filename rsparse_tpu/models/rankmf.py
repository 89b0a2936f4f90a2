"""RankMF: pairwise-ranking matrix factorization (BPR / WARP).

Re-design of the reference RankMF (R/model_RankMF.R:7-162 over
src/rankmf.cpp:103-283).  The reference runs hogwild single-sample SGD:
sample a user, a positive item, then *rejection-sample* negatives one at a
time until one violates the margin (WARP) or immediately (BPR).  Dynamic
per-sample loop lengths don't map to XLA, so this redesign draws a
**fixed budget** of ``max_negative_samples`` candidates per sample at once,
tests membership in the user's positive set with a vectorized binary search
over the CSR row segment, and selects the *first* acceptable candidate with
a masked argmax — semantically the same accepted negative (and the same WARP
rank-weight ``log1p((n_item-1)/(k+1)) / log1p(n_item+1)`` with ``k`` the
number of candidates tried, src/rankmf.cpp:25-27,227-235).

Side features: user/item embeddings are feature combinations
``w_u = sum_f W[f] * uf_val`` (identity features = plain MF,
R/model_RankMF.R:87-88); gradients are scattered to every feature id of the
touched entities with the reference's per-feature scalar AdaGrad/RMSprop
accumulator of *mean squared gradient per embedding* (src/rankmf.cpp:86-100).
Like the reference, feature gradients are not scaled by feature values, and
weight decay subtracts ``lr * lambda * combined_embedding`` from each feature
column (:246-279).

Updates are deterministic minibatches (all samples in a batch read
start-of-batch parameters; duplicates accumulate via scatter-add).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp
from jax.sharding import Mesh, PartitionSpec as P

from ..config import logger, resolve_dtype
from ..parallel.sgd_sharded import (
    DirectOps, ShardedOps, mesh_table_axes, replicate_on, shard_table,
    unshard)
from .base import MatrixFactorizationRecommender, get_names

_DIRECT = DirectOps()
ADAGRAD, RMSPROP = 0, 1
_MAX_PROBE = 8        # hash-set probe window (build_user_hash guarantees)
BPR, WARP = 0, 1
IDENTITY, SIGMOID = 0, 1
EPS = 1e-10


class _Feats(NamedTuple):
    """Padded per-entity feature lists: idx (n, F), val (n, F), mask."""

    idx: jax.Array
    val: jax.Array
    mask: jax.Array


def _pad_features(feats: sp.csr_matrix, dtype) -> _Feats:
    csr = sp.csr_matrix(feats)
    csr.sort_indices()
    n = csr.shape[0]
    F = max(int(np.diff(csr.indptr).max()) if csr.nnz else 1, 1)
    idx = np.zeros((n, F), np.int32)
    val = np.zeros((n, F), np.float64)
    nnz = np.diff(csr.indptr)
    offs = np.arange(F)[None, :]
    flat = np.minimum(csr.indptr[:-1, None] + offs, max(csr.nnz - 1, 0))
    mask = offs < nnz[:, None]
    if csr.nnz:
        idx = np.where(mask, csr.indices[flat], 0).astype(np.int32)
        val = np.where(mask, csr.data[flat], 0.0)
    return _Feats(jnp.asarray(idx), jnp.asarray(val, dtype),
                  jnp.asarray(mask))


def _combine(ops, emb: jax.Array, feats: Optional[_Feats], ids: jax.Array
             ) -> jax.Array:
    """Feature-combined embeddings for entities ``ids``: (..., r).
    ``emb`` may be a row-sharded table (gather goes through ``ops``);
    ``feats`` is replicated metadata.  ``feats=None`` is the IDENTITY
    feature matrix (the reference default, R/model_RankMF.R:87-88) taken
    as one direct row gather — the padded-feature indirection costs 3
    extra gathers per access and measured as the dominant batch cost
    (PERF.md round 5)."""
    if feats is None:
        return ops.gather(emb, ids)
    fi = feats.idx[ids]              # (..., F)
    fv = jnp.where(feats.mask[ids], feats.val[ids], 0.0)
    return jnp.einsum("...f,...fr->...r", fv, ops.gather(emb, fi))


_HASH_MULT = np.uint32(2654435761)      # Knuth multiplicative hash


def build_user_hash(csr: sp.csr_matrix, max_probe: int = 8):
    """Per-user bucketized hash sets of the positive items.

    The reference rejection-samples negatives with a per-sample binary
    search (src/rankmf.cpp:36-56); a batched port of that search is a
    12-round sequential ``fori_loop`` of (S, K) gathers, and a plain
    open-addressing hash answers membership with an (S, K, 8) gather of
    scalar rows.  Both are gather-count-bound.

    So the table is bucketized instead: each user owns ``bcap_u``
    (power of two) buckets of ``max_probe`` lanes in a 2-D
    ``(total_buckets, max_probe)`` table; an item lives in ANY free lane
    of bucket ``h(item) & (bcap_u - 1)`` (no chaining across buckets —
    bucket counts double until every bucket fits).  Membership is ONE
    (S, K) row gather of the whole candidate bucket + a lane compare:
    8x fewer row-fetches for the same answer.  Empty lanes hold -1.

    Bucket selection uses the HIGH bits of the multiplicative hash
    (Fibonacci hashing, ``(item * MULT) >> (32 - log2(bcap))``): the low
    bits of ``item * odd_constant`` are a bijection of ``item mod bcap``,
    so regularly-strided item ids sharing a power-of-2 factor with
    ``bcap`` (hashed/strided feature ids) would all collide into a few
    buckets and balloon the table through repeated doubling.

    Returns ``(table (TB, max_probe) int32, boff (n_user,) int32,
    bmask (n_user,) int32, bshift (n_user,) int32)`` with ``bmask =
    bcap - 1`` and ``bshift = min(32 - log2(bcap), 31)``.
    """
    n_user = csr.shape[0]
    nnz = np.diff(csr.indptr).astype(np.int64)
    # target mean load max_probe/4 items per bucket: Poisson tail past
    # max_probe lanes is rare, the resize loop below mops it up
    bcap = 2 ** np.ceil(np.log2(np.maximum(
        -(-nnz // max(max_probe // 4, 1)), 1))).astype(np.int64)
    items_all = csr.indices.astype(np.uint32)
    users_all = np.repeat(np.arange(n_user, dtype=np.int64), nnz)
    h_all = (items_all * _HASH_MULT).astype(np.uint32)

    while True:
        boff = np.zeros(n_user + 1, np.int64)
        np.cumsum(bcap, out=boff[1:])
        total = int(boff[-1])
        if total * max_probe >= (1 << 31):
            raise MemoryError("user hash table exceeds int32 indexing")
        log2b = np.round(np.log2(bcap)).astype(np.int64)
        sh = np.minimum(32 - log2b, 31).astype(np.uint32)
        b = ((h_all >> sh[users_all])
             & (bcap[users_all] - 1).astype(np.uint32)).astype(np.int64)
        gb = boff[users_all] + b
        order = np.argsort(gb, kind="stable")
        gbs = gb[order]
        first = np.ones(len(gbs), bool)
        first[1:] = gbs[1:] != gbs[:-1]
        run_start = np.flatnonzero(first)
        lane = np.arange(len(gbs)) - run_start[np.cumsum(first) - 1]
        over = lane >= max_probe
        if over.any():          # rare: a bucket drew > max_probe items
            bcap[np.unique(users_all[order[over]])] *= 2
            continue
        table = np.full((total, max_probe), -1, np.int32)
        table[gbs, lane] = items_all[order].astype(np.int32)
        return (jnp.asarray(table), jnp.asarray(boff[:-1], jnp.int32),
                jnp.asarray(bcap - 1, jnp.int32),
                jnp.asarray(sh, jnp.int32))


def _in_hash_set(table, off, capmask, bshift, u, queries, max_probe: int):
    """Membership of queries[s, k] in user u[s]'s hash set — one (S, K)
    bucket-row gather + lane compare (``max_probe`` is carried in the
    staged table's lane width; the argument is kept for the fallback
    path's signature).  Bucket = high hash bits (Fibonacci), matching
    :func:`build_user_hash`."""
    h = (queries.astype(jnp.uint32) * _HASH_MULT).astype(jnp.uint32)
    m = capmask[u][:, None].astype(jnp.uint32)          # (S, 1)
    sh = bshift[u][:, None].astype(jnp.uint32)
    row = off[u][:, None] + ((h >> sh) & m).astype(jnp.int32)   # (S, K)
    got = table[row]                                    # (S, K, lanes)
    return jnp.any(got == queries[..., None], axis=-1)


def _in_sorted_segment(flat_idx, p1, nnz, queries, n_steps: int):
    """Vectorized binary search: is queries[s, k] present in the sorted
    segment flat_idx[p1[s] : p1[s]+nnz[s]]?  (src/rankmf.cpp:36-56)"""
    S, K = queries.shape
    lo = jnp.broadcast_to(jnp.zeros_like(nnz)[:, None], (S, K))
    hi = jnp.broadcast_to(nnz[:, None], (S, K))  # exclusive

    def body(_, lohi):
        lo, hi = lohi
        mid = (lo + hi) // 2
        v = flat_idx[jnp.clip(p1[:, None] + mid, 0, flat_idx.shape[0] - 1)]
        go_right = v < queries
        lo = jnp.where(go_right, mid + 1, lo)
        hi = jnp.where(go_right, hi, mid)
        return lo, hi

    lo, hi = jax.lax.fori_loop(0, n_steps, body, (lo, hi))
    v = flat_idx[jnp.clip(p1[:, None] + lo, 0, flat_idx.shape[0] - 1)]
    return (lo < nnz[:, None]) & (v == queries)


def _rankmf_batch(ops, W, H, accW, accH, key, flat_idx, indptr, row_nnz,
                  uhash, uf: _Feats, itf: _Feats, lr, gamma, lam_u, lam_ip,
                  lam_in, margin, cfg, n_item: int, bs_steps: int):
    """One minibatch of pairwise updates (cfg = (S, K, loss, kernel,
    optimizer, update_items)).  Factor-table access goes through ``ops``
    (parallel/sgd_sharded.py): W/H/accW/accH may be row-sharded under
    shard_map; the interaction CSR (flat_idx/indptr/row_nnz), the
    positive-set hash tables (``uhash``) and feature metadata are
    replicated, so sampling and the membership test stay collective-free.
    """
    S, K, loss_kind, kernel, optimizer, update_items = cfg
    lr = jnp.asarray(lr, W.dtype)
    gamma = jnp.asarray(gamma, W.dtype)
    lam_u = jnp.asarray(lam_u, W.dtype)
    lam_ip = jnp.asarray(lam_ip, W.dtype)
    lam_in = jnp.asarray(lam_in, W.dtype)
    margin = jnp.asarray(margin, W.dtype)
    n_user = row_nnz.shape[0]
    # ONE raw-bits draw covers user, positive-offset and all K negative
    # candidates (three jax.random.randint launches measured ~1.4 ms of a
    # 17.9 ms batch, PERF.md round 4; ranges << 2^32 so the modulo bias
    # is negligible)
    bits = jax.random.bits(key, (S, K + 2), jnp.uint32)

    u = (bits[:, 0] % jnp.uint32(n_user)).astype(jnp.int32)
    nnz_u = row_nnz[u]
    valid = nnz_u > 0                       # skip users w/o positives
    p1 = indptr[u]
    pos_off = (bits[:, 1] % jnp.maximum(nnz_u, 1).astype(jnp.uint32)
               ).astype(jnp.int32)
    i = flat_idx[jnp.clip(p1 + pos_off, 0, flat_idx.shape[0] - 1)]

    w_u = _combine(ops, W, uf, u)           # (S, r)
    h_i = _combine(ops, H, itf, i)

    j_cand = (bits[:, 2:] % jnp.uint32(n_item)).astype(jnp.int32)
    if uhash is not None:
        is_neg = ~_in_hash_set(*uhash, u, j_cand, bs_steps)
    else:
        is_neg = ~_in_sorted_segment(flat_idx, p1, nnz_u, j_cand, bs_steps)

    h_j_all = _combine(ops, H, itf, j_cand)  # (S, K, r)
    r_ui = jnp.sum(w_u * h_i, axis=1)       # (S,)
    r_uj = jnp.einsum("sr,skr->sk", w_u, h_j_all)
    if kernel == SIGMOID:
        r_ui_k = jax.nn.sigmoid(r_ui)
        r_uj_k = jax.nn.sigmoid(r_uj)
        hi_adj = r_ui_k * (1 - r_ui_k)      # (S,)
        hj_adj_all = r_uj_k * (1 - r_uj_k)  # (S, K)
        d = r_uj_k - r_ui_k[:, None]
    else:
        hi_adj = jnp.ones_like(r_ui)
        hj_adj_all = jnp.ones_like(r_uj)
        d = r_uj - r_ui[:, None]

    if loss_kind == BPR:
        acceptable = is_neg
    else:
        acceptable = is_neg & (d + margin >= 0)
    found = jnp.any(acceptable, axis=1) & valid
    first_k = jnp.argmax(acceptable, axis=1)          # (S,)
    sel = lambda a: jnp.take_along_axis(
        a, first_k[:, None], axis=1)[:, 0]
    j = sel(j_cand)
    d_sel = sel(d)
    hj_adj = sel(hj_adj_all)
    h_j = jnp.take_along_axis(h_j_all, first_k[:, None, None], axis=1)[:, 0]

    weight = jax.nn.sigmoid(d_sel)
    if loss_kind == WARP:
        # rank_loss(x) = log1p(x + 1) (src/rankmf.cpp:25-27).  float(): a
        # strong np.float64 scalar would upcast the whole gradient chain
        # under x64 (f64 scatters into the f32 tables)
        norm = float(np.log1p(float(n_item) + 1.0))
        weight = weight * jnp.log1p(
            (n_item - 1.0) / (first_k + 1.0) + 1.0) / norm
    weight = jnp.where(found, weight, 0.0)

    # AUC estimator: candidate 0 a true negative ranked below the positive
    auc_num = jnp.sum((is_neg[:, 0] & (d[:, 0] < 0) & valid))
    auc_den = jnp.maximum(jnp.sum(valid), 1)

    grad_u = weight[:, None] * (hj_adj[:, None] * h_j
                                - hi_adj[:, None] * h_i)    # (S, r)
    grad_ip = -weight[:, None] * hi_adj[:, None] * w_u
    grad_in = weight[:, None] * hj_adj[:, None] * w_u
    r = W.shape[1]

    def apply(emb, acc, feats, ids, grad, lam, comb):
        """Scatter one entity-set's update into feature embeddings.
        ``ids``/``grad``/``comb`` may stack several entity sets along the
        leading axis (the positive- and negative-item updates run as ONE
        fused scatter batch); ``lam`` is a scalar or a per-row vector;
        ``feats=None`` = identity features (one row per entity)."""
        if feats is None:
            fi = ids[:, None]                          # (M, 1)
            fmask = (grad != 0).any(1)[:, None]
        else:
            fi = feats.idx[ids]                        # (M, F)
            fmask = feats.mask[ids] & (grad != 0).any(1)[:, None]
        g2 = jnp.sum(grad * grad, axis=1) / r          # (M,) mean sq grad
        if getattr(lam, "ndim", 0) == 1:
            lam = lam[:, None, None]
        g2f = jnp.where(fmask, g2[:, None], 0.0)
        if optimizer == ADAGRAD:
            acc = ops.scatter_add(acc, fi, g2f)
            denom = jnp.sqrt(ops.gather(acc, fi) + EPS)   # (S, F)
        else:
            # RMSPROP: acc <- gamma*acc + (1-gamma)*sum(g2) once per touched
            # feature per batch (the batched analog of the reference's
            # per-sample EMA, src/rankmf.cpp:86-100).  The (new - old) delta
            # must be divided by the feature's duplicate count in this
            # batch: naive scatter-add of it once per duplicate would apply
            # the (gamma-1)*old term n times and drive the accumulator
            # negative (NaN under sqrt) whenever a user/item repeats.
            # ``cnt`` is a batch-local table in the same (sharded) layout
            # as ``acc``.
            old = ops.gather(acc, fi)
            cnt = ops.scatter_add(jnp.zeros((acc.shape[0],), acc.dtype),
                                  fi, fmask.astype(acc.dtype))
            n_dup = jnp.maximum(ops.gather(cnt, fi), 1.0)
            delta = (gamma - 1.0) * old / n_dup + (1.0 - gamma) * g2[:, None]
            acc = ops.scatter_add(acc, fi, jnp.where(fmask, delta, 0.0))
            denom = jnp.sqrt(ops.gather(acc, fi) + EPS)
        step = grad[:, None, :] / denom[..., None] + lam * comb[:, None, :]
        step = jnp.where(fmask[..., None], step, 0.0)
        emb = ops.scatter_add(emb, fi, -lr * step)
        return emb, acc

    W, accW = apply(W, accW, uf, u, grad_u, lam_u, w_u)
    if update_items:
        # ONE fused apply for the positive + negative item updates (two
        # sequential scatter/gather/scatter chains measured as the bulk of
        # the ~4 ms fixed batch cost, PERF.md round 4).  Duplicate ids
        # across the two sets now see each other's accumulator
        # contributions — the same accumulator-first semantics duplicates
        # within one set already had.
        H, accH = apply(
            H, accH, itf,
            jnp.concatenate([i, j]),
            jnp.concatenate([grad_ip, grad_in]),
            jnp.concatenate([jnp.full((S,), lam_ip, W.dtype),
                             jnp.full((S,), lam_in, W.dtype)]),
            jnp.concatenate([h_i, h_j]))

    n_tried = jnp.sum(jnp.where(found, first_k + 1, K))
    return W, H, accW, accH, auc_num, auc_den, jnp.sum(found), n_tried


def _rankmf_epoch_impl(ops, W, H, accW, accH, keys, flat_idx, indptr,
                       row_nnz, uhash, uf: _Feats, itf: _Feats, lr, gamma,
                       lam_u, lam_ip, lam_in, margin, cfg, n_item: int,
                       bs_steps: int):
    """All minibatches of one fit call as a single scanned program —
    per-batch host dispatch would dominate on a high-latency runtime."""

    def step(carry, key):
        W, H, accW, accH, an, ad = carry
        W, H, accW, accH, a_n, a_d, _, _ = _rankmf_batch(
            ops, W, H, accW, accH, key, flat_idx, indptr, row_nnz, uhash,
            uf, itf, lr, gamma, lam_u, lam_ip, lam_in, margin, cfg, n_item,
            bs_steps)
        return (W, H, accW, accH, an + a_n.astype(jnp.int32),
                ad + a_d.astype(jnp.int32)), None

    init = (W, H, accW, accH, jnp.zeros((), jnp.int32),
            jnp.zeros((), jnp.int32))
    (W, H, accW, accH, auc_n, auc_d), _ = jax.lax.scan(step, init, keys)
    return W, H, accW, accH, auc_n, auc_d


@partial(jax.jit, static_argnames=("cfg", "n_item", "bs_steps"),
         donate_argnums=(0, 1, 2, 3))
def _rankmf_epoch(W, H, accW, accH, keys, flat_idx, indptr, row_nnz, uhash,
                  uf: _Feats, itf: _Feats, lr, gamma, lam_u, lam_ip, lam_in,
                  margin, cfg, n_item: int, bs_steps: int):
    return _rankmf_epoch_impl(_DIRECT, W, H, accW, accH, keys, flat_idx,
                              indptr, row_nnz, uhash, uf, itf, lr, gamma,
                              lam_u, lam_ip, lam_in, margin, cfg, n_item,
                              bs_steps)


_SHARDED_FNS: dict = {}


def _sharded_rankmf_fn(mesh: Mesh, cfg, n_item: int, bs_steps: int):
    """Cached shard_map program: W/H and their accumulators row-sharded
    (BASELINE config #5's "factor tables row-sharded across 2+ hosts");
    interactions/features/keys replicated."""
    key = (mesh, cfg, n_item, bs_steps)
    fn = _SHARDED_FNS.get(key)
    if fn is not None:
        return fn
    axes = mesh_table_axes(mesh)
    ops = ShardedOps(axes)
    tab, rep = P(axes), P()

    def body(W, H, accW, accH, *rest):
        return _rankmf_epoch_impl(ops, W, H, accW, accH, *rest, cfg=cfg,
                                  n_item=n_item, bs_steps=bs_steps)

    fn = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(tab, tab, tab, tab) + (rep,) * 13,
        out_specs=(tab, tab, tab, tab, rep, rep), check_vma=False),
        donate_argnums=(0, 1, 2, 3))
    _SHARDED_FNS[key] = fn
    if len(_SHARDED_FNS) > 16:
        _SHARDED_FNS.pop(next(iter(_SHARDED_FNS)))
    return fn


class RankMF(MatrixFactorizationRecommender):
    """Pairwise-ranking MF with optional user/item side features."""

    def __init__(
        self,
        rank: int = 8,
        learning_rate: float = 0.01,
        optimizer: str = "adagrad",
        lambda_: float = 0.0,
        gamma: float = 0.0,
        loss: str = "bpr",
        kernel: str = "identity",
        margin: float = 0.1,
        max_negative_samples: int = 50,
        batch_size: int = 512,
        precision: str = "float32",
        seed: Optional[int] = None,
        mesh: Optional[Mesh] = None,
    ):
        super().__init__()
        #: device mesh: when set, the four factor-state tables (user/item
        #: feature embeddings + optimizer accumulators) are row-sharded
        #: over the mesh's data axes — BASELINE config #5's requirement;
        #: replaces the reference's hogwild shared tables
        #: (src/rankmf.cpp:133-140).  Interactions and feature metadata
        #: are replicated (streamed read-only data), which keeps sampling
        #: and the positive-set binary search collective-free.
        self.mesh = mesh
        self.rank = int(rank)
        self.learning_rate = float(learning_rate)
        self.optimizer = {"adagrad": ADAGRAD, "rmsprop": RMSPROP}[optimizer]
        if np.isscalar(lambda_):
            lambda_ = {"lambda_user": lambda_, "lambda_item_positive": lambda_,
                       "lambda_item_negative": lambda_}
        self.lambda_user = float(lambda_["lambda_user"])
        self.lambda_item_positive = float(lambda_["lambda_item_positive"])
        self.lambda_item_negative = float(lambda_["lambda_item_negative"])
        self.gamma = float(gamma)
        self.loss = {"bpr": BPR, "warp": WARP}[loss]
        self.kernel = {"identity": IDENTITY, "sigmoid": SIGMOID}[kernel]
        self.margin = float(margin)
        self.max_negative_samples = int(max_negative_samples)
        self.batch_size = int(batch_size)
        self.dtype = resolve_dtype(precision)
        self._rng = np.random.default_rng(seed)
        self._key = jax.random.PRNGKey(seed if seed is not None else 0)
        self.user_features_embeddings = None   # W (n_user_feat, r)
        self.item_features_embeddings = None   # H (n_item_feat, r)
        self._accW = self._accH = None
        self._item_features = None
        self._identity_user_feats = self._identity_item_feats = False
        self.auc_history = []

    def partial_fit_transform(self, x: sp.spmatrix, item_features=None,
                              user_features=None, n_iter: int = 100,
                              update_items: bool = True):
        """Run ``n_iter * n_user`` pairwise updates; returns user embeddings
        (reference R/model_RankMF.R:86-160)."""
        csr = sp.csr_matrix(x)
        csr.sort_indices()
        n_user, n_item = csr.shape
        self.item_ids = get_names(x, 1)
        self._identity_item_feats = item_features is None
        self._identity_user_feats = user_features is None
        if item_features is None:
            item_features = sp.identity(n_item, format="csr")
        if user_features is None:
            user_features = sp.identity(n_user, format="csr")
        item_features = sp.csr_matrix(item_features)
        user_features = sp.csr_matrix(user_features)
        if user_features.shape[0] != n_user:
            raise ValueError("user_features rows must match n_users")
        if item_features.shape[0] != n_item:
            raise ValueError("item_features rows must match n_items")
        self._item_features = item_features
        self._user_features = user_features
        nuf, nif = user_features.shape[1], item_features.shape[1]

        self._nuf, self._nif = nuf, nif
        if self.user_features_embeddings is None:
            self.user_features_embeddings = jnp.asarray(
                self._rng.standard_normal((nuf, self.rank)) * 1e-3,
                self.dtype)
            self._accW = jnp.ones((nuf,), self.dtype)
            if self.mesh is not None:
                self.user_features_embeddings = shard_table(
                    self.user_features_embeddings, self.mesh)
                self._accW = shard_table(self._accW, self.mesh)
        if self.item_features_embeddings is None:
            self.item_features_embeddings = jnp.asarray(
                self._rng.standard_normal((nif, self.rank)) * 1e-3,
                self.dtype)
            self._accH = jnp.ones((nif,), self.dtype)
            if self.mesh is not None:
                self.item_features_embeddings = shard_table(
                    self.item_features_embeddings, self.mesh)
                self._accH = shard_table(self._accH, self.mesh)

        # content-addressed staging: repeated partial_fit calls on the same
        # interactions/features skip the host->device transfers entirely
        from ..sparse.device import staged_cached
        dt_key = (str(jnp.dtype(self.dtype)), self.mesh)
        rep = ((lambda t: replicate_on(self.mesh, t))
               if self.mesh is not None else (lambda t: t))
        # identity features (the reference default) skip the padded
        # feature indirection entirely: _combine/apply use the entity id
        # as the single feature row
        uf = None if self._identity_user_feats else staged_cached(
            "rankmf_uf", user_features,
            lambda: rep(_pad_features(user_features, self.dtype)),
            extra=dt_key)
        itf = None if self._identity_item_feats else staged_cached(
            "rankmf_if", item_features,
            lambda: rep(_pad_features(item_features, self.dtype)),
            extra=dt_key)
        flat_idx, indptr, row_nnz, uhash = staged_cached(
            "rankmf_x", csr,
            lambda: rep((jnp.asarray(csr.indices, jnp.int32),
                         jnp.asarray(csr.indptr[:-1], jnp.int32),
                         jnp.asarray(np.diff(csr.indptr), jnp.int32),
                         build_user_hash(csr, _MAX_PROBE))),
            extra=self.mesh)
        bs_steps = _MAX_PROBE      # hash probe window (see build_user_hash)

        S = min(self.batch_size, max(n_user, 8))
        K = min(self.max_negative_samples, n_item)
        n_updates = n_iter * n_user
        n_batches = max(n_updates // S, 1)
        cfg = (S, K, self.loss, self.kernel, self.optimizer,
               bool(update_items))

        W, H = self.user_features_embeddings, self.item_features_embeddings
        accW, accH = self._accW, self._accH
        # fixed-size scanned chunks: one compilation regardless of n_iter
        # (a single whole-call scan would re-compile per distinct batch
        # count), dispatch overhead amortized 8x; the chunk loop is fully
        # asynchronous (no host syncs until the AUC readback below)
        CHUNK = 8
        n_chunks = -(-n_batches // CHUNK)
        auc_n = auc_d = 0
        if self.mesh is not None:
            epoch = _sharded_rankmf_fn(self.mesh, cfg, n_item, bs_steps)
        else:
            epoch = partial(_rankmf_epoch, cfg=cfg, n_item=n_item,
                            bs_steps=bs_steps)
        for _ in range(n_chunks):
            self._key, sub = jax.random.split(self._key)
            keys = jax.random.split(sub, CHUNK)
            # scalars ride at the table dtype: python floats trace as f64
            # under x64 and would upcast the scatter updates (a future
            # jax error for .at[].add with mismatched dtypes)
            sc = lambda v: jnp.asarray(v, W.dtype)
            (W, H, accW, accH, an, ad) = epoch(
                W, H, accW, accH, keys, flat_idx, indptr, row_nnz, uhash,
                uf, itf,
                sc(self.learning_rate), sc(self.gamma), sc(self.lambda_user),
                sc(self.lambda_item_positive),
                sc(self.lambda_item_negative),
                sc(self.margin))
            auc_n, auc_d = an, ad  # last chunk's counters (freshest estimate)
        self.auc_history.append(int(auc_n) / max(int(auc_d), 1))
        logger.info("RankMF: %d updates, AUC~%.3f", n_batches * S,
                    self.auc_history[-1])

        self.user_features_embeddings = W
        self.item_features_embeddings = H
        self._accW, self._accH = accW, accH

        # final embeddings = features x feature-embeddings
        # (reference R/model_RankMF.R:154-159).  With identity features the
        # embeddings ARE the tables — return the device array and defer the
        # ``components`` materialization to first access (device->host pulls
        # are wasted between online partial_fit calls).
        self._components_cache = None
        self._components_l2 = None
        if self._identity_user_feats:
            # defensive copy: the live table is DONATED into the next
            # partial_fit's _rankmf_epoch, which would invalidate a
            # caller-held return value ("Array has been deleted").
            # [:nuf] slices off mesh-padding rows (no-op without mesh).
            return jnp.copy(W[:nuf]) if W.shape[0] != nuf else jnp.copy(W)
        return user_features @ unshard(W, nuf).astype(np.float64)

    @property
    def components(self):
        if (self._components_cache is None
                and self.item_features_embeddings is not None):
            H = unshard(self.item_features_embeddings,
                        self._nif).astype(np.float64)
            if self._identity_item_feats:
                self._components_cache = np.ascontiguousarray(H.T)
            else:
                self._components_cache = np.asarray(
                    (self._item_features @ H).T)
        return self._components_cache

    @components.setter
    def components(self, value):
        self._components_cache = value

    def transform(self, x: sp.spmatrix):
        """Embed known users (by their trained feature embeddings)."""
        if self.user_features_embeddings is None:
            raise RuntimeError("model is not fitted")
        if self._user_features is None or self._identity_user_feats:
            W = self.user_features_embeddings
            if x.shape[0] != self._nuf:
                raise ValueError(
                    f"x has {x.shape[0]} rows but the model was trained "
                    f"with identity features for {self._nuf} users")
            # live table is donated on the next fit call; [:nuf] slices
            # off mesh-padding rows
            return jnp.copy(W[:self._nuf]) if W.shape[0] != self._nuf \
                else jnp.copy(W)
        return self._user_features @ unshard(
            self.user_features_embeddings, self._nuf).astype(np.float64)
