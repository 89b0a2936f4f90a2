"""GloVe: Global Vectors embeddings.

Re-design of the reference GloVe (R/model_GloVe.R:13-183 over
src/GloVe.cpp:5-158).  The reference runs hogwild AdaGrad SGD over raw COO
triplets with racy shared-parameter updates (src/GloVe.cpp:91-156).  This
version is *deterministic minibatched* SGD: the co-occurrence
triplets are padded into fixed-size COO shards, an epoch is one jitted
``lax.scan`` over shards, and per-shard updates are segment scatter-adds
(duplicate indices within a shard accumulate instead of racing).

Update math matches the reference exactly per triplet:
  weight = min((x/x_max)^alpha, 1)                 (src/GloVe.cpp:46-51)
  cost_inner = clip(w_i.w_j + b_i + b_j - log x, +-100)   (:113-120)
  cost = weight * cost_inner; AdaGrad with squared-grad accumulators
  initialized to ones (:38-42); epoch loss = 0.5 * sum cost*cost_inner.
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
    DirectOps, ShardedOps, mesh_table_axes, padded_rows, replicate_on,
    shard_table, unshard)

CLIP_VALUE = 100.0  # reference src/rsparse.h:19

_DIRECT = DirectOps()


class GloveState(NamedTuple):
    w_i: jax.Array       # (n, r) main embeddings
    w_j: jax.Array       # (n, r) context embeddings
    b_i: jax.Array       # (n,)
    b_j: jax.Array       # (n,)
    acc_w_i: jax.Array   # squared-grad accumulators (init ones)
    acc_w_j: jax.Array
    acc_b_i: jax.Array
    acc_b_j: jax.Array


def _glove_epoch_impl(ops, state: GloveState, rows, cols, vals, valid,
                      x_max: float, alpha: float, lr: float):
    """One epoch over stacked COO shards: scan of minibatch AdaGrad steps.

    rows/cols: (n_shards, N) int32; vals/valid: (n_shards, N).  All table
    reads/writes go through ``ops`` (parallel/sgd_sharded.py), so the same
    kernel runs single-device and with row-sharded tables under shard_map.
    """

    def step(st: GloveState, shard):
        r, c, v, m = shard
        wi, wj, bi, bj = ops.gather_many(
            [(st.w_i, r), (st.w_j, c), (st.b_i, r), (st.b_j, c)])
        logv = jnp.log(jnp.where(m, v, 1.0))
        weight = jnp.where(v < x_max, jnp.power(v / x_max, alpha), 1.0)
        cost_inner = jnp.sum(wi * wj, axis=1) + bi + bj - logv
        cost_inner = jnp.clip(cost_inner, -CLIP_VALUE, CLIP_VALUE)
        cost = jnp.where(m, weight * cost_inner, 0.0)
        loss = jnp.sum(cost * cost_inner)

        g_wi = cost[:, None] * wj
        g_wj = cost[:, None] * wi

        # Accumulator-first AdaGrad: fold this shard's squared grads into the
        # accumulators *before* scaling.  The reference's per-sample loop
        # scales by the accumulator EXCLUDING the current sample's g^2 and
        # folds it in after (src/GloVe.cpp:134-146); accumulator-first adds
        # the current g^2 to the denominator, a deliberate deviation (each
        # step is slightly more conservative, and bounded by the same-batch
        # duplicate handling: high-degree nodes would otherwise sum many
        # full-size steps against a stale accumulator).  The batch-size-1
        # deviation from the reference ordering is bounded by the per-sample
        # replica test (tests/test_reference_replica.py).
        acc_w_i = ops.scatter_add(st.acc_w_i, r, g_wi * g_wi)
        acc_w_j = ops.scatter_add(st.acc_w_j, c, g_wj * g_wj)
        acc_b_i = ops.scatter_add(st.acc_b_i, r, cost * cost)
        acc_b_j = ops.scatter_add(st.acc_b_j, c, cost * cost)
        awi, awj, abi, abj = ops.gather_many(
            [(acc_w_i, r), (acc_w_j, c), (acc_b_i, r), (acc_b_j, c)])
        w_i = ops.scatter_add(st.w_i, r, -lr * g_wi / jnp.sqrt(awi))
        w_j = ops.scatter_add(st.w_j, c, -lr * g_wj / jnp.sqrt(awj))
        b_i = ops.scatter_add(st.b_i, r, -lr * cost / jnp.sqrt(abi))
        b_j = ops.scatter_add(st.b_j, c, -lr * cost / jnp.sqrt(abj))

        return GloveState(w_i, w_j, b_i, b_j, acc_w_i, acc_w_j,
                          acc_b_i, acc_b_j), loss

    state, losses = jax.lax.scan(step, state, (rows, cols, vals, valid))
    return state, 0.5 * jnp.sum(losses)


@partial(jax.jit, static_argnames=("x_max", "alpha", "lr"),
         donate_argnums=(0,))
def _glove_epoch(state: GloveState, rows, cols, vals, valid,
                 x_max: float, alpha: float, lr: float):
    return _glove_epoch_impl(_DIRECT, state, rows, cols, vals, valid,
                             x_max, alpha, lr)


def _glove_epoch_sched_impl(ops, state: GloveState, rows, cols, vals,
                            valid, sched_r, sched_c, x_max: float,
                            alpha: float, lr: float):
    """Scheduled (scatter-free) epoch over stacked COO shards.

    Replaces the 8 scatter-adds + 4 accumulator re-gathers per shard of
    :func:`_glove_epoch_impl` (measured 103 + 36 of a 187 ms tail,
    PERF.md round 4) with per-feature sums: because accumulator-first
    AdaGrad gives every occurrence of a feature the same freshly-summed
    accumulator, each side's whole update factors per feature into
    ``delta_f = -lr * sum(g) / sqrt(acc_f + sum(g^2))``, applied as a
    dense table add (ops/segsum.py).  Per-position traffic beyond the
    4 embedding/bias gathers is ONE (r+1)-wide permute-gather per side
    (packed ``[g_w, g_b]``).  Update math is identical to the scatter
    path modulo f32 summation order (parity-tested).

    ``sched_r``/``sched_c`` (ops/segsum.py StackedSchedule) carry one
    schedule per scanned shard; valid for fixed shard contents only —
    the within-shard triplet order is irrelevant (per-shard updates are
    feature sums either way), so device shuffles must permute shard
    order, not the flat nnz axis.
    """
    from ..ops.segsum import sched_apply_sums_multi, sched_reduce_chunks

    def side(cost, g, sched, t_w, t_b, t_acc_w, t_acc_b):
        # TILE DISCIPLINE: g stays (N, r) — r is a multiple of the
        # 128-lane tile in the bench regime, and a single concatenated
        # (N, r+1) operand physically pads to the next whole tile,
        # doubling every gather's row traffic (measured +50 ms/epoch).
        # Bias grads travel separately as scalar gathers (width-1 rows
        # fetch at full row rate, PERF.md round-4 matrix).  Sentinel
        # positions use OOB-fill gathers instead of a zero-row concat.
        r = g.shape[1]
        pairs = []
        for f in sched.feats:
            pairs += [(t_acc_w, f), (t_acc_b, f)]
        fl = ops.gather_many(pairs)
        aw = jnp.concatenate(fl[0::2], axis=0)               # (F_tot, r)
        ab = jnp.concatenate(fl[1::2], axis=0)               # (F_tot,)
        wchunks, bchunks = [], []
        for pk in sched.pos:
            Gk = jnp.take(g, pk, axis=0, mode="fill",
                          fill_value=0)                      # (Ck, Lk, r)
            ck = jnp.take(cost, pk, mode="fill", fill_value=0)
            wchunks.append(jnp.concatenate(
                [jnp.sum(Gk, axis=1), jnp.sum(Gk * Gk, axis=1)], axis=-1))
            bchunks.append(jnp.stack(
                [jnp.sum(ck, axis=1), jnp.sum(ck * ck, axis=1)], axis=-1))
        wred = sched_reduce_chunks(jnp.concatenate(wchunks, axis=0),
                                   sched)                    # (F_tot, 2r)
        bred = sched_reduce_chunks(jnp.concatenate(bchunks, axis=0),
                                   sched)                    # (F_tot, 2)
        s1w, s2w = wred[:, :r], wred[:, r:]
        s1b, s2b = bred[:, 0], bred[:, 1]
        t_acc_w, t_w = sched_apply_sums_multi(
            ops, [(t_acc_w, s2w),
                  (t_w, -lr * s1w / jnp.sqrt(aw + s2w))], sched)
        t_acc_b, t_b = sched_apply_sums_multi(
            ops, [(t_acc_b, s2b),
                  (t_b, -lr * s1b / jnp.sqrt(ab + s2b))], sched)
        return t_w, t_b, t_acc_w, t_acc_b

    def step(st: GloveState, shard):
        r, c, v, m, sr, sc = shard
        wi, wj, bi, bj = ops.gather_many(
            [(st.w_i, r), (st.w_j, c), (st.b_i, r), (st.b_j, c)])
        logv = jnp.log(jnp.where(m, v, 1.0))
        weight = jnp.where(v < x_max, jnp.power(v / x_max, alpha), 1.0)
        cost_inner = jnp.sum(wi * wj, axis=1) + bi + bj - logv
        cost_inner = jnp.clip(cost_inner, -CLIP_VALUE, CLIP_VALUE)
        cost = jnp.where(m, weight * cost_inner, 0.0)
        loss = jnp.sum(cost * cost_inner)

        w_i, b_i, acc_w_i, acc_b_i = side(
            cost, cost[:, None] * wj, sr,
            st.w_i, st.b_i, st.acc_w_i, st.acc_b_i)
        w_j, b_j, acc_w_j, acc_b_j = side(
            cost, cost[:, None] * wi, sc,
            st.w_j, st.b_j, st.acc_w_j, st.acc_b_j)
        return GloveState(w_i, w_j, b_i, b_j, acc_w_i, acc_w_j,
                          acc_b_i, acc_b_j), loss

    state, losses = jax.lax.scan(
        step, state, (rows, cols, vals, valid, sched_r, sched_c))
    return state, 0.5 * jnp.sum(losses)


@partial(jax.jit, static_argnames=("x_max", "alpha", "lr"),
         donate_argnums=(0,))
def _glove_epoch_sched(state: GloveState, rows, cols, vals, valid,
                       sched_r, sched_c, x_max: float, alpha: float,
                       lr: float):
    return _glove_epoch_sched_impl(_DIRECT, state, rows, cols, vals,
                                   valid, sched_r, sched_c, x_max,
                                   alpha, lr)


def _glove_dense_step_impl(ops, state: GloveState, rows, cols, xgrid,
                           x_max: float, alpha: float, lr: float,
                           compute_dtype=None):
    """Minibatched pass over the dense head-head co-occurrence block.

    Both triplet axes are zipf-distributed, so the (H, H) block of the
    hottest tokens holds ~half the nnz; processing it as dense matmuls
    costs ~0 vs. per-triplet gathers/scatter-adds.  The block is scanned in
    **2-D tiles** with parameter updates between tiles: tiling both axes
    bounds how many triplets of any one row *and* any one column aggregate
    into a single AdaGrad step, matching the online granularity of the
    sparse shard path (row-only chunking aggregates a hot row's entire
    context set into one step and oscillates at the reference's default
    learning rates).  Each tile is semantically exactly one shard of
    :func:`_glove_epoch` containing that tile's head-head triplets:
    ``weight`` is 0 at absent cells, and the AdaGrad accumulator terms use
    per-triplet squared grads (``cost^2 @ wj^2``), the scatter-add form.

    rows: (T, Cr) vocab ids; cols: (T, Cc) vocab ids (padding entries
    carry all-zero X -> no-op updates); xgrid: (T, Cr, Cc) raw counts
    (0 = absent) — log/weight computed on the fly (the dense step is
    grid-bandwidth-bound, so one grid beats two precomputed ones).

    ``compute_dtype="bfloat16"``: the five (Cr, Cc)-sized matmuls run
    with bf16 operands and f32 accumulation, and the cost/weight grids
    stay bf16 (the step is grid-bandwidth-bound; state, biases, AdaGrad
    accumulators and the loss stay full precision).
    """
    cdt = state.w_i.dtype if compute_dtype is None else jnp.dtype(
        compute_dtype)
    acc = state.w_i.dtype

    def tile(st: GloveState, slab):
        r, c, x = slab
        present = x > 0
        xf = x.astype(acc)
        lx = jnp.log(jnp.where(present, xf, 1.0))
        w = jnp.where(xf < x_max, jnp.power(xf / x_max, alpha), 1.0)
        w = jnp.where(present, w, 0.0)
        wi, wj, bi, bj = ops.gather_many(
            [(st.w_i, r), (st.w_j, c), (st.b_i, r), (st.b_j, c)])
        wi_c, wj_c = wi.astype(cdt), wj.astype(cdt)
        s = (jnp.dot(wi_c, wj_c.T, preferred_element_type=acc)
             + bi[:, None] + bj[None, :] - lx)
        s = jnp.clip(s, -CLIP_VALUE, CLIP_VALUE)
        # cost/weight grids live at the compute dtype (the step is
        # grid-bandwidth-bound); every reduction accumulates at ``acc``
        s_c = s.astype(cdt)
        cost_c = w.astype(cdt) * s_c     # weight == 0 -> absent cell
        loss = jnp.sum(cost_c.astype(acc) * s)
        c2_c = cost_c * cost_c

        acc_w_i = ops.scatter_add(
            st.acc_w_i, r,
            jnp.dot(c2_c, wj_c * wj_c, preferred_element_type=acc))
        acc_w_j = ops.scatter_add(
            st.acc_w_j, c,
            jnp.dot(c2_c.T, wi_c * wi_c, preferred_element_type=acc))
        acc_b_i = ops.scatter_add(st.acc_b_i, r,
                                  jnp.sum(c2_c, axis=1, dtype=acc))
        acc_b_j = ops.scatter_add(st.acc_b_j, c,
                                  jnp.sum(c2_c, axis=0, dtype=acc))
        awi, awj, abi, abj = ops.gather_many(
            [(acc_w_i, r), (acc_w_j, c), (acc_b_i, r), (acc_b_j, c)])
        w_i = ops.scatter_add(
            st.w_i, r,
            -lr * jnp.dot(cost_c, wj_c, preferred_element_type=acc)
            / jnp.sqrt(awi))
        w_j = ops.scatter_add(
            st.w_j, c,
            -lr * jnp.dot(cost_c.T, wi_c, preferred_element_type=acc)
            / jnp.sqrt(awj))
        b_i = ops.scatter_add(
            st.b_i, r,
            -lr * jnp.sum(cost_c, axis=1, dtype=acc) / jnp.sqrt(abi))
        b_j = ops.scatter_add(
            st.b_j, c,
            -lr * jnp.sum(cost_c, axis=0, dtype=acc) / jnp.sqrt(abj))
        return GloveState(w_i, w_j, b_i, b_j, acc_w_i, acc_w_j,
                          acc_b_i, acc_b_j), loss

    state, losses = jax.lax.scan(tile, state, (rows, cols, xgrid))
    # 0.5 * matches the _glove_epoch loss convention (reference
    # src/GloVe.cpp:156: global_cost += 0.5 * weight * cost_inner^2)
    return state, 0.5 * jnp.sum(losses)


@partial(jax.jit, static_argnames=("x_max", "alpha", "lr",
                                   "compute_dtype"),
         donate_argnums=(0,))
def _glove_dense_step(state: GloveState, rows, cols, xgrid,
                      x_max: float, alpha: float, lr: float,
                      compute_dtype=None):
    return _glove_dense_step_impl(_DIRECT, state, rows, cols, xgrid,
                                  x_max, alpha, lr, compute_dtype)


# Compiled-callable cache for the sharded epoch/dense-step programs (the
# alx.py pattern: a fresh shard_map closure per call would retrace).
_SHARDED_FNS: dict = {}


def _sharded_glove_fn(mesh: Mesh, which: str, x_max: float, alpha: float,
                      lr: float, compute_dtype=None):
    key = (mesh, which, x_max, alpha, lr, compute_dtype)
    fn = _SHARDED_FNS.get(key)
    if fn is not None:
        return fn
    axes = mesh_table_axes(mesh)
    ops = ShardedOps(axes)
    st_spec = GloveState(*([P(axes)] * 8))
    rep = P()
    impl = {"epoch": _glove_epoch_impl,
            "epoch_sched": _glove_epoch_sched_impl,
            "dense": _glove_dense_step_impl}[which]
    n_data = {"epoch": 4, "epoch_sched": 6, "dense": 3}[which]
    extra = {} if which != "dense" else {"compute_dtype": compute_dtype}

    def body(state, *data):
        return impl(ops, state, *data, x_max=x_max, alpha=alpha, lr=lr,
                    **extra)

    fn = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(st_spec,) + (rep,) * n_data,
        out_specs=(st_spec, rep), check_vma=False), donate_argnums=(0,))
    _SHARDED_FNS[key] = fn
    if len(_SHARDED_FNS) > 16:
        _SHARDED_FNS.pop(next(iter(_SHARDED_FNS)))
    return fn


def _split_head(coo: sp.coo_matrix, n_hot: int, dtype=jnp.float32):
    """Split triplets into a dense (H, H) head block + remainder COO.

    Hot tokens are chosen by total (row + col) occurrence count.  Returns
    ``(hot_ids, X_hh, remainder_coo)``, shrinking the head until the block
    is dense enough to pay for itself, or ``(None, None, coo)``."""
    n = coo.shape[0]
    n_hot = int(min(n_hot, n))
    if n_hot < 16 or coo.nnz == 0:
        return None, None, coo
    counts = (np.bincount(coo.row, minlength=n)
              + np.bincount(coo.col, minlength=n))
    by_count = np.argsort(-counts, kind="stable").astype(np.int32)
    pos = np.full((n,), -1, np.int32)
    # break-even density: a dense cell costs matmuls + one grid read, a
    # sparse triplet gathers + scatter-adds; the 0.4% density rule below
    # is carried over from an earlier chip and not tuned on the H100.
    # Shrink the head until dense enough (zipf density grows as H shrinks).
    in_head = None
    while n_hot >= 16:
        hot_ids = np.sort(by_count[:n_hot])
        pos[:] = -1
        pos[hot_ids] = np.arange(n_hot, dtype=np.int32)
        in_head = (pos[coo.row] >= 0) & (pos[coo.col] >= 0)
        if int(in_head.sum()) >= 0.004 * n_hot * n_hot:
            break
        n_hot //= 2
    if n_hot < 16:
        return None, None, coo
    # build the grid directly at the device dtype: a float64 intermediate
    # at head scale is ~4.3 GB of host RSS (23170^2 x 8 B) on top of the
    # budgeted f32 grid
    np_dt = np.float64 if jnp.dtype(dtype) == jnp.float64 else np.float32
    X = np.zeros((n_hot, n_hot), np_dt)
    # duplicate (i, j) triplets accumulate, matching coo.sum_duplicates()
    np.add.at(X, (pos[coo.row[in_head]], pos[coo.col[in_head]]),
              coo.data[in_head])
    rem = sp.coo_matrix(
        (coo.data[~in_head], (coo.row[~in_head], coo.col[~in_head])),
        shape=coo.shape)
    return hot_ids, X, rem


def _head_grids(X: np.ndarray, hot_ids: np.ndarray, dtype,
                batch_size: int):
    """2-D tiled (rows, cols, X) slabs for the dense head block.

    Square tiles are sized so each carries roughly ``batch_size`` nnz —
    the same minibatch granularity as the sparse shards along *both*
    axes; padding entries repeat ``hot_ids[0]`` with all-zero counts
    (no-op updates)."""
    H = X.shape[0]
    nnz_hh = max(int((X > 0).sum()), 1)
    density = nnz_hh / float(H * H)
    side = int(np.clip(np.sqrt(batch_size / density), 128, H))
    nt = -(-H // side)
    Hp = nt * side
    np_dt = np.float64 if jnp.dtype(dtype) == jnp.float64 else np.float32
    xg = np.zeros((Hp, Hp), np_dt)
    xg[:H, :H] = X
    ids = np.full((Hp,), hot_ids[0], np.int32)
    ids[:H] = hot_ids
    # tile (ti, tj) -> slab index ti * nt + tj
    rows = np.repeat(ids.reshape(nt, side), nt, axis=0)       # (nt*nt, side)
    cols = np.tile(ids.reshape(nt, side), (nt, 1))            # (nt*nt, side)
    xt = (xg.reshape(nt, side, nt, side).transpose(0, 2, 1, 3)
          .reshape(nt * nt, side, side))
    return (jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(xt, dtype))


def _stack_coo_host(coo: sp.coo_matrix, batch_size: int,
                    swap: bool = False):
    """Stack COO triplets into (n_shards, batch_size) shards,
    STRIDE-INTERLEAVED: triplet ``t`` lands in shard ``t % n_shards``.

    COO input is usually sorted by (row, col), so contiguous slicing
    would give every shard a narrow row range — minibatches of heavily
    correlated triplets, and (worse for the scheduled epoch) wildly
    different per-shard feature-occurrence profiles, which pad the
    shared-grid schedules to the cross-shard max (a measured 3x slot
    amplification at bench scale, PERF.md round 5).  Interleaving gives
    every shard the same zipf profile."""
    n = coo.nnz
    nb = -(-n // batch_size)
    pad = nb * batch_size - n
    r = np.concatenate([coo.row, np.zeros(pad, coo.row.dtype)])
    c = np.concatenate([coo.col, np.zeros(pad, coo.col.dtype)])
    v = np.concatenate([coo.data, np.ones(pad)])
    m = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    if swap:
        r, c = c, r
    stack = lambda a: np.ascontiguousarray(  # noqa: E731
        a.reshape(batch_size, nb).T)
    return (stack(r).astype(np.int32), stack(c).astype(np.int32),
            stack(v), stack(m))


def _stack_coo(coo: sp.coo_matrix, batch_size: int, dtype,
               swap: bool = False):
    r, c, v, m = _stack_coo_host(coo, batch_size, swap)
    return (jnp.asarray(r), jnp.asarray(c),
            jnp.asarray(v, dtype), jnp.asarray(m))


@jax.jit
def _shuffle_shards(rows, cols, vals, valid, key):
    """Permute staged COO shards on device (one gather over the flat nnz
    axis); padding entries travel with their valid-mask bits."""
    shp = rows.shape
    n = rows.size
    perm = jax.random.permutation(key, n)

    def f(a):
        return a.reshape(n)[perm].reshape(shp)

    return f(rows), f(cols), f(vals), f(valid)


class GloVe:
    """GloVe model (mlapi-style fit_transform)."""

    def __init__(
        self,
        rank: int,
        x_max: float,
        learning_rate: float = 0.15,
        alpha: float = 0.75,
        lambda_: float = 0.0,
        shuffle: bool = False,
        init: Optional[dict] = None,
        batch_size: int = 8192,
        precision: str = "float32",
        seed: Optional[int] = None,
        n_hot="auto",
        mesh: Optional[Mesh] = None,
        compute_dtype: Optional[str] = None,
    ):
        self.rank = int(rank)
        #: dense-head matmul/grid dtype ("bfloat16" halves the
        #: grid-bandwidth-bound head step; state, biases, accumulators
        #: and the loss stay at ``precision``)
        self.compute_dtype = compute_dtype
        #: device mesh: when set, the 8 state tables (embeddings, biases,
        #: AdaGrad accumulators) are ROW-SHARDED over the mesh's data axes
        #: — the device-mesh replacement for the reference's shared-memory
        #: hogwild table (src/GloVe.cpp:91-94); staged COO shards are
        #: replicated (streamed read-only data).  See
        #: parallel/sgd_sharded.py for the design.
        self.mesh = mesh
        self.x_max = float(x_max)
        self.learning_rate = float(learning_rate)
        self.alpha = float(alpha)
        self.lambda_ = float(lambda_)  # reserved, as in the reference
        self.shuffle = shuffle
        self.batch_size = int(batch_size)
        #: dense head-head block size (0 disables, "auto" sizes by memory
        #: budget): the hottest tokens' co-occurrence sub-matrix is
        #: processed as dense matmuls
        self.n_hot = n_hot
        self.dtype = resolve_dtype(precision)
        self._rng = np.random.default_rng(seed)
        self._init = init or {}
        self.components = None   # (rank, n) context embeddings w_j
        self.bias_i = None
        self.bias_j = None
        self.cost_history = []

    def fit_transform(self, x: sp.spmatrix, n_iter: int = 10,
                      convergence_tol: float = -1.0) -> jax.Array:
        coo = sp.coo_matrix(x)
        if coo.shape[0] != coo.shape[1]:
            raise ValueError("input co-occurrence matrix must be square")
        if coo.nnz and coo.data.min() <= 0:
            raise ValueError("all co-occurrence values must be > 0")
        n = coo.shape[0]
        k = self.rank

        # triangular co-occurrence => also fit on the transposed triplets
        # (reference R/model_GloVe.R:80,133-136)
        triu = bool((coo.row <= coo.col).all())
        tril = bool((coo.row >= coo.col).all())
        is_triangular = (triu or tril) and n > 1

        def initm(name, shape):
            v = self._init.get(name)
            if v is not None:
                v = np.asarray(v)
                want = tuple(reversed(shape)) if len(shape) == 2 else shape
                if v.shape == want and len(shape) == 2:
                    v = v.T  # accept reference-layout (rank, n) matrices
                if v.shape != shape:
                    raise ValueError(f"init {name} has wrong shape")
                return jnp.asarray(v, self.dtype)
            return jnp.asarray(
                self._rng.uniform(-0.5, 0.5, shape), self.dtype)

        state = GloveState(
            w_i=initm("w_i", (n, k)), w_j=initm("w_j", (n, k)),
            b_i=initm("b_i", (n,)), b_j=initm("b_j", (n,)),
            acc_w_i=jnp.ones((n, k), self.dtype),
            acc_w_j=jnp.ones((n, k), self.dtype),
            acc_b_i=jnp.ones((n,), self.dtype),
            acc_b_j=jnp.ones((n,), self.dtype),
        )
        if self.mesh is not None:
            # row-shard the state tables over the mesh (vocab axis padded
            # to the axis size; pad rows are never gathered/scattered)
            state = GloveState(*(shard_table(a, self.mesh) for a in state))
            epoch_fn = _sharded_glove_fn(
                self.mesh, "epoch", self.x_max, self.alpha,
                self.learning_rate)
            epoch_sched_fn = _sharded_glove_fn(
                self.mesh, "epoch_sched", self.x_max, self.alpha,
                self.learning_rate)
            dense_fn = _sharded_glove_fn(
                self.mesh, "dense", self.x_max, self.alpha,
                self.learning_rate, self.compute_dtype)
        else:
            epoch_fn = partial(_glove_epoch, x_max=self.x_max,
                               alpha=self.alpha, lr=self.learning_rate)
            epoch_sched_fn = partial(
                _glove_epoch_sched, x_max=self.x_max,
                alpha=self.alpha, lr=self.learning_rate)
            dense_fn = partial(_glove_dense_step, x_max=self.x_max,
                               alpha=self.alpha, lr=self.learning_rate,
                               compute_dtype=self.compute_dtype)

        nnz = max(coo.nnz, 1)
        self.cost_history = []
        n_hot = self.n_hot
        if n_hot == "auto":
            # memory budget for the raw-count grid(s): ~2 GB of f32 cells,
            # split across the transposed copy for triangular inputs
            cells = (1 << 29) // (2 if is_triangular else 1)
            n_hot = int(min(n, np.sqrt(cells)))
        hot_ids, X_hh, rem = _split_head(coo, int(n_hot), self.dtype)
        grids = None
        # the raw-count grid is staged at the compute dtype (bf16 halves
        # the dominant grid read); log/weight upcast on the fly
        gdt = (self.dtype if self.compute_dtype is None
               else resolve_dtype(self.compute_dtype))
        if hot_ids is not None:
            grids = _head_grids(X_hh, hot_ids, gdt, self.batch_size)
            grids_t = (_head_grids(X_hh.T, hot_ids, gdt,
                                   self.batch_size)
                       if is_triangular else None)
            logger.info("glove head block: %d tokens, %d/%d nnz dense",
                        len(hot_ids), coo.nnz - rem.nnz, coo.nnz)
        r_np, c_np, v_np, m_np = _stack_coo_host(rem, self.batch_size)
        shards = (jnp.asarray(r_np), jnp.asarray(c_np),
                  jnp.asarray(v_np, self.dtype), jnp.asarray(m_np))
        shards_t = ((shards[1], shards[0], shards[2], shards[3])
                    if is_triangular else None)
        # scheduled (scatter-free) tail epochs: valid whenever the shard
        # contents are fixed — i.e. shuffle=False (the device shuffle
        # permutes the flat nnz axis and would invalidate the schedules)
        sched_r = sched_c = None
        if not self.shuffle and rem.nnz > 0:
            from ..ops.segsum import build_stacked_col_schedule
            table_rows = (padded_rows(n, self.mesh)
                          if self.mesh is not None else n)
            sched_r = build_stacked_col_schedule(r_np, m_np, table_rows)
            sched_c = build_stacked_col_schedule(c_np, m_np, table_rows)
        if self.mesh is not None:
            shards = replicate_on(self.mesh, shards)
            shards_t = (replicate_on(self.mesh, shards_t)
                        if shards_t is not None else None)
            if sched_r is not None:
                sched_r, sched_c = replicate_on(self.mesh,
                                                (sched_r, sched_c))
            grids = (replicate_on(self.mesh, grids)
                     if grids is not None else None)
            if hot_ids is not None and is_triangular:
                grids_t = replicate_on(self.mesh, grids_t)
        for it in range(n_iter):
            if self.shuffle:
                # device-side permutation: the staged shards never leave the
                # device (host restaging cost ~16 B/nnz/epoch over the
                # host->device link); the swapped (triangular) pass reuses
                # the same permutation with roles exchanged, matching the
                # reference's shared shuffle order (R/model_GloVe.R:126-136)
                key = jax.random.PRNGKey(int(self._rng.integers(2 ** 31)))
                shards = _shuffle_shards(*shards, key)
                if is_triangular:
                    shards_t = (shards[1], shards[0], shards[2], shards[3])
            cost = 0.0
            if grids is not None:
                state, ch = dense_fn(state, *grids)
                cost += float(ch)
            if sched_r is not None:
                state, ce = epoch_sched_fn(state, *shards, sched_r,
                                           sched_c)
            else:
                state, ce = epoch_fn(state, *shards)
            cost += float(ce)
            if is_triangular:
                if grids is not None:
                    state, ch2 = dense_fn(state, *grids_t)
                    cost += float(ch2)
                if sched_r is not None:
                    # swapped pass: roles exchange, so the row-side
                    # schedule is the forward pass's column-side one
                    state, cost2 = epoch_sched_fn(state, *shards_t,
                                                  sched_c, sched_r)
                else:
                    state, cost2 = epoch_fn(state, *shards_t)
                cost += float(cost2)
            if np.isnan(cost):
                raise FloatingPointError(
                    "Cost becomes NaN, try a smaller learning_rate.")
            if cost / nnz > 1:
                raise FloatingPointError(
                    "Cost is too big, probably something is wrong... "
                    "try a smaller learning rate")
            self.cost_history.append(cost / nnz)
            logger.info("epoch %d, loss %.4f", it + 1, self.cost_history[-1])
            if (it > 0 and self.cost_history[-2] / self.cost_history[-1] - 1
                    < convergence_tol):
                logger.info("early stopping at epoch %d", it + 1)
                break

        # unshard() slices off mesh-padding vocab rows (no-op without mesh)
        self.components = unshard(state.w_j, n).T   # (rank, n), like w_j
        self.bias_i = unshard(state.b_i, n)
        self.bias_j = unshard(state.b_j, n)
        self._state = state
        return state.w_i[:n] if state.w_i.shape[0] != n else state.w_i

    def get_history(self):
        return {"cost_history": list(self.cost_history)}
