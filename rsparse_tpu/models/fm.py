"""Second-order Factorization Machine.

Re-design of the reference FM (R/model_FactorizationMachine.R:22-182 over
src/factorization_machine.cpp:8-194).  The reference is hogwild per-row
AdaGrad SGD; here rows are bucketed into padded (B, L) blocks and each block
is a deterministic jitted update computed in the feature-grouped scheduled
layout (ops/segsum.py SchedLayout) with accumulator-first AdaGrad factored
per feature (see glove.py for the accumulator-ordering rationale).

Per-sample math matches the reference:
  pred = w0 + sum w_j x_j + 0.5 * sum_f [(sum v_fj x_j)^2 - sum (v_fj x_j)^2]
                                       (factored O(k*nnz) trick, :93-109)
  binomial (y in +-1): dL = (sigmoid(pred*y) - 1) * y       (:138-139)
  gaussian:            dL = 2 * (pred - y)                  (:140-141)
  grad_w_j = clip(x_j dL + 2 lambda_w);  AdaGrad, acc init 1
  grad_v_j = clip(dL x_j (s1 - v_j x_j) + 2 lambda_v v_j);  AdaGrad
Gradients are clipped at +-100 (CLIP_VALUE, src/rsparse.h:19).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp
from jax.sharding import Mesh, PartitionSpec as P

from ..config import resolve_dtype
from ..parallel.sgd_sharded import (
    DirectOps, ShardedOps, mesh_table_axes, replicate_on, shard_table)

CLIP_VALUE = 100.0
_DIRECT = DirectOps()


def _fm_block_impl(ops, w0, acc_w0, w, v, acc_w, acc_v, col_idx, values,
                   y, sample_w, lr_w, lr_v, lam_w, lam_v, layout,
                   family: int, intercept: bool, do_update: bool,
                   rowmajor_pred: bool):
    """One padded row-block of FM predict (+optional update), computed in
    the feature-grouped scheduled layout (ops/segsum.py SchedLayout).

    w: (F+1,), v: (F+1, r) with a padding slot at index F, kept as
    SEPARATE tables (one gather per table; a packed narrow table is not
    measured on the GPU).  Table access goes through ``ops``
    (parallel/sgd_sharded.py): same kernel single-device or row-sharded;
    (w0, acc_w0) are scalars, updated replicated.

    All table reads (w, v and their AdaGrad accumulators) are
    per-FEATURE broadcasts; accumulator-first AdaGrad factors every
    table write into a per-feature sum (``delta_f = -lr * sum(g) /
    sqrt(acc_f + sum(g^2))`` — all occurrences of a feature share the
    freshly-summed accumulator).  Per-position traffic is three
    minibatch-operand permute-gathers: packed prediction contributions
    ``[w_f x, v_f x, (v_f x)^2]`` sched->row, and the per-row ``dL`` /
    ``s1`` row->sched for the gradient.  Per-sample math still matches
    src/factorization_machine.cpp:93-190.
    """
    B, L = values.shape
    r = v.shape[1]
    nb = len(layout.feats_c)
    if nb == 0:
        raw0 = jnp.full((B,), w0, values.dtype)
        yh = jax.nn.sigmoid(raw0) if family == 1 else raw0
        return w0, acc_w0, w, v, acc_w, acc_v, yh

    from ..ops.segsum import (sched_apply_sums_multi, sched_reduce_chunks,
                              sched_to_rows)

    # chunk-level (w, v) reads for the per-position math; level-2
    # accumulator reads for the per-feature factored AdaGrad step
    need_chunk = do_update or not rowmajor_pred
    pairs = []
    if need_chunk:
        pairs += [(w, f) for f in layout.feats_c]
        pairs += [(v, f) for f in layout.feats_c]
    if do_update:
        pairs += [(acc_w, f) for f in layout.feats]
        pairs += [(acc_v, f) for f in layout.feats]
    flat = ops.gather_many(pairs) if pairs else ()
    n2 = len(layout.feats)
    if need_chunk:
        wf, vf = flat[:nb], flat[nb:2 * nb]
    if do_update:
        awf = jnp.concatenate(flat[2 * nb:2 * nb + n2], axis=0)
        avf = jnp.concatenate(flat[2 * nb + n2:], axis=0)

    if rowmajor_pred:
        # small tables are HOT gather operands (291-426M row-fetch/s vs
        # ~64M/s cold, PERF.md): two direct table gathers beat the
        # sched->row permute whose packed flat operand is
        # minibatch-sized and cold (measured 92 of a 138 ms pass)
        wg, vg = ops.gather_many([(w, col_idx), (v, col_idx)])
        vx = vg * values[..., None]                      # (B, L, r)
        s1 = jnp.sum(vx, axis=1)                         # (B, r)
        raw = (w0 + jnp.sum(wg * values, axis=1)
               + 0.5 * (jnp.sum(s1 * s1, axis=1)
                        - jnp.sum(vx * vx, axis=(1, 2))))
    else:
        # packed per-position prediction contributions, built per
        # feature: [..., 0] = w_f x, [..., 1:r+1] = v_f x,
        # [..., r+1:] = (v_f x)^2
        packs = []
        for k in range(nb):
            xk = layout.vals[k]                          # (Ck, Lk)
            cvk = vf[k][:, None, :] * xk[..., None]      # (Ck, Lk, r)
            packs.append(jnp.concatenate(
                [(wf[k][:, None] * xk)[..., None], cvk, cvk * cvk],
                axis=-1))
        c_row = sched_to_rows(packs, layout, B, L)       # (B, L, 2r+1)
        s1 = jnp.sum(c_row[..., 1:r + 1], axis=1)        # (B, r)
        raw = (w0 + jnp.sum(c_row[..., 0], axis=1)
               + 0.5 * (jnp.sum(s1 * s1, axis=1)
                        - jnp.sum(c_row[..., r + 1:], axis=(1, 2))))
    y_hat = jax.nn.sigmoid(raw) if family == 1 else raw

    if not do_update:
        return w0, acc_w0, w, v, acc_w, acc_v, y_hat

    if family == 1:
        dL = (jax.nn.sigmoid(raw * y) - 1.0) * y
    else:
        dL = 2.0 * (raw - y)
    dL = dL * sample_w                                   # (B,)

    if intercept:
        # the reference updates w0 per sample without AdaGrad
        # (src/factorization_machine.cpp:147-149); summed batch steps need
        # an accumulator to stay stable
        acc_w0 = acc_w0 + jnp.sum(dL * dL)
        w0 = w0 - lr_w * jnp.sum(dL) / jnp.sqrt(acc_w0)

    chunks = []
    for k in range(nb):
        xk = layout.vals[k]                              # (Ck, Lk)
        ok = (jax.lax.broadcasted_iota(jnp.int32, xk.shape, 1)
              < layout.nnz[k][:, None])
        dk = dL[layout.rows[k]]                          # (Ck, Lk)
        s1k = s1[layout.rows[k]]                         # (Ck, Lk, r)
        g_w = jnp.clip(xk * dk + 2.0 * lam_w, -CLIP_VALUE, CLIP_VALUE)
        g_w = jnp.where(ok, g_w, 0.0)
        vxk = vf[k][:, None, :] * xk[..., None]
        g_v = (dk[..., None] * xk[..., None] * (s1k - vxk)
               + 2.0 * lam_v * vf[k][:, None, :])
        g_v = jnp.clip(g_v, -CLIP_VALUE, CLIP_VALUE)
        g_v = jnp.where(ok[..., None], g_v, 0.0)
        # per-chunk partials packed [sum g_w, sum g_w^2, sum g_v, sum g_v^2]
        chunks.append(jnp.concatenate(
            [jnp.sum(g_w, axis=1)[:, None],
             jnp.sum(g_w * g_w, axis=1)[:, None],
             jnp.sum(g_v, axis=1), jnp.sum(g_v * g_v, axis=1)], axis=-1))
    red = sched_reduce_chunks(jnp.concatenate(chunks, axis=0), layout)
    sw_sum, sw2 = red[:, 0], red[:, 1]                   # (F2,)
    sv_sum, sv2 = red[:, 2:2 + r], red[:, 2 + r:]        # (F2, r)
    # accumulator-first AdaGrad, factored per feature: every occurrence
    # shares the freshly-summed accumulator
    acc_w, w = sched_apply_sums_multi(
        ops, [(acc_w, sw2),
              (w, -lr_w * sw_sum / jnp.sqrt(awf + sw2))], layout)
    acc_v, v = sched_apply_sums_multi(
        ops, [(acc_v, sv2),
              (v, -lr_v * sv_sum / jnp.sqrt(avf + sv2))], layout)

    return w0, acc_w0, w, v, acc_w, acc_v, y_hat


@partial(jax.jit, static_argnames=("family", "intercept", "do_update",
                                   "rowmajor_pred"),
         donate_argnums=(0, 1, 2, 3, 4, 5))
def _fm_block(w0, acc_w0, w, v, acc_w, acc_v, col_idx, values, y,
              sample_w, lr_w, lr_v, lam_w, lam_v, layout, *,
              family: int, intercept: bool, do_update: bool,
              rowmajor_pred: bool):
    return _fm_block_impl(_DIRECT, w0, acc_w0, w, v, acc_w, acc_v,
                          col_idx, values, y, sample_w, lr_w, lr_v,
                          lam_w, lam_v, layout, family, intercept,
                          do_update, rowmajor_pred)


_SHARDED_FNS: dict = {}


def _sharded_fm_fn(mesh: Mesh, family: int, intercept: bool,
                   do_update: bool, rowmajor_pred: bool):
    key = (mesh, family, intercept, do_update, rowmajor_pred)
    fn = _SHARDED_FNS.get(key)
    if fn is not None:
        return fn
    axes = mesh_table_axes(mesh)
    ops = ShardedOps(axes)
    tab, rep = P(axes), P()

    def body(w0, acc_w0, w, v, acc_w, acc_v, col_idx, values, y,
             sample_w, lr_w, lr_v, lam_w, lam_v, layout):
        return _fm_block_impl(ops, w0, acc_w0, w, v, acc_w, acc_v,
                              col_idx, values, y, sample_w, lr_w,
                              lr_v, lam_w, lam_v, layout, family,
                              intercept, do_update, rowmajor_pred)

    fn = jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(rep, rep, tab, tab, tab, tab) + (rep,) * 9,
        out_specs=(rep, rep, tab, tab, tab, tab, rep), check_vma=False),
        donate_argnums=(0, 1, 2, 3, 4, 5))
    _SHARDED_FNS[key] = fn
    if len(_SHARDED_FNS) > 16:
        _SHARDED_FNS.pop(next(iter(_SHARDED_FNS)))
    return fn


class FactorizationMachine:
    """2nd-order FM, binomial or gaussian."""

    def __init__(
        self,
        learning_rate_w: float = 0.2,
        rank: int = 4,
        lambda_w: float = 0.0,
        lambda_v: float = 0.0,
        family: str = "binomial",
        intercept: bool = True,
        learning_rate_v: Optional[float] = None,
        precision: str = "float32",
        seed: Optional[int] = None,
        mesh: Optional[Mesh] = None,
    ):
        if family not in ("binomial", "gaussian"):
            raise ValueError("family must be 'binomial' or 'gaussian'")
        if not (lambda_w >= 0 and lambda_v >= 0 and learning_rate_w > 0
                and rank >= 1):
            raise ValueError("invalid hyperparameters")
        self.learning_rate_w = float(learning_rate_w)
        self.learning_rate_v = float(learning_rate_v
                                     if learning_rate_v is not None
                                     else learning_rate_w)
        self.rank = int(rank)
        self.lambda_w = float(lambda_w)
        self.lambda_v = float(lambda_v)
        self.family = family
        self.family_code = 1 if family == "binomial" else 2
        self.intercept = bool(intercept)
        self.precision = precision
        self.dtype = resolve_dtype(precision)
        self._rng = np.random.default_rng(seed)
        self.n_features: Optional[int] = None
        #: device mesh: when set, (w, v) and their AdaGrad accumulators are
        #: row-sharded over the mesh's data axes — BASELINE config #5's
        #: "factor tables row-sharded" requirement; replaces the
        #: reference's hogwild shared tables
        #: (src/factorization_machine.cpp:124-127).
        self.mesh = mesh

    def _ensure_state(self, n_features: int):
        if self.n_features is None:
            self.n_features = n_features
            # v init N(0, 0.001) like fill_float_matrix_randn
            # (src/factorization_machine.cpp:219-223)
            self.w0 = jnp.zeros((), self.dtype)
            self.acc_w0 = jnp.ones((), self.dtype)
            self.w = jnp.zeros((n_features + 1,), self.dtype)
            self.v = jnp.asarray(
                self._rng.standard_normal((n_features + 1, self.rank))
                * 0.001, self.dtype)
            self.acc_w = jnp.ones((n_features + 1,), self.dtype)
            self.acc_v = jnp.ones((n_features + 1, self.rank), self.dtype)
            if self.mesh is not None:
                self.w0, self.acc_w0 = replicate_on(
                    self.mesh, (self.w0, self.acc_w0))
                self.w = shard_table(self.w, self.mesh)
                self.v = shard_table(self.v, self.mesh)
                self.acc_w = shard_table(self.acc_w, self.mesh)
                self.acc_v = shard_table(self.acc_v, self.mesh)
        elif n_features != self.n_features:
            raise ValueError("feature count mismatch with fitted model")

    def _stage(self, x, y, weights, do_update: bool):
        """One-time content-cached staging per fit() (see FTRL._stage —
        per-pass fingerprint scans cost ~25 ms at bench scale)."""
        csr = sp.csr_matrix(x)
        if np.isnan(csr.data).any():
            raise ValueError("NA's in input matrix are not allowed")
        self._ensure_state(csr.shape[1])
        n_rows = csr.shape[0]
        if do_update:
            y = np.asarray(y, np.float64)
            if np.isnan(y).any():
                raise ValueError("NA's in y are not allowed")
            if len(y) != n_rows:
                raise ValueError("nrow(x) must equal length(y)")
            if self.family == "binomial":
                # convert {0,1} -> {-1,1} (reference
                # R/model_FactorizationMachine.R:99-101)
                y = np.where(y == 1, 1.0, -1.0)
        else:
            y = np.zeros(n_rows)
        weights = (np.ones(n_rows) if weights is None
                   else np.asarray(weights, np.float64))

        from ..ops.segsum import staged_label_gathers
        from .ftrl import _staged_blocks
        br, layouts = _staged_blocks(csr, self.dtype,
                                     self.n_features, self.mesh)
        # zero sample weight on batch-padding rows: dL carries sample_w,
        # so this kills their (otherwise unmasked) intercept/accumulator
        # contributions — the reference updates w0 once per REAL sample
        # (src/factorization_machine.cpp:147-149)
        labels = staged_label_gathers("fm_y", csr, y, weights, br,
                                      self.dtype, self.mesh,
                                      zero_pad_weight=True)
        return n_rows, br, layouts, labels

    def _run_staged(self, staged, do_update=False, materialize=True):
        n_rows, br, layouts, labels = staged
        # row-major prediction gathers while the (w, v) tables are small
        # (32 MB threshold carried over, not tuned on the H100)
        rowmajor = ((self.n_features + 1) * (self.rank + 1) * 4
                    < (1 << 25))
        if self.mesh is not None:
            step = _sharded_fm_fn(self.mesh, self.family_code,
                                  self.intercept, do_update, rowmajor)
        else:
            step = partial(_fm_block, family=self.family_code,
                           intercept=self.intercept, do_update=do_update,
                           rowmajor_pred=rowmajor)
        outs = []  # defer device->host reads so dispatches pipeline
        for b, lay, (y_b, w_b) in zip(br.buckets, layouts, labels):
            (self.w0, self.acc_w0, self.w, self.v, self.acc_w, self.acc_v,
             yh) = step(
                self.w0, self.acc_w0, self.w, self.v, self.acc_w,
                self.acc_v, b.col_idx, b.values, y_b, w_b,
                self.learning_rate_w, self.learning_rate_v,
                self.lambda_w, self.lambda_v, lay)
            outs.append((b.row_ids, yh))
        if not materialize:
            # mid-fit pass: predictions discarded by the caller; skip the
            # device->host transfer
            return None
        y_hat = np.empty(n_rows, np.float64)
        for row_ids, yh in outs:
            rows = np.asarray(row_ids)
            keep = rows < n_rows
            y_hat[rows[keep]] = np.asarray(yh, np.float64)[keep]
        return y_hat

    def _run(self, x, y=None, weights=None, do_update=False,
             materialize=True):
        return self._run_staged(self._stage(x, y, weights, do_update),
                                do_update=do_update,
                                materialize=materialize)

    def partial_fit(self, x, y, weights=None) -> np.ndarray:
        return self._run(x, y, weights, do_update=True)

    def fit(self, x, y, weights=None, n_iter: int = 1) -> np.ndarray:
        if n_iter < 1:
            raise ValueError("n_iter must be >= 1")
        staged = self._stage(x, y, weights, do_update=True)
        for i in range(n_iter):
            # only the final pass's predictions are materialized
            out = self._run_staged(staged, do_update=True,
                                   materialize=(i == n_iter - 1))
        return out

    def predict(self, x) -> np.ndarray:
        if self.n_features is None:
            raise RuntimeError("model is not fitted")
        return self._run(x, do_update=False)
