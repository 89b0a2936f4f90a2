"""FTRL-proximal elastic-net generalized linear model.

Re-design of the reference FTRL (R/model_FTRL.R:25-207 over
src/FTRL.cpp:18-169, McMahan et al.).  The reference is hogwild per-row SGD
mutating shared (z, n) state in place; here rows are bucketed into padded
(B, L) blocks and each block is one deterministic jitted update: lazy
weights from the (z, n) snapshot, link + gradient, then segment scatter-add
into z and n (duplicate features across a block accumulate).

Per-element math matches src/FTRL.cpp exactly:
  w_j = -(z_j - sign(z_j) l1) / ((decay + sqrt(n_j))/lr + l2)  if |z_j| > l1
  grad = sample_weight * (y_hat - y) * x, clipped at +-1000       (:146-158)
  sigma = (sqrt(n + g^2) - sqrt(n)) / lr;  z += g - sigma*w;  n += g^2
Input dropout keeps features with prob (1-dropout) and rescales by
1/(1-dropout) (:133-143).
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp
from jax.sharding import Mesh, PartitionSpec as P

from ..config import logger, resolve_dtype
from ..parallel.sgd_sharded import (
    DirectOps, ShardedOps, mesh_table_axes, padded_rows, replicate_on,
    shard_table, unshard)

_FAMILY_CODES = {"binomial": 1, "gaussian": 2, "poisson": 3}
CLIP_GRAD = 1000.0
_DIRECT = DirectOps()


def _staged_blocks(csr, dtype, n_features: int, mesh):
    # 1<<20-element blocks: the flat update operand stays ~8 MB, small
    # enough that the scheduled permute-gathers hit cache instead of
    # cold HBM (4x block growth measured 3x SLOWER per row, PERF.md r4)
    from ..ops.segsum import staged_blocks_with_layouts
    return staged_blocks_with_layouts(csr, dtype, n_features, mesh,
                                      "glm_blocks", max_elems=1 << 20)


def _link(x, family: int):
    if family == 1:
        return jax.nn.sigmoid(x)
    if family == 2:
        return x
    return jnp.exp(x)


def _lazy_weights(z, n, lr, decay, l1, l2):
    """w_ftprl (reference src/FTRL.cpp:78-92)."""
    active = jnp.abs(z) > l1
    denom = (decay + jnp.sqrt(n)) / lr + l2
    w = -(z - jnp.sign(z) * l1) / denom
    return jnp.where(active, w, 0.0)


def _ftrl_block_impl(ops, z, n, col_idx, values, y, sample_w, dropout_key,
                     lr, decay, l1, l2, dropout, layout, family: int,
                     do_update: bool, use_dropout: bool,
                     rowmajor_pred: bool):
    """One padded row-block update (or pure prediction), computed in the
    feature-grouped scheduled layout (ops/segsum.py SchedLayout).

    z and n stay SEPARATE 1-D tables (one gather per table).  Table
    access goes through ``ops``
    (parallel/sgd_sharded.py): the same kernel runs single-device and
    row-sharded under shard_map.

    All table reads are per-FEATURE (one (z, n) row per distinct feature,
    broadcast across its occurrences) and all table writes are
    per-feature sums — the per-position table traffic of the row-major
    kernel (2 gathers for (z, n) + 2 scheduled-sum gathers per pass,
    PERF.md round 4) collapses to two minibatch-operand permute-gathers:
    prediction contributions sched->row, the per-row gradient scalar
    row->sched.  Per-element math still matches src/FTRL.cpp:78-166
    exactly; sums equal the reference's per-position updates to f32
    summation order.

    ``use_dropout`` must be False when dropout == 0: the (B, L) uniform
    draw is a threefry evaluation per nnz and costs more than the whole
    elementwise chain.  With dropout the scheduled values are re-gathered
    from the row-layout dropped values through ``layout.pos`` (the draw
    must agree between the prediction and update layouts).
    """
    from ..ops.segsum import (sched_apply_sums_multi, sched_reduce_chunks,
                              sched_to_rows)

    B, L = values.shape
    nb = len(layout.feats_c)
    if nb == 0:
        return z, n, _link(jnp.zeros((B,), values.dtype), family)

    pairs = []
    for f in layout.feats_c:
        pairs.append((z, f))
        pairs.append((n, f))
    flat = ops.gather_many(pairs)
    zf, nf = flat[0::2], flat[1::2]
    wf = [_lazy_weights(zf[k], nf[k], lr, decay, l1, l2)
          for k in range(nb)]

    vrow = None
    if do_update and use_dropout:
        keep = jax.random.uniform(dropout_key, values.shape) > dropout
        vrow = jnp.where(keep, values * (1.0 / (1.0 - dropout)), 0.0)
        vflat = jnp.concatenate(
            [vrow.reshape(-1), jnp.zeros((1,), vrow.dtype)])
        vals_k = [vflat[p] for p in layout.pos]
    else:
        vals_k = list(layout.vals)

    if rowmajor_pred:
        # small tables are HOT gather operands (PERF.md round-4 matrix:
        # 291-426M row-fetch/s vs ~64M/s against large/cold ones), so one
        # direct w[col_idx] gather beats the sched->row permute whose flat
        # operand is minibatch-sized.  w_dense is one O(F) elementwise
        # pass — cheap exactly when the table is small.
        w_dense = _lazy_weights(z, n, lr, decay, l1, l2)
        wg = ops.gather(w_dense, col_idx)              # (B, L)
        vr = vrow if vrow is not None else values
        y_hat = _link(jnp.sum(wg * vr, axis=1), family)
    else:
        c_row = sched_to_rows(
            [wf[k][:, None] * vals_k[k] for k in range(nb)],
            layout, B, L)
        y_hat = _link(jnp.sum(c_row, axis=1), family)

    if not do_update:
        return z, n, y_hat

    d = sample_w * (y_hat - y)                      # (B,)
    chunks = []
    for k in range(nb):
        g = jnp.clip(d[layout.rows[k]] * vals_k[k],
                     -CLIP_GRAD, CLIP_GRAD)
        g2 = g * g
        nfk = nf[k][:, None]
        sigma = (jnp.sqrt(nfk + g2) - jnp.sqrt(nfk)) / lr
        uz = g - sigma * wf[k][:, None]
        chunks.append(jnp.stack(
            [jnp.sum(uz, axis=1), jnp.sum(g2, axis=1)], axis=-1))
    red = sched_reduce_chunks(jnp.concatenate(chunks, axis=0), layout)
    z, n = sched_apply_sums_multi(
        ops, [(z, red[:, 0]), (n, red[:, 1])], layout)
    return z, n, y_hat


@partial(jax.jit, static_argnames=("family", "do_update", "use_dropout",
                                   "rowmajor_pred"),
         donate_argnums=(0, 1))
def _ftrl_block(z, n, col_idx, values, y, sample_w, dropout_key,
                lr, decay, l1, l2, dropout, layout, *, family: int,
                do_update: bool, use_dropout: bool, rowmajor_pred: bool):
    return _ftrl_block_impl(_DIRECT, z, n, col_idx, values, y,
                            sample_w, dropout_key, lr, decay, l1, l2,
                            dropout, layout, family, do_update,
                            use_dropout, rowmajor_pred)


_SHARDED_FNS: dict = {}


def _sharded_ftrl_fn(mesh: Mesh, family: int, do_update: bool,
                     use_dropout: bool, rowmajor_pred: bool):
    key = (mesh, family, do_update, use_dropout, rowmajor_pred)
    fn = _SHARDED_FNS.get(key)
    if fn is not None:
        return fn
    axes = mesh_table_axes(mesh)
    ops = ShardedOps(axes)
    tab, rep = P(axes), P()

    def body(z, n, col_idx, values, y, sample_w, dropout_key,
             lr, decay, l1, l2, dropout, layout):
        return _ftrl_block_impl(ops, z, n, col_idx, values, y,
                                sample_w, dropout_key, lr, decay, l1, l2,
                                dropout, layout, family, do_update,
                                use_dropout, rowmajor_pred)

    fn = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(tab, tab) + (rep,) * 11,
        out_specs=(tab, tab, rep), check_vma=False),
        donate_argnums=(0, 1))
    _SHARDED_FNS[key] = fn
    if len(_SHARDED_FNS) > 16:
        _SHARDED_FNS.pop(next(iter(_SHARDED_FNS)))
    return fn


class FTRL:
    """'Follow the Regularized Leader' proximal GLM (binomial default)."""

    def __init__(
        self,
        learning_rate: float = 0.1,
        learning_rate_decay: float = 0.5,
        lambda_: float = 0.0,
        l1_ratio: float = 1.0,
        dropout: float = 0.0,
        family: str = "binomial",
        precision: str = "float32",
        seed: Optional[int] = None,
        mesh: Optional[Mesh] = None,
    ):
        if not 0 <= dropout < 1:
            raise ValueError("dropout must be in [0, 1)")
        if not 0 <= l1_ratio <= 1:
            raise ValueError("l1_ratio must be in [0, 1]")
        if lambda_ < 0 or learning_rate <= 0 or learning_rate_decay <= 0:
            raise ValueError("invalid learning-rate/lambda parameters")
        if family not in _FAMILY_CODES:
            raise ValueError(f"unknown family {family!r}")
        self.learning_rate = float(learning_rate)
        self.learning_rate_decay = float(learning_rate_decay)
        self.lambda_ = float(lambda_)
        self.l1_ratio = float(l1_ratio)
        self.dropout = float(dropout)
        self.family = family
        self.family_code = _FAMILY_CODES[family]
        self.precision = precision
        self.dtype = resolve_dtype(precision)
        self.n_features: Optional[int] = None
        self.z = None
        self.n = None
        #: device mesh: when set, the (z, n) state is row-sharded over the
        #: mesh's data axes (the device-mesh replacement for the
        #: reference's hogwild shared state, src/FTRL.cpp:122-125); padded
        #: row blocks are replicated.  See parallel/sgd_sharded.py.
        self.mesh = mesh
        self._key = jax.random.PRNGKey(seed if seed is not None else 0)

    @property
    def _l1(self):
        return self.lambda_ * self.l1_ratio

    @property
    def _l2(self):
        return self.lambda_ * (1.0 - self.l1_ratio)

    def _ensure_state(self, n_features: int):
        if self.n_features is None:
            self.n_features = n_features
            z = jnp.zeros((n_features + 1,), self.dtype)
            n = jnp.zeros((n_features + 1,), self.dtype)
            if self.mesh is not None:
                z = shard_table(z, self.mesh)
                n = shard_table(n, self.mesh)
            self.z, self.n = z, n
        elif n_features != self.n_features:
            raise ValueError(
                f"feature count mismatch: model has {self.n_features}, "
                f"input has {n_features}")

    def _stage(self, x: sp.spmatrix, y, weights, do_update: bool):
        """Content-cached staging of one (x, y, weights) problem —
        computed ONCE per ``fit()`` call: the content fingerprints alone
        (two adler32 scans over the CSR arrays) cost ~25 ms/pass at bench
        scale when re-derived every pass."""
        csr = sp.csr_matrix(x)
        if np.isnan(csr.data).any():
            raise ValueError("NA's in input matrix are not allowed")
        self._ensure_state(csr.shape[1])
        n_rows = csr.shape[0]
        y = np.zeros(n_rows) if y is None else np.asarray(y, np.float64)
        if do_update and len(y) != n_rows:
            raise ValueError("nrow(x) must equal length(y)")
        weights = (np.ones(n_rows) if weights is None
                   else np.asarray(weights, np.float64))
        br, layouts = _staged_blocks(csr, self.dtype,
                                     self.n_features, self.mesh)
        from ..ops.segsum import staged_label_gathers
        labels = staged_label_gathers("ftrl_y", csr, y, weights, br,
                                      self.dtype, self.mesh,
                                      zero_pad_weight=False)
        return n_rows, br, layouts, labels

    def _run_staged(self, staged, do_update=False, materialize=True):
        n_rows, br, layouts, labels = staged
        use_dropout = do_update and self.dropout > 0
        # row-major prediction gathers while the (z, n) tables are small
        # (32 MB threshold carried over, not tuned on the H100)
        rowmajor = (self.n_features + 1) * 8 < (1 << 25)
        if self.mesh is not None:
            step = _sharded_ftrl_fn(self.mesh, self.family_code, do_update,
                                    use_dropout, rowmajor)
        else:
            step = partial(_ftrl_block, family=self.family_code,
                           do_update=do_update, use_dropout=use_dropout,
                           rowmajor_pred=rowmajor)
        outs = []  # defer device->host reads so dispatches pipeline
        for b, lay, (y_b, w_b) in zip(br.buckets, layouts, labels):
            if use_dropout:
                self._key, sub = jax.random.split(self._key)
                if self.mesh is not None:
                    sub = replicate_on(self.mesh, sub)
            else:
                sub = self._key    # unused by the kernel
            self.z, self.n, yh = step(
                self.z, self.n, b.col_idx, b.values, y_b, w_b, sub,
                self.learning_rate, self.learning_rate_decay,
                self._l1, self._l2, self.dropout, lay)
            outs.append((b.row_ids, yh))
        if not materialize:
            # mid-fit pass: the caller discards the predictions; skip the
            # device->host transfer
            return None
        y_hat = np.empty(n_rows, np.float64)
        for row_ids, yh in outs:
            rows = np.asarray(row_ids)
            keep = rows < n_rows
            y_hat[rows[keep]] = np.asarray(yh, np.float64)[keep]
        return y_hat

    def _run(self, x: sp.spmatrix, y=None, weights=None, do_update=False,
             materialize=True):
        return self._run_staged(self._stage(x, y, weights, do_update),
                                do_update=do_update,
                                materialize=materialize)

    def partial_fit(self, x: sp.spmatrix, y, weights=None) -> np.ndarray:
        """One SGD pass over the samples; returns in-pass predictions."""
        return self._run(x, y, weights, do_update=True)

    def fit(self, x, y, weights=None, n_iter: int = 1):
        if n_iter < 1:
            raise ValueError("n_iter must be >= 1")
        staged = self._stage(x, y, weights, do_update=True)
        for i in range(n_iter):
            logger.debug("FTRL iter %03d", i + 1)
            # only the final pass's in-pass predictions are returned;
            # intermediate ones skip the device->host transfer
            out = self._run_staged(staged, do_update=True,
                                   materialize=(i == n_iter - 1))
        return out

    def predict(self, x: sp.spmatrix) -> np.ndarray:
        if self.n_features is None:
            raise RuntimeError("model is not fitted")
        return self._run(x, do_update=False)

    def coef(self) -> np.ndarray:
        """Regression weights from the (z, n) state
        (reference src/FTRL.cpp:59-75).  unshard() handles row-sharded
        (incl. multi-process) state."""
        w = _lazy_weights(jnp.asarray(unshard(self.z, self.n_features)),
                          jnp.asarray(unshard(self.n, self.n_features)),
                          self.learning_rate, self.learning_rate_decay,
                          self._l1, self._l2)
        return np.asarray(w, np.float64)

    # -- serialization (reference R/model_FTRL.R:142-158) ------------------

    def dump(self) -> Dict:
        if self.n_features is None:
            raise RuntimeError("model is not fitted")
        return {
            "kind": "ftrl_model_dump",
            "learning_rate": self.learning_rate,
            "learning_rate_decay": self.learning_rate_decay,
            "lambda": self.lambda_, "l1_ratio": self.l1_ratio,
            "dropout": self.dropout, "family": self.family,
            "n_features": self.n_features,
            # slice off mesh-padding rows so dumps are mesh-independent
            "z": unshard(self.z, self.n_features + 1).copy(),
            "n": unshard(self.n, self.n_features + 1).copy(),
        }

    @classmethod
    def load(cls, d: Dict) -> "FTRL":
        if d.get("kind") != "ftrl_model_dump":
            raise ValueError("input should be an ftrl_model_dump dict")
        m = cls(learning_rate=d["learning_rate"],
                learning_rate_decay=d["learning_rate_decay"],
                lambda_=d["lambda"], l1_ratio=d["l1_ratio"],
                dropout=d["dropout"], family=d["family"])
        m.n_features = d["n_features"]
        m.z = jnp.asarray(d["z"], m.dtype)
        m.n = jnp.asarray(d["n"], m.dtype)
        return m
