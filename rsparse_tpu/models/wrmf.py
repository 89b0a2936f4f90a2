"""WRMF: Weighted Regularized Matrix Factorization (iALS).

Re-design of the reference WRMF model (R/model_WRMF.R:35-454 over
inst/include/wrmf_implicit.hpp / wrmf_explicit.hpp).  Capabilities match the
reference: implicit (Hu/Koren/Volinsky) and explicit feedback, three solvers
(cholesky / conjugate_gradient / nnls — the latter yields NNMF), static or
dynamic lambda, user/item/global biases, a user-supplied confidence
``preprocess`` hook, warm-start ``init``, and a precision axis
(float32 default, bfloat16, float64).

Architecture: interactions are bucketed into padded (B, L) row blocks
(sparse/device.py); each ALS half-sweep is a single jitted program that
gathers source factors, builds batched normal equations as matrix products
and scatters solved rows back (ops/als.py).  The alternating item/user sweeps
mirror the reference's fit loop (R/model_WRMF.R:318-338), including the
final avoid-CG half-sweep that makes ``fit_transform(x)`` equal
``transform(x)`` exactly (R/model_WRMF.R:355-359, tested in the reference
at tests/testthat/test-wrmf.R:56-57).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from ..config import logger, resolve_dtype
from ..ops.als import (ALSConfig, CHOLESKY, CONJUGATE_GRADIENT, NNLS,
                       solver_code, wrmf_sweep, wrmf_sweep_streamed)
from ..ops.bias_init import initialize_biases
from ..sparse.device import (BucketedRows, bucket_rows, hot_bucket_rows,
                             split_hot_cold)
from .base import MatrixFactorizationRecommender, get_names


from functools import partial as _partial

_jit_whole_sweep = _partial(jax.jit, static_argnames=("cfg",))(wrmf_sweep)


class _FitState:
    """Mid-fit WRMF checkpoint payload (factor tables + loop counters) —
    serialized through utils.checkpoint, so mesh-sharded tables ride the
    orbax store (per-device writes, no host gather)."""


def _save_fit_state(path, U, V, it, loss_history, loss_prev, global_bias):
    from ..utils import checkpoint
    st = _FitState()
    st.U, st.V, st.it = U, V, int(it)
    st.loss_history = [float(l) for l in loss_history]
    st.loss_prev = float(loss_prev)
    st.global_bias = float(global_bias)
    checkpoint.save(st, path)
    logger.info("fit checkpoint written to %s (iteration %d)", path, it)


def _load_fit_state(path):
    import os
    if not os.path.exists(os.path.join(path, "meta.json")):
        return None
    from ..utils import checkpoint
    return checkpoint.load(path, cls=_FitState)


class WRMF(MatrixFactorizationRecommender):
    """Weighted ALS matrix factorization for implicit/explicit feedback."""

    def __init__(
        self,
        rank: int = 10,
        lambda_: float = 0.0,
        dynamic_lambda: bool = True,
        init: Optional[np.ndarray] = None,
        preprocess: Optional[Callable] = None,
        feedback: str = "implicit",
        solver: str = "conjugate_gradient",
        with_user_item_bias: bool = False,
        with_global_bias: bool = False,
        cg_steps: int = 3,
        precision: str = "float32",
        nnls_max_iter: int = 10_000,
        seed: Optional[int] = None,
        mesh=None,
        compute_dtype: str = "float32",
        n_hot="auto",
        hot_dtype: str = "auto",
        routing: Optional[str] = None,
    ):
        super().__init__()
        if feedback not in ("implicit", "explicit"):
            raise ValueError("feedback must be 'implicit' or 'explicit'")
        self.feedback = feedback
        self.solver = solver_code(solver)
        self.non_negative = self.solver == NNLS
        if self.non_negative and with_global_bias:
            logger.warning("setting with_global_bias=False for 'nnls' solver")
            with_global_bias = False
        # NB: implicit + per-entity biases + CG runs the mathematically-
        # consistent CG form (ops/als.py _solve_bucket_implicit handles the
        # x_bias rhs offset for every solver).  The reference's own implicit
        # CG-with-bias path is broken (inst/include/wrmf_implicit.hpp:199
        # drops the bias coordinate from the rhs twice) and untested; ours
        # matches the Cholesky solution to CG tolerance
        # (tests/test_wrmf.py::test_implicit_cg_bias_matches_cholesky).
        self.with_user_item_bias = with_user_item_bias
        self.with_global_bias = with_global_bias
        self.rank = int(rank)
        self._R = self.rank + (2 if with_user_item_bias else 0)
        self.lambda_ = float(lambda_)
        self.dynamic_lambda = bool(dynamic_lambda)
        self.cg_steps = int(cg_steps)
        self.precision = precision
        self.dtype = resolve_dtype(precision)
        self.preprocess = preprocess or (lambda m: m)
        self.nnls_max_iter = int(nnls_max_iter)
        self._rng = np.random.default_rng(seed)
        self.global_bias = 0.0
        self._init_components = init
        #: optional jax Mesh with a "data" axis (and optionally "model"):
        #: buckets shard over "data", factor tables over "model"
        self.mesh = mesh
        self.compute_dtype = compute_dtype
        #: dense zipf-head split (sparse/device.py HotBlock): the hottest
        #: columns of each sweep orientation are handled as a dense matmul
        #: block with zero per-nnz gathers.  ``0`` disables, an int fixes
        #: the head size, "auto" picks by a break-even column count
        #: (see ``_resolve_n_hot``).
        self.n_hot = n_hot
        #: storage dtype of the dense hot block: "auto" follows
        #: ``compute_dtype``; "uint8" stores quantized confidence codes with
        #: a per-row scale (implicit feedback only; halves the W-block HBM
        #: footprint; error < scale per confidence, <= scale/2 for values
        #: within 510x of the row max — see HotBlock docs)
        #: "alx": route only the referenced source-factor rows to each
        #: device via a static all-to-all plan instead of the implicit
        #: all-gather (parallel/alx.py; PAPERS.md ALX).  Requires a mesh
        #: with a "data" axis and no per-entity biases.
        if routing not in (None, "alx", "alx_ragged"):
            raise ValueError(f"unknown routing {routing!r}")
        if routing in ("alx", "alx_ragged"):
            ax = set(mesh.axis_names) if mesh is not None else set()
            if mesh is None or not ("data" in ax or {"dcn", "ici"} <= ax):
                raise ValueError("routing='alx' requires a mesh with a "
                                 "'data' axis or both 'dcn' and 'ici'")
            if with_user_item_bias:
                raise ValueError("routing='alx' does not support "
                                 "per-entity biases")
        if (routing == "alx_ragged"
                and mesh.devices.flat[0].platform == "gpu"):
            # the ragged exchange alone matches its plan on the GPU, but
            # fits routed through it returned wrong factors (4 H100s,
            # jax 0.9.0; PERF.md) — refuse rather than emulate
            raise NotImplementedError(
                "routing='alx_ragged' is disabled on GPUs: fits routed "
                "through ragged_all_to_all returned wrong factors there; "
                "use routing='alx'")
        self.routing = routing
        if hot_dtype not in ("auto", "uint8", "bfloat16", "float32"):
            raise ValueError(f"unknown hot_dtype {hot_dtype!r}")
        if hot_dtype == "uint8" and feedback != "implicit":
            raise ValueError("hot_dtype='uint8' requires implicit feedback "
                             "(quantized confidences must be positive)")
        self.hot_dtype = hot_dtype
        self.components = None          # (R, n_items) view for the public API
        self._V = None                  # (n_items, R) device factors
        self._U = None                  # (n_users, R) device factors
        self._cnt_u = None
        self._cnt_i = None
        self._n_items = None

    # -- helpers -----------------------------------------------------------

    def _cfg(self, bias_last_in_source: bool, solver: Optional[int] = None
             ) -> ALSConfig:
        return ALSConfig(
            feedback=self.feedback,
            solver=self.solver if solver is None else solver,
            cg_steps=self.cg_steps,
            with_biases=self.with_user_item_bias,
            bias_last_in_source=bias_last_in_source,
            use_global_bias=(self.feedback == "implicit"
                             and self.with_global_bias
                             and not self.with_user_item_bias),
            dynamic_lambda=self.dynamic_lambda,
            nnls_max_iter=self.nnls_max_iter,
            compute_dtype=self.compute_dtype,
            solve_empty=self._include_empty,
        )

    # -- sharding helpers --------------------------------------------------

    @property
    def _row_align(self) -> int:
        if self.mesh is None:
            return 8
        if "data" in self.mesh.axis_names:
            n = self.mesh.shape.get("data", 1)
        else:       # ("dcn","ici") multihost-style mesh: all devices
            n = 1
            for a in self.mesh.axis_names:
                n *= self.mesh.shape[a]
        return 8 * n if 8 % n else 8

    @property
    def _multihost(self) -> bool:
        from ..parallel.multihost import is_multihost
        return is_multihost(self.mesh)

    def _bucketize(self, csr, include_empty: bool, n_src: Optional[int] = None):
        if self.routing in ("alx", "alx_ragged"):
            # host-built buckets -> static routing plan + cache-remapped
            # sharded buckets (parallel/alx.py); n_src = source-table rows.
            # On a ("dcn","ici") mesh the exchange rides both axes (the
            # multi-host factor routing the plain all-gather path can't
            # do).  "alx_ragged" swaps the padded all_to_all for
            # ragged_all_to_all — exactly the referenced rows cross the
            # wire (single-axis meshes; emulated on CPU, whose XLA has no
            # ragged collective).
            from ..parallel.alx import stage_alx
            from ..parallel.multihost import DATA_AXES
            axis = ("data" if "data" in self.mesh.axis_names
                    else DATA_AXES)
            br = bucket_rows(csr, self.dtype, include_empty=include_empty,
                             row_align=self._row_align)
            return stage_alx(br, n_src if n_src is not None
                             else csr.shape[1], self.mesh, axis=axis,
                             ragged=self.routing == "alx_ragged")
        if self._multihost:
            # per-process bucket building: this host buckets only its own
            # contiguous row shard; shapes negotiated via tiny all-gathers
            from ..parallel.multihost import (distributed_bucket_rows,
                                              process_row_range)
            lo, hi = process_row_range(csr.shape[0])
            return distributed_bucket_rows(
                sp.csr_matrix(csr)[lo:hi], lo, csr.shape[0], csr.shape[1],
                self.mesh, self.dtype, include_empty=include_empty)
        br = bucket_rows(csr, self.dtype, include_empty=include_empty,
                         row_align=self._row_align)
        if self.mesh is not None:
            from ..parallel.mesh import shard_buckets
            br = shard_buckets(br, self.mesh, "data")
        return br

    def _place_factors(self, arr):
        if self.mesh is None:
            return arr
        from jax.sharding import NamedSharding, PartitionSpec as P
        if self._multihost:
            from ..parallel.multihost import replicate
            return replicate(arr, self.mesh)
        if "model" in self.mesh.axis_names:
            n = self.mesh.shape["model"]
            if arr.shape[0] % n == 0:
                return jax.device_put(
                    arr, NamedSharding(self.mesh, P("model")))
        return jax.device_put(
            arr, NamedSharding(self.mesh, P()))

    def _sweep(self, src, tgt, container, src_cnt, lam, g, cfg, hot=None,
               hot_rows=None, prepared=None):
        from ..parallel.alx import ALXStage
        if isinstance(container, ALXStage):
            from ..parallel.alx import alx_sweep
            return alx_sweep(self.mesh, src, tgt, container, src_cnt, lam,
                             g, cfg)
        buckets = container.buckets
        if self.mesh is not None:
            with self.mesh:
                return wrmf_sweep_streamed(src, tgt, buckets, src_cnt, lam,
                                           g, cfg, hot=hot,
                                           hot_rows=hot_rows)
        # small problems: one jitted program for the WHOLE half-sweep.  The
        # streamed path dispatches one program per bucket, and per-dispatch
        # latency (not compute) dominates small fits.  Large problems keep
        # the per-shape streamed programs (compile cost is per bucket shape
        # there, not per bucket).
        if sum(b.batch * b.pad_len for b in buckets) <= (1 << 22):
            return _jit_whole_sweep(src, tgt, buckets, src_cnt,
                                    jnp.asarray(lam), jnp.asarray(g), cfg,
                                    hot, hot_rows)
        return wrmf_sweep_streamed(src, tgt, buckets, src_cnt, lam, g, cfg,
                                   hot=hot, hot_rows=hot_rows,
                                   prepared=prepared)

    def _resolve_n_hot(self, csr: sp.csr_matrix) -> int:
        """Head size for the dense zipf-head split of one sweep orientation.

        Only the CG-no-per-entity-bias configurations have a hot kernel
        path; "auto" includes every column whose nnz count clears a
        break-even (a cold nnz pays a gathered factor row, a hot column a
        dense W entry per target row per sweep), capped by a 1 GB budget
        for the dense W block.  The break-even constants were derived on
        an earlier chip and are not tuned on the H100 (PERF.md).
        """
        if (self.with_user_item_bias
                or self._multihost or self.routing is not None):
            return 0
        if self.solver != CONJUGATE_GRADIENT and self.n_hot == "auto":
            # exact solvers pay B*H*d^2 for the dense-head lhs term
            # (ops/als.py _hot_lhs) regardless of head density — not
            # profitable at auto-sized heads; explicit n_hot is honored
            return 0
        n_rows, n_cols = csr.shape
        n = self.n_hot
        # true storage width of the W block (mirrors the w_dt resolution in
        # fit_transform): uint8 codes, bf16, or the full solve dtype
        if self.hot_dtype == "uint8":
            w_bytes = 1
        elif (self.hot_dtype == "bfloat16"
              or (self.hot_dtype == "auto"
                  and self.compute_dtype == "bfloat16")):
            w_bytes = 2
        else:
            w_bytes = jnp.dtype(self.dtype).itemsize
        if n == "auto":
            counts = np.bincount(csr.indices, minlength=n_cols)
            # uint8 halves the per-column W cost -> break-even at half the
            # popularity, and the same bandwidth affords a 2x-wider head
            n = int((counts >= max(8, n_rows // (512 // min(w_bytes, 4))
                                   )).sum())
        cap = (1 << 30) // max(w_bytes * n_rows, 1)
        n = int(min(int(n), 16384 // min(w_bytes, 4), cap, n_cols))
        return n if n >= 16 else 0

    @property
    def _include_empty(self) -> bool:
        # the reference solves empty entities too when biases or an implicit
        # global bias are present (wrmf_implicit.hpp:180)
        return self.feedback == "implicit" and (
            self.with_user_item_bias or
            (self.with_global_bias and not self.with_user_item_bias))

    def _rand(self, n: int) -> jnp.ndarray:
        # N(0, 0.01) init, matching large_rand_matrix / flrnorm
        # (reference src/utils.cpp:131-143, R/model_WRMF.R:211)
        a = self._rng.standard_normal((n, self._R)) * 0.01
        return jnp.asarray(a, dtype=self.dtype)

    def _check_values(self, x: sp.spmatrix):
        if (self.feedback == "implicit" or self.non_negative) and x.nnz:
            if x.data.min() < 0:
                raise ValueError(
                    "all values must be >= 0 for implicit feedback / nnls")

    # -- fitting -----------------------------------------------------------

    def fit_transform(self, x: sp.spmatrix, n_iter: int = 10,
                      convergence_tol: Optional[float] = None,
                      checkpoint_path: Optional[str] = None,
                      checkpoint_every: int = 1,
                      resume: bool = False) -> jax.Array:
        """Alternating sweeps over items and users; returns user embeddings
        of shape (n_users, rank [+2 with biases]).

        ``checkpoint_path``: directory to write the full fit state (factor
        tables + iteration counter + loss history) every
        ``checkpoint_every`` iterations — the restart story for long
        multi-host fits (sharded tables go through the orbax store without
        a host gather).  ``resume=True`` picks up from the latest state in
        ``checkpoint_path`` (same ``x`` and hyperparameters assumed); the
        remaining iterations are bit-identical to an uninterrupted fit
        because the ALS loop is deterministic given (U, V).
        """
        if convergence_tol is None:
            convergence_tol = 0.005 if self.feedback == "implicit" else 0.001

        row_names, col_names = get_names(x, 0), get_names(x, 1)
        csr = sp.csr_matrix(x).astype(np.float64)
        csr = self.preprocess(csr)
        self._check_values(csr)
        n_users, n_items = csr.shape
        self._n_items = n_items
        self.item_ids = col_names
        self.user_ids = row_names
        R = self._R

        self.global_bias = 0.0
        user_bias = item_bias = None
        if self.with_user_item_bias:
            g, user_bias, item_bias, csr = initialize_biases(
                csr, self.lambda_, self.dynamic_lambda, self.non_negative,
                self.with_global_bias, self.feedback == "explicit")
            if self.with_global_bias:
                self.global_bias = g
        elif self.with_global_bias:
            if self.feedback == "explicit":
                self.global_bias = float(csr.data.mean()) if csr.nnz else 0.0
                csr = csr.copy()
                csr.data = csr.data - self.global_bias
            else:
                s = float(csr.data.sum())
                self.global_bias = s / (
                    s + float(n_users) * float(n_items) - csr.nnz)

        incl = self._include_empty
        # items-as-rows buckets drive the item sweep; users-as-rows the user
        # sweep (the two orientations of R/model_WRMF.R:184-189).  With the
        # dense zipf-head split active, training sweeps run on (hot block +
        # cold buckets); the exact final/transform half-sweep keeps the full
        # buckets (its Cholesky solver has no hot path).
        if self.hot_dtype == "auto":
            w_dt = (jnp.bfloat16 if self.compute_dtype == "bfloat16"
                    else self.dtype)
        else:
            w_dt = jnp.dtype(self.hot_dtype)
        with_presence = self.feedback == "explicit"
        n_hot_items = self._resolve_n_hot(csr)

        # Three independent staging chains (hot/cold split -> bucket build
        # -> host->device transfer per orientation, plus the full-matrix
        # transform buckets).  Run them on threads when single-process:
        # numpy/scipy and the OpenMP native fill release the GIL, and the
        # chains share no data.  Multihost keeps the
        # sequential order — its bucket negotiation issues collectives,
        # which must be issued in identical order on every process.
        def chain_ui():
            if not n_hot_items:
                return None, csr, None
            hot_ui, cold_ui = split_hot_cold(csr, n_hot_items, self.dtype,
                                             w_dtype=w_dt,
                                             with_presence=with_presence)
            ui = self._bucketize(cold_ui, incl or hot_ui is not None)
            return hot_ui, cold_ui, ui

        def chain_iu():
            csr_t = csr.T.tocsr()
            n_hot_users = self._resolve_n_hot(csr_t)
            if n_hot_users:
                hot_iu, cold_iu = split_hot_cold(
                    csr_t, n_hot_users, self.dtype, w_dtype=w_dt,
                    with_presence=with_presence)
            else:
                hot_iu, cold_iu = None, csr_t
            iu = self._bucketize(cold_iu, incl or hot_iu is not None)
            return csr_t, n_hot_users, hot_iu, cold_iu, iu

        def chain_full():
            return self._bucketize(csr, incl)

        def build_stages():
            if self.routing is None and not self._multihost:
                from concurrent.futures import ThreadPoolExecutor
                with ThreadPoolExecutor(3) as ex:
                    f_ui = ex.submit(chain_ui)
                    f_iu = ex.submit(chain_iu)
                    f_full = ex.submit(chain_full)
                    hot_ui, cold_ui, ui = f_ui.result()
                    csr_t, n_hot_users, hot_iu, cold_iu, iu = f_iu.result()
                    ui_full = f_full.result()
            else:
                hot_ui, cold_ui, ui = chain_ui()
                csr_t, n_hot_users, hot_iu, cold_iu, iu = chain_iu()
                ui_full = chain_full()
            if n_hot_items or n_hot_users:
                logger.info(
                    "zipf-head split: %d hot items (%.0f%% nnz), "
                    "%d hot users (%.0f%% nnz)", n_hot_items,
                    100 * (1 - cold_ui.nnz / max(csr.nnz, 1)),
                    n_hot_users, 100 * (1 - cold_iu.nnz / max(csr.nnz, 1)))
            if self.mesh is not None:
                from ..parallel.mesh import shard_hot
                hot_ui = shard_hot(hot_ui, self.mesh)
                hot_iu = shard_hot(hot_iu, self.mesh)
            # pre-gather the hot rows into bucket order once: bucket order
            # is fixed for the whole fit, and the per-sweep W[ids] random
            # gather is a random row gather per bucket (sparse/device.py
            # hot_bucket_rows) (works under a mesh too: W is
            # "model"-col-sharded, bucket row ids "data"-sharded, so the
            # staged rows come out (data, model)-sharded and the per-sweep
            # W[ids] random gather disappears on both paths)
            iu_hot_rows = ui_hot_rows = None
            if hot_iu is not None:
                iu_hot_rows = hot_bucket_rows(hot_iu, iu.buckets, n_items)
                hot_iu = hot_iu._replace(W=hot_iu.W[:1])   # free the big W
            if hot_ui is not None:
                ui_hot_rows = hot_bucket_rows(hot_ui, ui.buckets, n_users)
                hot_ui = hot_ui._replace(W=hot_ui.W[:1])
            if ui is None:
                ui = ui_full
            cnt_u = jnp.asarray(np.diff(csr.indptr), jnp.float32)
            # per-item counts come free from the transposed CSR (row
            # counts of csr_t == column counts of csr)
            cnt_i = jnp.asarray(np.diff(csr_t.indptr), jnp.float32)
            if self._multihost:
                from ..parallel.multihost import replicate
                cnt_u = replicate(cnt_u, self.mesh)
                cnt_i = replicate(cnt_i, self.mesh)
            return (hot_ui, hot_iu, ui, iu, ui_full, iu_hot_rows,
                    ui_hot_rows, cnt_u, cnt_i)

        if self.routing is None and not self._multihost:
            # warm re-fits on the same matrix skip the whole staging
            # pipeline (hot/cold splits + bucket builds + transfers +
            # hot-row pre-gathers).  Multihost/ALX staging issues
            # collectives whose order must match across processes, and
            # per-process LRU state may differ — keep those uncached.
            from ..sparse.device import staged_cached
            (hot_ui, hot_iu, ui, iu, ui_full, iu_hot_rows, ui_hot_rows,
             self._cnt_u, self._cnt_i) = staged_cached(
                "wrmf_stages", csr, build_stages,
                extra=(str(jnp.dtype(self.dtype)), str(w_dt),
                       with_presence, n_hot_items, incl, self._row_align,
                       self.mesh, "stages_v1"))
        else:
            (hot_ui, hot_iu, ui, iu, ui_full, iu_hot_rows, ui_hot_rows,
             self._cnt_u, self._cnt_i) = build_stages()
        self._train_ui = ui_full
        nnz = max(csr.nnz, 1)

        # factor init (R/model_WRMF.R:203-255)
        U = self._rand(n_users)
        if self._init_components is not None:
            comp = np.asarray(self._init_components)
            if comp.shape != (R, n_items):
                raise ValueError(
                    f"init must have shape ({R}, {n_items})")
            V = jnp.asarray(comp.T, dtype=self.dtype)
        elif self.solver == CONJUGATE_GRADIENT:
            V = jnp.zeros((n_items, R), dtype=self.dtype)
        else:
            V = self._rand(n_items)
        if self.non_negative:
            U, V = jnp.abs(U), jnp.abs(V)
        U, V = self._place_factors(U), self._place_factors(V)
        if self.with_user_item_bias:
            # users = [1, emb..., u_bias]; items = [i_bias, emb..., 1]
            U = U.at[:, 0].set(1.0)
            U = U.at[:, R - 1].set(jnp.asarray(user_bias, self.dtype))
            V = V.at[:, R - 1].set(1.0)
            V = V.at[:, 0].set(jnp.asarray(item_bias, self.dtype))

        cfg_items = self._cfg(bias_last_in_source=True)
        cfg_users = self._cfg(bias_last_in_source=False)
        lam = self.lambda_
        g = self.global_bias if self.feedback == "implicit" else 0.0

        from ..utils.profiling import FitTrace
        loss_prev = math.inf
        self.loss_history = []
        self.fit_trace = FitTrace()
        start_iter = 0
        if resume:
            if checkpoint_path is None:
                raise ValueError("resume=True requires checkpoint_path")
            state = _load_fit_state(checkpoint_path)
            if state is not None:
                U = self._place_factors(jnp.asarray(state.U, self.dtype))
                V = self._place_factors(jnp.asarray(state.V, self.dtype))
                start_iter = int(state.it)
                self.loss_history = list(state.loss_history)
                loss_prev = float(state.loss_prev)
                self.global_bias = float(state.global_bias)
                g = self.global_bias if self.feedback == "implicit" else 0.0
                logger.info("resumed fit from %s at iteration %d",
                            checkpoint_path, start_iter)
        for it in range(start_iter, n_iter):
            with self.fit_trace.phase(it + 1, "items") as rec:
                V, loss = self._sweep(U, V, iu, self._cnt_u,
                                      lam, g, cfg_items, hot_iu,
                                      iu_hot_rows)
                loss = float(loss) / nnz
                rec["loss"] = loss
            logger.info("iter %d (items) loss = %.4f", it + 1, loss)
            with self.fit_trace.phase(it + 1, "users") as rec:
                U, loss = self._sweep(V, U, ui, self._cnt_i,
                                      lam, g, cfg_users, hot_ui,
                                      ui_hot_rows)
                loss = float(loss) / nnz
                rec["loss"] = loss
            logger.info("iter %d (users) loss = %.4f", it + 1, loss)
            self.loss_history.append(loss)
            if checkpoint_path and (it + 1) % max(checkpoint_every, 1) == 0:
                # the resumed loop's loss_prev is THIS iteration's loss
                # (matching the uninterrupted `loss_prev = loss` below)
                _save_fit_state(checkpoint_path, U, V, it + 1,
                                self.loss_history, loss, self.global_bias)
            if loss == 0.0 or loss_prev / loss - 1 < convergence_tol:
                logger.info("converged after %d iterations", it + 1)
                break
            loss_prev = loss

        self._V = V
        self.components = np.asarray(V).T  # (R, n_items) public layout

        # extra half-sweep so fit_transform == transform exactly
        # (R/model_WRMF.R:355-359)
        self._U = self._transform_buckets(ui_full, n_users)
        return self._U

    def _transform_buckets(self, ui: BucketedRows, n_users: int) -> jax.Array:
        """User-side half-sweep from zero init with CG swapped for Cholesky
        (``avoid_cg``, reference R/model_WRMF.R:111-112,412-452).

        The sweep-invariant prepared terms (XtX Gram, rhs_init) are cached
        across calls against the fitted item factors — the analog of the
        reference caching XtX after fit (R/model_WRMF.R:347-353)."""
        solver = CHOLESKY if self.solver == CONJUGATE_GRADIENT else self.solver
        cfg = self._cfg(bias_last_in_source=False, solver=solver)
        tgt0 = self._place_factors(
            jnp.zeros((n_users, self._R), dtype=self.dtype))
        g = self.global_bias if self.feedback == "implicit" else 0.0
        prepared = None
        if self.mesh is None and sum(
                b.batch * b.pad_len for b in ui.buckets) > (1 << 22):
            # only the streamed path consumes it; the whole-sweep jit
            # (small problems) fuses the Gram for free
            from ..ops.als import _sweep_prepare, accum_dtype
            key = (id(self._V), cfg, float(self.lambda_), float(g))
            if getattr(self, "_prep_cache_key", None) == key:
                prepared = self._prep_cache
            else:
                sdt = accum_dtype(self._V.dtype)
                prepared = _sweep_prepare(
                    self._V, jnp.asarray(self.lambda_, sdt),
                    jnp.asarray(g, sdt), cfg, sdt)
                self._prep_cache_key = key
                self._prep_cache = prepared
        U, _ = self._sweep(self._V, tgt0, ui, self._cnt_i,
                           self.lambda_, g, cfg, prepared=prepared)
        return U

    def transform(self, x: sp.spmatrix) -> jax.Array:
        """Project new users onto the fixed item factors (one ALS half-step,
        reference R/model_WRMF.R:365-385)."""
        if self._V is None:
            raise RuntimeError("model is not fitted")
        if x.shape[1] != self._n_items:
            raise ValueError("column count mismatch with fitted model")
        csr = sp.csr_matrix(x).astype(np.float64)
        csr = self.preprocess(csr)
        self._check_values(csr)
        if self.feedback == "explicit" and self.global_bias != 0.0:
            csr = csr.copy()
            csr.data = csr.data - self.global_bias
        ui = self._bucketize(csr, self._include_empty)
        emb = self._transform_buckets(ui, csr.shape[0])
        return emb
