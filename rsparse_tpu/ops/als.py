"""Batched alternating-least-squares sweep kernels for WRMF.

This is the batched redesign of the reference ALS kernels
(``als_implicit`` inst/include/wrmf_implicit.hpp:91-305, ``als_explicit``
inst/include/wrmf_explicit.hpp:34-174).  Where the reference loops over
entities with OpenMP and solves one rank-dim system per thread, here a whole
nnz-bucket of entities is solved at once:

    gather   Xg   = src[col_idx]            (B, L, d)   -- one XLA gather
    weight   lhs  = XtX + Xg' diag(w) Xg    (B, d, d)   -- batched matmul
    rhs      rhs  = Xg' c                   (B, d)
    solve    batched Cholesky / 3-step CG / NNLS coordinate descent

Bias handling uses the reference's augmented-factor convention
(wrmf_implicit.hpp:96-101): with user/item biases enabled the factor arrays
have ``rank + 2`` columns; user rows are ``[1, emb..., u_bias]`` and item
rows ``[i_bias, emb..., 1]`` so a plain dot product scores
``i_bias + emb.emb + u_bias``.

Loss semantics match the reference exactly (normalized by total nnz, with a
final lambda * ||src||^2 term over learned parameters,
wrmf_implicit.hpp:257-304, wrmf_explicit.hpp:131-173).

Note: for the implicit model with *both* per-entity biases and a global bias
the reference's Cholesky rhs (wrmf_implicit.hpp:226) and CG rhs
(wrmf_implicit.hpp:71) disagree by a ``g*(c-1)`` term; we implement the
mathematically-consistent CG form (the two coincide for ``g == 0``, which is
the only configuration the reference tests exercise).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..config import accum_dtype
from ..sparse.device import RowBucket
from .solvers import batched_cg, batched_nnls, batched_spd_solve

# Solver codes, mirroring reference inst/include/wrmf.hpp:16-18
CHOLESKY = 0
CONJUGATE_GRADIENT = 1
NNLS = 2

_SOLVER_CODES = {"cholesky": CHOLESKY, "conjugate_gradient": CONJUGATE_GRADIENT,
                 "nnls": NNLS}


def _exact_prec(gdt):
    """Matmul precision for the exact (Cholesky/NNLS) solver inputs: with
    f32 operands the default lets XLA run the products in TF32 on the GPU
    (about three decimal digits on the normal equations), so f32 compute
    means HIGHEST there; bf16 operands keep the default (the user opted
    into reduced precision).
    """
    return lax.Precision.HIGHEST if gdt == jnp.float32 else None


@dataclass(frozen=True)
class ALSConfig:
    """Static configuration of one ALS half-sweep (hashable -> jit static)."""

    feedback: str               # "implicit" | "explicit"
    solver: int                 # CHOLESKY | CONJUGATE_GRADIENT | NNLS
    cg_steps: int = 3
    with_biases: bool = False
    #: True when the *source* factor carries its bias in the last column
    #: (i.e. source = users, solving items); mirrors ``is_x_bias_last_row``
    #: in the reference (wrmf_implicit.hpp:96-101).
    bias_last_in_source: bool = True
    use_global_bias: bool = False
    dynamic_lambda: bool = False
    nnls_max_iter: int = 10_000
    #: dtype of the gathered factor blocks fed to the matmuls ("bfloat16"
    #: halves the memory traffic of the gathers; accumulation stays f32)
    compute_dtype: str = "float32"
    #: solve rows with zero total nnz too (implicit global-bias semantics,
    #: wrmf_implicit.hpp:180).  Only consulted on the hot/cold-split path,
    #: where bucket membership alone can't distinguish "row is empty" from
    #: "row's nnz all live in the hot block".
    solve_empty: bool = False


def solver_code(name: str) -> int:
    try:
        return _SOLVER_CODES[name]
    except KeyError:
        raise ValueError(
            f"unknown solver {name!r}; one of {sorted(_SOLVER_CODES)}"
        ) from None


def _active_slices(cfg: ALSConfig, R: int):
    """Column slices: (source active dims, target solved dims == same size).

    With biases the source drops its own bias column but keeps its ones
    column (which generates the target's bias coordinate) — the batched
    equivalent of ``drop_row`` (reference inst/include/wrmf_utils.hpp:4-10).
    """
    if not cfg.with_biases:
        return slice(0, R), slice(0, R)
    if cfg.bias_last_in_source:
        # source = [1, emb..., bias]  ->  active [:-1]
        # target = [bias, emb..., 1]  ->  solved [:-1], ones col at R-1
        return slice(0, R - 1), slice(0, R - 1)
    # source = [bias, emb..., 1]  ->  active [1:]
    # target = [1, emb..., bias]  ->  solved [1:], ones col at 0
    return slice(1, R), slice(1, R)


def hot_outer_table(Vh: jax.Array, sdt) -> jax.Array:
    """(H, d*d) outer-product table for the dense-head lhs term — sweep-
    invariant (depends only on the hot source factors), so callers build it
    ONCE per half-sweep and pass it to every bucket solve."""
    H, d = Vh.shape
    Vs = Vh.astype(sdt)
    return (Vs[:, :, None] * Vs[:, None, :]).reshape(H, d * d)


def _hot_lhs(w: jax.Array, Vh: jax.Array, sdt, outer=None) -> jax.Array:
    """Dense-head per-entity normal-matrix term
    ``lhs_hot[b] = sum_h w[b,h] * Vh[h] Vh[h]'`` as a single matmul
    against the (H, d*d) outer-product table.  w: (B, H); Vh: (H, d)."""
    d = Vh.shape[1]
    if outer is None:
        outer = hot_outer_table(Vh, sdt)
    flat = jnp.einsum("bh,hx->bx", w.astype(sdt), outer,
                      preferred_element_type=sdt,
                      precision=_exact_prec(sdt))
    return flat.reshape(w.shape[0], d, d)


def _solve_bucket_implicit(
    src_act: jax.Array,            # (n_src, d)
    x_biases: Optional[jax.Array],  # (n_src,) or None
    XtX: jax.Array,                # (d, d) incl. lambda ridge
    rhs_init: Optional[jax.Array],  # (d,) or None
    bucket: RowBucket,
    x_init: jax.Array,             # (B, d) warm start
    lam: jax.Array,
    g: jax.Array,                  # global bias (0 when unused)
    cfg: ALSConfig,
    sdt,
    hot_W: Optional[jax.Array] = None,   # (B, H) dense hot confidences
    V_hot: Optional[jax.Array] = None,   # (H, d) hot source factors
    hot_scale: Optional[jax.Array] = None,  # (B,) uint8 dequant scale
    hot_outer: Optional[jax.Array] = None,  # (H, d*d) sweep-invariant table
) -> Tuple[jax.Array, jax.Array]:
    """One bucket of per-entity implicit-feedback normal-equation solves.

    Math of ``als_implicit`` (reference inst/include/wrmf_implicit.hpp:91-270):
    lhs = XtX + Xg' diag(c-1) Xg,  rhs = Xg' (c - (c-1)(x_bias+g)) + rhs_init.

    With a hot/cold split (sparse/device.py ``HotBlock``) the bucket holds
    only the cold (long-tail) nnz; the head items' contributions enter as
    dense matmuls against ``hot_W``/``V_hot`` — algebraically the same
    normal equations, partitioned by item set, with zero per-nnz gathers for
    the head.
    """
    mask = bucket.mask()
    gdt = (jnp.bfloat16 if (cfg.compute_dtype == "bfloat16"
                            and sdt == jnp.float32) else sdt)
    # Gather from a shadow table pre-cast to the compute dtype (halves the
    # random-read bytes); the barrier pins the cast BEFORE the gather so XLA
    # cannot commute it back onto the gather output (which would re-read
    # f32 rows).
    src_g = jax.lax.optimization_barrier(src_act.astype(gdt))
    Xg = src_g[bucket.col_idx]                               # (B, L, d)
    c = bucket.values.astype(sdt)
    cm = jnp.where(mask, c, 0.0)
    cm1 = jnp.where(mask, c - 1.0, 0.0)

    if cfg.with_biases:
        xb = x_biases[bucket.col_idx].astype(sdt)        # (B, L)
        offs = xb + g
    elif cfg.use_global_bias:
        xb = None
        offs = g
    else:
        xb = None
        offs = None

    c_eff = cm if offs is None else cm - cm1 * offs
    rhs = jnp.einsum("bld,bl->bd", Xg, c_eff.astype(gdt),
                     preferred_element_type=sdt,
                     precision=_exact_prec(gdt))
    if rhs_init is not None:
        rhs = rhs + rhs_init[None, :]

    if hot_W is not None:
        # dense head terms (no per-nnz gathers): Wc = c (0 = absent),
        # W1 = c - 1 on present entries.  All (B, H) intermediates stay in
        # the compute dtype — the hot chain reads the whole W block, and
        # f32 copies of it would double the bytes.  With a
        # quantized block the dequant (1 mul by a per-row scalar) fuses into
        # each pass, so the passes read 1-byte codes instead of bf16.
        Vh = V_hot.astype(gdt)                           # (H, d)
        Wc = hot_W.astype(gdt)
        if hot_scale is not None:
            Wc = Wc * hot_scale[:, None].astype(gdt)
        W1 = jnp.where(Wc > 0, Wc - jnp.asarray(1.0, gdt),
                       jnp.asarray(0.0, gdt))
        ce_hot = Wc if offs is None else Wc - W1 * g.astype(gdt)
        rhs = rhs + jnp.einsum("bh,hd->bd", ce_hot, Vh,
                               preferred_element_type=sdt)

    if cfg.solver == CONJUGATE_GRADIENT:
        def matvec(p):
            t = jnp.einsum("bld,bd->bl", Xg, p.astype(gdt),
                           preferred_element_type=sdt) * cm1
            out = p @ XtX + jnp.einsum("bl,bld->bd", t.astype(gdt), Xg,
                                       preferred_element_type=sdt)
            if hot_W is not None:
                # th materializes (B, H); keep it in the compute dtype
                th = (jnp.einsum("bd,hd->bh", p.astype(gdt), Vh,
                                 preferred_element_type=sdt).astype(gdt)
                      * W1)
                out = out + jnp.einsum("bh,hd->bd", th, Vh,
                                       preferred_element_type=sdt)
            return out
        y = batched_cg(matvec, rhs, x_init.astype(sdt), cfg.cg_steps)
    else:
        Xgw = (Xg.astype(sdt) * cm1[..., None]).astype(gdt)
        lhs = XtX[None] + jnp.einsum("bld,ble->bde", Xgw, Xg,
                                     preferred_element_type=sdt,
                                     precision=_exact_prec(gdt))
        if hot_W is not None:
            # dense-head lhs term: sum_h W1[b,h] v_h v_h' — one
            # (B,H)x(H,d^2) matmul against the precomputed outer
            # products (same partition-by-column-set algebra as the CG
            # matvec, materialized; reference lhs build
            # inst/include/wrmf_implicit.hpp:206-237).  NOTE: costs
            # B*H*d^2 FLOPs regardless of head density — profitable only
            # for narrow heads, which is why n_hot="auto" keeps exact
            # solvers at 0 and explicit head sizes are honored as-is.
            lhs = lhs + _hot_lhs(W1, Vh, sdt, hot_outer)
        if cfg.solver == NNLS:
            y = batched_nnls(lhs, rhs, x_init.astype(sdt),
                             max_iter=cfg.nnls_max_iter)
        else:
            y = batched_spd_solve(lhs, rhs)

    # Per-entity loss with the NEW target factor (wrmf_implicit.hpp:257-270):
    # sum_nnz c * ((1-g) - y.x - x_bias)^2 + lambda * ||y||^2
    pred = jnp.einsum("bld,bd->bl", Xg, y.astype(gdt),
                      preferred_element_type=sdt)
    base = 1.0 - pred
    if cfg.use_global_bias:
        base = base - g
    if cfg.with_biases:
        base = base - xb
    loss = jnp.einsum("bl,bl->b", cm, base * base) + lam * jnp.sum(y * y, -1)
    if hot_W is not None:
        # loss stays f32 (pred_h error would otherwise square into the
        # convergence metric); XLA fuses the Wc cast into the reduction
        pred_h = jnp.einsum("bd,hd->bh", y.astype(gdt), Vh,
                            preferred_element_type=sdt)
        base_h = (1.0 - g) - pred_h if cfg.use_global_bias else 1.0 - pred_h
        loss = loss + jnp.einsum("bh,bh->b", Wc.astype(sdt), base_h * base_h)
    return y, loss


def _solve_bucket_explicit(
    src_act: jax.Array,
    x_biases: Optional[jax.Array],
    bucket: RowBucket,
    x_init: jax.Array,
    lam: jax.Array,
    cfg: ALSConfig,
    sdt,
    hot_W: Optional[jax.Array] = None,     # (B, H) dense hot ratings
    V_hot: Optional[jax.Array] = None,     # (H, d) hot source factors
    hot_bits: Optional[jax.Array] = None,  # (B, ceil(H/8)) presence bits
    nnz_total: Optional[jax.Array] = None,  # (B,) total row nnz (hot + cold)
    hot_outer: Optional[jax.Array] = None,  # (H, d*d) sweep-invariant table
) -> Tuple[jax.Array, jax.Array]:
    """One bucket of explicit-feedback (observed-entries-only) solves.

    Math of ``als_explicit`` (reference inst/include/wrmf_explicit.hpp:34-132):
    lhs = Xg' Xg + lambda_use I,  rhs = Xg' (r - x_bias),
    lambda_use = lambda * nnz when dynamic (wrmf_explicit.hpp:78).

    With a hot/cold split the head columns' terms are dense matmuls
    (same partition-by-column-set algebra as the implicit path).  Presence
    of an observed entry is a packed bitmask (``hot_bits``) because a 0.0
    rating is a legal observed value: zero ratings contribute nothing to the
    rhs, but their ``v v'`` term still enters the lhs matvec and the loss.
    """
    mask = bucket.mask()
    gdt = (jnp.bfloat16 if (cfg.compute_dtype == "bfloat16"
                            and sdt == jnp.float32) else sdt)
    # shadow-table cast before the gather (see the implicit path): halves
    # the random-read bytes of the hot gather and pins the cast src-side.
    # Xg itself stays unmasked — padding is killed on the small (B, L)
    # intermediates instead, so no masked copy of the gathered block is
    # ever materialized (it is the dominant HBM tensor of the sweep).
    src_g = jax.lax.optimization_barrier(src_act.astype(gdt))
    Xg = src_g[bucket.col_idx]                         # (B, L, d)
    conf = jnp.where(mask, bucket.values.astype(sdt), 0.0)
    if cfg.with_biases:
        xb = x_biases[bucket.col_idx].astype(sdt)
        conf = conf - jnp.where(mask, xb, 0.0)

    nnz = (bucket.nnz if nnz_total is None else nnz_total).astype(sdt)
    lam_use = lam * nnz if cfg.dynamic_lambda else jnp.full_like(nnz, lam)

    rhs = jnp.einsum("bld,bl->bd", Xg, conf.astype(gdt),
                     preferred_element_type=sdt,
                     precision=_exact_prec(gdt))
    if hot_W is not None:
        Vh = V_hot.astype(gdt)                         # (H, d)
        Wv = hot_W.astype(gdt)                         # ratings, absent = 0
        H = Wv.shape[1]
        if hot_bits is not None:
            from .topk import _expand_bits
            Mh = _expand_bits(hot_bits)[:, :H]         # (B, H) present
        else:
            Mh = Wv != 0            # exact when no stored-zero ratings
        # absent cells carry Wv == 0 and present zero-ratings contribute
        # nothing to the rhs either, so no presence mask is needed here
        rhs = rhs + jnp.einsum("bh,hd->bd", Wv, Vh,
                               preferred_element_type=sdt)

    if cfg.solver == CONJUGATE_GRADIENT:
        def matvec(p):
            t = jnp.einsum("bld,bd->bl", Xg, p.astype(gdt),
                           preferred_element_type=sdt)
            t = jnp.where(mask, t, 0.0)
            out = (jnp.einsum("bl,bld->bd", t.astype(gdt), Xg,
                              preferred_element_type=sdt)
                   + lam_use[:, None] * p)
            if hot_W is not None:
                th = jnp.einsum("bd,hd->bh", p.astype(gdt), Vh,
                                preferred_element_type=sdt)
                th = jnp.where(Mh, th, 0.0).astype(gdt)
                out = out + jnp.einsum("bh,hd->bd", th, Vh,
                                       preferred_element_type=sdt)
            return out
        y = batched_cg(matvec, rhs, x_init.astype(sdt), cfg.cg_steps)
    else:
        d = Xg.shape[-1]
        Xgm = jnp.where(mask[..., None], Xg, jnp.asarray(0.0, gdt))
        lhs = jnp.einsum("bld,ble->bde", Xgm, Xgm, preferred_element_type=sdt,
                         precision=_exact_prec(gdt))
        if hot_W is not None:
            # observed head cells contribute v v' with unit weight
            lhs = lhs + _hot_lhs(Mh.astype(sdt), Vh, sdt, hot_outer)
        lhs = lhs + lam_use[:, None, None] * jnp.eye(d, dtype=sdt)[None]
        # keep padding rows nonsingular (their solutions are discarded)
        invalid = (bucket.nnz == 0) & (lam_use == 0)
        lhs = lhs + invalid[:, None, None] * jnp.eye(d, dtype=sdt)[None]
        if cfg.solver == NNLS:
            y = batched_nnls(lhs, rhs, x_init.astype(sdt),
                             max_iter=cfg.nnls_max_iter)
        else:
            y = batched_spd_solve(lhs, rhs)

    pred = jnp.einsum("bld,bd->bl", Xg, y.astype(gdt),
                      preferred_element_type=sdt)
    diff = conf - jnp.where(mask, pred, 0.0)
    loss = jnp.sum(diff * diff, -1) + lam_use * jnp.sum(y * y, -1)
    if hot_W is not None:
        pred_h = jnp.einsum("bd,hd->bh", y.astype(gdt), Vh,
                            preferred_element_type=sdt)
        diff_h = jnp.where(Mh, hot_W.astype(sdt) - pred_h, 0.0)
        loss = loss + jnp.sum(diff_h * diff_h, -1)
    return y, loss


def _check_hot_supported(hot, cfg: ALSConfig):
    if hot is None:
        return
    if cfg.with_biases:
        raise NotImplementedError(
            "hot/cold split does not support per-entity biases")
    # all three solvers are supported: CG folds the head terms into the
    # matvec; Cholesky/NNLS add the dense-head normal-matrix term
    # (_hot_lhs).  Explicit feedback: presence bits exist only when the hot
    # block holds explicitly-stored zero ratings
    # (split_hot_cold(with_presence=True)); otherwise ``W != 0`` is an
    # exact presence indicator


def _sweep_prepare(src, lam, g, cfg: ALSConfig, sdt):
    """XtX Gram (+ridge for implicit) and rhs_init from the source factors."""
    R = src.shape[1]
    src_sl, _ = _active_slices(cfg, R)
    src_act = src[:, src_sl]
    d = src_act.shape[1]
    if cfg.with_biases:
        bias_col = (R - 1) if cfg.bias_last_in_source else 0
        x_biases = src[:, bias_col]
    else:
        x_biases = None

    if cfg.feedback == "implicit":
        # one small full-table Gram per sweep: always exact (f32 inputs at
        # default precision may run in TF32)
        XtX = jnp.einsum("nd,ne->de", src_act.astype(sdt),
                         src_act.astype(sdt), preferred_element_type=sdt,
                         precision=_exact_prec(sdt))
        XtX = XtX + lam * jnp.eye(d, dtype=sdt)
    else:
        # explicit feedback builds per-entity Grams from the gathered rows
        # only (wrmf_explicit.hpp:74-78) — the full-table Gram would be an
        # n_src x d^2 matmul whose value no consumer reads.  A 1x1 token
        # keeps the bucket-program signature (its dtype carries sdt).
        XtX = jnp.zeros((1, 1), sdt)

    rhs_init = None
    if cfg.feedback == "implicit":
        if cfg.with_biases:
            rhs_init = -jnp.einsum(
                "nd,n->d", src_act.astype(sdt), x_biases.astype(sdt) + g,
                preferred_element_type=sdt)
        elif cfg.use_global_bias:
            rhs_init = -g * jnp.sum(src_act.astype(sdt), axis=0)
    return src_act, x_biases, XtX, rhs_init


def _solve_one_bucket(src_act, x_biases, XtX, rhs_init, bucket, x_init,
                      lam, g, cfg: ALSConfig, sdt, hot_W=None, V_hot=None,
                      hot_bits=None, nnz_total=None, hot_scale=None,
                      hot_outer=None):
    if cfg.feedback == "implicit":
        return _solve_bucket_implicit(
            src_act, x_biases, XtX, rhs_init, bucket, x_init, lam, g, cfg,
            sdt, hot_W=hot_W, V_hot=V_hot, hot_scale=hot_scale,
            hot_outer=hot_outer)
    return _solve_bucket_explicit(src_act, x_biases, bucket, x_init, lam,
                                  cfg, sdt, hot_W=hot_W, V_hot=V_hot,
                                  hot_bits=hot_bits, nnz_total=nnz_total,
                                  hot_outer=hot_outer)


def _src_reg_loss(src, src_cnt, lam, cfg: ALSConfig, sdt):
    """Final lambda * ||learned source params||^2 term
    (wrmf_implicit.hpp:286-303, wrmf_explicit.hpp:147-172)."""
    R = src.shape[1]
    if cfg.with_biases:
        excl_sl = slice(1, R) if cfg.bias_last_in_source else slice(0, R - 1)
        X_excl = src[:, excl_sl].astype(sdt)
    else:
        X_excl = src.astype(sdt)
    if cfg.feedback == "explicit" and cfg.dynamic_lambda:
        return lam * jnp.einsum("nd,n->", X_excl * X_excl,
                                src_cnt.astype(sdt))
    return lam * jnp.sum(X_excl * X_excl)


def _assemble_target(result_act, n_tgt, cfg: ALSConfig, dtype):
    if not cfg.with_biases:
        return result_act
    ones = jnp.ones((n_tgt, 1), dtype=dtype)
    if cfg.bias_last_in_source:   # target ones col is last
        return jnp.concatenate([result_act, ones], axis=1)
    return jnp.concatenate([ones, result_act], axis=1)


def _solve_scatter(result_act, src_act, x_biases, XtX, rhs_init,
                   bucket, old_act, lam, g, n_tgt: int, cfg: ALSConfig,
                   hot=None, V_hot=None, hot_pre=None, hot_outer=None):
    """One bucket: gather warm start, solve, scatter into the result.
    Small per-shape program — compiles once per (B, L) shape and is reused
    by every same-shape chunk (donates the result buffer).

    ``hot_pre``: optional staging-time pre-gathered hot rows for this
    bucket (sparse/device.py ``hot_bucket_rows``) — skips the per-sweep
    ``W[ids]`` random gather."""
    sdt = XtX.dtype
    ids = jnp.minimum(bucket.row_ids, n_tgt - 1)
    valid = bucket.row_ids < n_tgt
    x_init = old_act[ids]
    hot_W = hot_bits = nnz_total = hot_scale = None
    if hot_pre is not None:
        hot_W, hot_bits, row_nnz, hot_scale = hot_pre
        if cfg.feedback == "explicit" and cfg.dynamic_lambda:
            nnz_total = row_nnz
        if not cfg.solve_empty:
            valid = valid & (row_nnz > 0)
    elif hot is not None:
        hot_W = hot.W[ids]
        if hot.present_bits is not None:
            hot_bits = hot.present_bits[ids]
        if hot.w_scale is not None:
            hot_scale = hot.w_scale[ids]
        if cfg.feedback == "explicit" and cfg.dynamic_lambda:
            nnz_total = hot.row_nnz[ids]
        if not cfg.solve_empty:
            # rows with zero TOTAL nnz keep the excluded-row semantics (y=0)
            valid = valid & (hot.row_nnz[ids] > 0)
    y, le = _solve_one_bucket(src_act, x_biases, XtX, rhs_init, bucket,
                              x_init, lam, g, cfg, sdt,
                              hot_W=hot_W, V_hot=V_hot,
                              hot_bits=hot_bits, nnz_total=nnz_total,
                              hot_scale=hot_scale, hot_outer=hot_outer)
    y = jnp.where(valid[:, None], y, 0.0).astype(result_act.dtype)
    loss = jnp.sum(jnp.where(valid, le, 0.0))
    return result_act.at[bucket.row_ids].set(y), loss


_jit_solve_scatter = partial(jax.jit, static_argnames=("cfg", "n_tgt"),
                             donate_argnums=(0,))(_solve_scatter)


def wrmf_sweep_streamed(
    src: jax.Array,
    tgt_old: jax.Array,
    buckets: Tuple[RowBucket, ...],
    src_cnt: Optional[jax.Array],
    lam,
    g,
    cfg: ALSConfig,
    hot=None,
    hot_rows=None,
    prepared=None,
) -> Tuple[jax.Array, jax.Array]:
    """Streaming ALS half-sweep: one small jitted program per bucket shape.

    Numerically identical to :func:`wrmf_sweep`, but the per-bucket solves
    dispatch as separate XLA programs keyed on (B, L) — compile cost is per
    *shape*, not per chunk, which matters when remote-compile latency is
    high and nnz is large.

    ``hot_rows``: optional per-bucket pre-gathered hot rows
    (sparse/device.py ``hot_bucket_rows``), aligned with ``buckets``.

    ``prepared``: optional cached :func:`_sweep_prepare` output for this
    exact (src, lam, g, cfg) — the serving path caches the Gram across
    ``transform()`` calls like the reference caches XtX after fitting
    (R/model_WRMF.R:347-353); recomputing it here costs an eager dispatch
    chain per call.
    """
    n_tgt = tgt_old.shape[0]
    R = src.shape[1]
    dtype = src.dtype
    sdt = accum_dtype(dtype)
    lam = jnp.asarray(lam, sdt)
    g = jnp.asarray(g, sdt)

    _check_hot_supported(hot, cfg)
    src_act, x_biases, XtX, rhs_init = (
        prepared if prepared is not None
        else _sweep_prepare(src, lam, g, cfg, sdt))
    _, tgt_sl = _active_slices(cfg, R)
    old_act = tgt_old[:, tgt_sl]
    d = src_act.shape[1]
    V_hot = None if hot is None else src_act[hot.hot_ids]
    # sweep-invariant dense-head outer table for the exact solvers (one
    # (H, d^2) build instead of one per bucket program)
    hot_outer = (hot_outer_table(V_hot, sdt)
                 if (V_hot is not None and cfg.solver != CONJUGATE_GRADIENT)
                 else None)
    result_act = jnp.zeros((n_tgt + 1, d), dtype=dtype)
    losses = []
    # with pre-gathered rows the full HotBlock never enters the per-bucket
    # programs (its W stays referenced only by the staging arrays)
    hot_arg = None if hot_rows is not None else hot
    for bi, bucket in enumerate(buckets):
        result_act, le = _jit_solve_scatter(
            result_act, src_act, x_biases, XtX, rhs_init, bucket, old_act,
            lam, g, n_tgt, cfg, hot_arg,
            V_hot, None if hot_rows is None else hot_rows[bi], hot_outer)
        losses.append(le)
    tgt_new = _assemble_target(result_act[:n_tgt], n_tgt, cfg, dtype)
    loss = sum(losses) + _src_reg_loss(src, src_cnt, lam, cfg, sdt)
    return tgt_new, loss


def wrmf_sweep(
    src: jax.Array,                 # (n_src, R) source factors
    tgt_old: jax.Array,             # (n_tgt, R) previous target factors
    buckets: Tuple[RowBucket, ...],  # target rows over source columns
    src_cnt: Optional[jax.Array],   # (n_src,) nnz counts (dynamic lambda loss)
    lam: jax.Array,
    g: jax.Array,
    cfg: ALSConfig,
    hot=None,                       # Optional[HotBlock]: dense zipf-head terms
    hot_rows=None,                  # optional per-bucket pre-gathered rows
) -> Tuple[jax.Array, jax.Array]:
    """One ALS half-sweep: re-solve every target entity given fixed sources.

    Returns (new target factors (n_tgt, R), summed un-normalized loss).
    Mirrors one call of ``private$solver`` in the reference fit loop
    (R/model_WRMF.R:318-338).
    """
    n_tgt = tgt_old.shape[0]
    R = src.shape[1]
    dtype = src.dtype
    sdt = accum_dtype(dtype)
    lam = jnp.asarray(lam, sdt)
    g = jnp.asarray(g, sdt)

    _check_hot_supported(hot, cfg)
    src_act, x_biases, XtX, rhs_init = _sweep_prepare(src, lam, g, cfg, sdt)
    _, tgt_sl = _active_slices(cfg, R)
    old_act = tgt_old[:, tgt_sl]
    d = src_act.shape[1]
    V_hot = None if hot is None else src_act[hot.hot_ids]
    hot_outer = (hot_outer_table(V_hot, sdt)
                 if (V_hot is not None and cfg.solver != CONJUGATE_GRADIENT)
                 else None)
    hot_arg = None if hot_rows is not None else hot
    result_act = jnp.zeros((n_tgt + 1, d), dtype=dtype)
    loss = jnp.zeros((), sdt)
    for bi, bucket in enumerate(buckets):
        result_act, le = _solve_scatter(
            result_act, src_act, x_biases, XtX, rhs_init, bucket, old_act,
            lam, g, n_tgt, cfg, hot_arg, V_hot,
            None if hot_rows is None else hot_rows[bi], hot_outer)
        loss = loss + le
    tgt_new = _assemble_target(result_act[:n_tgt], n_tgt, cfg, dtype)
    loss = loss + _src_reg_loss(src, src_cnt, lam, cfg, sdt)
    return tgt_new, loss
