"""Masked top-K retrieval: the device replacement for ``top_product``.

The reference computes one BLAS row-vector product per user and streams it
through a size-k min-heap with per-user ``not_recommend`` masking and a
global exclude set (reference src/matrix_top_product.cpp:20-102, R wrapper
``find_top_product`` R/utils.R:31-59).  Here the same result comes from a
single jitted ``lax.scan`` over user chunks: a dense matmul per chunk
(``scores = U_chunk @ V``, f32 at HIGHEST precision) followed by a masked
tournament top-k.

Masks travel as **packed bitmasks** ((users, items/8) uint8, little-endian
bit order), not as ``-inf`` scatters into the (users, items) score matrix:
the bitmask expands with three elementwise ops (shift/and/compare) that XLA
fuses directly into the tournament's single full pass over the scores — the
mask never reaches device memory as a full-size tensor.  Everything is
staged to the device once — per-chunk host round-trips would dominate
otherwise.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

NEG_INF = float(np.finfo(np.float32).min)

#: users per scanned device step.  Larger chunks amortize the tournament's
#: k sequential take rounds over more rows: on an H100 at 26,744 items the
#: masked scan ran at 40G item-scores/s with 256, 98G with 1024 and 178G
#: with 4096 users per chunk (PERF.md "Kernel decisions").
USER_CHUNK = 4096

#: the scoring product runs in full f32: the default lets XLA use TF32 on
#: the GPU, which reorders near-ties (0.3% of top-10 indices differed from
#: a float64 oracle at rank 128 on an H100; none at HIGHEST)
SCORE_PRECISION = jax.lax.Precision.HIGHEST


def _tournament_steps(sg: jax.Array, bg, k: int, gmean,
                      pre_clamped: bool = False):
    """Shared tournament engine over grouped scores.

    sg: (B, Gn, group) raw scores; bg: optional (B, Gn, group // 8) packed
    mask bits.  Builds per-group (max, argmax) tables in one fused pass,
    then runs k take/re-scan rounds.  A taken entry is killed with a single
    lexicographic threshold — ``(value, -col)`` strictly decreases along a
    group's take sequence, so comparing against the entry just taken also
    kills every earlier take from that group (no O(k) taken-list compare).
    """
    B, Gn, group = sg.shape

    def maskify(s, b):
        # masked entries read as the FINITE floor NEG_INF, not -inf: the
        # taken-entry kill writes true -inf, and the tournament's dedup
        # depends on killed entries sorting STRICTLY below everything
        # still selectable (else a fully-masked group re-picks its argmax
        # forever and rows with < k live entries return duplicates)
        live = s if pre_clamped else jnp.maximum(s + gmean, NEG_INF)
        if b is None:
            return live
        return jnp.where(_expand_bits(b), NEG_INF, live)

    m = maskify(sg, bg)                     # fused into the two reduces
    gm = jnp.max(m, axis=-1)                                  # (B, Gn)
    gi = jnp.argmax(m, axis=-1).astype(jnp.int32)
    col_ids = jnp.arange(group, dtype=jnp.int32)[None, :]
    grp_ids = jnp.arange(Gn, dtype=jnp.int32)[None, :]

    def step(carry, _):
        gm, gi = carry
        bgrp = jnp.argmax(gm, axis=-1).astype(jnp.int32)      # (B,)
        bs = jnp.take_along_axis(gm, bgrp[:, None], 1)[:, 0]
        bloc = jnp.take_along_axis(gi, bgrp[:, None], 1)[:, 0]
        bi = bgrp * group + bloc
        row_s = jnp.take_along_axis(sg, bgrp[:, None, None], 1)[:, 0]
        row_b = None if bg is None else \
            jnp.take_along_axis(bg, bgrp[:, None, None], 1)[:, 0]
        row = maskify(row_s, row_b)                           # (B, group)
        dead = (row > bs[:, None]) | ((row == bs[:, None])
                                      & (col_ids <= bloc[:, None]))
        row = jnp.where(dead, -jnp.inf, row)
        onehot = grp_ids == bgrp[:, None]
        gm = jnp.where(onehot, jnp.max(row, axis=-1)[:, None], gm)
        gi = jnp.where(onehot,
                       jnp.argmax(row, axis=-1).astype(jnp.int32)[:, None],
                       gi)
        return (gm, gi), (bs, bi)

    _, (ss, ii) = jax.lax.scan(step, (gm, gi), None, length=k)
    return ss.T, ii.T.astype(jnp.int32)


def exact_top_k_tournament(scores: jax.Array, k: int, group: int = 256):
    """Exact top-k as a tournament with replacement: one full pass builds
    per-group (max, argmax) tables, then k cheap iterations each pick the
    globally best group, re-scan only that group's ``group`` values with
    already-taken entries masked, and update the tables.

    The formulation reads the score matrix once plus k tiny gathers.  On
    an H100 it was 6.5x faster than masked scores plus ``lax.top_k``
    (32,768 users in chunks of 4,096, 26,744 items, k=10), with identical
    indices (PERF.md "Kernel decisions").  Ties resolve to the lowest
    index, matching stable ``lax.top_k``.  ``group`` (256) is carried over
    from an earlier chip and not tuned on the H100.

    Taken entries are killed by a single lexicographic threshold against
    the entry just taken — a group's take sequence is strictly decreasing
    in (value, -col) order, so every earlier take from the same group
    compares above the current one and one (value, col) pair per step
    suffices (no O(k) taken-list compare).
    """
    n = scores.shape[-1]
    if n <= max(2 * group, 2 * k) or scores.ndim != 2:
        s, i = jax.lax.top_k(scores, k)
        return s, i.astype(jnp.int32)
    B = scores.shape[0]
    Gn = -(-n // group)
    pad = Gn * group - n
    # live values are clamped to >= NEG_INF (finfo.min) so that the true
    # -inf used for taken/padding entries is STRICTLY below every live
    # value — otherwise a taken entry could be re-selected when a group's
    # remaining values tie with the dead sentinel (duplicate indices)
    scores = jnp.maximum(scores, NEG_INF)
    if pad:
        scores = jnp.concatenate(
            [scores, jnp.full((B, pad), -jnp.inf, scores.dtype)], axis=-1)
    sg = scores.reshape(B, Gn, group)
    return _tournament_steps(sg, None, k, jnp.asarray(0.0, scores.dtype),
                             pre_clamped=True)


def _expand_bits(bits: jax.Array) -> jax.Array:
    """(..., m) uint8 -> (..., m*8) bool, little-endian bit order (bit ``t``
    of byte ``j`` guards column ``j*8 + t``, matching
    ``np.packbits(..., bitorder="little")``)."""
    t = jnp.arange(8, dtype=jnp.uint8)
    e = (bits[..., None] >> t) & jnp.uint8(1)
    return e.reshape(bits.shape[:-1] + (bits.shape[-1] * 8,)) != 0


def masked_top_k_bits(scores: jax.Array, bits: jax.Array, k: int,
                      glob_mean=0.0, group: int = 256):
    """Exact top-k of ``scores + glob_mean`` with a packed boolean mask.

    scores: (B, n) raw (un-shifted, un-masked) scores; bits: (B, n // 8)
    uint8 with 1-bits marking masked-out columns.  ``n`` must be a multiple
    of ``group`` (pad the *score source* — e.g. the item factor matrix —
    with zero columns and set their mask bits; padding the score matrix here
    would cost a full copy pass).

    Same tournament structure as :func:`exact_top_k_tournament`, but the
    mask is applied lazily: the bit expansion fuses into the one full pass
    that builds the per-group (max, argmax) tables and into the k per-group
    re-scans.  Masked entries read as the finite floor ``NEG_INF``
    (= float32 min, the same value the reference writes over masked
    scores); rows with fewer than k live entries fill the tail with
    NEG_INF-scored but still DISTINCT indices (taken entries are killed to
    true -inf, strictly below the floor).
    """
    B, n = scores.shape
    if group % 8 or n % group:
        raise ValueError(f"n={n} must be a multiple of group={group} "
                         "(and group of 8)")
    if bits.shape != (B, n // 8):
        raise ValueError(f"bits shape {bits.shape} != {(B, n // 8)}")
    gmean = jnp.asarray(glob_mean, scores.dtype)

    if n <= max(2 * group, 2 * k):
        masked = jnp.where(_expand_bits(bits), NEG_INF,
                           jnp.maximum(scores + gmean, NEG_INF))
        s, i = jax.lax.top_k(masked, k)
        return s, i.astype(jnp.int32)

    Gn = n // group
    return _tournament_steps(scores.reshape(B, Gn, group),
                             bits.reshape(B, Gn, group // 8), k, gmean)


def pack_mask_bits(
    n_cols_padded: int,
    dense_rows: Optional[np.ndarray] = None,
    csr: Optional[sp.spmatrix] = None,
    rows: Optional[slice] = None,
    exclude_mask: Optional[np.ndarray] = None,
    n_rows: Optional[int] = None,
) -> np.ndarray:
    """Host-side packed-bitmask builder for :func:`masked_top_k_bits`.

    Combines (a) per-row masked columns from a CSR slice, (b) a global
    column exclude mask, and (c) dead bits for padding columns beyond the
    true item count, into a (n_rows, n_cols_padded // 8) uint8 array."""
    if dense_rows is not None:
        dense = dense_rows
        n_rows = dense.shape[0]
        if dense.shape[1] < n_cols_padded:
            pad = np.ones((n_rows, n_cols_padded - dense.shape[1]), bool)
            dense = np.concatenate([dense, pad], axis=1)
    else:
        dense = np.zeros((n_rows, n_cols_padded), bool)
        n_true = n_cols_padded
        if exclude_mask is not None:
            n_true = len(exclude_mask)
            dense[:, :n_true] = exclude_mask[None, :]
        if csr is not None:
            n_true = csr.shape[1]
            sub = csr[rows] if rows is not None else csr
            coo = sub.tocoo()
            dense[coo.row, coo.col] = True
        dense[:, n_true:] = True
    return np.packbits(dense, axis=1, bitorder="little")


@partial(jax.jit, static_argnames=("k",))
def _topk_scan(x, y, bits, glob_mean, k: int):
    """x: (n_chunks, C, R); y: (R, n_pad); bits: (n_chunks, C, n_pad // 8)
    packed mask (per-user not_recommend | global exclude | padding columns).
    Returns ((n_chunks, C, k) scores, idx)."""

    def chunk(_, args):
        xc, bc = args
        scores = jnp.dot(xc, y, preferred_element_type=jnp.float32,
                         precision=SCORE_PRECISION)
        ts, ti = masked_top_k_bits(scores, bc, k, glob_mean=glob_mean)
        return None, (ts, ti)

    _, (ts, ti) = jax.lax.scan(chunk, None, (x, bits))
    return ts, ti


@partial(jax.jit, static_argnames=("k",))
def _topk_scan_nomask(x, y, glob_mean, k: int):
    """Mask-free variant over the true (unpadded) item axis."""

    def chunk(_, xc):
        scores = jnp.dot(xc, y, preferred_element_type=jnp.float32,
                         precision=SCORE_PRECISION)
        ts, ti = exact_top_k_tournament(scores + glob_mean, k)
        return None, (ts, ti)

    _, (ts, ti) = jax.lax.scan(chunk, None, x)
    return ts, ti


def top_product(
    x,
    y,
    k: int,
    not_recommend: Optional[sp.spmatrix] = None,
    exclude: Optional[np.ndarray] = None,
    glob_mean: float = 0.0,
    user_chunk: int = USER_CHUNK,
) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k items by score ``x @ y + glob_mean`` with masking.

    x: (n_users, R) user embeddings; y: (R, n_items) item embeddings.
    Returns (indices (n_users, k) int32 0-based, scores (n_users, k)).
    Same contract as the reference ``top_product``
    (src/matrix_top_product.cpp:20-102) minus R's 1-based indexing.

    ``user_chunk``: rows per scanned device step (see ``USER_CHUNK``).
    """
    x_dev = isinstance(x, jax.Array)
    y_dev = isinstance(y, jax.Array)
    if not x_dev:
        x = np.asarray(x, np.float32)
    if not y_dev:
        y = np.asarray(y)     # accept any array-like (no dtype copy yet)
    n_users, n_items = x.shape[0], y.shape[1]
    if k > n_items:
        raise ValueError(f"k={k} > n_items={n_items}")
    if n_users == 0:
        return (np.empty((0, k), np.int32), np.empty((0, k), np.float32))

    exclude_mask = None
    if exclude is not None and len(exclude) > 0:
        exclude = np.asarray(exclude)
        if exclude.max() >= n_items or exclude.min() < 0:
            raise ValueError(
                "items_exclude indices must be in [0, number of items)")
        exclude_mask = np.zeros((n_items,), bool)
        exclude_mask[exclude] = True

    nr = None
    if not_recommend is not None:
        nr = sp.csr_matrix(not_recommend)
        if nr.shape != (n_users, n_items):
            raise ValueError("not_recommend shape mismatch")
        if nr.nnz == 0:
            nr = None

    C = min(user_chunk, max(n_users, 8))
    n_chunks = -(-n_users // C)
    if x_dev:
        # query embeddings usually come straight from transform(): keep
        # them on the device instead of a host round-trip
        xs = jnp.pad(x.astype(jnp.float32),
                     ((0, n_chunks * C - n_users), (0, 0))
                     ).reshape(n_chunks, C, x.shape[1])
    else:
        xs_np = np.zeros((n_chunks, C, x.shape[1]), np.float32)
        for ci, s in enumerate(range(0, n_users, C)):
            e = min(s + C, n_users)
            xs_np[ci, : e - s] = x[s:e]
        xs = jnp.asarray(xs_np)

    group = 256
    masked = nr is not None or exclude_mask is not None
    n_pad = -(-n_items // group) * group if masked else n_items

    def stage_y():
        if y_dev:
            yj = y.astype(jnp.float32)
            if n_pad > n_items:
                yj = jnp.pad(yj, ((0, 0), (0, n_pad - n_items)))
            return yj
        yn = np.asarray(y, np.float32)
        if n_pad > n_items:
            yn = np.concatenate(
                [yn, np.zeros((yn.shape[0], n_pad - n_items), yn.dtype)], 1)
        return jnp.asarray(yn)

    if not y_dev:
        # item factors are typically fixed across predict calls: cache the
        # staged copy (content-addressed).
        # Fingerprint WITHOUT forcing a contiguous copy — components is
        # usually an F-contiguous transpose view of the (n_items, R) factor
        # table, and ascontiguousarray would copy it on every predict call.
        import zlib
        if y.flags.c_contiguous:
            fp = zlib.adler32(y)
        elif y.flags.f_contiguous:
            fp = zlib.adler32(y.T) ^ 0x5F5F
        else:
            fp = zlib.adler32(np.ascontiguousarray(y))
        from ..sparse.device import staged_cached
        ykey = (y.shape, n_pad, str(y.dtype), fp)
        y_staged = staged_cached("topk_y", sp.csr_matrix((1, 1)), stage_y,
                                 extra=ykey)
    else:
        y_staged = stage_y()

    if not masked:
        ts, ti = _topk_scan_nomask(xs, y_staged, jnp.float32(glob_mean), k)
    else:
        def stage_bits():
            bits = np.empty((n_chunks, C, n_pad // 8), np.uint8)
            for ci, s in enumerate(range(0, n_users, C)):
                e = min(s + C, n_users)
                b = pack_mask_bits(n_pad, csr=nr, rows=slice(s, e),
                                   exclude_mask=exclude_mask, n_rows=e - s)
                bits[ci, : e - s] = b
                bits[ci, e - s:] = 0
            return jnp.asarray(bits)

        if nr is not None:
            # masks are usually the (static) training interactions: cache
            # the packed bitmask staging across predict calls
            from ..sparse.device import staged_cached
            ekey = None if exclude_mask is None else exclude_mask.tobytes()
            bits_d = staged_cached("topk_bits", nr, stage_bits,
                                   extra=(n_pad, C, ekey))
        else:
            bits_d = stage_bits()
        ts, ti = _topk_scan(xs, y_staged, bits_d, jnp.float32(glob_mean), k)
    ts = np.asarray(ts).reshape(n_chunks * C, k)[:n_users]
    ti = np.asarray(ti).reshape(n_chunks * C, k)[:n_users]
    return ti, ts
