"""Device-resident sparse containers.

The reference's substrate is a zero-copy ``MappedCSR``/``MappedCSC`` view over
host memory (reference inst/include/mapped_csr.hpp:9-36, mapped_csc.hpp:9-29)
whose rows are walked by dynamically-scheduled OpenMP threads.  The device
replacement is a *bucketed, padded* row container: rows are grouped by
nnz-bucket (power-of-two padded lengths) so that every bucket is a dense
``(B, L)`` block of column indices and values — static shapes that XLA can
tile onto the matrix units, with per-row masks recovering exact sparse semantics.
Bucketing by nnz is the batched answer to ``schedule(dynamic)`` load balancing
(reference inst/include/wrmf_implicit.hpp:162-174): no wasted FLOPs on
wildly-mismatched row lengths, no dynamic shapes.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp


class RowBucket(NamedTuple):
    """One padded bucket of sparse rows (a pytree of device arrays).

    ``row_ids[b]`` is the original row index of batch entry ``b``; padding
    entries use ``row_id == n_rows`` (a dummy slot sliced off after scatter).
    ``col_idx`` padding points at column 0 and is neutralized by masks derived
    from ``nnz``.
    """

    row_ids: jax.Array  # (B,)   int32
    col_idx: jax.Array  # (B, L) int32
    values: jax.Array   # (B, L) float
    nnz: jax.Array      # (B,)   int32

    @property
    def batch(self) -> int:
        return self.row_ids.shape[0]

    @property
    def pad_len(self) -> int:
        return self.col_idx.shape[1]

    def mask(self) -> jax.Array:
        """(B, L) validity mask."""
        iota = jax.lax.broadcasted_iota(jnp.int32, self.col_idx.shape, 1)
        return iota < self.nnz[:, None]


@dataclass(frozen=True)
class BucketedRows:
    """A sparse matrix as a list of padded row buckets, ready for batched
    per-row solves.  Replaces the reference's per-column OpenMP loop over a
    ``MappedCSC`` (inst/include/wrmf_implicit.hpp:175-184)."""

    buckets: Tuple[RowBucket, ...]
    n_rows: int
    n_cols: int
    nnz: int
    #: row indices with zero nnz (handled outside the buckets unless
    #: ``include_empty`` was set at construction)
    empty_rows: np.ndarray

    @property
    def shapes(self) -> List[Tuple[int, int]]:
        return [(b.batch, b.pad_len) for b in self.buckets]


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _length_grid(min_len: int, max_len: int, ratio: float,
                 quantum: int = 8) -> np.ndarray:
    """Geometric grid of padded row lengths: each step grows by ``ratio``
    (rounded up to ``quantum``; lengths past 256 snap to multiples of 32,
    which bounds the number of distinct L values).  ``ratio=2`` reproduces
    power-of-two bucketing; the default 1.25 cuts average padding waste from
    ~1.4x to ~1.1x at the cost of more distinct (B, L) program shapes
    (amortized by the persistent compilation cache)."""
    g = [min_len]
    while g[-1] < max_len:
        nxt = max(int(g[-1] * ratio), g[-1] + quantum)
        q = quantum if nxt <= 256 else max(quantum, 32)
        g.append(_round_up(nxt, q))
    return np.asarray(g, dtype=np.int64)


def bucket_rows(
    x: sp.spmatrix,
    dtype=jnp.float32,
    *,
    min_len: int = 8,
    row_align: int = 32,
    max_buckets: int = 24,
    length_ratio: float = 1.25,
    include_empty: bool = False,
    max_elems: Optional[int] = 1 << 22,
    host_out: Optional[list] = None,
) -> BucketedRows:
    """Build a :class:`BucketedRows` from a scipy sparse matrix.

    ``host_out``: optional list; when given, the HOST-side
    ``(col_idx, nnz, values)`` numpy arrays of each bucket are appended to
    it (in bucket order) before device transfer — consumers like the
    column scheduler (ops/segsum.py) need them without paying a
    device->host readback.

    Rows are grouped by padded length from a geometric grid with step
    ``length_ratio`` (2.0 = classic power-of-two); the number of distinct
    bucket lengths is capped at ``max_buckets`` by merging the
    least-populated lengths upward, bounding the number of distinct XLA
    compilations while keeping padding waste geometric.  Buckets whose
    ``B * L`` footprint exceeds ``max_elems`` are split into batch chunks so
    the gathered ``(B, L, rank)`` factor blocks stay within device memory.
    """
    csr = sp.csr_matrix(x)
    csr.sort_indices()
    n_rows, n_cols = csr.shape
    row_nnz = np.diff(csr.indptr).astype(np.int64)

    empty = np.flatnonzero(row_nnz == 0).astype(np.int32)
    if include_empty:
        active = np.arange(n_rows, dtype=np.int64)
    else:
        active = np.flatnonzero(row_nnz > 0).astype(np.int64)

    if active.size == 0:
        return BucketedRows((), n_rows, n_cols, int(csr.nnz), empty)

    act_nnz = np.maximum(row_nnz[active], 1)
    grid = _length_grid(min_len, int(act_nnz.max()), length_ratio)
    lengths = grid[np.searchsorted(grid, act_nnz)]

    # Cap the number of distinct bucket lengths: repeatedly merge the
    # smallest-population length into the next larger one.
    uniq, counts = np.unique(lengths, return_counts=True)
    while len(uniq) > max_buckets:
        k = int(np.argmin(counts[:-1]))  # never merge the largest upward-less
        lengths[lengths == uniq[k]] = uniq[k + 1]
        uniq, counts = np.unique(lengths, return_counts=True)

    np_val_dtype = np.float64 if jnp.dtype(dtype) == jnp.float64 else np.float32

    buckets: List[RowBucket] = []
    for L in uniq:
        L = int(L)
        rows_all = active[lengths == L]
        if max_elems is not None:
            chunk_rows = max(_round_up(max(max_elems // L, 1), row_align),
                             row_align)
        else:
            chunk_rows = len(rows_all)
        for s in range(0, len(rows_all), chunk_rows):
            rows = rows_all[s:s + chunk_rows]
            B = _round_up(len(rows), row_align)
            native_out = None
            if csr.nnz:
                from ..native import fill_bucket
                native_out = fill_bucket(csr.indptr, csr.indices, csr.data,
                                         rows, B, L, n_rows, np_val_dtype)
            if native_out is not None:
                col_idx, values, nnz_arr, row_ids = native_out
            else:
                # numpy fallback: vectorized padded gather of CSR segments
                nnz_arr = np.zeros((B,), dtype=np.int32)
                nnz_arr[: len(rows)] = row_nnz[rows]
                row_ids = np.full((B,), n_rows, dtype=np.int32)
                row_ids[: len(rows)] = rows
                starts = np.zeros((B,), dtype=np.int64)
                starts[: len(rows)] = csr.indptr[rows]
                offs = np.arange(L, dtype=np.int64)[None, :]
                flat = np.minimum(starts[:, None] + offs,
                                  max(csr.nnz - 1, 0))
                valid = offs < nnz_arr[:, None]
                if csr.nnz:
                    col_idx = np.where(valid, csr.indices[flat],
                                       0).astype(np.int32)
                    values = np.where(valid, csr.data[flat],
                                      0).astype(np_val_dtype)
                else:
                    col_idx = np.zeros((B, L), np.int32)
                    values = np.zeros((B, L), np_val_dtype)
            if host_out is not None:
                host_out.append((col_idx, nnz_arr, values))
            buckets.append(RowBucket(
                row_ids=jnp.asarray(row_ids),
                col_idx=jnp.asarray(col_idx),
                values=jnp.asarray(values, dtype=dtype),
                nnz=jnp.asarray(nnz_arr),
            ))

    return BucketedRows(tuple(buckets), n_rows, n_cols, int(csr.nnz), empty)


class COOBatch(NamedTuple):
    """Padded COO triplet shards for SGD-family models (GloVe etc.).

    Replaces the reference's raw triplet loop (src/GloVe.cpp:91-156)."""

    rows: jax.Array  # (N,) int32
    cols: jax.Array  # (N,) int32
    vals: jax.Array  # (N,) float
    valid: jax.Array  # (N,) bool


def coo_batches(
    x: sp.spmatrix, dtype=jnp.float32, *, batch_size: int = 1 << 16,
    shuffle: Optional[np.random.Generator] = None,
) -> List[COOBatch]:
    """Split a sparse matrix's triplets into fixed-size padded COO batches."""
    coo = sp.coo_matrix(x)
    n = coo.nnz
    order = np.arange(n)
    if shuffle is not None:
        shuffle.shuffle(order)
    np_val = np.float64 if jnp.dtype(dtype) == jnp.float64 else np.float32
    out = []
    for s in range(0, n, batch_size):
        e = min(s + batch_size, n)
        m = e - s
        idx = order[s:e]
        rows = np.zeros((batch_size,), np.int32)
        cols = np.zeros((batch_size,), np.int32)
        vals = np.zeros((batch_size,), np_val)
        valid = np.zeros((batch_size,), bool)
        rows[:m] = coo.row[idx]
        cols[:m] = coo.col[idx]
        vals[:m] = coo.data[idx]
        valid[:m] = True
        out.append(COOBatch(jnp.asarray(rows), jnp.asarray(cols),
                            jnp.asarray(vals, dtype=dtype), jnp.asarray(valid)))
    return out


class HotBlock(NamedTuple):
    """Dense block for the hottest columns (zipf head).

    The per-nnz gather is row-fetch-bound, so every nnz that lands on a popular column pays the same
    fetch as a rare one.  For the head of the popularity distribution it is
    far cheaper to store the interaction weights *densely* (rows x n_hot)
    and run the ALS normal-equation terms as plain matmuls against the
    n_hot gathered factor rows — zero per-nnz gathers.  The long tail stays
    on the bucketed-gather path.  ``W[r, j] = c`` for column ``hot_ids[j]``
    (0 = absent; implicit confidences are >= 1 so 0 is unambiguous).

    For explicit feedback a 0 *rating* is a legal observed value (e.g. after
    global-mean centering), so presence is carried separately as a packed
    bitmask ``present_bits`` ((n_rows, ceil(H/8)) uint8, little-endian; the
    bit-expand is three elementwise ops fused into the consumer).

    With ``w_dtype=jnp.uint8`` the block is stored *quantized*: ``W`` holds
    uint8 codes (0 = absent, present entries in 1..255) and ``w_scale`` the
    per-row dequantization scale, ``confidence = code * w_scale[row]``.  The
    1-byte codes halve the W block's HBM footprint and per-pass read traffic
    vs bfloat16.  Quantization error per confidence is below ``w_scale``
    always, and at most ``w_scale / 2`` for values >= ``w_scale / 2`` —
    values smaller than half a code unit round UP to code 1 to preserve
    presence (0 must remain the absence sentinel), so rows whose confidence
    spread exceeds ~510x over-weight their smallest hot entries.  Non-exact,
    opt-in; requires strictly positive values (implicit feedback).
    """

    hot_ids: jax.Array        # (H,) int32 original column ids
    W: jax.Array              # (n_rows, H) confidence/rating, 0 = absent
    row_nnz: jax.Array        # (n_rows,) int32 TOTAL row nnz (hot + cold)
    present_bits: Optional[jax.Array] = None   # (n_rows, ceil(H/8)) uint8
    w_scale: Optional[jax.Array] = None        # (n_rows,) f32 dequant scale


def split_hot_cold(
    x: sp.spmatrix,
    n_hot: int,
    dtype=jnp.float32,
    w_dtype=None,
    with_presence: bool = False,
    device_build: bool = True,
) -> Tuple[Optional[HotBlock], sp.csr_matrix]:
    """Split columns into a dense hot block + a cold remainder CSR.

    Returns ``(HotBlock | None, cold_csr)`` — the cold matrix keeps the
    original shape and column ids (hot entries removed structurally, so
    explicitly-stored zero values elsewhere survive), and bucketed solves
    are unchanged; the hot block adds dense rhs/matvec/loss terms.

    Explicit-feedback callers MUST pass ``with_presence=True``: a stored
    0.0 rating is a legal observed value there, and without presence bits
    the consumers fall back to ``W != 0`` and silently treat it as absent
    (bits are only materialized when stored zeros actually land in the hot
    block, so the flag costs nothing otherwise).
    """
    csr = sp.csr_matrix(x)
    n_rows, n_cols = csr.shape
    n_hot = int(min(n_hot, n_cols))
    if n_hot <= 0 or csr.nnz == 0:
        return None, csr
    col_counts = np.bincount(csr.indices, minlength=n_cols)
    hot_ids = np.sort(np.argsort(-col_counts, kind="stable")[:n_hot]
                      .astype(np.int32))
    row_nnz_total = np.diff(csr.indptr).astype(np.int32)

    hot_pos = np.full((n_cols,), -1, np.int32)
    hot_pos[hot_ids] = np.arange(n_hot, dtype=np.int32)
    is_hot = hot_pos[csr.indices] >= 0

    rows_all = np.repeat(np.arange(n_rows, dtype=np.int64),
                         np.diff(csr.indptr))
    rows = rows_all[is_hot]
    hot_cols = hot_pos[csr.indices[is_hot]]
    hot_data = csr.data[is_hot]
    eff = dtype if (w_dtype is not None
                    and jnp.dtype(w_dtype) == jnp.uint8) else (w_dtype or dtype)
    np_w = np.float64 if eff == jnp.float64 else np.float32

    present_bits = None
    if with_presence and (hot_data == 0).any():
        # presence bits are only physically needed when the hot block holds
        # explicitly-stored ZERO values (``W != 0`` is exact otherwise)
        present = np.zeros((n_rows, -(-n_hot // 8) * 8), bool)
        present[rows, hot_cols] = True
        present_bits = jnp.asarray(
            np.packbits(present, axis=1, bitorder="little"))

    # structural removal of the hot entries (not eliminate_zeros, which
    # would also drop genuine explicitly-stored zero values in the tail)
    keep = ~is_hot
    cold_indptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(np.bincount(rows_all[keep], minlength=n_rows),
              out=cold_indptr[1:])
    cold = sp.csr_matrix(
        (csr.data[keep], csr.indices[keep], cold_indptr), shape=csr.shape)

    w_dtype = w_dtype or dtype
    w_scale = None
    scatter_vals = hot_data.astype(np_w)
    if jnp.dtype(w_dtype) == jnp.uint8:
        # per-row affine-free quantization: code = round(v / s) in 1..255,
        # s = rowmax / 255.  0 stays the absence sentinel, so values must be
        # strictly positive (implicit confidences are; reference semantics
        # reject negatives there too, R/model_WRMF.R preprocess contract)
        if with_presence or (hot_data <= 0).any():
            raise ValueError(
                "uint8 hot block requires strictly positive values "
                "(implicit-feedback confidences)")
        wmax = np.zeros((n_rows,), np_w)
        np.maximum.at(wmax, rows, scatter_vals)
        s = np.where(wmax > 0, wmax / 255.0, 1.0).astype(np_w)
        scatter_vals = np.clip(np.rint(scatter_vals / s[rows]),
                               1, 255).astype(np.uint8)
        # scale dtype follows the solve dtype so exactly-representable
        # confidences dequantize exactly (code * scale == value)
        w_scale = jnp.asarray(s, dtype=dtype)

    if device_build:
        # build the dense W on device from the hot COO triplets: ~10 B/nnz
        # over the wire instead of the full (n_rows, H) block (512 MB+ at
        # bench scale), and no dense host intermediate at all
        W = _scatter_hot_block(
            jnp.asarray(rows.astype(np.int32)),
            jnp.asarray(hot_cols.astype(np.int32)),
            jnp.asarray(scatter_vals), n_rows, n_hot, str(jnp.dtype(w_dtype)))
    else:
        Wh = np.zeros((n_rows, n_hot), scatter_vals.dtype)
        Wh[rows, hot_cols] = scatter_vals
        W = jnp.asarray(Wh, w_dtype)
    blk = HotBlock(hot_ids=jnp.asarray(hot_ids),
                   W=W,
                   row_nnz=jnp.asarray(row_nnz_total),
                   present_bits=present_bits,
                   w_scale=w_scale)
    return blk, cold


@partial(jax.jit, static_argnums=(3, 4, 5))
def _scatter_hot_block(rows, cols, vals, n_rows: int, n_hot: int,
                       w_dtype: str):
    W = jnp.zeros((n_rows, n_hot), jnp.dtype(w_dtype))
    return W.at[rows, cols].set(vals.astype(W.dtype), mode="drop",
                                unique_indices=True)


def hot_bucket_rows(hot: Optional[HotBlock], buckets, n_tgt: int):
    """Pre-gather the hot block's per-bucket rows once at staging time.

    Bucket membership and order are fixed for the whole fit, but the sweep
    re-gathers ``W[bucket.row_ids]`` on every bucket of every sweep — a
    full-matrix random gather (~4.2 ms for the 512 MB bench block,
    PERF.md).  Doing the permutation once here turns every per-sweep
    access into a free contiguous block.

    Returns a tuple aligned with ``buckets``; each entry is
    ``(W_rows (B, H), bits_rows | None, nnz_rows (B,), scale_rows | None)``.
    """
    if hot is None:
        return None
    # one jitted program for ALL buckets: per-bucket eager gathers each pay
    # a full dispatch round-trip
    return _gather_hot_rows(hot.W, hot.present_bits, hot.row_nnz,
                            hot.w_scale, tuple(b.row_ids for b in buckets))


@jax.jit
def _gather_hot_rows(W, bits, row_nnz, scale, row_ids_tuple):
    out = []
    for rid in row_ids_tuple:
        ids = jnp.minimum(rid, W.shape[0] - 1)
        out.append((W[ids], None if bits is None else bits[ids],
                    row_nnz[ids], None if scale is None else scale[ids]))
    return tuple(out)


# -- staged-bucket cache ------------------------------------------------------

_BUCKET_CACHE: dict = {}
# sized so one RankMF partial_fit (3 entries) + FTRL/FM/GloVe staged
# buckets coexist without thrashing each other out of the LRU
_BUCKET_CACHE_MAX = 10


def clear_staging_cache() -> int:
    """Drop every cached staged device array (buckets, top-k item factors,
    packed bitmasks), releasing their HBM.  The LRU otherwise keeps up to
    ``_BUCKET_CACHE_MAX`` entries alive for the process lifetime, which can
    pin multi-GB buffers from past models.  Returns the number of entries
    dropped."""
    n = len(_BUCKET_CACHE)
    _BUCKET_CACHE.clear()
    return n


def _csr_fingerprint(csr: sp.csr_matrix) -> tuple:
    """Cheap content fingerprint of a CSR matrix (adler32 of the three
    constituent arrays) — a few ms, vs. ~seconds to restage the device
    buckets through a slow host->device link."""
    import zlib
    return (csr.shape, csr.nnz,
            zlib.adler32(np.ascontiguousarray(csr.data)),
            zlib.adler32(np.ascontiguousarray(csr.indices)),
            zlib.adler32(np.ascontiguousarray(csr.indptr)))


def staged_aux_cached(tag: str, fingerprint, build, extra=None):
    """Staging cache keyed by an arbitrary (hashable) content fingerprint
    — for pass-invariant device arrays that are not derived from a CSR
    matrix alone (per-bucket label gathers, masks, ...).  Shares the LRU
    with :func:`bucket_rows_cached`."""
    key = (tag, extra, fingerprint)
    hit = _BUCKET_CACHE.pop(key, None)
    if hit is None:
        hit = build()
    _BUCKET_CACHE[key] = hit                   # re-insert: LRU order
    while len(_BUCKET_CACHE) > _BUCKET_CACHE_MAX:
        _BUCKET_CACHE.pop(next(iter(_BUCKET_CACHE)))
    return hit


def staged_cached(tag: str, csr: sp.csr_matrix, build, extra=None):
    """Generic content-addressed staging cache.

    ``build()`` produces device arrays derived from ``csr``; repeated
    partial_fit calls on the same matrix then skip host->device re-staging
    (a host->device copy per call).  Shares
    the LRU with :func:`bucket_rows_cached`.  ``extra`` must carry every
    non-``csr`` input that shapes the built arrays (dtype, padding
    options, ...) — two models differing only in precision must not share
    an entry."""
    return staged_aux_cached(tag, _csr_fingerprint(csr), build, extra)


def bucket_rows_cached(x: sp.spmatrix, dtype=jnp.float32,
                       **kwargs) -> BucketedRows:
    """:func:`bucket_rows` with a small content-addressed cache.

    Online models (FTRL / FM / GloVe epochs) call partial_fit repeatedly on
    the same matrix; without the cache every call re-buckets on the host
    and re-stages ~8 B/nnz to the device.  Keyed by content fingerprint, so
    in-place mutation of the caller's arrays is detected."""
    csr = sp.csr_matrix(x)
    key = (_csr_fingerprint(csr), str(jnp.dtype(dtype)),
           tuple(sorted(kwargs.items())))
    hit = _BUCKET_CACHE.pop(key, None)
    if hit is None:
        hit = bucket_rows(csr, dtype, **kwargs)
    _BUCKET_CACHE[key] = hit                   # re-insert: LRU order
    while len(_BUCKET_CACHE) > _BUCKET_CACHE_MAX:
        _BUCKET_CACHE.pop(next(iter(_BUCKET_CACHE)))
    return hit
