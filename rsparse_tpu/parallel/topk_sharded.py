"""Item-axis-sharded top-k retrieval.

The reference streams a per-user min-heap over the full item axis
(src/matrix_top_product.cpp:61-97).  At pod scale the item axis is the long
axis (SURVEY §5): here items are sharded across the mesh, every device
computes a fused dot+mask+top-k over its item shard, and only the O(k)
candidates per user cross the wire — an all-gather of (k, score) pairs
followed by a final top-k merge.  This is the MF counterpart of
ring/Ulysses-style sequence sharding: partition the long axis, exchange
only per-shard summaries.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from rsparse_tpu.ops.topk import (SCORE_PRECISION, USER_CHUNK,
                                  exact_top_k_tournament, masked_top_k_bits,
                                  pack_mask_bits, _expand_bits)

NEG_INF = float(np.finfo(np.float32).min)


def sharded_top_product(
    mesh: Mesh,
    x,
    y,
    k: int,
    not_recommend: Optional[sp.spmatrix] = None,
    exclude: Optional[np.ndarray] = None,
    glob_mean: float = 0.0,
    axis: str = "data",
    user_chunk: int = 4096,
) -> Tuple[np.ndarray, np.ndarray]:
    """Mesh-path drop-in for ``ops.topk.top_product``.

    Same contract as the single-device retrieval kernel (reference
    ``top_product`` src/matrix_top_product.cpp:20-102): top-k of
    ``x @ y + glob_mean`` with per-user ``not_recommend`` and global
    ``exclude`` masking — but the item axis is sharded over the mesh's
    ``axis``: item factors live column-sharded, masks travel as packed
    bitmasks sharded by item range, and only O(k) candidates per user
    cross the interconnect (:func:`sharded_top_k`).

    Items are padded to a per-shard multiple of 256 (dead mask bits), so
    the per-shard pass always runs the fused tournament.
    """
    n_dev = mesh.shape[axis]
    x = np.asarray(x, np.float32)     # gathers device shards if needed
    y = np.asarray(y, np.float32)
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

    # pad items so every shard is a multiple of 256 (fused tournament) and
    # padding columns are masked dead
    n_pad = -(-n_items // (256 * n_dev)) * 256 * n_dev
    if k > n_pad // n_dev:
        raise ValueError(f"k={k} > items-per-shard={n_pad // n_dev}")
    yp = y if n_pad == n_items else np.concatenate(
        [y, np.zeros((y.shape[0], n_pad - n_items), y.dtype)], axis=1)
    if exclude_mask is None and nr is None and n_pad > n_items:
        # pack_mask_bits only marks columns beyond a caller-supplied true
        # width; with no mask source the zero-padded columns would score
        # glob_mean and could win the top-k (returning out-of-range ids)
        exclude_mask = np.zeros((n_items,), bool)

    out_i = np.empty((n_users, k), np.int32)
    out_s = np.empty((n_users, k), np.float32)
    # content-addressed staging of the sharded item factors: predict is
    # called repeatedly against fixed components, and re-uploading the
    # (R, n_pad) table per call costs seconds on a slow host link.
    # Fingerprint without forcing a contiguous copy — components is
    # usually an F-contiguous transpose view (see ops/topk.py).
    import zlib
    from rsparse_tpu.sparse.device import staged_cached
    if y.flags.c_contiguous:
        fp = zlib.adler32(y)
    elif y.flags.f_contiguous:
        fp = zlib.adler32(y.T) ^ 0x5F5F
    else:
        fp = zlib.adler32(np.ascontiguousarray(y))
    y_dev = staged_cached(
        "sharded_topk_y", sp.csr_matrix((1, 1)),
        lambda: jax.device_put(jnp.asarray(yp),
                               NamedSharding(mesh, P(None, axis))),
        extra=(y.shape, n_pad, fp, mesh, axis))
    chunks = [(s, min(s + user_chunk, n_users))
              for s in range(0, n_users, user_chunk)]

    def stage_bits_one(s, e):
        bits = pack_mask_bits(n_pad, csr=nr, rows=slice(s, e),
                              exclude_mask=exclude_mask, n_rows=e - s)
        return jax.device_put(jnp.asarray(bits),
                              NamedSharding(mesh, P(None, axis)))

    if nr is not None:
        # masks are usually the (static) training interactions: cache the
        # packed+staged bitmask chunks as ONE entry (host packbits alone
        # costs ~0.5 s per 8k-user chunk at 32k items; per-chunk entries
        # would flood the small shared LRU and evict each other)
        ekey = None if exclude_mask is None else exclude_mask.tobytes()
        all_bits = staged_cached(
            "sharded_topk_bits", nr,
            lambda: [stage_bits_one(s, e) for s, e in chunks],
            extra=(n_pad, user_chunk, ekey, mesh, axis))
    elif exclude_mask is not None:
        # row-invariant mask (padding / global excludes only): one staged
        # (1, n_pad/8) row broadcast per chunk, cached by its content
        one = staged_cached(
            "sharded_topk_pad_bits", sp.csr_matrix((1, 1)),
            lambda: jax.device_put(
                jnp.asarray(pack_mask_bits(
                    n_pad, exclude_mask=exclude_mask, n_rows=1)),
                NamedSharding(mesh, P(None, axis))),
            extra=(n_pad, exclude_mask.tobytes(), mesh, axis))
        all_bits = [jnp.broadcast_to(one, (e - s, n_pad // 8))
                    for s, e in chunks]
    else:
        all_bits = [None] * len(chunks)

    for (s, e), bits_d in zip(chunks, all_bits):
        si, ii = sharded_top_k(mesh, jnp.asarray(x[s:e]), y_dev, k,
                               mask_bits=bits_d,
                               glob_mean=glob_mean, axis=axis)
        out_s[s:e] = np.asarray(si)
        out_i[s:e] = np.asarray(ii)
    return out_i, out_s


def sharded_top_k(
    mesh: Mesh,
    x: jax.Array,          # (n_users, R) replicated
    y: jax.Array,          # (R, n_items) — will be sharded on axis 1
    k: int,
    mask: Optional[jax.Array] = None,   # (n_users, n_items) bool, True=mask
    glob_mean: float = 0.0,
    axis: str = "data",
    mask_bits: Optional[jax.Array] = None,  # (n_users, n_items // 8) uint8
) -> Tuple[jax.Array, jax.Array]:
    """Exact top-k of ``x @ y + glob_mean`` with the item axis sharded.

    Returns (scores (n_users, k), indices (n_users, k) int32).  ``n_items``
    must divide the mesh axis size.  The mask travels either as a dense
    bool matrix (``mask``) or — 8x smaller on the wire and in HBM — as a
    packed little-endian bitmask (``mask_bits``, see
    ``ops.topk.pack_mask_bits``); bit expansion fuses into the local
    tournament pass.
    """
    n_dev = mesh.shape[axis]
    n_users, n_items = x.shape[0], y.shape[1]
    if n_items % n_dev:
        raise ValueError(f"n_items={n_items} not divisible by mesh axis "
                         f"{n_dev}")
    shard = n_items // n_dev
    if k > shard:
        raise ValueError(f"k={k} must be <= items-per-shard={shard}")
    if mask is not None and mask_bits is not None:
        raise ValueError("pass at most one of mask / mask_bits")
    if mask_bits is not None and shard % 8:
        raise ValueError("mask_bits needs items-per-shard divisible by 8")

    y_sh = jax.device_put(y, NamedSharding(mesh, P(None, axis)))
    x_rep = jax.device_put(x, NamedSharding(mesh, P()))
    gm = jnp.float32(glob_mean)
    is_bits = mask_bits is not None

    m_arg = mask_bits if is_bits else mask
    fn = _sharded_topk_fn(mesh, axis, k, shard, n_users, n_dev, is_bits,
                          m_arg is not None)
    if m_arg is not None:
        mask_sh = jax.device_put(m_arg, NamedSharding(mesh, P(None, axis)))
        return fn(x_rep, y_sh, gm, mask_sh)
    return fn(x_rep, y_sh, gm)


# compiled-callable cache: building the shard_map closure inside every call
# would defeat jax's compilation cache (fresh function identity each time —
# measured 35 s for two predict chunks that should cost ~20 ms warm)
_FN_CACHE: dict = {}


def _sharded_topk_fn(mesh, axis, k, shard, n_users, n_dev, is_bits, masked):
    key = (mesh, axis, k, shard, n_users, n_dev, is_bits, masked)
    hit = _FN_CACHE.get(key)
    if hit is not None:
        return hit

    def local_pass(x_l, y_l, gm, m_l):
        # per-shard fused dot + mask + top-k (tournament formulation: one
        # pass over the shard's scores + k tiny group re-scans, see
        # ops/topk.py)
        scores = jnp.dot(x_l, y_l, preferred_element_type=jnp.float32,
                         precision=SCORE_PRECISION)
        if is_bits and shard % 256 == 0 and shard > max(512, 2 * k):
            return masked_top_k_bits(scores, m_l, k, glob_mean=gm)
        scores = scores + gm
        if m_l is not None:
            dead = _expand_bits(m_l)[:, :shard] if is_bits else m_l
            scores = jnp.where(dead, NEG_INF, scores)
        return exact_top_k_tournament(scores, k)

    # row chunks of the single-device scan (ops/topk.py USER_CHUNK)
    ROWS = USER_CHUNK

    def local_topk(x_l, y_l, gm, m_l=None):
        if n_users % ROWS == 0 and n_users > ROWS:
            xc = x_l.reshape(n_users // ROWS, ROWS, x_l.shape[1])
            mc = (None if m_l is None
                  else m_l.reshape(n_users // ROWS, ROWS, m_l.shape[1]))

            def step(_, args):
                xi, mi = args
                return None, local_pass(xi, y_l, gm, mi)

            if mc is None:
                _, (s, i) = jax.lax.scan(
                    lambda c, xi: (None, local_pass(xi, y_l, gm, None)),
                    None, xc)
            else:
                _, (s, i) = jax.lax.scan(step, None, (xc, mc))
            s = s.reshape(n_users, k)
            i = i.reshape(n_users, k)
        else:
            s, i = local_pass(x_l, y_l, gm, m_l)
        # globalize indices: offset by this shard's item base
        base = jax.lax.axis_index(axis) * shard
        i = i.astype(jnp.int32) + base
        # all-gather the O(k) candidates and merge
        s_all = jax.lax.all_gather(s, axis, axis=1)      # (n_u, n_dev, k)
        i_all = jax.lax.all_gather(i, axis, axis=1)
        s_flat = s_all.reshape(n_users, n_dev * k)
        i_flat = i_all.reshape(n_users, n_dev * k)
        sm, im = jax.lax.top_k(s_flat, k)
        return sm, jnp.take_along_axis(i_flat, im, axis=1)

    if masked:
        fn = jax.jit(jax.shard_map(
            local_topk, mesh=mesh,
            in_specs=(P(), P(None, axis), P(), P(None, axis)),
            out_specs=(P(), P()), check_vma=False))
    else:
        fn = jax.jit(jax.shard_map(
            local_topk, mesh=mesh,
            in_specs=(P(), P(None, axis), P()),
            out_specs=(P(), P()), check_vma=False))
    _FN_CACHE[key] = fn
    if len(_FN_CACHE) > 32:
        _FN_CACHE.pop(next(iter(_FN_CACHE)))
    return fn
