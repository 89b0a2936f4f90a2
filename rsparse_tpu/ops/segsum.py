"""Scheduled segment-sum: scatter-free table updates for SGD models.

The reference's FTRL/FM hot loops are per-row scatter updates into shared
tables (reference src/FTRL.cpp:122-169, src/factorization_machine.cpp:
112-194).  Dynamic scatter-add with many duplicate indices serializes on
some accelerators (this layout was built for one where it did); whether
it still wins over plain ``segment_sum`` on the GPU is not measured yet.

The scheduled layout exploits that the minibatch *layout* is static:
bucketed (B, L) blocks are staged once per fit, so the flat position of
every (sample, feature) pair is known on the host.  Staging builds a
**column schedule** — for each feature, the padded list of flat positions
where it occurs — and the update becomes three gather/reduce ops:

    per-nnz updates  u = f(gathered z/n, x, y)       (B, L)   elementwise
    per-feature sums s_f = sum u[positions_f]        gather + masked reduce
    table update     T += s[inv_perm]                (dense mode)
                     T  = T.at[feats].add(s)         (sparse mode)

Per-position scatters are gone either way; what remains is mode-chosen
at build time (see :class:`ColSchedule`): small tables take a full
dense add (``inv`` gather — zero dynamic scatters), hashed-feature
tables (rows >> nnz) take ONE scatter of the per-feature sums (the
dense delta would be O(table_rows) per block).  Sums match per-position
scatter-add up to f32 summation order.

Features are bucketed by occurrence count on the same geometric grid as
the row substrate (sparse/device.py), so wildly-popular features don't
force padding on rare ones.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..sparse.device import _round_up


class ColSchedule(NamedTuple):
    """Device-resident column schedule of one (B, L) block.

    ``pos[k]``: (Bk, Lk) int32 flat positions (into the block's B*L flat
    axis) of each scheduled feature's occurrences; padding entries hold
    ``n_flat`` (masked by ``nnz``).

    Two table-update modes, chosen at build time by the ratio of table
    rows to scheduled rows:

    - **dense** (small tables): ``inv`` is the (table_rows,) int32 map
      from each table row to its row in the concatenated per-bucket sums
      (+ one trailing zero row for absent features); the update is a full
      dense gather + table add.  O(table_rows) per block — cheap when the
      table fits a few MB.
    - **sparse** (table_rows >> scheduled rows, e.g. hashed GLM features
      at 1e7+): ``inv`` is None and ``feats`` holds the (sum Bk,) global
      ids of the scheduled features (bucket-concatenated; padding rows
      point at row 0 and carry exactly-zero sums).  The update scatters
      only the active rows — O(nnz) per block.  The dense form measured
      4.7 s/pass at F=40M (8 full-table gathers+adds of 160 MB each per
      pass) vs ~0.08 s for the scatter of ~1M summed rows (PERF.md r4).

    ``row_of_pos`` maps every flat position to the scheduled row of its
    own feature (positions -> rows of the ``scheduled_sums`` output):
    the per-position image of a freshly-updated accumulator is then
    ``old_gathered + sums[row_of_pos]`` — no second cold table gather
    (FM's accumulator-first AdaGrad re-gather, models/fm.py).
    """

    pos: Tuple[jax.Array, ...]
    nnz: Tuple[jax.Array, ...]
    inv: Optional[jax.Array]
    feats: Optional[jax.Array]
    row_of_pos: Optional[jax.Array] = None


def build_col_schedule(
    col_flat: np.ndarray,
    table_rows: int,
    *,
    row_align: int = 8,
    max_buckets: int = 10,
    sparse_factor: int = 4,
) -> ColSchedule:
    """Build the column schedule of one block from its flat column ids.

    ``col_flat`` (n_flat,) int32; masked padding entries may point at any
    column (their update values are zero, so their sums are no-ops).
    ``table_rows`` is the (mesh-padded) table row count a dense delta
    must cover.  Sparse mode is chosen when ``table_rows >
    sparse_factor * scheduled_rows`` (dense costs a table-sized gather +
    add per update; sparse a scheduled-rows scatter at ~1/4 the gather
    rate, PERF.md round-4 table-op matrix).

    Occurrence counts bucket on a pure power-of-2 grid FROM 1: in the
    sparse-feature regime (features occurring once or twice, e.g. one-hot
    GLM columns at millions of features) any larger minimum length
    multiplies the scheduled gather volume by that minimum (a measured
    5.5x gather amplification at 4M features with min_len=8, PERF.md
    round 4).
    """
    n_flat = int(col_flat.size)
    if n_flat == 0:
        return ColSchedule((), (), None, None)
    order = np.argsort(col_flat, kind="stable").astype(np.int64)
    # per-active-feature occurrence counts from ONE sort: run boundaries
    # of the sorted copy (np.unique would re-sort; a
    # bincount(minlength=4e7) per block dominated staging before that)
    sc = col_flat[order]
    first = np.empty(n_flat, bool)
    first[0] = True
    np.not_equal(sc[1:], sc[:-1], out=first[1:])
    starts = np.flatnonzero(first)         # first sorted position per feat
    active = sc[starts].astype(np.int64)
    occ = np.diff(np.append(starts, n_flat))

    lengths = 2 ** np.ceil(np.log2(occ)).astype(np.int64)
    lengths = np.maximum(lengths, 1)
    uniq, ucounts = np.unique(lengths, return_counts=True)
    while len(uniq) > max_buckets:
        k = int(np.argmin(ucounts[:-1]))
        lengths[lengths == uniq[k]] = uniq[k + 1]
        uniq, ucounts = np.unique(lengths, return_counts=True)

    pos_np: List[np.ndarray] = []
    nnz_out: List[jax.Array] = []
    feats_np: List[np.ndarray] = []
    meta: List[Tuple[np.ndarray, int]] = []   # (feature ids, row offset)
    offset = 0
    for L in uniq:
        L = int(L)
        sel = lengths == L
        feats = active[sel]
        cnt = occ[sel]
        B = _round_up(len(feats), row_align)
        nnz = np.zeros((B,), np.int32)
        nnz[: len(feats)] = cnt
        flat = starts[sel][:, None] + np.arange(L)[None, :]
        valid = np.arange(L)[None, :] < cnt[:, None]
        pos = np.full((B, L), n_flat, np.int32)
        pos[: len(feats)] = np.where(
            valid, order[np.minimum(flat, n_flat - 1)], n_flat)
        fp = np.zeros((B,), np.int32)          # padding rows -> row 0,
        fp[: len(feats)] = feats               # their sums are exactly 0
        meta.append((feats, offset))
        offset += B
        pos_np.append(pos)
        nnz_out.append(jnp.asarray(nnz))
        feats_np.append(fp)

    # position -> scheduled-sums row of its own feature (every real flat
    # position appears in exactly one pos list; padding writes land in
    # the spare trailing slot)
    rop = np.zeros(n_flat + 1, np.int32)
    for (_, off), pos in zip(meta, pos_np):
        B, L = pos.shape
        rows = np.broadcast_to(
            (off + np.arange(B, dtype=np.int32))[:, None], (B, L))
        rop[np.minimum(pos, n_flat)] = rows
    row_of_pos = jnp.asarray(rop[:n_flat])
    pos_out = tuple(jnp.asarray(p) for p in pos_np)

    if table_rows > sparse_factor * offset:
        return ColSchedule(pos_out, tuple(nnz_out), None,
                           jnp.asarray(np.concatenate(feats_np)),
                           row_of_pos)

    # dense: absent features read the trailing zero row of the sums
    inv_final = np.full((table_rows,), offset, np.int32)
    for feats, off in meta:
        inv_final[feats] = off + np.arange(len(feats), dtype=np.int32)
    return ColSchedule(pos_out, tuple(nnz_out),
                       jnp.asarray(inv_final), None, row_of_pos)


def staged_blocks_with_schedules(csr, dtype, n_features: int, mesh,
                                 tag: str, max_elems: int = 1 << 20):
    """Content-cached staging of the GLM row blocks + column schedules.

    Returns ``(BucketedRows, (ColSchedule, ...), (mask, ...))`` aligned by
    bucket — masks are pre-computed here because ``bucket.mask()`` is an
    eager per-call device computation otherwise (one dispatch per block
    per pass).  Under a mesh everything is fully replicated (the delta
    covers the mesh-padded table rows, so ``ops.add_dense`` can slice per
    shard)."""
    from ..parallel.sgd_sharded import padded_rows, replicate_on
    from ..sparse.device import (BucketedRows, RowBucket, bucket_rows,
                                 staged_cached)

    table_rows = (padded_rows(n_features + 1, mesh)
                  if mesh is not None else n_features + 1)

    def build():
        host_out: list = []
        br = bucket_rows(csr, dtype, include_empty=True,
                         max_elems=max_elems, host_out=host_out)
        scheds = tuple(build_col_schedule(c.reshape(-1), table_rows)
                       for c, _, _ in host_out)
        masks = tuple(b.mask() for b in br.buckets)
        if mesh is not None:
            bks = tuple(RowBucket(*replicate_on(mesh, tuple(b)))
                        for b in br.buckets)
            br = BucketedRows(bks, br.n_rows, br.n_cols, br.nnz,
                              br.empty_rows)
            scheds = replicate_on(mesh, scheds)
            masks = replicate_on(mesh, masks)
        return br, scheds, masks

    return staged_cached(tag, csr, build,
                         extra=(str(jnp.dtype(dtype)), mesh, max_elems))


def staged_blocks_with_layouts(csr, dtype, n_features: int, mesh,
                               tag: str, max_elems: int = 1 << 20):
    """Content-cached staging of GLM row blocks + feature-grouped layouts.

    The round-5 replacement for :func:`staged_blocks_with_schedules` on
    the FTRL/FM path: returns ``(BucketedRows, (SchedLayout, ...))``
    aligned by bucket.  Under a mesh the row blocks and layouts are fully
    replicated (table reads/writes inside the kernels go through the
    sharded ops algebra)."""
    from ..parallel.sgd_sharded import padded_rows, replicate_on
    from ..sparse.device import (BucketedRows, RowBucket, bucket_rows,
                                 staged_cached)

    table_rows = (padded_rows(n_features + 1, mesh)
                  if mesh is not None else n_features + 1)

    def build():
        host_out: list = []
        br = bucket_rows(csr, dtype, include_empty=True,
                         max_elems=max_elems, host_out=host_out)
        layouts = tuple(
            build_sched_layout(c, v, nz, table_rows)
            for c, nz, v in host_out)
        if mesh is not None:
            bks = tuple(RowBucket(*replicate_on(mesh, tuple(b)))
                        for b in br.buckets)
            br = BucketedRows(bks, br.n_rows, br.n_cols, br.nnz,
                              br.empty_rows)
            layouts = replicate_on(mesh, layouts)
        return br, layouts

    return staged_cached(tag, csr, build,
                         extra=(str(jnp.dtype(dtype)), mesh, max_elems,
                                "layout_v1"))


def staged_label_gathers(tag: str, csr, y: np.ndarray,
                         weights: np.ndarray, br, dtype, mesh,
                         zero_pad_weight: bool):
    """Per-bucket label/weight gathers, content-cached.

    ``y[bucket.row_ids]`` is pass-invariant for a fixed (x, y, weights)
    triple, but computing it per block per pass costs an eager dispatch
    plus a host->device staging of y/weights each call.  Returns a tuple
    of (y_b, w_b) per bucket; ``zero_pad_weight`` zeroes w on
    batch-padding rows (the FM intercept contract,
    src/factorization_machine.cpp:147-149)."""
    import zlib

    from ..parallel.sgd_sharded import replicate_on
    from ..sparse.device import _csr_fingerprint, staged_aux_cached

    fp = (_csr_fingerprint(csr), zlib.adler32(np.ascontiguousarray(y)),
          zlib.adler32(np.ascontiguousarray(weights)), len(y))

    def build():
        n_rows = len(y)
        yd = jnp.asarray(y, dtype)
        wd = jnp.asarray(weights, dtype)
        out = []
        for b in br.buckets:
            rid = jnp.minimum(b.row_ids, n_rows - 1)
            w_b = wd[rid]
            if zero_pad_weight:
                w_b = jnp.where(b.row_ids < n_rows, w_b, 0.0)
            out.append((yd[rid], w_b))
        out = tuple(out)
        return replicate_on(mesh, out) if mesh is not None else out

    return staged_aux_cached(tag, fp, build,
                             extra=(str(jnp.dtype(dtype)), mesh,
                                    zero_pad_weight))


class SchedLayout(NamedTuple):
    """Feature-grouped ("scheduled") layout of one (B, L) row block, with
    everything a kernel needs to COMPUTE per-nnz updates directly in that
    layout instead of computing them row-major and re-gathering.

    The round-4 scheduled segment-sum (:class:`ColSchedule`) removed the
    scatters but still worked row-major: per-position updates were built in
    the (B, L) row layout — which costs one table gather PER POSITION for
    every state table read — then permuted feature-major for the sums.  The
    round-5 layout inverts this: because all positions of one feature share
    that feature's state row, every table READ becomes a per-feature
    broadcast, and because accumulator-first AdaGrad gives all positions of
    a feature the SAME updated accumulator, the update itself factors into
    ``delta_f = -lr * sum_pos(g) / sqrt(acc_f + sum_pos(g^2))`` — per
    feature, no per-position table traffic at all.  What crosses layouts
    per pass is exactly two per-position permute-gathers (prediction
    contributions sched->row via ``sched_of_pos``; the per-row gradient
    scalar row->sched via ``rows``), both from minibatch-sized operands.

    The layout is TWO-LEVEL.  Popularity is zipf-distributed, so a flat
    power-of-2 occurrence grid pads hot features catastrophically (a
    measured 122x slot amplification on the GloVe tail, PERF.md round 5).
    Level 1 splits every feature's occurrence list into CHUNKS of at most
    ``chunk_len`` positions, bucketed by power-of-2 chunk length (at most
    ``log2(chunk_len)+1`` shapes, amplification < 2).  Level 2 reduces the
    per-chunk partial sums to per-feature totals through a second, tiny
    position schedule over the chunk-row axis (most features have one
    chunk; hot features have up to occ/chunk_len).

    Only VALID positions are scheduled (row-padding slots are excluded at
    build time), so zero-padding inside the scheduled buckets carries
    ``vals == 0`` and contributes exactly nothing.

    Level-1 (chunk) arrays, per chunk-length bucket ``k`` (padded chunk
    count ``Ck``, padded chunk length ``Lk``):

    - ``feats_c[k]``: (Ck,) global feature id of each chunk (padding
      rows -> 0) — for per-chunk state BROADCASTS (w_f, n_f, v_f ...)
    - ``nnz[k]``: (Ck,) real positions in the chunk (slot mask)
    - ``vals[k]``: (Ck, Lk) input values (0 at padding slots)
    - ``rows[k]``: (Ck, Lk) row index within the row block (0 at padding)
    - ``pos[k]``: (Ck, Lk) flat positions into the block's B*L axis
      (sentinel ``B*L`` at padding slots)

    ``sched_of_pos`` (B*L,) maps every row-layout flat position to its
    slot in the bucket-concatenated level-1 flat space (see
    :func:`sched_to_rows`); invalid positions map to the trailing zero
    slot.

    Level-2 arrays, per chunks-per-feature bucket ``m`` (padded feature
    count ``Fm``, padded chunk count ``Gm``):

    - ``pos2[m]``: (Fm, Gm) global chunk-row indices (into the level-1
      bucket-concatenated chunk axis, sentinel = total chunk rows) — feed
      :func:`sched_reduce_chunks`
    - ``feats[m]``: (Fm,) global feature ids (padding rows -> 0, their
      sums are exactly 0) — for per-FEATURE state reads (AdaGrad
      accumulators) and apply alignment

    ``inv`` / ``all_feats`` choose the table-apply mode exactly like
    :class:`ColSchedule` (dense full-table add vs active-rows scatter),
    aligned with the level-2 concatenation.
    """

    feats_c: Tuple[jax.Array, ...]
    nnz: Tuple[jax.Array, ...]
    vals: Tuple[jax.Array, ...]
    rows: Tuple[jax.Array, ...]
    pos: Tuple[jax.Array, ...]
    sched_of_pos: jax.Array
    pos2: Tuple[jax.Array, ...]
    feats: Tuple[jax.Array, ...]
    inv: Optional[jax.Array]
    all_feats: Optional[jax.Array]


def _chunk_plan(cols: np.ndarray, chunk_len: int):
    """Sort a block's (valid) feature ids and split each feature's
    occurrence run into chunks of at most ``chunk_len``.

    Returns ``(order, active, occ, cidx, cstart, clen, cum0)`` where
    ``order`` sorts positions by feature, ``active``/``occ`` are the
    distinct features and their counts, and per chunk ``cidx`` indexes
    into ``active``, ``cstart`` is the chunk's start in sorted order,
    ``clen`` its real length; ``cum0[f]`` is the first chunk index of
    feature ``f`` (chunks of one feature are consecutive)."""
    nv = cols.size
    order = np.argsort(cols, kind="stable")
    sc = cols[order]
    first = np.empty(nv, bool)
    first[0] = True
    np.not_equal(sc[1:], sc[:-1], out=first[1:])
    starts = np.flatnonzero(first)
    active = sc[starts]
    occ = np.diff(np.append(starts, nv))
    ncf = -(-occ // chunk_len)                    # chunks per feature
    total = int(ncf.sum())
    cum0 = np.concatenate([[0], np.cumsum(ncf)[:-1]]).astype(np.int64)
    cidx = np.repeat(np.arange(len(active), dtype=np.int64), ncf)
    within = np.arange(total, dtype=np.int64) - np.repeat(cum0, ncf)
    cstart = starts[cidx] + within * chunk_len
    clen = np.minimum(occ[cidx] - within * chunk_len, chunk_len)
    return order, active, occ, ncf, cum0, cidx, cstart, clen


def _pow2_grid(lengths: np.ndarray, max_buckets: int) -> np.ndarray:
    """Per-item power-of-2 padded lengths, capped at ``max_buckets``
    distinct values by merging the least-populated length upward."""
    out = np.maximum(2 ** np.ceil(np.log2(lengths)).astype(np.int64), 1)
    uniq, counts = np.unique(out, return_counts=True)
    while len(uniq) > max_buckets:
        k = int(np.argmin(counts[:-1]))
        out[out == uniq[k]] = uniq[k + 1]
        uniq, counts = np.unique(out, return_counts=True)
    return out


def build_sched_layout(
    col_idx: np.ndarray,
    values: np.ndarray,
    nnz_rows: np.ndarray,
    table_rows: int,
    *,
    row_align: int = 8,
    chunk_len: int = 128,       # carried over; not tuned on the H100
    max_buckets: int = 8,
    sparse_factor: int = 4,
) -> SchedLayout:
    """Build the two-level feature-grouped layout of one (B, L) row block.

    ``col_idx``/``values`` are the HOST-side padded block arrays;
    ``nnz_rows`` (B,) gives each row's real length (slots at ``l >=
    nnz_rows[b]`` are excluded).  Apply mode: dense full-table add unless
    ``table_rows > sparse_factor * level-2 rows`` (active-rows scatter —
    the hashed-feature regime, PERF.md round 4)."""
    B, L = col_idx.shape
    n_flat = B * L
    valid = np.arange(L, dtype=np.int64)[None, :] < np.asarray(
        nnz_rows, np.int64)[:, None]
    vmask = valid.reshape(-1)
    cols_f = col_idx.reshape(-1)[vmask].astype(np.int64)
    vals_f = np.ascontiguousarray(values).reshape(-1)[vmask]
    flatpos = np.flatnonzero(vmask).astype(np.int64)
    n_valid = cols_f.size

    sop = np.full(n_flat, 0, np.int32)  # filled below; invalid -> trailing
    if n_valid == 0:
        return SchedLayout((), (), (), (), (), jnp.asarray(sop),
                           (), (), None, None)

    order, active, occ, ncf, cum0, cidx, cstart, clen = _chunk_plan(
        cols_f, chunk_len)
    total_chunks = len(cidx)
    l1len = _pow2_grid(clen, max_buckets)
    row_of_flat = np.repeat(np.arange(B, dtype=np.int32), L)
    val_dt = vals_f.dtype

    uniq1 = np.unique(l1len)
    chunkrow = np.empty(total_chunks, np.int64)   # global chunk row
    feats_c_l, nnz_l, vals_l, rows_l, pos_l = [], [], [], [], []
    c_off = 0         # row offset into the concatenated chunk space
    flat_off = 0      # slot offset into the concatenated sched-flat space
    for Lk in uniq1:
        Lk = int(Lk)
        sel = l1len == Lk
        nb = int(sel.sum())
        Ck = _round_up(nb, row_align)
        cnt = clen[sel]
        chunkrow[sel] = c_off + np.arange(nb)
        slots = cstart[sel][:, None] + np.arange(Lk)[None, :]
        ok = np.arange(Lk)[None, :] < cnt[:, None]
        src = order[np.minimum(slots, n_valid - 1)]      # into valid-compact
        fp_pos = flatpos[src]                            # into row flat
        posk = np.full((Ck, Lk), n_flat, np.int32)
        posk[:nb] = np.where(ok, fp_pos, n_flat)
        valk = np.zeros((Ck, Lk), val_dt)
        valk[:nb] = np.where(ok, vals_f[src], 0)
        rowk = np.zeros((Ck, Lk), np.int32)
        rowk[:nb] = np.where(ok, row_of_flat[fp_pos], 0)
        nnzk = np.zeros((Ck,), np.int32)
        nnzk[:nb] = cnt
        fk = np.zeros((Ck,), np.int32)
        fk[:nb] = active[cidx[sel]]
        slot_ids = (flat_off
                    + np.arange(nb, dtype=np.int64)[:, None] * Lk
                    + np.arange(Lk, dtype=np.int64)[None, :])
        sop[fp_pos[ok]] = slot_ids[ok]
        c_off += Ck
        flat_off += Ck * Lk
        feats_c_l.append(jnp.asarray(fk))
        nnz_l.append(jnp.asarray(nnzk))
        vals_l.append(jnp.asarray(valk))
        rows_l.append(jnp.asarray(rowk))
        pos_l.append(jnp.asarray(posk))
    sop[~vmask] = flat_off    # trailing zero slot

    # level 2: per-feature reduction over chunk rows.  When NO feature
    # needed chunking (every occurrence run fits one chunk — the
    # hashed-feature regime where occurrences are ~1), level 2 would be a
    # pure permutation: skip it entirely (pos2 = ()) and align the apply
    # map with the CHUNK concatenation instead — sched_reduce_chunks
    # passes chunk sums through unchanged.
    if int(ncf.max()) == 1:
        feats_out = tuple(feats_c_l)
        if table_rows > sparse_factor * c_off:
            all_feats = jnp.asarray(np.concatenate(
                [np.asarray(f) for f in feats_c_l]))
            return SchedLayout(tuple(feats_c_l), tuple(nnz_l),
                               tuple(vals_l), tuple(rows_l), tuple(pos_l),
                               jnp.asarray(sop), (), feats_out,
                               None, all_feats)
        inv_np = np.full((table_rows,), c_off, np.int32)
        row0 = 0
        for fk, nz in zip(feats_c_l, nnz_l):
            nzv = np.asarray(nz)
            nb_real = int((nzv > 0).sum())
            fv = np.asarray(fk)[:nb_real]
            inv_np[fv] = row0 + np.arange(nb_real, dtype=np.int32)
            row0 += len(nzv)
        return SchedLayout(tuple(feats_c_l), tuple(nnz_l), tuple(vals_l),
                           tuple(rows_l), tuple(pos_l), jnp.asarray(sop),
                           (), feats_out, jnp.asarray(inv_np), None)

    l2len = _pow2_grid(ncf, max_buckets)
    uniq2 = np.unique(l2len)
    pos2_l, feats_l = [], []
    meta: List[Tuple[np.ndarray, int]] = []
    f_off = 0
    for Gm in uniq2:
        Gm = int(Gm)
        sel = l2len == Gm
        nf = int(sel.sum())
        Fm = _round_up(nf, row_align)
        cnt = ncf[sel]
        slots = cum0[sel][:, None] + np.arange(Gm)[None, :]
        ok = np.arange(Gm)[None, :] < cnt[:, None]
        p2 = np.full((Fm, Gm), c_off, np.int32)
        p2[:nf] = np.where(
            ok, chunkrow[np.minimum(slots, total_chunks - 1)], c_off)
        fm = np.zeros((Fm,), np.int32)
        fm[:nf] = active[sel]
        meta.append((active[sel], f_off))
        f_off += Fm
        pos2_l.append(jnp.asarray(p2))
        feats_l.append(jnp.asarray(fm))

    inv = None
    all_feats = None
    if table_rows > sparse_factor * f_off:
        all_feats = jnp.asarray(
            np.concatenate([np.asarray(f) for f in feats_l]))
    else:
        inv_np = np.full((table_rows,), f_off, np.int32)
        for feats, off in meta:
            inv_np[feats] = off + np.arange(len(feats), dtype=np.int32)
        inv = jnp.asarray(inv_np)
    return SchedLayout(tuple(feats_c_l), tuple(nnz_l), tuple(vals_l),
                       tuple(rows_l), tuple(pos_l), jnp.asarray(sop),
                       tuple(pos2_l), tuple(feats_l), inv, all_feats)


def sched_reduce_chunks(chunk_vals: jax.Array, layout) -> jax.Array:
    """Reduce bucket-concatenated per-CHUNK partial sums (C[, w]) to
    per-FEATURE totals ((level-2 rows)[, w]) through the level-2 position
    schedule.  Padding chunk rows carry exact zeros; the sentinel reads a
    trailing zero row.  An EMPTY level-2 schedule means chunks == features
    (no feature was split — see build_sched_layout) and the chunk sums
    pass through unchanged."""
    if not layout.pos2:
        return chunk_vals
    zero = jnp.zeros((1,) + chunk_vals.shape[1:], chunk_vals.dtype)
    pad = jnp.concatenate([chunk_vals, zero], axis=0)
    return jnp.concatenate([jnp.sum(pad[p2], axis=1)
                            for p2 in layout.pos2], axis=0)


class StackedSchedule(NamedTuple):
    """Per-shard two-level column schedules on SHARED bucket grids,
    stacked along a leading shard axis — every leaf has leading dim ``S``
    so the whole structure is valid ``lax.scan`` xs (each scan step sees
    one shard's schedule with static shapes).

    Built for the GloVe sparse-tail epoch (models/glove.py): the 10-20
    scanned COO shards each get a feature-grouped schedule, but a scan
    needs uniform shapes, so all shards share one chunk-length grid and
    one chunks-per-feature grid, each bucket padded to the max count over
    shards.  Chunking (level 1 splits hot features into rows of at most
    ``chunk_len`` positions, level 2 reduces chunk partial sums per
    feature) bounds zipf padding: a flat pow2 grid measured 122x slot
    amplification on the GloVe tail, the two-level grid < 2x (PERF.md
    round 5).

    - ``pos[k]``: (S, Ck, Lk) level-1 flat positions into the shard's
      N-element axis (sentinel ``N`` — gathers from an (N+1)-row
      zero-padded operand need no mask)
    - ``pos2[m]``: (S, Fm, Gm) level-2 chunk-row indices into the
      bucket-concatenated chunk axis (sentinel = total chunk rows)
    - ``feats[m]``: (S, Fm) global feature ids per level-2 row (padding
      rows -> 0, their sums are exactly 0)
    - ``inv`` (S, table_rows) / ``all_feats`` (S, sum Fm): apply mode per
      :class:`ColSchedule`, aligned with the level-2 concatenation.
    """

    pos: Tuple[jax.Array, ...]
    pos2: Tuple[jax.Array, ...]
    feats: Tuple[jax.Array, ...]
    inv: Optional[jax.Array]
    all_feats: Optional[jax.Array]


def build_stacked_col_schedule(
    ids: np.ndarray,
    valid: np.ndarray,
    table_rows: int,
    *,
    row_align: int = 8,
    chunk_len: int = 128,       # carried over; not tuned on the H100
    max_buckets: int = 8,
    sparse_factor: int = 4,
) -> StackedSchedule:
    """Build stacked two-level per-shard schedules from (S, N) feature
    ids + valid mask.  Only valid positions are scheduled."""
    S, N = ids.shape
    plans = []
    for s in range(S):
        m = np.asarray(valid[s], bool)
        f = np.asarray(ids[s], np.int64)[m]
        fpos = np.flatnonzero(m).astype(np.int64)
        if f.size == 0:
            plans.append(None)
            continue
        order, active, occ, ncf, cum0, cidx, cstart, clen = _chunk_plan(
            f, chunk_len)
        plans.append({"sorted_pos": fpos[order], "active": active,
                      "occ": occ, "ncf": ncf, "cum0": cum0, "cidx": cidx,
                      "cstart": cstart, "clen": clen,
                      "l1len": np.maximum(
                          2 ** np.ceil(np.log2(clen)).astype(np.int64), 1)})
    live = [p for p in plans if p is not None]
    if not live:
        return StackedSchedule((), (), (), None, None)

    # shared level-1 grid (chunk lengths are bounded by chunk_len, so at
    # most log2(chunk_len)+1 buckets — no cap needed)
    uniq1 = np.unique(np.concatenate([p["l1len"] for p in live]))
    Cks = [_round_up(max(max((int((p["l1len"] == L).sum()) for p in live),
                            default=1), 1), row_align) for L in uniq1]
    c_tot = sum(Cks)

    pos_l = []
    c_off = 0
    # per shard: global chunk row of each chunk (shared offsets — bucket
    # shapes are shared across shards)
    chunkrows = [None if p is None else
                 np.empty(len(p["cidx"]), np.int64) for p in plans]
    for L, Ck in zip(uniq1, Cks):
        L = int(L)
        posk = np.full((S, Ck, L), N, np.int32)
        for s, p in enumerate(plans):
            if p is None:
                continue
            sel = p["l1len"] == L
            nb = int(sel.sum())
            if nb == 0:
                continue
            chunkrows[s][sel] = c_off + np.arange(nb)
            cnt = p["clen"][sel]
            slots = p["cstart"][sel][:, None] + np.arange(L)[None, :]
            ok = np.arange(L)[None, :] < cnt[:, None]
            nv = p["sorted_pos"].size
            src = np.minimum(slots, max(nv - 1, 0))
            posk[s, :nb] = np.where(ok, p["sorted_pos"][src], N)
        pos_l.append(jnp.asarray(posk))
        c_off += Ck

    # shared level-2 grid (chunks per feature), capped
    l2lens = []
    for p in plans:
        l2lens.append(None if p is None else np.maximum(
            2 ** np.ceil(np.log2(p["ncf"])).astype(np.int64), 1))
    allv = np.concatenate([x for x in l2lens if x is not None])
    uniq2, counts = np.unique(allv, return_counts=True)
    while len(uniq2) > max_buckets:
        k = int(np.argmin(counts[:-1]))
        tgt = uniq2[k + 1]
        for x in l2lens:
            if x is not None:
                x[x == uniq2[k]] = tgt
        allv = np.concatenate([x for x in l2lens if x is not None])
        uniq2, counts = np.unique(allv, return_counts=True)

    Fms = []
    for G in uniq2:
        nf = max(max((int((x == G).sum())
                      for x in l2lens if x is not None), default=1), 1)
        Fms.append(_round_up(nf, row_align))

    pos2_l, feats_l, nf_l = [], [], []
    for G, Fm in zip(uniq2, Fms):
        G = int(G)
        p2 = np.full((S, Fm, G), c_tot, np.int32)
        fm = np.zeros((S, Fm), np.int32)
        nfk = np.zeros((S,), np.int64)
        for s, p in enumerate(plans):
            if p is None:
                continue
            sel = l2lens[s] == G
            nf = int(sel.sum())
            nfk[s] = nf
            if nf == 0:
                continue
            cnt = p["ncf"][sel]
            slots = p["cum0"][sel][:, None] + np.arange(G)[None, :]
            ok = np.arange(G)[None, :] < cnt[:, None]
            tc = len(p["cidx"])
            src = np.minimum(slots, tc - 1)
            p2[s, :nf] = np.where(ok, chunkrows[s][src], c_tot)
            fm[s, :nf] = p["active"][sel]
        pos2_l.append(p2)
        feats_l.append(fm)
        nf_l.append(nfk)

    f_tot = sum(Fms)
    dev = lambda arrs: tuple(jnp.asarray(a) for a in arrs)  # noqa: E731
    if table_rows > sparse_factor * f_tot:
        all_feats = jnp.asarray(np.concatenate(feats_l, axis=1))
        return StackedSchedule(tuple(pos_l), dev(pos2_l), dev(feats_l),
                               None, all_feats)
    inv_np = np.full((S, table_rows), f_tot, np.int32)
    off = 0
    for fm, nfk, Fm in zip(feats_l, nf_l, Fms):
        for s in range(S):
            nf = int(nfk[s])   # only real rows — padding rows hold feature
            if nf:             # 0 and must not clobber its real mapping
                inv_np[s, fm[s, :nf]] = off + np.arange(nf, dtype=np.int32)
        off += Fm
    return StackedSchedule(tuple(pos_l), dev(pos2_l), dev(feats_l),
                           jnp.asarray(inv_np), None)


def sched_to_rows(parts: Sequence[jax.Array], layout: SchedLayout,
                  B: int, L: int) -> jax.Array:
    """Permute per-bucket scheduled data back to the (B, L) row layout.

    ``parts[k]`` is (Bk, Lk[, w]) — one array per bucket, matching
    ``layout.vals`` shapes.  Returns (B, L[, w]); row-padding positions
    read a trailing zero slot."""
    w = parts[0].shape[2:] if parts else ()
    flat = jnp.concatenate(
        [p.reshape((-1,) + tuple(w)) for p in parts], axis=0)
    zero = jnp.zeros((1,) + tuple(w), flat.dtype)
    flat = jnp.concatenate([flat, zero], axis=0)
    return flat[layout.sched_of_pos].reshape((B, L) + tuple(w))


def sched_apply_sums(ops, table: jax.Array, sums: jax.Array,
                     layout: SchedLayout) -> jax.Array:
    """Apply bucket-concatenated per-feature sums/deltas to the table —
    dense full-table add (``inv``) or active-rows scatter (``all_feats``),
    exactly like :func:`scheduled_table_add_sums`."""
    if layout.inv is not None:
        zero = jnp.zeros((1,) + sums.shape[1:], sums.dtype)
        delta = jnp.concatenate([sums, zero], axis=0)[layout.inv]
        return ops.add_dense(table, delta)
    return ops.scatter_add(table, layout.all_feats, sums)


def sched_apply_sums_multi(ops, pairs, layout):
    """Apply several ``(table, sums)`` pairs through ONE shared ``inv``
    gather (dense mode).  The dense apply is row-fetch-bound — each
    table's ``cat(sums)[inv]`` costs a table-rows gather regardless of
    width — so packing the sums column-wise and slicing the single
    gathered delta halves/quarters the apply cost (measured on the GloVe
    tail, PERF.md round 5).  Pack width-compatible sums only: pair two
    (F, r) embeddings-sized sums, or scalar sums together — mixing r and
    scalar widths would break the minor-dim tile alignment.  Sparse mode
    scatters each pair (row count there is active features, already
    cheap).  Returns the updated tables in order."""
    if layout.inv is None:
        return tuple(ops.scatter_add(t, layout.all_feats, s)
                     for t, s in pairs)
    cols = [s if s.ndim == 2 else s[:, None] for _, s in pairs]
    packed = jnp.concatenate(cols, axis=-1)
    zero = jnp.zeros((1, packed.shape[1]), packed.dtype)
    delta = jnp.concatenate([packed, zero], axis=0)[layout.inv]
    out, o = [], 0
    for (t, s), c in zip(pairs, cols):
        w = c.shape[1]
        d = delta[:, o:o + w]
        out.append(ops.add_dense(t, d if s.ndim == 2 else d[:, 0]))
        o += w
    return tuple(out)


def scheduled_sums(u_flat: jax.Array, sched: ColSchedule) -> jax.Array:
    """Per-scheduled-feature sums of flat per-nnz updates, concatenated
    across the schedule's occurrence buckets: (sum Bk[, r]).  Padding rows
    sum to exactly 0 (the nnz mask zeroes every term)."""
    n_flat = u_flat.shape[0]
    outs = []
    for pos, nnz in zip(sched.pos, sched.nnz):
        g = u_flat[jnp.minimum(pos, n_flat - 1)]        # (B, L[, r])
        m = jax.lax.broadcasted_iota(jnp.int32, pos.shape, 1) < nnz[:, None]
        if u_flat.ndim == 2:
            m = m[..., None]
        outs.append(jnp.sum(jnp.where(m, g, 0), axis=1))
    return jnp.concatenate(outs, axis=0)


def scheduled_table_add(ops, table: jax.Array, u_flat: jax.Array,
                        sched: ColSchedule) -> jax.Array:
    """``table += zeros.at[col_flat].add(u_flat)`` through the staged
    schedule — the single entry point model kernels use.

    Dense-mode schedules apply a full-table delta (``ops.add_dense``);
    sparse-mode schedules scatter only the active-feature sums
    (``ops.scatter_add`` on global ids — the sharded ops mask to the
    local row shard).  Both produce identical tables: each feature row
    receives its single bucket-sum either way.
    """
    if not sched.pos:
        return table
    return scheduled_table_add_sums(ops, table,
                                    scheduled_sums(u_flat, sched), sched)


def scheduled_table_add_sums(ops, table: jax.Array, sums: jax.Array,
                             sched: ColSchedule) -> jax.Array:
    """Apply precomputed ``scheduled_sums`` output to the table (callers
    that also need the sums — e.g. FM's accumulator-first re-gather via
    ``sums[sched.row_of_pos]`` — avoid summing twice)."""
    if sched.inv is not None:
        zero = jnp.zeros((1,) + sums.shape[1:], sums.dtype)
        delta = jnp.concatenate([sums, zero], axis=0)[sched.inv]
        return ops.add_dense(table, delta)
    return ops.scatter_add(table, sched.feats, sums)
