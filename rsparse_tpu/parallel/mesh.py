"""Device mesh & sharding utilities.

The reference's only parallelism is shared-memory OpenMP + BLAS threads
(SURVEY §2.4; reference inst/include/wrmf_implicit.hpp:162-174).  The
replacement here is an SPMD device mesh:

- axis ``data``  — target entities (users/items being solved) are sharded
  across devices; each device solves its bucket shard (the analog of the
  OpenMP worker pool, but deterministic and batched).
- axis ``model`` — factor tables are row-sharded (the model state of an MF
  model *is* the embedding tables); Gram matrices ``X'X`` are computed as
  per-shard partials and psum-ed (rank x rank — tiny wire cost).

XLA's SPMD partitioner inserts the collectives (all_gather of source factors
for nnz gathers, psum of Grams and losses) from sharding annotations — the
"How to Scale Your Model" recipe rather than hand-written NCCL.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..sparse.device import BucketedRows, RowBucket


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Tuple[str, ...] = ("data",),
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Create a device mesh.  Default: 1-D ``data`` mesh over all local
    devices."""
    if devices is None:
        devices = jax.devices()
    if shape is None:
        shape = (len(devices),)
    arr = np.asarray(devices).reshape(shape)
    return Mesh(arr, axis_names)


def data_sharding(mesh: Mesh, axis: str = "data") -> NamedSharding:
    """Shard the leading (batch/entity) axis across ``axis``."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_hot(hot, mesh: Mesh, model_axis: str = "model"):
    """Place a dense zipf-head block (sparse/device.py ``HotBlock``) on the
    mesh.

    ``W`` shards its hot-column axis over ``model``: every device holds all
    target rows for its slice of hot columns, so the per-bucket row gather
    ``W[ids]`` stays device-local and the H-axis contractions of the hot
    rhs/matvec terms reduce with a rank-sized psum.  ``hot_ids`` and
    ``row_nnz`` are replicated (O(H + n_rows) ints).  Falls back to
    replication when the column count doesn't divide the axis.
    """
    if hot is None:
        return None
    from ..sparse.device import HotBlock

    H = hot.W.shape[1]
    n = mesh.shape.get(model_axis, 1) if model_axis in mesh.axis_names else 1
    col_spec = P(None, model_axis) if (n > 1 and H % n == 0) else P()
    W = jax.device_put(hot.W, NamedSharding(mesh, col_spec))
    pb = hot.present_bits
    if pb is not None:
        pb_spec = col_spec if (col_spec != P() and (H // n) % 8 == 0) else P()
        pb = jax.device_put(pb, NamedSharding(mesh, pb_spec))
    rep = NamedSharding(mesh, P())
    ws = hot.w_scale
    if ws is not None:
        ws = jax.device_put(ws, rep)      # per-ROW scale: replicate
    return HotBlock(jax.device_put(hot.hot_ids, rep), W,
                    jax.device_put(hot.row_nnz, rep), pb, ws)


def shard_buckets(
    br: BucketedRows, mesh: Mesh, axis: str = "data"
) -> BucketedRows:
    """Place every bucket's batch axis sharded across the mesh.

    Bucket batches must be divisible by the axis size — pass
    ``row_align=lcm(8, n_devices)`` to :func:`bucket_rows` when building.
    """
    n = mesh.shape[axis]
    sh = data_sharding(mesh, axis)
    out = []
    for b in br.buckets:
        if b.batch % n:
            raise ValueError(
                f"bucket batch {b.batch} not divisible by mesh axis {n}; "
                f"build buckets with row_align divisible by {n}")
        out.append(RowBucket(*(jax.device_put(a, sh) for a in b)))
    return BucketedRows(tuple(out), br.n_rows, br.n_cols, br.nnz,
                        br.empty_rows)
