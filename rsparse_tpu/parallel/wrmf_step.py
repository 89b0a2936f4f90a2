"""Sharded WRMF training step: one full ALS iteration under SPMD.

Replaces the reference's per-iteration pair of OpenMP-parallel native calls
(R/model_WRMF.R:318-338) with a single jitted program over a
``("data", "model")`` device mesh:

- interaction buckets are sharded along their batch axis over ``data``
  (data parallelism over the entities being solved);
- user/item factor tables are row-sharded over ``model`` (the embedding
  tables are the model state — the MF analog of tensor/expert parallelism);
- XLA inserts the collectives: all-gather of source factor shards feeding
  the nnz gathers, psum of the rank x rank Gram and of the loss.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.als import ALSConfig, wrmf_sweep
from ..sparse.device import BucketedRows


@partial(jax.jit, static_argnames=("cfg_items", "cfg_users"))
def train_step(
    U: jax.Array,
    V: jax.Array,
    iu_buckets,
    ui_buckets,
    cnt_u: jax.Array,
    cnt_i: jax.Array,
    lam: jax.Array,
    g: jax.Array,
    cfg_items: ALSConfig,
    cfg_users: ALSConfig,
    hot_iu=None,
    hot_ui=None,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """One full ALS iteration (items then users), jitted end-to-end.

    ``hot_iu`` / ``hot_ui`` are optional dense zipf-head blocks
    (sparse/device.py ``HotBlock``, placed with ``mesh.shard_hot``): the
    head columns' normal-equation terms run as matmuls whose H-axis
    contractions psum over the ``model`` axis.
    """
    V, _ = wrmf_sweep(U, V, iu_buckets, cnt_u, lam, g, cfg_items,
                      hot=hot_iu)
    U, loss = wrmf_sweep(V, U, ui_buckets, cnt_i, lam, g, cfg_users,
                         hot=hot_ui)
    return U, V, loss


def shard_problem(
    mesh: Mesh,
    U: jax.Array,
    V: jax.Array,
    iu: BucketedRows,
    ui: BucketedRows,
):
    """Place factors row-sharded over ``model`` and buckets batch-sharded
    over ``data``.  Factor row counts must divide the ``model`` axis size;
    bucket batches the ``data`` axis size."""
    from .mesh import shard_buckets

    fsh = NamedSharding(mesh, P("model"))
    U = jax.device_put(U, fsh)
    V = jax.device_put(V, fsh)
    iu_s = shard_buckets(iu, mesh, "data")
    ui_s = shard_buckets(ui, mesh, "data")
    return U, V, iu_s, ui_s
