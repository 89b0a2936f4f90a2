"""Row-sharded state tables for the SGD model family.

The reference parallelizes its SGD models with shared-memory hogwild —
OpenMP threads racing scatter-updates into one table (reference
src/GloVe.cpp:91-94, src/rankmf.cpp:133-140, src/FTRL.cpp:122-125,
src/factorization_machine.cpp:124-127).  The device-mesh replacement keeps
the deterministic-minibatch kernels and distributes the *state*: every
table (embeddings, biases, AdaGrad accumulators, FTRL (z, n)) is
row-sharded over a mesh axis, so model memory — the scaling limit at
BASELINE config #5's 10M-user scale — splits across devices/hosts.

Design: **replicated batch, sharded tables.**  A minibatch's ids and
values are replicated; every device computes the full batch's elementwise
update math redundantly.  That is deliberate: the batch elementwise FLOPs
are the same order as the masking work each device already does inside a
sharded gather, so slicing the batch would add all-gathers of gradients
without removing any bottleneck.  What scales is what must scale:

- table memory:       1/n per device
- gather bandwidth:   each device reads only its own shard rows
- scatter bandwidth:  each device writes only its own shard rows
- wire cost:          one ``psum`` of batch-sized gathers per phase
                      (proportional to the minibatch, never the table)

The primitives form a tiny algebra used *inside* ``jax.shard_map``:

- :meth:`ShardedOps.gather` — masked local gather + ``psum`` over the
  mesh axes: ``table[ids]`` where ``table`` is the local row shard and
  ``ids`` are global (replicated) row ids.
- :meth:`ShardedOps.scatter_add` — masked local scatter-add: each device
  applies only the updates landing in its row range.

:class:`DirectOps` implements the same contract with plain indexing, so
every model kernel is written ONCE against the ``ops`` object and runs
identically on a single device and under ``shard_map`` — scatter/gather
aggregation order is the only difference (f32 reduction-order noise).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

Axes = Union[str, Tuple[str, ...]]


class DirectOps:
    """Single-device table ops: plain gather / scatter-add."""

    is_sharded = False

    def gather(self, table: jax.Array, ids: jax.Array) -> jax.Array:
        return table[ids]

    def gather_many(self, pairs):
        return tuple(t[i] for t, i in pairs)

    def scatter_add(self, table, ids, upd) -> jax.Array:
        return table.at[ids].add(upd)

    def add_dense(self, table, delta) -> jax.Array:
        """table += delta where delta covers the table's full (global)
        row range — the scatter-free update of ops/segsum.py."""
        return table + delta

    def add_dense_cols(self, table, delta, col_start: int) -> jax.Array:
        """table[:, col_start:col_start+w] += delta (full global row
        range) — column-window variant for packed state tables."""
        return table.at[:, col_start:col_start + delta.shape[1]].add(delta)


class ShardedOps:
    """Table ops inside a ``shard_map`` region over mesh axes ``axes``.

    Tables are local row shards (global row ``g`` lives on shard
    ``g // per`` at local row ``g % per``, ``per`` = local shape[0]); ids
    are global and replicated across the axes.
    """

    is_sharded = True

    def __init__(self, axes: Axes):
        self.axes = (axes,) if isinstance(axes, str) else tuple(axes)

    def _linear_index(self):
        idx = None
        for ax in self.axes:
            i = jax.lax.axis_index(ax)
            idx = i if idx is None else idx * jax.lax.psum(1, ax) + i
        return idx

    def _local(self, table, ids):
        per = table.shape[0]
        local = ids - self._linear_index() * per
        ok = (local >= 0) & (local < per)
        return jnp.clip(local, 0, per - 1), ok

    def _masked_gather(self, table, ids):
        safe, ok = self._local(table, ids)
        g = table[safe]
        okb = ok.reshape(ok.shape + (1,) * (g.ndim - ok.ndim))
        return jnp.where(okb, g, 0)

    def gather(self, table, ids):
        return jax.lax.psum(self._masked_gather(table, ids), self.axes)

    def gather_many(self, pairs):
        """Fused multi-table gather: ONE psum over the whole tuple (one
        collective launch instead of len(pairs))."""
        parts = tuple(self._masked_gather(t, i) for t, i in pairs)
        return jax.lax.psum(parts, self.axes)

    def scatter_add(self, table, ids, upd):
        safe, ok = self._local(table, ids)
        okb = ok.reshape(ok.shape + (1,) * (upd.ndim - ok.ndim))
        return table.at[safe].add(jnp.where(okb, upd, 0))

    def add_dense(self, table, delta):
        """Local shard += its slice of the replicated global delta (the
        delta is computed replicated from replicated batch data, so each
        shard just takes its own row window — no collective needed)."""
        per = table.shape[0]
        start = self._linear_index() * per
        return table + jax.lax.dynamic_slice_in_dim(delta, start, per, 0)

    def add_dense_cols(self, table, delta, col_start: int):
        per = table.shape[0]
        start = self._linear_index() * per
        d = jax.lax.dynamic_slice_in_dim(delta, start, per, 0)
        return table.at[:, col_start:col_start + d.shape[1]].add(d)


# -- host-side staging helpers ------------------------------------------------


def mesh_table_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The mesh axes a state table's row axis shards over: ``("dcn",
    "ici")`` on a multihost mesh, else every mesh axis (usually
    ``("data",)``)."""
    from .multihost import DATA_AXES

    if DATA_AXES[0] in mesh.axis_names:
        return DATA_AXES
    return tuple(mesh.axis_names)


def axes_size(mesh: Mesh, axes: Axes) -> int:
    axes = (axes,) if isinstance(axes, str) else axes
    n = 1
    for ax in axes:
        n *= mesh.shape[ax]
    return n


def padded_rows(n: int, mesh: Mesh, axes: Optional[Axes] = None) -> int:
    """Table rows padded up so the row axis divides the mesh axes."""
    d = axes_size(mesh, axes if axes is not None else mesh_table_axes(mesh))
    return -(-n // d) * d


def _put(arr: jax.Array, sharding: NamedSharding) -> jax.Array:
    """Place a process-local array under ``sharding`` — ``device_put``
    in-process; per-shard callback assembly when the mesh spans processes
    (multi-controller: every process passes the same values)."""
    if all(d.process_index == jax.process_index()
           for d in sharding.mesh.devices.flat):
        return jax.device_put(arr, sharding)
    host = np.asarray(arr)
    return jax.make_array_from_callback(host.shape, sharding,
                                        lambda idx: host[idx])


def shard_table(arr, mesh: Mesh, axes: Optional[Axes] = None,
                n_rows: Optional[int] = None) -> jax.Array:
    """Pad ``arr``'s row axis to the mesh and place it row-sharded.

    Padding rows are zeros — sharded gathers/scatters only ever touch real
    ids, so their value is irrelevant; zeros keep checkpoints clean."""
    if axes is None:
        axes = mesh_table_axes(mesh)
    a = jnp.asarray(arr)
    n = a.shape[0] if n_rows is None else n_rows
    np_ = padded_rows(n, mesh, axes)
    if np_ != a.shape[0]:
        pad = [(0, np_ - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
        a = jnp.pad(a, pad)
    return _put(a, NamedSharding(mesh, P(axes)))


def replicate_on(mesh: Mesh, tree):
    """Place a pytree of arrays fully replicated on the mesh (minibatch
    ids/values: streamed read-only data, not state)."""
    sh = NamedSharding(mesh, P())
    return jax.tree.map(lambda a: _put(jnp.asarray(a), sh), tree)


def unshard(arr, n: Optional[int] = None) -> np.ndarray:
    """Materialize a (possibly padded, sharded) table on host, sliced back
    to its logical row count.  On a multi-process mesh the row shards are
    first all-gathered to a replicated layout (a tiny jitted identity with
    replicated out_shardings), since np.asarray only reads fully-replicated
    or addressable arrays."""
    if isinstance(arr, jax.Array) and not arr.is_fully_addressable \
            and not arr.sharding.is_fully_replicated:
        mesh = arr.sharding.mesh
        arr = jax.jit(lambda a: a,
                      out_shardings=NamedSharding(mesh, P()))(arr)
    a = np.asarray(arr)
    return a if n is None else a[:n]
