"""Multi-host (multi-process) distributed runtime.

The reference has no multi-node layer at all — its parallelism stops at
shared-memory OpenMP (reference inst/include/wrmf_implicit.hpp:162-174;
SURVEY §2.4).  This module is the net-new distributed component this
package adds on top of the same SPMD kernels:

- :func:`initialize` — process bring-up (``jax.distributed.initialize``;
  gloo collectives when the backend is CPU, for multi-process tests).
- :func:`make_multihost_mesh` — a ``("dcn", "ici")`` device mesh: the
  ``dcn`` axis spans processes (slow inter-host network), ``ici`` the
  devices within each process (fast interconnect).  Batch axes shard over
  ``("dcn", "ici")`` jointly, so XLA keeps the heavy collectives on ICI
  and only crosses DCN at the hierarchy boundary.
- :func:`distributed_bucket_rows` — per-process bucket building: every
  host buckets only its OWN contiguous CSR row shard (the multi-host
  analog of the host ingestion layer, reference src/utils.cpp:58-78);
  bucket shapes are negotiated across hosts with tiny metadata
  all-gathers, and the global device arrays are assembled shard-locally
  via ``jax.make_array_from_process_local_data`` — no host ever
  materializes another host's interactions on device.
- :func:`replicate` — fully-replicated global arrays (factor tables) from
  process-local copies (every process computes the same seeded init).

The model integration is ``WRMF(mesh=make_multihost_mesh())``: the sweeps
are unchanged SPMD programs (ops/als.py); only array construction differs.
Every process must execute the same program sequence — the standard
multi-controller discipline.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..sparse.device import BucketedRows, RowBucket, _length_grid, _round_up


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    local_device_count: Optional[int] = None,
) -> None:
    """Bring up the distributed runtime for this process.

    On CPU backends (multi-process tests; ``jax_platforms=cpu``) this also
    selects gloo cross-process collectives and — when
    ``local_device_count`` is given — the virtual per-process device count.
    GPU processes get their devices from JAX's CUDA plugin (each process
    sees the cards it is given, e.g. through ``CUDA_VISIBLE_DEVICES``) and
    ignore ``local_device_count``; the coordinator address, process count
    and process id must be passed explicitly.
    """
    import os

    if local_device_count is not None:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count="
                f"{local_device_count}").strip()
    try:
        if jax.config.jax_platforms in (None, "", "cpu"):
            jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:  # noqa: BLE001 - older jax without the option
        pass
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


#: axis names of the hierarchical data mesh: ``dcn`` crosses hosts, ``ici``
#: the in-host devices.  Batch axes shard over the tuple.
DATA_AXES: Tuple[str, str] = ("dcn", "ici")


def make_multihost_mesh(axis_names: Tuple[str, str] = DATA_AXES) -> Mesh:
    """A ``(n_processes, devices_per_process)`` mesh over all global devices.

    Device order is process-major, so a batch axis sharded over
    ``(dcn, ici)`` gives each process a contiguous block of rows landing on
    its own local devices — the layout :func:`distributed_bucket_rows`
    builds for.
    """
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    n_proc = jax.process_count()
    n_local = len(devs) // n_proc
    arr = np.asarray(devs).reshape(n_proc, n_local)
    return Mesh(arr, axis_names)


def is_multihost(mesh: Optional[Mesh]) -> bool:
    """True for any ``("dcn", "ici")``-style mesh — including in a single
    process (where :func:`distributed_bucket_rows` degenerates cleanly), so
    a pod program can be dry-run locally without a KeyError on the missing
    "data" axis."""
    return mesh is not None and DATA_AXES[0] in mesh.axis_names


def data_spec(mesh: Mesh) -> P:
    """PartitionSpec sharding a leading batch axis over the mesh's data
    axes (``("dcn","ici")`` on a multihost mesh, ``"data"`` otherwise)."""
    if DATA_AXES[0] in mesh.axis_names:
        return P(DATA_AXES)
    return P("data")


def replicate(arr, mesh: Mesh) -> jax.Array:
    """A fully-replicated global array from this process's local copy
    (every process must pass the same values)."""
    return jax.make_array_from_process_local_data(
        NamedSharding(mesh, P()), np.asarray(arr))


def process_row_range(n_rows: int, n_proc: Optional[int] = None,
                      pid: Optional[int] = None) -> Tuple[int, int]:
    """This process's contiguous row range ``[lo, hi)`` of a global row
    axis: ``ceil(n_rows / n_proc)`` rows per process, last one short."""
    n_proc = jax.process_count() if n_proc is None else n_proc
    pid = jax.process_index() if pid is None else pid
    per = -(-n_rows // n_proc)
    lo = min(pid * per, n_rows)
    return lo, min(lo + per, n_rows)


def _allgather_max(x: np.ndarray) -> np.ndarray:
    """Element-wise max of a small int array across processes."""
    from jax.experimental import multihost_utils
    g = multihost_utils.process_allgather(np.asarray(x))
    return np.max(np.asarray(g), axis=0)


def distributed_bucket_rows(
    local_csr: sp.spmatrix,
    row_offset: int,
    n_rows: int,
    n_cols: int,
    mesh: Mesh,
    dtype=jnp.float32,
    *,
    min_len: int = 8,
    max_buckets: int = 24,
    length_ratio: float = 1.25,
    include_empty: bool = False,
    max_elems: Optional[int] = 1 << 22,
) -> BucketedRows:
    """Build globally-sharded :class:`BucketedRows` from per-process shards.

    Each process passes only its own contiguous row shard (``local_csr``,
    global rows ``[row_offset, row_offset + local_csr.shape[0])``).  Shapes
    are negotiated with two tiny all-gathers (max row length; per-length
    populations), after which every process builds identical-shape local
    blocks — padded with sentinel rows (``row_id == n_rows``) where its
    shard has fewer members — and assembles global arrays whose batch axis
    is sharded ``(dcn, ici)``-process-major, so each device holds rows of
    its own host only.
    """
    csr = sp.csr_matrix(local_csr)
    csr.sort_indices()
    n_local_rows = csr.shape[0]
    n_proc = jax.process_count()
    n_local_dev = len(jax.local_devices())
    row_align = 8 * n_local_dev if 8 % n_local_dev else 8

    row_nnz = np.diff(csr.indptr).astype(np.int64)
    if include_empty:
        active = np.arange(n_local_rows, dtype=np.int64)
    else:
        active = np.flatnonzero(row_nnz > 0).astype(np.int64)
    act_nnz = np.maximum(row_nnz[active], 1) if active.size else \
        np.zeros((0,), np.int64)

    # --- negotiate a common length grid (one scalar all-gather) ----------
    local_max = int(act_nnz.max()) if active.size else min_len
    global_max = int(_allgather_max(np.asarray([local_max]))[0])
    grid = _length_grid(min_len, global_max, length_ratio)
    lengths = grid[np.searchsorted(grid, act_nnz)] if active.size else \
        np.zeros((0,), np.int64)

    # --- merge sparsely-populated lengths IDENTICALLY on all hosts -------
    from jax.experimental import multihost_utils
    local_counts = np.asarray(
        [(lengths == L).sum() for L in grid], np.int64)
    all_counts = np.asarray(multihost_utils.process_allgather(local_counts))
    gcounts = all_counts.sum(axis=0)
    live = [i for i in range(len(grid)) if gcounts[i] > 0]
    while len(live) > max_buckets:
        k = int(np.argmin([gcounts[i] for i in live[:-1]]))
        src_i, dst_i = live[k], live[k + 1]
        lengths[lengths == grid[src_i]] = grid[dst_i]
        gcounts[dst_i] += gcounts[src_i]
        gcounts[src_i] = 0
        live.pop(k)

    # --- per-length: equal per-process padded batches --------------------
    per_len_local = np.asarray(
        [(lengths == grid[i]).sum() for i in live], np.int64)
    per_len_max = _allgather_max(per_len_local)

    np_val = np.float64 if jnp.dtype(dtype) == jnp.float64 else np.float32
    spec = data_spec(mesh)
    sharding = NamedSharding(mesh, spec)
    sh1 = NamedSharding(mesh, P(spec[0]) if len(spec) else P())

    buckets = []
    nnz_total = int(csr.nnz)
    for i, li in enumerate(live):
        L = int(grid[li])
        rows_all = active[lengths == grid[li]]
        B_target = int(per_len_max[i])          # max members on any host
        if max_elems is not None:
            chunk_rows = max(_round_up(max(max_elems // L, 1), row_align),
                             row_align)
        else:
            chunk_rows = max(_round_up(B_target, row_align), row_align)
        n_chunks = max(-(-B_target // chunk_rows), 1)
        for c in range(n_chunks):
            s = c * chunk_rows
            want = min(chunk_rows, B_target - s) if B_target > s else 0
            B = _round_up(max(want, 1), row_align)
            rows = rows_all[s:s + want]
            # local sentinel = n_rows - row_offset, so the uniform
            # +row_offset shift lands padding exactly on the global
            # sentinel ``n_rows``
            sentinel_base = n_rows - row_offset
            native_out = None
            if csr.nnz:
                from ..native import fill_bucket
                native_out = fill_bucket(csr.indptr, csr.indices, csr.data,
                                         rows, B, L, sentinel_base, np_val)
            if native_out is not None:
                col_idx, values, nnz_arr, row_ids = native_out
                row_ids = row_ids + np.int32(row_offset)
            else:
                nnz_arr = np.zeros((B,), np.int32)
                nnz_arr[:len(rows)] = row_nnz[rows]
                row_ids = np.full((B,), n_rows, np.int32)
                row_ids[:len(rows)] = rows + row_offset
                starts = np.zeros((B,), np.int64)
                starts[:len(rows)] = csr.indptr[rows]
                offs = np.arange(L, dtype=np.int64)[None, :]
                flat = np.minimum(starts[:, None] + offs,
                                  max(csr.nnz - 1, 0))
                ok = offs < nnz_arr[:, None]
                if csr.nnz:
                    col_idx = np.where(ok, csr.indices[flat],
                                       0).astype(np.int32)
                    values = np.where(ok, csr.data[flat], 0).astype(np_val)
                else:
                    col_idx = np.zeros((B, L), np.int32)
                    values = np.zeros((B, L), np_val)
            mk = jax.make_array_from_process_local_data
            buckets.append(RowBucket(
                row_ids=mk(sh1, row_ids),
                col_idx=mk(sharding, col_idx),
                values=mk(sharding, values.astype(np_val)),
                nnz=mk(sh1, nnz_arr),
            ))

    gnnz = int(np.asarray(
        multihost_utils.process_allgather(
            np.asarray([nnz_total], np.int64))).sum())
    # global empty-row list via a padded all-gather (each process pads its
    # shard's list to the global max count), so the public field means the
    # same thing it does on the single-host builder
    empty_local = np.flatnonzero(row_nnz == 0).astype(np.int32) + row_offset
    cnts = np.asarray(multihost_utils.process_allgather(
        np.asarray([len(empty_local)], np.int64))).reshape(-1)
    cap = int(cnts.max()) if cnts.size else 0
    if cap:
        padded = np.full((cap,), -1, np.int32)
        padded[: len(empty_local)] = empty_local
        allp = np.asarray(
            multihost_utils.process_allgather(padded)).reshape(-1, cap)
        empty = np.sort(np.concatenate(
            [allp[p, : int(cnts[p])] for p in range(allp.shape[0])]
        )).astype(np.int32)
    else:
        empty = empty_local
    return BucketedRows(tuple(buckets), n_rows, n_cols, gnnz, empty)
