"""ALX-style routed ALS sweep: all-to-all factor exchange + local solves.

Integrates the routing primitive (parallel/routing.py) into a real WRMF
half-sweep.  The plain mesh path lets XLA all-gather the whole source
factor table to every device before the per-nnz gathers; at DCN scale that
is wasteful — each device's bucket shard references only a subset of rows.
Here (the ALX recipe, arXiv:2112.02194, PAPERS.md):

- the source factor table is ROW-SHARDED over the mesh's data axis;
- a static routing plan (built once at staging — sparsity is fixed across
  ALS iterations) tells every owner which of its rows each peer needs;
- one ``all_to_all`` delivers per-device factor caches; bucket column
  indices were remapped to cache-local slots at staging;
- the rank x rank Gram ``X'X`` is a per-shard partial + ``psum`` (tiny
  wire cost), the batched normal-equation solves run device-local inside
  ``shard_map`` (reusing the exact single-device bucket kernels of
  ops/als.py), and only the solved target rows leave the region.

Enabled with ``WRMF(mesh=..., routing="alx")``.  Supports all three
solvers; per-entity biases and the dense zipf-head split stay on the
default path (reference solver contract: inst/include/wrmf_implicit.hpp
:91-305, wrmf_explicit.hpp:34-174).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.als import (ALSConfig, _solve_one_bucket, _src_reg_loss,
                       _assemble_target, _active_slices)
from ..config import accum_dtype
from ..sparse.device import BucketedRows, RowBucket
from .routing import RoutingPlan, build_routing_plan


class ALXStage(NamedTuple):
    """Staged ALX state for one sweep orientation (items or users)."""

    plan: RoutingPlan               # static all-to-all routing plan
    buckets: Tuple[RowBucket, ...]  # col_idx remapped to cache-local slots
    n_src_padded: int               # source rows incl. divisibility padding
    #: mesh axis (or tuple of axes, e.g. ("dcn","ici") on a multi-host
    #: mesh) the exchange and bucket batches ride on
    axis: object = "data"


def _axis_size(mesh: Mesh, axis) -> int:
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= mesh.shape[a]
        return n
    return mesh.shape[axis]


def _put(arr, mesh: Mesh, spec: P):
    """Place a host/global array with ``spec`` — process-local assembly
    when running multi-process (plain device_put cannot target
    non-addressable devices there)."""
    if jax.process_count() == 1:
        return jax.device_put(arr, NamedSharding(mesh, spec))
    if isinstance(arr, jax.Array) and not arr.is_fully_addressable:
        return jax.device_put(arr, NamedSharding(mesh, spec))  # reshard
    a = np.asarray(arr)
    if spec and spec[0] is not None:     # leading axis sharded: local slice
        n_proc = jax.process_count()
        if a.shape[0] % n_proc:
            raise ValueError(
                f"leading axis {a.shape[0]} not divisible by "
                f"{n_proc} processes — rows would be silently dropped")
        per = a.shape[0] // n_proc
        a = a[jax.process_index() * per:(jax.process_index() + 1) * per]
    return jax.make_array_from_process_local_data(
        NamedSharding(mesh, spec), a)


def stage_alx(
    br: BucketedRows,
    n_src: int,
    mesh: Mesh,
    axis="data",
    ragged: bool = False,
) -> ALXStage:
    """Build the routing plan + cache-remapped sharded buckets.

    ``br`` must be UNsharded (host-built) buckets whose batches divide the
    data-axis size; the returned buckets are device arrays with their batch
    axis sharded over ``axis`` and ``col_idx`` rewritten to cache-local
    slots (valid only on the owning device — they are meaningless outside
    the shard_map region).
    """
    n_dev = _axis_size(mesh, axis)
    n_src_p = -(-n_src // n_dev) * n_dev

    # per-device column-id sets: each bucket's batch is split contiguously
    per_dev = [[] for _ in range(n_dev)]
    for b in br.buckets:
        B = b.batch
        if B % n_dev:
            raise ValueError(f"bucket batch {B} not divisible by {n_dev}")
        step = B // n_dev
        ci = np.asarray(b.col_idx)
        for d in range(n_dev):
            per_dev[d].append(ci[d * step:(d + 1) * step])
    col_idx_per_device = [np.concatenate([a.ravel() for a in blocks])
                          if blocks else np.zeros((0,), np.int64)
                          for blocks in per_dev]

    if ragged:
        # zero per-pair padding on the wire (ragged_all_to_all; the dense
        # plan pads every pair to the global max — PERF.md round-5 wire
        # accounting measured that at 3.6x the information floor under
        # zipf reference skew)
        from .routing import build_ragged_routing_plan
        plan, remapped = build_ragged_routing_plan(
            col_idx_per_device, n_src_p, n_dev)
    else:
        plan, remapped = build_routing_plan(col_idx_per_device, n_src_p,
                                            n_dev)

    spec = P(axis)
    out = []
    for bi, b in enumerate(br.buckets):
        B = b.batch
        step = B // n_dev
        L = b.pad_len
        new_ci = np.empty((B, L), np.int32)
        for d in range(n_dev):
            # this bucket's flat slice within device d's concatenated ids
            off = sum(blk.size for blk in per_dev[d][:bi])
            flat = remapped[d][off:off + step * L]
            new_ci[d * step:(d + 1) * step] = flat.reshape(step, L)
        out.append(RowBucket(
            row_ids=_put(np.asarray(b.row_ids), mesh, spec),
            col_idx=_put(new_ci, mesh, spec),
            values=_put(np.asarray(b.values), mesh, spec),
            nnz=_put(np.asarray(b.nnz), mesh, spec),
        ))
    return ALXStage(plan, tuple(out), n_src_p, axis)


from .routing import exchange_body as _exchange_local  # shared with
# routed_factor_exchange — one body, no drift


# Compiled-callable caches: rebuilding jitted shard_map closures inside
# every sweep call would defeat jax's compilation cache (fresh function
# identity -> full retrace+recompile per half-sweep; same pitfall measured
# at 35 s vs 20 ms in parallel/topk_sharded.py).
_EXCHANGE_FNS: dict = {}
_BUCKET_FNS: dict = {}


def _get_exchange_fn(mesh: Mesh, axis, n_dev: int, m: int):
    key = (mesh, tuple(axis) if isinstance(axis, tuple) else axis, n_dev, m)
    fn = _EXCHANGE_FNS.get(key)
    if fn is None:
        def ex(src_l, req_l):
            return _exchange_local(src_l, req_l, axis, n_dev, m)

        fn = jax.jit(jax.shard_map(ex, mesh=mesh,
                                   in_specs=(P(axis), P(axis)),
                                   out_specs=P(axis), check_vma=False))
        _EXCHANGE_FNS[key] = fn
    return fn


def _get_ragged_exchange_fn(mesh: Mesh, axis, cache_size: int,
                            emulate_m: int):
    """Cached jitted ragged exchange (see _get_exchange_fn for why the
    closure must not be rebuilt per sweep).  ``emulate_m > 0`` selects
    the plan-equivalent dense emulation (XLA:CPU lacks
    ragged-all-to-all; routing.py ragged_exchange_body)."""
    from .routing import ragged_exchange_body

    if isinstance(axis, tuple):
        raise NotImplementedError(
            "routing='alx_ragged' supports single-axis meshes")
    key = ("ragged", mesh, axis, cache_size, emulate_m)
    fn = _EXCHANGE_FNS.get(key)
    if fn is None:
        def ex(src_l, want_l, io_l, ss_l, oo_l, rs_l):
            return ragged_exchange_body(
                src_l, want_l, io_l, ss_l, oo_l, rs_l, axis, cache_size,
                emulate_m=emulate_m)

        fn = jax.jit(jax.shard_map(ex, mesh=mesh,
                                   in_specs=(P(axis),) * 6,
                                   out_specs=P(axis), check_vma=False))
        _EXCHANGE_FNS[key] = fn
    return fn


def _get_bucket_fn(mesh: Mesh, axis, cfg: ALSConfig, n_tgt: int,
                   has_rhs0: bool, sdt_name: str, dt_name: str):
    """Per-bucket routed solve: device-local bucket kernel + psum'd loss.
    Cached per (mesh, cfg, n_tgt, dtype) — jit specializes on array shapes,
    so one entry serves every bucket shape of a fit."""
    axis_key = tuple(axis) if isinstance(axis, tuple) else axis
    key = (mesh, axis_key, cfg, n_tgt, has_rhs0, sdt_name, dt_name)
    fn = _BUCKET_FNS.get(key)
    if fn is not None:
        return fn
    sdt = jnp.dtype(sdt_name)
    dt = jnp.dtype(dt_name)

    def body(cache_l, XtX, rhs_init, old_l, rid_l, ci_l, val_l, nz_l,
             lam_, g_):
        bucket = RowBucket(rid_l, ci_l, val_l, nz_l)
        ids = jnp.minimum(rid_l, n_tgt - 1)
        valid = rid_l < n_tgt
        x_init = old_l[ids]
        y, le = _solve_one_bucket(cache_l, None, XtX,
                                  rhs_init if has_rhs0 else None, bucket,
                                  x_init, lam_, g_, cfg, sdt)
        y = jnp.where(valid[:, None], y, 0.0)
        return y.astype(dt), jax.lax.psum(
            jnp.sum(jnp.where(valid, le, 0.0)), axis)

    fn = jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axis), P(), P(), P(), P(axis), P(axis), P(axis),
                  P(axis), P(), P()),
        out_specs=(P(axis), P()), check_vma=False))
    _BUCKET_FNS[key] = fn
    return fn


def alx_sweep(
    mesh: Mesh,
    src: jax.Array,                # (n_src, R) host/replicated factors
    tgt_old: jax.Array,            # (n_tgt, R)
    stage: ALXStage,
    src_cnt: Optional[jax.Array],
    lam,
    g,
    cfg: ALSConfig,
) -> Tuple[jax.Array, jax.Array]:
    """One routed ALS half-sweep; numerically identical to
    :func:`ops.als.wrmf_sweep` on the same buckets.

    Per half-sweep: ONE routed exchange (the static plan covers every
    bucket's requests) and ONE full-table Gram/rhs_init build; each bucket
    then runs a device-local solve inside a cached shard_map program, and
    the solved rows are scattered into the replicated target table outside.
    """
    if cfg.with_biases:
        raise NotImplementedError("routing='alx' supports the no-per-entity"
                                  "-bias configurations")
    from ..ops.als import _sweep_prepare

    n_tgt = tgt_old.shape[0]
    R = src.shape[1]
    dtype = src.dtype
    sdt = accum_dtype(dtype)
    lam = jnp.asarray(lam, sdt)
    g = jnp.asarray(g, sdt)
    axis = stage.axis
    n_dev = _axis_size(mesh, axis)
    m = stage.plan.cache_size // n_dev

    # sweep-invariant pieces, computed once: active slices, full-table Gram
    # (+ridge) and global-bias rhs_init — same math as the unrouted path
    src_act, _, XtX, rhs_init = _sweep_prepare(src, lam, g, cfg, sdt)
    _, tgt_sl = _active_slices(cfg, R)
    d = src_act.shape[1]
    old_act = tgt_old[:, tgt_sl]
    has_rhs0 = rhs_init is not None
    if rhs_init is None:
        rhs_init = jnp.zeros((d,), sdt)

    src_x = src_act.astype(sdt)
    if stage.n_src_padded != src_x.shape[0]:
        src_x = jnp.concatenate([
            src_x, jnp.zeros((stage.n_src_padded - src_x.shape[0], d),
                             src_x.dtype)], axis=0)
    src_sh = _put(src_x, mesh, P(axis))

    # one exchange per sweep: only the referenced factor rows cross the wire
    from .routing import RaggedRoutingPlan, emulate_ragged
    if isinstance(stage.plan, RaggedRoutingPlan):
        p = stage.plan
        em = (max(int(np.asarray(p.send_sz).max()), 1)
              if emulate_ragged(mesh.devices.flat[0].platform) else 0)
        cache = _get_ragged_exchange_fn(mesh, axis, p.cache_size, em)(
            src_sh, _put(np.asarray(p.want), mesh, P(axis)),
            _put(np.asarray(p.in_off), mesh, P(axis)),
            _put(np.asarray(p.send_sz), mesh, P(axis)),
            _put(np.asarray(p.out_off), mesh, P(axis)),
            _put(np.asarray(p.recv_sz), mesh, P(axis)))
    else:
        req_sh = _put(np.asarray(stage.plan.request_ids).reshape(
            n_dev * n_dev, m), mesh, P(axis))
        cache = _get_exchange_fn(mesh, axis, n_dev, m)(src_sh, req_sh)

    bucket_fn = _get_bucket_fn(mesh, axis, cfg, n_tgt, has_rhs0,
                               str(jnp.dtype(sdt)), str(jnp.dtype(dtype)))
    result_act = jnp.zeros((n_tgt + 1, d), dtype=dtype)
    loss = jnp.zeros((), sdt)
    for b in stage.buckets:
        y, le = bucket_fn(cache, XtX, rhs_init, old_act, b.row_ids,
                          b.col_idx, b.values, b.nnz, lam, g)
        result_act = result_act.at[b.row_ids].set(y)
        loss = loss + le
    tgt_new = _assemble_target(result_act[:n_tgt], n_tgt, cfg, dtype)
    loss = loss + _src_reg_loss(src, src_cnt, lam, cfg, sdt)
    return tgt_new, loss
