"""ALX-style all-to-all factor routing.

Within one host, gathering source factors from a row-sharded table via
all-gather is fine (the whole table rides the interconnect).  Across hosts
that is wasteful: each host's CSR shard references only a subset of the
factor rows.  The ALX recipe (arXiv:2112.02194, PAPERS.md) routes *only the referenced rows*: every device asks each
owner for the rows its buckets touch, owners slice their shard, and a
single ``all_to_all`` delivers per-device factor caches; bucket column
indices are remapped to cache-local positions ahead of time (the sparsity
pattern is static across ALS iterations, so the routing plan is built once
on the host).

This module provides the routing plan + exchange primitive and a test-level
guarantee that a routed gather equals a direct global gather.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


class RoutingPlan(NamedTuple):
    """Static all-to-all routing plan for one bucket set.

    request_ids: (n_dev, n_dev, m) int32 — request_ids[d, o] are the rows
      device ``d`` wants from owner ``o``, as *owner-local* row indices
      (padded with 0; padding slots are never referenced after remap).
    cache_size: rows per device cache (= n_dev * m).
    remap:      per input shard, col_idx rewritten to cache-local ids.
    """

    request_ids: jax.Array
    cache_size: int
    shard_rows: int


def build_routing_plan(
    col_idx_per_device: Sequence[np.ndarray],
    n_src: int,
    n_dev: int,
) -> Tuple[RoutingPlan, list]:
    """Build the static plan and the remapped col_idx arrays.

    ``col_idx_per_device[d]`` holds the (arbitrary-shape) global column ids
    device ``d`` references.  The source table is row-sharded contiguously:
    owner(i) = i // shard_rows.
    """
    if n_src % n_dev:
        raise ValueError(
            "n_dev must divide n_src for contiguous sharding "
            f"(got n_src={n_src}, n_dev={n_dev}); pad the source table")
    shard_rows = n_src // n_dev

    needed = []   # per device: per owner unique local ids
    m = 1
    for d in range(n_dev):
        ids = np.unique(np.asarray(col_idx_per_device[d]).ravel())
        per_owner = []
        for o in range(n_dev):
            lo, hi = o * shard_rows, (o + 1) * shard_rows
            local = ids[(ids >= lo) & (ids < hi)] - lo
            per_owner.append(local)
            m = max(m, len(local))
        needed.append(per_owner)

    request_ids = np.zeros((n_dev, n_dev, m), np.int32)
    # lookup: global id -> cache slot, per device
    remapped = []
    for d in range(n_dev):
        lut = np.zeros(n_src, np.int32)
        for o in range(n_dev):
            local = needed[d][o]
            request_ids[d, o, :len(local)] = local
            slots = o * m + np.arange(len(local), dtype=np.int32)
            lut[o * shard_rows + local] = slots
        remapped.append(lut[np.asarray(col_idx_per_device[d])])

    plan = RoutingPlan(jnp.asarray(request_ids), n_dev * m, shard_rows)
    return plan, remapped


def routed_factor_exchange(
    mesh: Mesh,
    src: jax.Array,          # (n_src, r) row-sharded over `axis`
    plan: RoutingPlan,
    axis: str = "data",
) -> jax.Array:
    """Deliver each device's factor cache (n_dev, cache_size per device).

    Returns a (n_dev * cache_size, r) array sharded over ``axis`` whose
    device-local block is that device's cache; index it with the remapped
    col_idx from :func:`build_routing_plan`.
    """
    n_dev = mesh.shape[axis]
    m = plan.cache_size // n_dev
    req_sh = jax.device_put(
        plan.request_ids.reshape(n_dev * n_dev, m),
        NamedSharding(mesh, P(axis)))
    src_sh = jax.device_put(src, NamedSharding(mesh, P(axis)))

    def exchange(src_local, req_local):
        return exchange_body(src_local, req_local, axis, n_dev, m)

    fn = jax.shard_map(exchange, mesh=mesh,
                       in_specs=(P(axis), P(axis)),
                       out_specs=P(axis), check_vma=False)
    return fn(src_sh, req_sh)


def exchange_body(src_local, req_local, axis, n_dev: int, m: int):
    """Inside-shard_map body of the routed exchange (shared with
    parallel/alx.py).  req_local: (n_dev, m) — what *this* device wants
    from each owner; first an all_to_all of requests tells every owner
    what to slice, then one all_to_all delivers the caches."""
    want = jax.lax.all_to_all(req_local[None], axis, split_axis=1,
                              concat_axis=0)[:, 0, :]       # (n_dev, m)
    sliced = src_local[want]                                # (n_dev, m, r)
    cache = jax.lax.all_to_all(sliced, axis, split_axis=0,
                               concat_axis=0)               # (n_dev, m, r)
    return cache.reshape(n_dev * m, src_local.shape[1])


def wire_cost_report(plan: RoutingPlan, n_dev: int, rank: int,
                     itemsize: int = 4) -> dict:
    """Analytic per-sweep collective wire bytes of one routed factor
    exchange vs the plain data-parallel path's all-gather.

    This is the point of the ALX design (arXiv:2112.02194, PAPERS.md):
    the plain mesh path all-gathers the
    ENTIRE row-sharded source factor table to every device before the
    per-nnz gathers — wire bytes grow with the table; the routed exchange
    moves only (max-padded) referenced rows — wire bytes grow with the
    bucket shards' unique references and are INDEPENDENT of table size.

    Counts only off-device traffic (each device's own diagonal block of
    an all_to_all / its own shard in an all-gather stays local):

    - ``request_bytes``: int32 request-id all_to_all,
      ``n_dev * (n_dev-1) * m * 4``.
    - ``cache_bytes``: factor-row all_to_all,
      ``n_dev * (n_dev-1) * m * rank * itemsize``.
    - ``allgather_bytes``: the plain path,
      ``n_dev * (n_dev-1) * shard_rows * rank * itemsize``.

    ``m = cache_size / n_dev`` is the max unique referenced rows per
    (device, owner) pair — the all_to_all's static padding.  Totals are
    summed over all devices per exchange (one exchange per sweep
    orientation per ALS iteration; the request all_to_all is
    iteration-invariant and could be hoisted, it is counted here).
    """
    m = plan.cache_size // n_dev
    off = n_dev * (n_dev - 1)
    request_bytes = off * m * 4
    cache_bytes = off * m * rank * itemsize
    allgather_bytes = off * plan.shard_rows * rank * itemsize
    return {
        "n_dev": n_dev,
        "m": m,
        "shard_rows": plan.shard_rows,
        "request_bytes": request_bytes,
        "cache_bytes": cache_bytes,
        "routed_total_bytes": request_bytes + cache_bytes,
        "allgather_bytes": allgather_bytes,
        "routed_over_allgather": (request_bytes + cache_bytes)
        / max(allgather_bytes, 1),
    }


class RaggedRoutingPlan(NamedTuple):
    """Static ragged all-to-all routing plan (no per-pair max padding).

    The dense :class:`RoutingPlan` pads every (device, owner) request list
    to the GLOBAL max ``m`` — under zipf reference skew that inflates wire
    bytes ~3.6x over the information floor (PERF.md round-5 accounting).
    ``jax.lax.ragged_all_to_all`` moves exactly the requested rows; only
    the STATIC buffer bounds are padded (per-owner total send rows /
    per-device total receive rows — maxima of SUMS, not sums of maxima).

    Per-device rows (stacked along the device axis, sharded at dispatch):

    - ``want[d]``: (S_send_max,) owner-local row ids this device (as
      OWNER) must slice, concatenated by requester id (padding -> 0)
    - ``in_off[d][j]`` / ``send_sz[d][j]``: slice of ``want``'s gathered
      rows destined to requester ``j``
    - ``out_off[d][j]``: offset in requester ``j``'s cache where owner
      ``d``'s chunk lands (receiver caches are concatenated by owner id)
    - ``recv_sz[d][j]``: rows device ``d`` receives from owner ``j``

    ``cache_size`` = max over devices of total requested rows.
    """

    want: jax.Array
    in_off: jax.Array
    send_sz: jax.Array
    out_off: jax.Array
    recv_sz: jax.Array
    cache_size: int
    shard_rows: int


def build_ragged_routing_plan(
    col_idx_per_device: Sequence[np.ndarray],
    n_src: int,
    n_dev: int,
) -> Tuple[RaggedRoutingPlan, list]:
    """Build the ragged plan + cache-remapped col_idx arrays (same
    contract as :func:`build_routing_plan`)."""
    if n_src % n_dev:
        raise ValueError(
            "n_dev must divide n_src for contiguous sharding "
            f"(got n_src={n_src}, n_dev={n_dev}); pad the source table")
    shard_rows = n_src // n_dev

    # needed[d][o]: sorted unique owner-local ids device d wants from o
    needed = []
    for d in range(n_dev):
        ids = np.unique(np.asarray(col_idx_per_device[d]).ravel())
        needed.append([ids[(ids >= o * shard_rows)
                           & (ids < (o + 1) * shard_rows)] - o * shard_rows
                       for o in range(n_dev)])
    n = np.array([[len(needed[d][o]) for o in range(n_dev)]
                  for d in range(n_dev)], np.int64)   # n[requester, owner]

    send_total = n.sum(axis=0)          # per owner: rows it must send
    recv_total = n.sum(axis=1)          # per requester: rows it receives
    s_send = int(send_total.max()) if n_dev else 1
    cache_size = int(recv_total.max()) if n_dev else 1
    s_send = max(s_send, 1)
    cache_size = max(cache_size, 1)

    want = np.zeros((n_dev, s_send), np.int32)
    in_off = np.zeros((n_dev, n_dev), np.int32)
    send_sz = np.zeros((n_dev, n_dev), np.int32)
    out_off = np.zeros((n_dev, n_dev), np.int32)
    recv_sz = np.zeros((n_dev, n_dev), np.int32)
    # receiver cache offsets: concat by owner id
    cache_off = np.zeros((n_dev, n_dev), np.int64)
    for d in range(n_dev):
        cache_off[d] = np.concatenate([[0], np.cumsum(n[d])[:-1]])

    remapped = []
    for d in range(n_dev):
        # as OWNER: slices ordered by requester j
        pos = 0
        for j in range(n_dev):
            ids = needed[j][d]
            in_off[d, j] = pos
            send_sz[d, j] = len(ids)
            want[d, pos:pos + len(ids)] = ids
            pos += len(ids)
            # where owner d's chunk lands on requester j
            out_off[d, j] = cache_off[j, d]
        # as REQUESTER: sizes received from each owner
        recv_sz[d] = n[d]
        # remap this device's col ids to cache slots
        lut = np.zeros(n_src, np.int32)
        for o in range(n_dev):
            ids = needed[d][o]
            lut[o * shard_rows + ids] = (
                cache_off[d, o] + np.arange(len(ids), dtype=np.int64)
            ).astype(np.int32)
        remapped.append(lut[np.asarray(col_idx_per_device[d])])

    plan = RaggedRoutingPlan(
        jnp.asarray(want), jnp.asarray(in_off), jnp.asarray(send_sz),
        jnp.asarray(out_off), jnp.asarray(recv_sz), cache_size, shard_rows)
    return plan, remapped


def ragged_exchange_body(src_local, want_l, in_off_l, send_sz_l,
                         out_off_l, recv_sz_l, axis, cache_size: int,
                         emulate_m: int = 0):
    """Inside-shard_map body of the ragged routed exchange: slice the
    owner-ordered rows, then ONE ragged_all_to_all delivers every
    device's cache with zero per-pair padding on the wire.

    ``emulate_m > 0`` replaces the ragged collective with a dense
    all_to_all padded to ``emulate_m`` rows per pair — XLA:CPU does not
    implement ragged-all-to-all, so the CPU-mesh tests validate the
    plan/offset/remap math through the emulation while accelerators run
    the real collective (identical results by construction)."""
    r = src_local.shape[1]
    sliced = src_local[want_l[0]]                       # (S_send_max, r)
    n_dev = send_sz_l.shape[1]
    if not emulate_m:
        out = jnp.zeros((cache_size, r), src_local.dtype)
        return jax.lax.ragged_all_to_all(
            sliced, out, in_off_l[0], send_sz_l[0], out_off_l[0],
            recv_sz_l[0], axis_name=axis)
    M = emulate_m
    iota = jnp.arange(M, dtype=jnp.int32)[None, :]
    idx = in_off_l[0][:, None] + iota                   # (n_dev, M)
    oks = iota < send_sz_l[0][:, None]
    chunk = jnp.where(
        oks[..., None],
        sliced[jnp.minimum(idx, sliced.shape[0] - 1)], 0.0)
    recv = jax.lax.all_to_all(chunk, axis, 0, 0)        # (n_dev, M, r)
    # local cache offsets by owner = exclusive cumsum of recv sizes
    roff = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32),
         jnp.cumsum(recv_sz_l[0])[:-1].astype(jnp.int32)])
    okr = iota < recv_sz_l[0][:, None]
    pos = jnp.where(okr, roff[:, None] + iota, cache_size)
    out = jnp.zeros((cache_size + 1, r), src_local.dtype)
    out = out.at[pos.reshape(-1)].add(
        jnp.where(okr[..., None], recv, 0.0).reshape(-1, r))
    return out[:cache_size]


def emulate_ragged(platform: str) -> bool:
    """Whether the ragged exchange on devices of ``platform`` runs as the
    dense emulation: only on ``"cpu"``, whose XLA backend has no
    ragged-all-to-all.  Every other platform runs the real collective."""
    return platform == "cpu"


def ragged_factor_exchange(
    mesh: Mesh,
    src: jax.Array,
    plan: RaggedRoutingPlan,
    axis: str = "data",
    emulate: Optional[bool] = None,
) -> jax.Array:
    """Deliver each device's ragged factor cache; index it with the
    remapped col_idx from :func:`build_ragged_routing_plan`.  Returns a
    (n_dev * cache_size, r) array sharded over ``axis``.

    ``emulate=None`` auto-selects by :func:`emulate_ragged`."""
    n_dev = mesh.shape[axis]
    if emulate is None:
        emulate = emulate_ragged(mesh.devices.flat[0].platform)
    emulate_m = int(np.asarray(plan.send_sz).max()) if emulate else 0
    emulate_m = max(emulate_m, 1) if emulate else 0
    sh = NamedSharding(mesh, P(axis))
    args = (jax.device_put(src, sh),
            jax.device_put(plan.want, sh),
            jax.device_put(plan.in_off, sh),
            jax.device_put(plan.send_sz, sh),
            jax.device_put(plan.out_off, sh),
            jax.device_put(plan.recv_sz, sh))

    def ex(src_l, want_l, io_l, ss_l, oo_l, rs_l):
        return ragged_exchange_body(src_l, want_l, io_l, ss_l, oo_l, rs_l,
                                    axis, plan.cache_size, emulate_m)

    fn = jax.shard_map(ex, mesh=mesh, in_specs=(P(axis),) * 6,
                       out_specs=P(axis), check_vma=False)
    return fn(*args)


def wire_cost_report_ragged(plan: RaggedRoutingPlan, n_dev: int,
                            rank: int, itemsize: int = 4) -> dict:
    """Analytic off-device wire bytes of the ragged exchange: exactly the
    requested rows (minus each device's self-chunk)."""
    n = np.asarray(plan.recv_sz, np.int64)              # (n_dev, n_dev)
    off_device = int(n.sum() - np.trace(n))
    cache_bytes = off_device * rank * itemsize
    return {
        "n_dev": n_dev,
        "rows_on_wire": off_device,
        "cache_bytes": cache_bytes,
        "routed_total_bytes": cache_bytes,   # requests are static (staged)
        "allgather_bytes": n_dev * (n_dev - 1) * plan.shard_rows
        * rank * itemsize,
    }
