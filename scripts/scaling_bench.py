#!/usr/bin/env python
"""Scaling-efficiency benchmark: sharded WRMF sweep vs device count.

    python scripts/scaling_bench.py --devices 1 2 4 8 [--cpu]

On several accelerators this measures sweep scaling with device count;
with --cpu it runs on virtual host devices
(functional validation — on an oversubscribed host the timings are not
meaningful).  Prints one JSON line per device count.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--cpu", action="store_true",
                    help="force CPU platform with virtual devices")
    ap.add_argument("--users", type=int, default=32768)
    ap.add_argument("--items", type=int, default=16384)
    ap.add_argument("--rank", type=int, default=128)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    if args.cpu:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                   f" --xla_force_host_platform_device_count="
                                   f"{max(args.devices)}")
    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from rsparse_tpu.config import use_compile_cache
    use_compile_cache()
    import jax.numpy as jnp
    import bench
    from rsparse_tpu.ops.als import ALSConfig, CONJUGATE_GRADIENT
    from rsparse_tpu.ops.als import wrmf_sweep
    from rsparse_tpu.parallel.mesh import make_mesh, shard_buckets
    from rsparse_tpu.sparse.device import bucket_rows
    from jax.sharding import NamedSharding, PartitionSpec as P

    csr = bench.synth_ml20m_like(args.users, args.items)
    rng = np.random.default_rng(0)
    base_t = None
    sweep = jax.jit(wrmf_sweep, static_argnames=("cfg",))
    for n in args.devices:
        if n > jax.device_count():
            print(json.dumps({"devices": n, "skipped": "not enough devices"}))
            continue
        mesh = make_mesh((n,), ("data",), jax.devices()[:n])
        ui = bucket_rows(csr, jnp.float32, row_align=8 * n, max_buckets=6)
        ui = shard_buckets(ui, mesh, "data")
        U = jnp.asarray(rng.standard_normal((args.users, args.rank)) * 0.01,
                        jnp.float32)
        V = jax.device_put(
            jnp.asarray(rng.standard_normal((args.items, args.rank)) * 0.01,
                        jnp.float32), NamedSharding(mesh, P()))
        cfg = ALSConfig(feedback="implicit", solver=CONJUGATE_GRADIENT,
                        compute_dtype="bfloat16")
        with mesh:
            U2, _ = sweep(V, U, ui.buckets, None, 0.1, 0.0, cfg)
            U2.block_until_ready()
            times = []
            for _ in range(args.reps):
                t0 = time.time()
                U2, _ = sweep(V, U2, ui.buckets, None, 0.1, 0.0, cfg)
                U2.block_until_ready()
                times.append(time.time() - t0)
        dt = min(times)
        if base_t is None:
            base_t = dt
            eff = 1.0
        else:
            eff = base_t / (dt * n / args.devices[0])
        print(json.dumps({
            "devices": n, "ms_per_sweep": round(dt * 1e3, 1),
            "updates_per_s": round(args.users / dt),
            "scaling_efficiency": round(eff, 3),
        }), flush=True)


if __name__ == "__main__":
    main()
