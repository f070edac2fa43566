#!/usr/bin/env python3
"""Scaling-efficiency harness: batched registrations/s across a device mesh.

Measures registrations/s and points/s at 1 device and at N devices for the
batched data-parallel aligner (parallel.align_batched_sharded). On several
GPUs (or hosts, after ``parallel.distributed.initialize()``) it runs
unmodified; on the CPU test rig
(``JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8``)
it exercises the identical program over virtual devices, which validates the
protocol and the collective layout, not device speed.

    python benchmark/scaling.py [--batch 8] [--scan-points 16384]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--scan-points", type=int, default=16384)
    ap.add_argument("--map-points", type=int, default=600_000)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    from point_cloud_registration_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    import bench
    from point_cloud_registration_tpu.core.config import VPlaneICPConfig
    from point_cloud_registration_tpu.models import build_vplane_target
    from point_cloud_registration_tpu.parallel import align_batched_sharded, make_mesh

    devices = jax.devices()
    print(f"devices: {len(devices)} x {devices[0].platform}")

    rng = np.random.RandomState(0)
    map_np = bench.make_city_map(rng, args.map_points)
    cfg = VPlaneICPConfig(voxel_size=1.0, max_iter=30, max_dist=2.0, tol=1e-3)
    target = build_vplane_target(jax.device_put(jnp.asarray(map_np)), cfg)

    B, n = args.batch, args.scan_points
    scans = jnp.stack(
        [jnp.asarray(bench.make_scan(np.random.RandomState(b), map_np, n)) for b in range(B)]
    )
    weights = jnp.ones((B, n), jnp.float32)
    init_Ts = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (B, 4, 4))

    for n_dev in sorted({1, len(devices)}):
        data = max(1, n_dev // min(n_dev, B))
        batch_ax = n_dev // data
        if B % batch_ax or n % data:
            continue
        mesh = make_mesh(batch=batch_ax, data=data, devices=devices[:n_dev])

        def run():
            return align_batched_sharded(
                "vplane_icp", target, scans, weights, init_Ts, cfg, mesh
            )

        jax.block_until_ready(run().T)  # compile + warm
        t0 = time.perf_counter()
        for _ in range(args.reps):
            jax.block_until_ready(run().T)
        dt = (time.perf_counter() - t0) / args.reps
        print(
            f"mesh batch={batch_ax} data={data} ({n_dev} devices): "
            f"{B / dt:8.1f} registrations/s  {B * n / dt / 1e6:7.2f} Mpts/s  "
            f"({dt * 1e3:.1f} ms / batch of {B})"
        )


if __name__ == "__main__":
    main()
