#!/usr/bin/env python3
"""Headline benchmark: B-01-protocol registration wall-clock on one GPU.

Reproduces the reference benchmark protocol
(/root/reference/benchmark/speed_test_comparison.py:162-217 +
benchmark/test_data.py:21-44): a >1M-point map, a 100k-point scan offset by
t = [0, 0, 0.3] with N(0, 0.005) noise, params max_iter=30, tol=1e-3,
voxel_size=1, max_dist=2. Timings include ``set_target`` + ``align`` (the
reference's timing boundary, speed_test_comparison.py:14-20).

The reference's B-01.pcd (Osaka Kyobashi LiDAR) is git-LFS-stripped in this
checkout and the environment has no egress, so the map is a synthetic urban
scene of the same scale (1M+ points, streets + building facades); the
*baseline* numbers come from the reference README's published table
(README.md:19-23), which also does not state its hardware.

Output: ONE JSON line on stdout —
  {"metric": ..., "value": <flagship VPlaneICP wall-clock s>, "unit": "s",
   "vs_baseline": <reference 0.420 s / ours>, "device": {...}, "all": {...}}
Detailed per-method numbers go to stderr. The run fails when JAX finds no
GPU, and names the card and its power limit.

Timing excludes one warmup run per method (XLA compilation is a one-time,
cached cost; the reference pays no compile because it is interpreted NumPy).
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_city_map(rng: np.random.RandomState, n_total: int = 1_200_000) -> np.ndarray:
    """Synthetic LiDAR-map stand-in for B-01.pcd: ground plane + building
    facades + scattered structure over a ~200x200 m tile."""
    extent = 200.0
    n_ground = n_total // 2
    ground = np.stack(
        [
            rng.rand(n_ground) * extent,
            rng.rand(n_ground) * extent,
            rng.randn(n_ground) * 0.03,
        ],
        axis=1,
    )
    # building facades: axis-aligned walls on a street grid
    n_walls = n_total // 3
    n_per = n_walls // 40
    walls = []
    for _ in range(40):
        x0, y0 = rng.rand(2) * (extent - 30)
        length = 10 + rng.rand() * 20
        height = 5 + rng.rand() * 15
        if rng.rand() < 0.5:
            w = np.stack(
                [
                    x0 + rng.rand(n_per) * length,
                    np.full(n_per, y0) + rng.randn(n_per) * 0.02,
                    rng.rand(n_per) * height,
                ],
                axis=1,
            )
        else:
            w = np.stack(
                [
                    np.full(n_per, x0) + rng.randn(n_per) * 0.02,
                    y0 + rng.rand(n_per) * length,
                    rng.rand(n_per) * height,
                ],
                axis=1,
            )
        walls.append(w)
    n_rest = n_total - n_ground - n_per * 40
    scatter = np.stack(
        [
            rng.rand(n_rest) * extent,
            rng.rand(n_rest) * extent,
            rng.rand(n_rest) * 6,
        ],
        axis=1,
    )
    pts = np.vstack([ground, *walls, scatter]).astype(np.float32)
    return pts


def make_sparse_scene(rng: np.random.RandomState, n_total: int = 1_200_000) -> np.ndarray:
    """Second scene family (sparse outdoor): undulating terrain + scattered
    vegetation clusters over a ~300x300 m tile. Different density profile
    from the city map — no planar walls, broad smooth ground, clumpy
    volumetric canopies — to show parity/perf bounds are not tuned to one
    geometry."""
    extent = 300.0
    n_ground = int(n_total * 0.55)
    gx = rng.rand(n_ground) * extent
    gy = rng.rand(n_ground) * extent
    gz = (
        1.5 * np.sin(gx * 0.05) * np.cos(gy * 0.04)
        + 0.8 * np.sin(gx * 0.013 + 1.0)
        + rng.randn(n_ground) * 0.04
    )
    ground = np.stack([gx, gy, gz], axis=1)
    n_veg = n_total - n_ground
    n_clusters = 300
    n_per = n_veg // n_clusters
    centers = rng.rand(n_clusters, 2) * extent
    heights = 2.0 + rng.rand(n_clusters) * 10.0
    radii = 0.5 + rng.rand(n_clusters) * 2.5
    veg = []
    for c, h, r in zip(centers, heights, radii):
        base = 1.5 * np.sin(c[0] * 0.05) * np.cos(c[1] * 0.04)
        veg.append(
            np.stack(
                [
                    c[0] + rng.randn(n_per) * r,
                    c[1] + rng.randn(n_per) * r,
                    base + rng.rand(n_per) * h,
                ],
                axis=1,
            )
        )
    rest = n_veg - n_per * n_clusters
    pad = np.stack(
        [rng.rand(rest) * extent, rng.rand(rest) * extent, rng.rand(rest) * 3],
        axis=1,
    )
    return np.vstack([ground, *veg, pad]).astype(np.float32)


def make_lidar_map(rng: np.random.RandomState, n_total: int = 1_200_000) -> np.ndarray:
    """Third scene family: genuine spinning-LiDAR sampling statistics.

    The first two families sample surfaces *uniformly*; real B-01-style maps
    (reference data/README.md:1-24, benchmark/test_data.py:21-44) are unions
    of ring scans — range-dependent density (~1/r^2 per unit area), discrete
    elevation rings, and hard occlusion shadows behind structure. This
    ray-casts 64-ring scans from poses along a trajectory through a walled
    world (first-hit only, so facades shadow everything behind them), then
    concatenates the returns: near-field cells hold hundreds of points while
    far ground thins to <1/m^2, which is exactly the regime that stresses
    per-block candidate caps and window-exactness fractions.
    """
    extent = 200.0
    n_walls = 40
    # world: ground plane z=0 + axis-aligned facades (x0, y0, length,
    # height, axis) — axis 0: wall along x at y=y0; axis 1: along y at x=x0
    walls = []
    for _ in range(n_walls):
        x0, y0 = rng.rand(2) * (extent - 30)
        walls.append((x0, y0, 10 + rng.rand() * 20, 5 + rng.rand() * 15,
                      0 if rng.rand() < 0.5 else 1))
    wx0 = np.array([w[0] for w in walls])
    wy0 = np.array([w[1] for w in walls])
    wlen = np.array([w[2] for w in walls])
    whgt = np.array([w[3] for w in walls])
    waxis = np.array([w[4] for w in walls])

    n_rings = 64
    elev = np.deg2rad(np.linspace(-24.0, 14.0, n_rings))
    n_poses = 10
    path_t = np.linspace(0.15, 0.85, n_poses)
    ox = extent * path_t
    oy = extent * (0.5 + 0.25 * np.sin(path_t * 4.0))
    oz = np.full(n_poses, 1.8)
    n_az = max(256, n_total // (n_poses * n_rings) + 1)
    az = np.linspace(0, 2 * np.pi, n_az, endpoint=False)

    max_range = 120.0
    pts = []
    for p in range(n_poses):
        a = az + rng.rand() * (2 * np.pi / n_az)  # de-correlate pose phases
        ca, sa = np.cos(a), np.sin(a)
        ce, se = np.cos(elev), np.sin(elev)
        # ray dirs (n_rings, n_az, 3)
        dx = ce[:, None] * ca[None, :]
        dy = ce[:, None] * sa[None, :]
        dz = np.broadcast_to(se[:, None], dx.shape)
        t_best = np.full(dx.shape, max_range)
        # ground z=0
        with np.errstate(divide="ignore", invalid="ignore"):
            tg = -oz[p] / dz
        hit = (dz < -1e-6) & (tg < t_best)
        t_best = np.where(hit, tg, t_best)
        # facades (first hit wins -> occlusion shadows)
        for j in range(n_walls):
            if waxis[j] == 0:
                with np.errstate(divide="ignore", invalid="ignore"):
                    tw = (wy0[j] - oy[p]) / dy
                hx = ox[p] + tw * dx
                span_lo, span_hi = wx0[j], wx0[j] + wlen[j]
            else:
                with np.errstate(divide="ignore", invalid="ignore"):
                    tw = (wx0[j] - ox[p]) / dx
                hx = oy[p] + tw * dy
                span_lo, span_hi = wy0[j], wy0[j] + wlen[j]
            hz = oz[p] + tw * dz
            ok = (
                (tw > 0.5) & (tw < t_best)
                & (hx >= span_lo) & (hx <= span_hi)
                & (hz >= 0.0) & (hz <= whgt[j])
            )
            t_best = np.where(ok, tw, t_best)
        ret = t_best < max_range
        r = t_best[ret]
        hits = np.stack(
            [ox[p] + r * dx[ret], oy[p] + r * dy[ret], oz[p] + r * dz[ret]],
            axis=1,
        )
        # range-dependent sensor noise along the ray
        hits += (rng.randn(len(hits), 3) * (0.008 * (1 + r / 60.0))[:, None])
        pts.append(hits)
    pts = np.vstack(pts)
    if len(pts) >= n_total:
        sel = rng.choice(len(pts), n_total, replace=False)
        return pts[sel].astype(np.float32)
    # top up with re-noised duplicates (denser near-field, like repeated
    # passes over the same street)
    extra = rng.choice(len(pts), n_total - len(pts), replace=True)
    dup = pts[extra] + rng.randn(n_total - len(pts), 3) * 0.01
    return np.vstack([pts, dup]).astype(np.float32)


SCENES = {"city": make_city_map, "sparse": make_sparse_scene,
          "lidar": make_lidar_map}


def make_scan(rng, map_points, num_points=100_000):
    """scan = map + t[0,0,0.3], random 100k subsample, N(0, 0.005) noise
    (benchmark/test_data.py:21-44)."""
    t = np.array([0.0, 0.0, 0.3], np.float32)
    idx = rng.choice(len(map_points), num_points, replace=False)
    scan = map_points[idx] + t
    scan = scan + rng.randn(*scan.shape).astype(np.float32) * 0.005
    return scan.astype(np.float32)


def timed(fn, warmup=1, reps=3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return min(times)


def main():
    from point_cloud_registration_tpu.utils.runtime import (
        card_name_and_power_limit,
        enable_compile_cache,
        require_gpu,
    )

    enable_compile_cache()
    devs = require_gpu()
    import jax
    import jax.numpy as jnp

    import point_cloud_registration_tpu as pcr

    cards = card_name_and_power_limit()
    log("devices:", devs, "| nvidia-smi name, power.limit:", cards)
    rng = np.random.RandomState(42)
    map_np = make_city_map(rng)
    scan_np = make_scan(rng, map_np)
    # device-resident inputs: the production steady state keeps clouds on
    # the device, so the rows time registration, not the host transfer
    map_pts = jax.device_put(jnp.asarray(map_np))
    scan = jax.device_put(jnp.asarray(scan_np))
    jax.block_until_ready((map_pts, scan))
    log(f"map {map_np.shape}, scan {scan_np.shape}")

    max_iter, tol, max_dist, voxel_size = 30, 1e-3, 2.0, 1.0
    results = {}

    def set_target_align(make, **target_kw):
        def f():
            s = make()
            s.set_target(map_pts, **target_kw)
            return np.asarray(s.align(scan))

        return f

    def make_vplane():
        return pcr.VPlaneICP(voxel_size=voxel_size, max_iter=max_iter,
                             max_dist=max_dist, tol=tol)

    def make_ndt():
        return pcr.NDT(voxel_size=voxel_size, max_iter=max_iter,
                       max_dist=max_dist, tol=tol)

    # flagship first
    t_vplane = timed(set_target_align(make_vplane))
    results["vplane_icp"] = (t_vplane, 0.420)
    log(f"VPlaneICP set_target+align: {t_vplane:.3f}s (ref 0.420s)")

    t_ndt = timed(set_target_align(make_ndt))
    results["ndt"] = (t_ndt, 0.511)
    log(f"NDT set_target+align: {t_ndt:.3f}s (ref 0.511s)")

    # SLAM steady-state rows: the map is built ONCE and every scan pays only
    # align (the production serving shape — a LiDAR front end re-targets
    # rarely). vs_baseline keeps the reference's full set_target+align row:
    # the reference rebuilds its kd-tree per scan, this framework does not
    # have to.
    for name, make, ref in (("vplane_icp", make_vplane, 0.420), ("ndt", make_ndt, 0.511)):
        s = make()
        s.set_target(map_pts)
        t = timed(lambda: np.asarray(s.align(scan)))
        results[f"{name}_align_only"] = (t, ref)
        log(f"{name} align-only (amortized set_target): {t:.3f}s")

    t_icp = timed(set_target_align(
        lambda: pcr.ICP(max_iter=max_iter, max_dist=max_dist, tol=tol)), reps=5)
    results["icp"] = (t_icp, 0.502)
    log(f"ICP set_target+align: {t_icp:.3f}s (ref 0.502s)")

    # per-phase ICP breakdown: blocked wall of the two halves of the row above
    from point_cloud_registration_tpu.core.config import ICPConfig
    from point_cloud_registration_tpu.models.icp import build_icp_target

    icfg = ICPConfig(max_iter=max_iter, max_dist=max_dist, tol=tol)
    phases = {"icp_build_s": round(timed(
        lambda: jax.block_until_ready(build_icp_target(map_pts, icfg).packed.pts_packed)
    ), 4)}
    icp = pcr.ICP(max_iter=max_iter, max_dist=max_dist, tol=tol)
    icp.set_target(map_pts)
    phases["icp_align_s"] = round(timed(lambda: np.asarray(icp.align(scan))), 4)
    log(f"  phases: {phases}")

    from point_cloud_registration_tpu.ops.normals import estimate_normals

    t_norm = timed(lambda: jax.block_until_ready(estimate_normals(map_pts, k=15)))
    normals = estimate_normals(map_pts, k=15)
    results["normals"] = (t_norm, 2.201)
    log(f"estimate_normals: {t_norm:.3f}s (ref 2.201s)")

    t_picp = timed(set_target_align(
        lambda: pcr.PlaneICP(max_iter=max_iter, max_dist=max_dist, tol=tol),
        kdree="precomputed", norm=normals), reps=5)
    results["plane_icp"] = (t_picp, 0.334)
    log(f"PlaneICP set_target+align (excl. normals): {t_picp:.3f}s (ref 0.334s)")

    # FastVPlaneICP (coreset two-phase): the reference's own fast variant is
    # bit-rotted (fast_voxelized_plane_icp.py:56-99 never ran), so there is
    # no published baseline — the comparison is against OUR VPlaneICP row.
    t_fast = timed(set_target_align(
        lambda: pcr.FastVPlaneICP(voxel_size=voxel_size, max_iter=max_iter,
                                  max_dist=max_dist, tol=tol)))
    results["fast_vplane_icp"] = (t_fast, float("nan"))
    fast_vs_vplane = round(t_vplane / t_fast, 3)
    log(f"FastVPlaneICP set_target+align: {t_fast:.3f}s "
        f"({fast_vs_vplane:.2f}x our VPlaneICP)")

    # voxel_filter on the full map (reference speed_test_comparison.py:174-182;
    # the reference does not publish this number, so no vs_baseline)
    t_vf = timed(lambda: pcr.voxel_filter(map_pts, voxel_size))
    results["voxel_filter"] = (t_vf, float("nan"))
    log(f"voxel_filter 1.2M pts: {t_vf:.3f}s")

    # device-resident variant: the 201k-row result stays on the device
    # (+inf padded, count alongside) for set_target/coreset pipelines
    from point_cloud_registration_tpu.ops.voxelize import voxel_filter_device_deferred

    dropped = []

    def run_vfilter_dev():
        means, n_cells, nd = voxel_filter_device_deferred(map_pts, voxel_size)
        jax.block_until_ready((means, n_cells))
        dropped.append(nd)

    t_vfd = timed(run_vfilter_dev)
    # deferred-hint contract: the validity scalar rides the next sync; a
    # nonzero count would mean the timed rows were clipped
    if any(int(jax.device_get(nd)) != 0 for nd in dropped):
        raise RuntimeError("voxel_filter_device dropped points: timed rows were clipped")
    results["voxel_filter_device"] = (t_vfd, float("nan"))
    log(f"voxel_filter_device 1.2M pts: {t_vfd:.3f}s")

    # Batched multi-scan registration throughput (SLAM front-end axis,
    # BASELINE.json configs[4]): B scans aligned against one prebuilt map.
    from point_cloud_registration_tpu.core.config import VPlaneICPConfig
    from point_cloud_registration_tpu.models import build_vplane_target
    from point_cloud_registration_tpu.parallel import align_batched_sharded, make_mesh

    cfg = VPlaneICPConfig(voxel_size=voxel_size, max_iter=max_iter,
                          max_dist=max_dist, tol=tol)
    target = build_vplane_target(map_pts, cfg)
    B, n_b = 8, 16384
    scans = jax.device_put(jnp.asarray(np.stack(
        [make_scan(np.random.RandomState(100 + b), map_np, n_b) for b in range(B)]
    )))
    weights = jnp.ones((B, n_b), jnp.float32)
    init_Ts = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (B, 4, 4))
    mesh = make_mesh(batch=1, data=1)
    t_batch = timed(lambda: jax.block_until_ready(align_batched_sharded(
        "vplane_icp", target, scans, weights, init_Ts, cfg, mesh).T))
    log(f"batched VPlaneICP: {B} x {n_b}-pt scans in {t_batch:.3f}s -> "
        f"{B / t_batch:.1f} registrations/s, {B * n_b / t_batch / 1e6:.2f} Mpts/s")
    results["batched_regs_per_s"] = (B / t_batch, float("nan"))
    # BASELINE.json protocol asks for points/s alongside registrations/s
    results["batched_mpts_per_s"] = (B * n_b / t_batch / 1e6, float("nan"))

    for k, (t, ref) in results.items():
        log(f"  {k:12s} {t:7.3f}s  vs_baseline x{ref / t:.2f}")

    t, ref = results["vplane_icp"]
    payload = {
        "metric": "vplane_icp_1.2Mmap_100kscan_settarget_align_wall_clock",
        "value": round(t, 4),
        "unit": "s",
        "vs_baseline": round(ref / t, 3),
        "device": {"platform": devs[0].platform, "kind": devs[0].device_kind,
                   "count": len(devs), "nvidia_smi": cards},
        # every per-method wall-clock in the one driver-captured line:
        # {name: [seconds, x_vs_published_reference]} (reg/s rows: [rate, null])
        "all": {
            k: [round(tv, 4), (round(rv / tv, 3) if np.isfinite(rv) else None)]
            for k, (tv, rv) in results.items()
        },
        "phases": phases,
        "fast_vs_vplane": fast_vs_vplane,
    }
    print(json.dumps(payload))


if __name__ == "__main__":
    main()
