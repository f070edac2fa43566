#!/usr/bin/env python3
"""Environment-variant benchmark: the same B-01-protocol tests on the CPU
XLA backend.

Role counterpart of the reference's ``benchmark/speed_test_comparison_mkl.py``
(speed_test_comparison_mkl.py:1-14), which re-ran its tests under an
alternative execution environment (MKL-backed NumPy) to quantify how much of
its speed came from the environment vs the algorithms. Here the alternative
environment is XLA:CPU — the identical jitted programs, no GPU — so the
GPU-vs-CPU delta isolates the hardware contribution (same code, same fixed
shapes, same numerics modulo summation order).

Usage:  python benchmark/speed_test_cpu_jax.py [--n-map 1200000] [--n-scan 100000]
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
    ap.add_argument("--n-map", type=int, default=1_200_000)
    ap.add_argument("--n-scan", type=int, default=100_000)
    args = ap.parse_args()

    from point_cloud_registration_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    import jax

    # force XLA:CPU even on a machine with a GPU
    jax.config.update("jax_platforms", "cpu")

    import bench
    import point_cloud_registration_tpu as pcr

    print("backend:", jax.default_backend())
    rng = np.random.RandomState(42)
    map_np = bench.make_city_map(rng, args.n_map)
    scan_np = bench.make_scan(rng, map_np, args.n_scan)
    print(f"map {map_np.shape}, scan {scan_np.shape}")

    params = dict(max_iter=30, max_dist=2, tol=1e-3)
    cases = [
        ("ICP", lambda: pcr.ICP(**params)),
        ("VPlaneICP", lambda: pcr.VPlaneICP(voxel_size=1.0, **params)),
        ("NDT", lambda: pcr.NDT(voxel_size=1.0, **params)),
    ]
    for name, ctor in cases:
        s = ctor()
        s.set_target(map_np)
        s.align(scan_np)  # warm compile
        t0 = time.perf_counter()
        s2 = ctor()
        s2.set_target(map_np)
        T = s2.align(scan_np)
        dt = time.perf_counter() - t0
        print(f"{name:12s} set_target+align {dt:8.3f}s  t={np.round(T[:3, 3], 4)}")

    t0 = time.perf_counter()
    nrm = pcr.estimate_normals(map_np, k=15)
    dt = time.perf_counter() - t0
    print(f"{'normals':12s} {dt:8.3f}s  ({np.asarray(nrm).shape})")


if __name__ == "__main__":
    main()
