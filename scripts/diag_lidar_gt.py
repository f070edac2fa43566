"""Ground-truth ICP/PlaneICP accuracy per scene after the stratified-
truncation fix, plus per-scene packed-grid truncation stats."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
from point_cloud_registration_tpu.utils.runtime import enable_compile_cache  # noqa: E402

enable_compile_cache()
import bench  # noqa: E402
import point_cloud_registration_tpu as pcr  # noqa: E402

print("devices:", jax.devices(), flush=True)

T_true = np.eye(4)
T_true[:3, 3] = [0.0, 0.0, 0.3]


def gt_err(T):
    return np.abs(np.asarray(T, np.float64) @ T_true - np.eye(4)).max()


for scene in ("city", "sparse", "lidar"):
    rng = np.random.RandomState(42)
    map_np = bench.SCENES[scene](rng)
    scan_np = bench.make_scan(rng, map_np)
    map_dev = jax.device_put(jnp.asarray(map_np))
    scan_dev = jax.device_put(jnp.asarray(scan_np))
    jax.block_until_ready((map_dev, scan_dev))

    # truncation stats at the ICP packed grid's geometry (0.5 fine cells,
    # 1.0 blocks)
    blocks = np.floor(map_np / 1.0).astype(np.int64)
    _, counts = np.unique(blocks, axis=0, return_counts=True)
    for cap in (32, 64, 96):
        tr = np.maximum(counts - cap, 0).sum()
        print(f"{scene}: cap {cap}: dropped {tr / len(map_np):.3%}", flush=True)

    params = dict(max_iter=30, max_dist=2, tol=1e-3)
    s = pcr.ICP(**params)
    s.set_target(map_dev)
    T = np.asarray(s.align(scan_dev))
    print(f"{scene}: ICP gt err {gt_err(T):.5f} iters "
          f"{s.last_diagnostics.iterations}", flush=True)

    from point_cloud_registration_tpu.ops.normals import estimate_normals
    nrm = estimate_normals(map_dev, k=15)
    p = pcr.PlaneICP(**params, k=15)
    p.set_target(map_dev, kdree="precomputed", norm=nrm)
    Tp = np.asarray(p.align(scan_dev))
    print(f"{scene}: PlaneICP gt err {gt_err(Tp):.5f} iters "
          f"{p.last_diagnostics.iterations}", flush=True)
