"""End-to-end verify drive through the public API (.claude/skills/verify).

Exercises the public API from a neutral cwd: all four solvers + FastVPlaneICP
on a structured scene, the utility surface, and the failure probes. Prints
PASS/FAIL per check and exits nonzero on any failure. Runs on whatever
device JAX picks (``python chip_smoke.py`` is the checked GPU run).
"""
import sys
import time
import traceback

import numpy as np

import jax

from point_cloud_registration_tpu.utils.runtime import enable_compile_cache

enable_compile_cache()

import point_cloud_registration_tpu as pcr

failures = []


def check(name, fn):
    t0 = time.time()
    try:
        fn()
        print(f"PASS {name} ({time.time()-t0:.1f}s)", flush=True)
    except Exception as e:
        failures.append(name)
        print(f"FAIL {name}: {type(e).__name__}: {e}", flush=True)
        traceback.print_exc()


def make_scene(rng, n=60000):
    # floor + two walls + clutter, ~30 m tile
    n_f = n // 2
    floor = np.stack([rng.rand(n_f) * 30, rng.rand(n_f) * 30,
                      rng.randn(n_f) * 0.01], 1)
    n_w = n // 4
    w1 = np.stack([rng.rand(n_w) * 30, np.full(n_w, 5.0) + rng.randn(n_w) * 0.01,
                   rng.rand(n_w) * 4], 1)
    w2 = np.stack([np.full(n_w, 12.0) + rng.randn(n_w) * 0.01,
                   rng.rand(n_w) * 30, rng.rand(n_w) * 4], 1)
    rest = n - n_f - 2 * n_w
    clutter = np.stack([rng.rand(rest) * 30, rng.rand(rest) * 30,
                        rng.rand(rest) * 3], 1)
    return np.vstack([floor, w1, w2, clutter]).astype(np.float32)


rng = np.random.RandomState(0)
pts = make_scene(rng)
offset = np.float32([0.05, -0.08, 0.12])
scan = pts[rng.choice(len(pts), 20000, replace=False)] + offset
scan += rng.randn(*scan.shape).astype(np.float32) * 0.005

print("devices:", jax.devices(), flush=True)


def solver_check(mk, name, atol=0.02):
    def fn():
        s = mk()
        s.set_target(pts)
        T = s.align(scan)
        d = s.last_diagnostics
        t = T[:3, 3]
        err = np.abs(t + offset).max()
        assert err < atol, f"{name} recovered t {t} vs {-offset} (err {err})"
        assert np.isfinite(T).all()
        # repeat-align determinism
        T2 = s.align(scan)
        assert np.allclose(T, T2, atol=0), "repeat align not deterministic"
        print(f"  {name}: t={np.round(t, 4)} iters={int(d.iterations)}",
              flush=True)
    return fn


check("icp", solver_check(lambda: pcr.ICP(max_iter=30, max_dist=2.0), "icp"))
check("plane_icp_pipeline", solver_check(
    lambda: pcr.PlaneICP(max_iter=30, max_dist=2.0), "plane_icp"))
check("vplane_icp", solver_check(
    lambda: pcr.VPlaneICP(voxel_size=1.0, max_iter=30, max_dist=2.0),
    "vplane_icp"))
check("ndt", solver_check(
    lambda: pcr.NDT(voxel_size=1.0, max_iter=30, max_dist=2.0), "ndt"))
check("fast_vplane_icp", solver_check(
    lambda: pcr.FastVPlaneICP(voxel_size=1.0, max_iter=30, max_dist=2.0),
    "fast_vplane_icp", atol=0.03))


def utilities():
    f = pcr.voxel_filter(pts, 1.0)
    assert 100 < len(f) < len(pts)
    nrm = np.asarray(pcr.estimate_normals(pts[:50000], k=10))
    assert np.allclose(np.linalg.norm(nrm, axis=1), 1.0, atol=1e-3)
    colored = pcr.color_by_voxel(pts[:10000], 2.0)
    assert len(colored) == 10000
    vg = pcr.VoxelGrid(1.0)
    vg.set_points(pts[:100000])
    vg.calc_icov()
    d, i = pcr.KDTree(pts[:100000]).query(scan[:1000])
    assert d.shape == (1000,)


check("utilities", utilities)


def probes():
    s = pcr.ICP()
    try:
        s.align(scan)
        raise AssertionError("align before set_target must raise")
    except ValueError:
        pass
    # all-outlier scan: far from the map
    s2 = pcr.VPlaneICP(voxel_size=1.0, max_dist=2.0)
    s2.set_target(pts)
    far = scan + np.float32([1e4, 1e4, 1e4])
    T = s2.align(far)
    assert np.isfinite(T).all()


check("probes", probes)

print("FAILURES:", failures, flush=True)
sys.exit(1 if failures else 0)
