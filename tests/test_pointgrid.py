"""Packed-block point-table tests: tier-1 exactness + packed-solver parity."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from point_cloud_registration_tpu.core.config import CorrespondenceConfig
from point_cloud_registration_tpu.ops.pointgrid import (
    build_packed_grid,
    knn_packed,
    nearest_point_packed,
)
from oracles import gn_align_np, icp_stats_np, knn_np, make_scan, make_scene


@pytest.fixture(scope="module")
def scene():
    rng = np.random.RandomState(44)
    return make_scene(rng)


def test_tier1_exact_within_cell_fine(scene):
    # cap above the worst block occupancy -> tier-1 exactness is exact, which
    # validates the window-coverage logic in isolation from truncation
    pg = build_packed_grid(scene, cell_fine=0.5, cap=256)
    rng = np.random.RandomState(1)
    q = (scene[rng.choice(len(scene), 500)] + rng.randn(500, 3) * 0.2).astype(np.float32)
    res = nearest_point_packed(pg, jnp.asarray(q))
    d_ref, i_ref = knn_np(scene, q, k=1)
    d = np.asarray(jax.device_get(res.dist))
    resolved = np.asarray(jax.device_get(res.resolved))
    # resolved queries must carry the true nearest distance
    np.testing.assert_allclose(d[resolved], d_ref[resolved, 0], atol=1e-4)
    # and with a 0.2-sigma offset cloud, nearly everything resolves
    assert resolved.mean() > 0.95
    # resolved flag only claims d < cell_fine
    assert np.all(d[resolved] < 0.5)


def test_tier1_truncation_quality(scene):
    # default cap truncates dense blocks: matches may be near-nearest, but
    # must stay in-window (within ~3 fine cells) and mostly exact
    pg = build_packed_grid(scene, cell_fine=0.5, cap=32)
    rng = np.random.RandomState(5)
    q = (scene[rng.choice(len(scene), 500)] + rng.randn(500, 3) * 0.2).astype(np.float32)
    res = nearest_point_packed(pg, jnp.asarray(q))
    d_ref, _ = knn_np(scene, q, k=1)
    d = np.asarray(jax.device_get(res.dist))
    resolved = np.asarray(jax.device_get(res.resolved))
    exact = np.isclose(d[resolved], d_ref[resolved, 0], atol=1e-4)
    assert exact.mean() > 0.6
    # truncated matches are near-nearest, never far
    assert np.all(d[resolved] - d_ref[resolved, 0] < 0.5)


def test_tier1_unresolved_far_queries(scene):
    pg = build_packed_grid(scene, cell_fine=0.5, cap=64)
    q = jnp.asarray(np.array([[500.0, 500.0, 500.0]], np.float32))
    res = nearest_point_packed(pg, q)
    assert not bool(jax.device_get(res.resolved)[0])


def test_cap_truncation_graceful(scene):
    # tiny cap: distances may be suboptimal but must stay >= true NN and finite
    pg = build_packed_grid(scene, cell_fine=0.5, cap=4)
    rng = np.random.RandomState(2)
    q = (scene[rng.choice(len(scene), 200)] + rng.randn(200, 3) * 0.1).astype(np.float32)
    res = nearest_point_packed(pg, jnp.asarray(q))
    d = np.asarray(jax.device_get(res.dist))
    d_ref, _ = knn_np(scene, q, k=1)
    assert np.all(d >= d_ref[:, 0] - 1e-5)
    assert np.isfinite(d).mean() > 0.9


def test_knn_packed_matches_kdtree(scene):
    from point_cloud_registration_tpu.ops.normals import sample_knn_radius

    k = 10
    r = sample_knn_radius(jnp.asarray(scene), k)
    pg = build_packed_grid(scene, cell_fine=r, cap=64)
    q = jnp.asarray(scene[:300])
    d, i = knn_packed(pg, q, k, chunk=128)
    d_ref, _ = knn_np(scene, scene[:300], k=k)
    d = np.asarray(jax.device_get(d))
    # the 8-block window covers the sampled median k-NN radius; the tail of
    # wider neighborhoods is approximate (same contract as the grid k-NN)
    agree = np.isclose(d, d_ref, atol=1e-4).all(axis=1)
    assert agree.mean() > 0.8, agree.mean()


def test_packed_icp_matches_exact_oracle(scene):
    """End-to-end: the packed+proxy ICP must land on the float64 exact-NN
    oracle's transform (the proxy tier only steers early iterations)."""
    from point_cloud_registration_tpu import ICP

    rng = np.random.RandomState(3)
    scan, T_true = make_scan(rng, scene, np.array([0.04, -0.03, 0.12, 0.01, -0.012, 0.02]))
    icp = ICP(max_iter=30, max_dist=2.0, tol=1e-3)
    icp.cfg = dataclasses.replace(
        icp.cfg, corr=dataclasses.replace(icp.cfg.corr, method="packed")
    )
    icp.set_target(scene)
    T_ours = icp.align(scan)
    T_ref, _ = gn_align_np(
        lambda T: icp_stats_np(scene, scan, T, 2.0), max_iter=30, tol=1e-3
    )
    np.testing.assert_allclose(T_ours, T_ref, atol=5e-3)
    residual = T_ours @ T_true - np.eye(4)
    assert np.abs(residual).max() < 0.02


def test_packed_plane_icp_converges(scene):
    from point_cloud_registration_tpu import PlaneICP

    rng = np.random.RandomState(4)
    scan, T_true = make_scan(rng, scene, np.array([0.05, -0.04, 0.15, 0.012, -0.015, 0.02]))
    picp = PlaneICP(max_iter=30, max_dist=2.0, tol=1e-3, k=15)
    picp.cfg = dataclasses.replace(
        picp.cfg, corr=dataclasses.replace(picp.cfg.corr, method="packed")
    )
    picp.set_target(scene)
    T_est = picp.align(scan)
    residual = T_est @ T_true - np.eye(4)
    assert np.abs(residual).max() < 0.02, residual


def test_pack_gather_and_scatter_paths_identical(scene):
    """The phase-shifted-gather pack and the row-scatter fallback must
    produce bit-identical tables (the gather path is a pure reformulation
    of the placement, selected statically by cloud size)."""
    import point_cloud_registration_tpu.ops.pointgrid as PGM

    pg_gather = build_packed_grid(scene, cell_fine=0.5, cap=8)
    orig = PGM._PACK_GATHER_BUDGET
    try:
        PGM._PACK_GATHER_BUDGET = 0  # force the scatter branch ...
        jax.clear_caches()  # ... and drop the cached gather-path trace
        pg_scatter = build_packed_grid(scene, cell_fine=0.5, cap=8)
    finally:
        PGM._PACK_GATHER_BUDGET = orig
        jax.clear_caches()
    for a, b in zip(pg_gather, pg_scatter):
        np.testing.assert_array_equal(
            np.asarray(jax.device_get(a)), np.asarray(jax.device_get(b))
        )


def test_truncation_subsample_is_unbiased():
    """Over-cap blocks must keep a SPATIALLY UNIFORM subsample, not the
    first-in-input-order points. Input order is spatially correlated in
    practice (scan generators and LiDAR logs emit ring-by-ring), and a
    corner-clustered kept set biases the nearest-neighbor field — measured
    on the ray-cast LiDAR bench family as converged ICP landing 1.5 cm off
    ground truth (vs 0.5 mm for the reference). Regression for the hashed
    secondary sort key in _keys_sort_count."""
    rng = np.random.RandomState(7)
    n = 4096
    # one over-full block: points spatially SORTED along x in input order
    # (the adversarial emission order), spanning a single 1.0-block
    x = np.sort(rng.rand(n).astype(np.float32)) * 0.96 + 0.02
    pts = np.stack([x, rng.rand(n).astype(np.float32) * 0.96 + 0.02,
                    rng.rand(n).astype(np.float32) * 0.96 + 0.02], axis=1)
    cap = 32
    pg = build_packed_grid(pts, cell_fine=0.5, cap=cap)
    idx_packed = np.asarray(jax.device_get(pg.idx_packed))
    kept = idx_packed[idx_packed >= 0]
    assert kept.size == cap < n, "expected a truncated block"
    kept_x = pts[kept, 0]
    # uniform subsample: mean x near the block's 0.5 center. The pre-fix
    # corner subsample kept the 32 smallest x (mean ~0.006 != 0.5).
    assert abs(kept_x.mean() - x.mean()) < 0.1, kept_x.mean()
    # and spread across the block, not clustered in one corner
    assert kept_x.max() - kept_x.min() > 0.5, (kept_x.min(), kept_x.max())
