"""The XLA correspondence and statistics paths against float64 oracles.

Scenarios: voxel plane/NDT statistics with far-tier stragglers; the blocked
nearest-voxel query in each of its modes; packed raw-point ICP/PlaneICP at a
small and a straggler-heavy offset; packed-block overflow that degrades to
the proxy fallback tiers; k-NN normals (geometric truth, isolated points,
exact neighbour sets).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as cs
from oracles import knn_np, ndt_stats_np, voxel_map_np, vplane_stats_np
from point_cloud_registration_tpu.core.config import (
    CorrespondenceConfig,
    ICPConfig,
    NDTConfig,
    PlaneICPConfig,
    VPlaneICPConfig,
)
from point_cloud_registration_tpu.models import (
    build_icp_target,
    build_ndt_target,
    build_plane_icp_target,
    build_vplane_target,
    icp_align,
    plane_icp_align,
)
from point_cloud_registration_tpu.models._point_corr import match_points
from point_cloud_registration_tpu.models.icp import icp_stats
from point_cloud_registration_tpu.models.ndt import ndt_solver_stats
from point_cloud_registration_tpu.models.plane_icp import plane_icp_stats
from point_cloud_registration_tpu.models.voxelized_plane_icp import vplane_stats
from point_cloud_registration_tpu.ops.knn import brute_force_nn
from point_cloud_registration_tpu.ops.normals import estimate_normals
from point_cloud_registration_tpu.ops.pointgrid import build_packed_grid, knn_packed
from point_cloud_registration_tpu.ops.voxelize import query_nearest_voxel

EYE = jnp.eye(4, dtype=jnp.float32)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.fixture(scope="module")
def clusters():
    """60 Gaussian clusters in an 18 m box: many partially filled voxels."""
    rng = np.random.RandomState(0)
    centers = rng.rand(60, 3) * 18
    pts = (centers[:, None, :] + rng.randn(60, 80, 3) * 0.5).reshape(-1, 3)
    return pts.astype(np.float32), rng


@pytest.fixture(scope="module")
def floor_wall():
    """30 m floor + a 6 m wall: dense enough that 1 m packed blocks overflow."""
    rng = np.random.RandomState(3)
    n = 24000
    floor = np.stack([rng.rand(n // 2) * 30, rng.rand(n // 2) * 30,
                      rng.randn(n // 2) * 0.02], 1)
    wall = np.stack([rng.rand(n // 2) * 30, np.full(n // 2, 15.0) + rng.randn(n // 2) * 0.02,
                     rng.rand(n // 2) * 6], 1)
    return np.vstack([floor, wall]).astype(np.float32)


# --- voxel solvers --------------------------------------------------------


@pytest.mark.parametrize("fixed_tiers", [False, True], ids=["tiers", "fixed_tiers"])
@pytest.mark.parametrize("offset", [(0.05, -0.03, 0.08), (0.9, -0.7, 0.6)],
                         ids=["near", "stragglers"])
@pytest.mark.parametrize("kind", ["vplane", "ndt"])
def test_voxel_stats_match_oracle(clusters, kind, offset, fixed_tiers):
    pts, _ = clusters
    rng = np.random.RandomState(1)
    scan = pts[rng.choice(len(pts), 1500, replace=False)] + np.float32(offset)
    means, _, normals, icovs = voxel_map_np(pts, 1.0, min_points=5)
    if offset[0] > 0.5:
        # the scenario is real: queries beyond the 1-cell near tier
        d = np.min(np.linalg.norm(scan[:, None] - means[None], axis=-1), axis=1)
        assert np.sum((d > 1.0) & (d < 2.0)) > 50
    w = jnp.ones((len(scan),), jnp.float32)
    if kind == "vplane":
        cfg = VPlaneICPConfig(voxel_size=1.0, min_points=5, fixed_tiers=fixed_tiers)
        st = vplane_stats(build_vplane_target(pts, cfg), jnp.asarray(scan), w, EYE, cfg)
        H, g, e2, n = vplane_stats_np(means, normals, scan, np.eye(4), 2.0)
        bar = 1e-5
    else:
        cfg = NDTConfig(voxel_size=1.0, min_points=5, fixed_tiers=fixed_tiers)
        st = ndt_solver_stats(build_ndt_target(pts, cfg), jnp.asarray(scan), w, EYE, cfg)
        H, g, e2, n = ndt_stats_np(means, icovs, scan, np.eye(4), 2.0)
        bar = 1e-3  # float32 inverse covariances of thin voxels
    assert int(st.n_inliers) == n
    assert rel(st.H, H) < bar and rel(st.g, g) < bar and rel(st.e2, e2) < bar


@pytest.mark.parametrize("spread", [0.3, 1.2])
@pytest.mark.parametrize("mode", ["tiers", "fixed_tiers", "full_window"])
def test_nearest_voxel_matches_brute_force(clusters, mode, spread):
    pts, _ = clusters
    cfg = VPlaneICPConfig(voxel_size=1.0, min_points=5)
    vm = build_vplane_target(pts, cfg)
    assert vm.dense_blocks is not None
    rng = np.random.RandomState(3)
    q = (pts[rng.choice(len(pts), 600)] + rng.randn(600, 3) * spread).astype(np.float32)
    nn = query_nearest_voxel(vm, jnp.asarray(q), voxel_size=1.0, max_dist=2.0,
                             fixed_tiers=mode == "fixed_tiers",
                             full_window=mode == "full_window")
    ref = brute_force_nn(jnp.asarray(q), vm.means, vm.valid)
    d, ref_d = np.asarray(nn.dist), np.asarray(ref.dist)
    gated = ref_d < 2.0
    assert gated.sum() > 300 and (~gated).sum() > (0 if spread < 1 else 5)
    np.testing.assert_allclose(d[gated], ref_d[gated], atol=1e-5)
    means = np.asarray(vm.means)
    np.testing.assert_allclose(means[np.asarray(nn.idx)[gated]],
                               means[np.asarray(ref.idx)[gated]], atol=1e-5)
    assert np.all(~(d[~gated] < 2.0))


# --- packed raw-point solvers ---------------------------------------------

PACKED = CorrespondenceConfig(method="packed")
OFFSETS = [(0.08, -0.06, 0.1), (0.6, -0.5, 0.4)]


def _scan(pts, offset, seed=11, n=4000):
    rng = np.random.RandomState(seed)
    return (pts[rng.choice(len(pts), n, replace=False)] + np.float32(offset)
            + rng.randn(n, 3).astype(np.float32) * 0.004).astype(np.float32)


def _raw_target(kind, pts):
    if kind == "point":
        cfg = ICPConfig(corr=PACKED)
        tgt = build_icp_target(pts, cfg)
        ref = cs.point_oracle(pts, corr=PACKED)
        return cfg, tgt, ref, icp_stats, icp_align
    cfg = PlaneICPConfig(corr=PACKED)
    tgt = build_plane_icp_target(pts, cfg)
    ref = cs.point_oracle(pts, np.asarray(tgt.normals), corr=PACKED, proxy_min_points=3)
    return cfg, tgt, ref, plane_icp_stats, plane_icp_align


@pytest.mark.parametrize("offset", OFFSETS, ids=["near", "stragglers"])
@pytest.mark.parametrize("kind", ["point", "plane"])
def test_packed_stats_match_oracle(floor_wall, kind, offset):
    pts = floor_wall
    scan = _scan(pts, offset)
    cfg, tgt, ref, stats, _ = _raw_target(kind, pts)
    st = stats(tgt, jnp.asarray(scan), jnp.ones((len(scan),), jnp.float32), EYE, cfg)
    H, g, e2 = cs.oracle_stats(kind, ref, scan, np.eye(4))
    assert rel(st.H, H) < 1e-5 and rel(st.g, g) < 1e-5 and rel(st.e2, e2) < 1e-5


@pytest.mark.parametrize("offset", OFFSETS, ids=["near", "stragglers"])
@pytest.mark.parametrize("kind", ["point", "plane"])
def test_packed_align_stops_where_oracle_stops(floor_wall, kind, offset):
    """At the returned T the device objective still equals the oracle's, and
    a converged align stops where the oracle's own step is below tol. (From
    the far offset, point-to-point ICP slides along the floor/wall seam
    direction, which neither surface constrains, for all 30 iterations.)"""
    pts = floor_wall
    scan = _scan(pts, offset)
    cfg, tgt, ref, stats, align = _raw_target(kind, pts)
    w = jnp.ones((len(scan),), jnp.float32)
    res = align(tgt, jnp.asarray(scan), w, EYE, cfg)
    T = np.asarray(res.T, np.float64)
    st = stats(tgt, jnp.asarray(scan), w, res.T, cfg)
    H, g, e2 = cs.oracle_stats(kind, ref, scan, T)
    assert rel(st.H, H) < 1e-5 and rel(st.e2, e2) < 1e-5
    # g is near zero at a minimum, so compare the Gauss-Newton steps
    step = np.linalg.solve(H, g)
    assert np.linalg.norm(np.linalg.solve(H, np.asarray(st.g, np.float64)) - step) < 1e-4
    converged = bool(res.diagnostics.converged)
    assert converged or (kind, offset) == ("point", OFFSETS[1])
    if converged:
        assert np.linalg.norm(step) < cfg.tol


@pytest.mark.parametrize("tier,far_share", [("compacted", 0.05), ("full", 1.0),
                                            ("fixed_tiers", 0.2)])
def test_block_overflow_degrades_to_proxy_tiers(floor_wall, tier, far_share):
    """cap=4 truncates almost every 1 m block; queries raised off the floor
    then miss the exact tier and resolve on the proxy voxels — compacted
    (few unresolved), full pass (more than the compaction capacity) or the
    unconditional batched variant (within its capacity) — exactly as the
    oracle's objective."""
    pts = floor_wall
    corr = CorrespondenceConfig(method="packed", packed_cap=4)
    tgt = build_icp_target(pts, ICPConfig(corr=corr))
    rng = np.random.RandomState(5)
    floor = pts[:12000][rng.choice(12000, 4000, replace=False)].copy()
    far = rng.rand(4000) < far_share
    floor[:, 2] += np.where(far, 0.8, 0.05).astype(np.float32)
    ref = cs.point_oracle(pts, corr=corr)
    d_exact, _ = ref["tree"].query(floor.astype(np.float64))
    n_unres = int(np.sum(d_exact >= ref["cell_fine"]))
    cap = 1024  # compaction capacity at 4000 queries, either variant
    assert (n_unres > cap) if tier == "full" else (0 < n_unres <= cap)
    m = match_points(tgt, jnp.asarray(floor), corr, 2.0, fixed_tiers=tier == "fixed_tiers")
    # the oracle's own match distance per query: exact tier, else proxy
    d = d_exact.copy()
    far_q = d_exact >= ref["cell_fine"]
    d[far_q], _ = ref["proxy"]["tree"].query(floor[far_q].astype(np.float64))
    got = np.linalg.norm(np.asarray(m.target) - floor, axis=1)
    live = np.asarray(m.weight) > 0
    np.testing.assert_array_equal(live, d < 2.0)
    np.testing.assert_allclose(got[live], d[live], atol=1e-5)
    assert np.sum(np.asarray(m.proxy_slot) >= 0) == n_unres


# --- normals --------------------------------------------------------------


@pytest.mark.parametrize("k", [8, 15])
def test_normals_geometric_truth(k):
    rng = np.random.RandomState(2)
    floor = np.stack([rng.rand(6000) * 20, rng.rand(6000) * 20, rng.randn(6000) * 0.002], 1)
    wall = np.stack([np.full(3000, 10.0) + rng.randn(3000) * 0.002,
                     rng.rand(3000) * 20, rng.rand(3000) * 4 + 1.0], 1)
    pts = np.vstack([floor, wall]).astype(np.float32)
    n = np.asarray(estimate_normals(pts, k=k))
    truth = np.vstack([np.tile([0, 0, 1.0], (6000, 1)), np.tile([1.0, 0, 0], (3000, 1))])
    away = np.abs(pts[:, 0] - 10.0) > 0.6  # off the floor/wall seam
    cos = np.abs(np.sum(n * truth, axis=1))
    assert np.all(cos[away] > 0.99)


def test_normals_isolated_points_are_unit():
    """Points with fewer than k neighbours anywhere near still get finite
    unit normals (from whatever neighbours the widest window holds)."""
    rng = np.random.RandomState(6)
    cloud = np.stack([rng.rand(3000) * 10, rng.rand(3000) * 10, rng.randn(3000) * 0.01], 1)
    lonely = rng.rand(12, 3) * 10 + np.float32([0, 0, 50.0])
    pts = np.vstack([cloud, lonely]).astype(np.float32)
    n = np.asarray(estimate_normals(pts, k=15))
    assert np.all(np.isfinite(n))
    np.testing.assert_allclose(np.linalg.norm(n, axis=1), 1.0, atol=1e-4)


@pytest.mark.parametrize("k", [1, 8, 15])
def test_knn_packed_exact_within_provable_radius(k):
    """Continuous random coordinates (no distance ties), no truncated block:
    when the k-th neighbour lies within ``cell_fine`` the packed k-NN
    returns exactly the k nearest."""
    rng = np.random.RandomState(k)
    pts = (rng.rand(20000, 3) * np.float32([20, 20, 2])).astype(np.float32)
    cell = 1.0
    pg = build_packed_grid(pts, cell, cap=256)
    idx = np.asarray(pg.idx_packed)
    assert np.sum(idx >= 0) == len(pts)  # every point kept: no truncation
    q = pts[rng.choice(len(pts), 2000, replace=False)]
    d, i = knn_packed(pg, jnp.asarray(q), k)
    d_ref, i_ref = knn_np(pts, q, k)
    inside = d_ref[:, -1] < cell
    assert inside.mean() > 0.9
    np.testing.assert_array_equal(np.sort(np.asarray(i)[inside], 1), np.sort(i_ref[inside], 1))
    np.testing.assert_allclose(np.asarray(d)[inside], d_ref[inside], atol=1e-5)
