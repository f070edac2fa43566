"""Map sharding: voxel slabs distributed over the mesh's ``model`` axis.

SURVEY §2.3 TP row / BASELINE north star ("sharding scan points and map
voxel blocks"). The sharded map must reproduce the replicated-map align
exactly, and per-device map bytes must shrink ~linearly with shard count
(the beyond-HBM capacity contract).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from point_cloud_registration_tpu.core.config import NDTConfig, VPlaneICPConfig
from point_cloud_registration_tpu.models import (
    build_ndt_target,
    build_vplane_target,
    ndt_align,
    vplane_align,
)
from point_cloud_registration_tpu.models.base import pad_points
from point_cloud_registration_tpu.parallel import (
    align_map_sharded,
    make_map_mesh,
    shard_voxel_map,
)
from oracles import make_scan, make_scene


@pytest.fixture(scope="module")
def problem():
    rng = np.random.RandomState(7)
    scene = make_scene(rng)
    scan, T_true = make_scan(
        rng, scene, np.array([0.05, -0.03, 0.1, 0.01, -0.01, 0.015])
    )
    return scene, scan, T_true


@pytest.mark.parametrize("kind", ["vplane_icp", "ndt"])
def test_map_sharded_matches_replicated(problem, kind):
    scene, scan, _ = problem
    if kind == "vplane_icp":
        cfg = VPlaneICPConfig(voxel_size=1.0, max_iter=30, max_dist=2.0, tol=1e-3)
        single = vplane_align(build_vplane_target(scene, cfg), *_args(scan), cfg)
    else:
        cfg = NDTConfig(voxel_size=1.0, max_iter=30, max_dist=2.0, tol=1e-3)
        single = ndt_align(build_ndt_target(scene, cfg), *_args(scan), cfg)

    svm, meta = shard_voxel_map(
        scene, 1.0, n_shards=4, min_points=cfg.min_points,
        with_icov=(kind == "ndt"),
    )
    mesh = make_map_mesh(model=4, data=2)
    src, w = pad_points(scan)
    out = align_map_sharded(
        kind, svm, meta, src, w, jnp.eye(4, dtype=jnp.float32), cfg, mesh
    )
    np.testing.assert_allclose(
        np.asarray(jax.device_get(out.T)),
        np.asarray(jax.device_get(single.T)),
        atol=1e-5,
    )
    assert int(jax.device_get(out.diagnostics.iterations)) == int(
        jax.device_get(single.diagnostics.iterations)
    )


def _args(scan):
    src, w = pad_points(scan)
    return src, w, jnp.eye(4, dtype=jnp.float32)


def test_map_shard_capacity_scales():
    """Per-device bytes shrink ~linearly with shard count: the capacity
    contract that lets a map exceed one device's HBM. Uses a z-extended
    cloud — a flat scene's blocked-table z padding would mask the scaling."""
    rng = np.random.RandomState(11)
    scene = (rng.rand(60000, 3) * np.array([30.0, 30.0, 64.0])).astype(np.float32)
    svm1, _ = shard_voxel_map(scene, 1.0, n_shards=1)
    svm4, _ = shard_voxel_map(scene, 1.0, n_shards=4)

    def slab_bytes(svm):
        return sum(
            a.nbytes // a.shape[0]
            for a in jax.tree.leaves(svm)
        )

    b1, b4 = slab_bytes(svm1), slab_bytes(svm4)
    assert b4 <= b1 / 2.5, (b1, b4)  # blocked-table z padding costs a bit


def test_map_sharded_rejects_point_kinds(problem):
    scene, scan, _ = problem
    svm, meta = shard_voxel_map(scene, 1.0, n_shards=4)
    cfg = VPlaneICPConfig(voxel_size=1.0)
    mesh = make_map_mesh(model=4, data=2)
    src, w = pad_points(scan)
    with pytest.raises(ValueError, match="voxel-map kinds"):
        align_map_sharded("icp", svm, meta, src, w, jnp.eye(4), cfg, mesh)


def test_map_sharded_large_scan_beyond_tier_capacity(problem):
    """With z-slab sharding most queries' true voxels live on other
    shards; a compacted unresolved tier (capacity ~N/4) silently overflows
    for scans past ~4x its floor, leaving near-pass results whose window
    can miss 2-cell matches at unlucky block alignments. The slab query
    therefore probes the FULL max_dist window for every query — asserted
    here to keep the sharded align identical to the replicated one at
    beyond-capacity scan sizes and a multi-cell initial offset."""
    scene, _, _ = problem
    rng = np.random.RandomState(3)
    n = 12_288  # > 4 * the 1024 compaction floor per data shard
    # big initial offset: early-iteration matches sit 1-2 cells away, so
    # the near pass resolves almost nothing and the old compacted tier
    # overflowed on most shards
    scan = scene[rng.choice(len(scene), n, replace=True)] + np.float32(
        [0.45, -0.3, 1.3]
    )
    cfg = VPlaneICPConfig(voxel_size=1.0, max_iter=10, max_dist=2.0, tol=1e-3)
    single = vplane_align(build_vplane_target(scene, cfg), *_args(scan), cfg)
    svm, meta = shard_voxel_map(scene, 1.0, n_shards=4, min_points=cfg.min_points)
    mesh = make_map_mesh(model=4, data=2)
    src, w = pad_points(scan)
    out = align_map_sharded(
        "vplane_icp", svm, meta, src, w, jnp.eye(4, dtype=jnp.float32), cfg, mesh
    )
    np.testing.assert_allclose(
        np.asarray(out.T), np.asarray(single.T), atol=1e-5
    )
    assert int(out.diagnostics.iterations) == int(single.diagnostics.iterations)


def test_distributed_builder_matches_local(problem):
    """shard_voxel_map_on_mesh builds each slab on its own devices — the
    global dense array never exists — and must reproduce the local reshape
    builder's slabs (f32 partial-sum grouping differs, hence the atol)."""
    from point_cloud_registration_tpu.parallel import shard_voxel_map_on_mesh

    scene, _, _ = problem
    mesh = make_map_mesh(model=4, data=2)
    svm_l, meta_l = shard_voxel_map(scene, 1.0, n_shards=4, min_points=10)
    svm_d, meta_d = shard_voxel_map_on_mesh(scene, 1.0, mesh, min_points=10, axis=2)
    assert meta_l == meta_d
    np.testing.assert_array_equal(
        np.asarray(jax.device_get(svm_l.counts)),
        np.asarray(jax.device_get(svm_d.counts)),
    )
    np.testing.assert_array_equal(
        np.asarray(jax.device_get(svm_l.valid)),
        np.asarray(jax.device_get(svm_d.valid)),
    )
    np.testing.assert_allclose(
        np.asarray(jax.device_get(svm_l.means)),
        np.asarray(jax.device_get(svm_d.means)),
        atol=2e-5,
    )


@pytest.mark.parametrize("kind", ["vplane_icp", "ndt"])
def test_on_mesh_auto_axis_align_matches_single(problem, kind):
    """End-to-end: distributed build along the auto (widest) axis + the
    compacted per-slab query == the single-device align."""
    from point_cloud_registration_tpu.parallel import shard_voxel_map_on_mesh

    scene, scan, _ = problem
    if kind == "vplane_icp":
        cfg = VPlaneICPConfig(voxel_size=1.0, max_iter=30, max_dist=2.0,
                              tol=1e-3)
        single = vplane_align(build_vplane_target(scene, cfg), *_args(scan), cfg)
    else:
        cfg = NDTConfig(voxel_size=1.0, max_iter=30, max_dist=2.0, tol=1e-3)
        single = ndt_align(build_ndt_target(scene, cfg), *_args(scan), cfg)
    mesh = make_map_mesh(model=4, data=2)
    svm, meta = shard_voxel_map_on_mesh(
        scene, 1.0, mesh, min_points=cfg.min_points, with_icov=(kind == "ndt")
    )
    src, w = pad_points(scan)
    out = align_map_sharded(
        kind, svm, meta, src, w, jnp.eye(4, dtype=jnp.float32), cfg, mesh
    )
    # the distributed builder's per-slab partial-sum grouping differs from
    # the single build at f32 rounding level; NDT's icovs amplify it a bit
    np.testing.assert_allclose(np.asarray(out.T), np.asarray(single.T), atol=5e-5)
    assert int(out.diagnostics.iterations) == int(single.diagnostics.iterations)


def test_on_mesh_skewed_scene_overflow_fallback(problem):
    """All scan points inside ONE slab's overlap along the shard axis: the
    owning slab's compaction capacity overflows and the scalar lax.cond
    falls back to querying everything — results stay exact. model=8 so the
    compacted path is actually active (qcap < n per slab — at model<=4 the
    static qcap >= n branch queries everything and compaction never runs)."""
    from point_cloud_registration_tpu.parallel import shard_voxel_map_on_mesh

    scene, _, _ = problem
    rng = np.random.RandomState(13)
    # cluster the scan at one end of the widest axis
    sel = np.argsort(scene[:, 0])[:4000]
    scan = scene[sel][rng.choice(4000, 6000, replace=True)] + np.float32(
        [0.05, -0.03, 0.1]
    )
    cfg = VPlaneICPConfig(voxel_size=1.0, max_iter=10, max_dist=2.0, tol=1e-3)
    single = vplane_align(build_vplane_target(scene, cfg), *_args(scan), cfg)
    mesh = make_map_mesh(model=8, data=1)
    svm, meta = shard_voxel_map_on_mesh(scene, 1.0, mesh, min_points=cfg.min_points)
    src, w = pad_points(scan)
    out = align_map_sharded(
        "vplane_icp", svm, meta, src, w, jnp.eye(4, dtype=jnp.float32), cfg, mesh
    )
    np.testing.assert_allclose(np.asarray(out.T), np.asarray(single.T), atol=1e-5)


def test_on_mesh_compacted_query_matches_single():
    """model=8, evenly spread scan over a WIDE scene (thick slabs, so the
    static qcap < n and every slab takes the query_compact branch) —
    results identical to the single-device align (regression for the
    duplicate-index scatter-set hazard in query_compact)."""
    from point_cloud_registration_tpu.parallel import shard_voxel_map_on_mesh

    rng = np.random.RandomState(23)
    n = 40000
    scene = np.stack(
        [rng.rand(n) * 100, rng.rand(n) * 40, rng.randn(n) * 0.5], 1
    ).astype(np.float32)
    idx = rng.choice(n, 6000, replace=False)
    scan = (scene[idx] + np.float32([0.06, -0.04, 0.09])
            + rng.randn(6000, 3).astype(np.float32) * 0.004).astype(np.float32)
    cfg = VPlaneICPConfig(voxel_size=1.0, max_iter=30, max_dist=2.0, tol=1e-3,
                          min_points=3)
    single = vplane_align(build_vplane_target(scene, cfg), *_args(scan), cfg)
    mesh = make_map_mesh(model=8, data=1)
    svm, meta = shard_voxel_map_on_mesh(scene, 1.0, mesh, min_points=cfg.min_points)
    src, w = pad_points(scan)
    n_s = src.shape[0]
    # compaction must actually be active for this test to mean anything
    radius = 2  # max_dist / voxel_size
    ns_ax = meta.dims_slab[meta.axis]
    slabs_per_window = 2 * radius // max(ns_ax, 1) + 2
    qcap = int(min(n_s, max(512, -(-2 * slabs_per_window * n_s) // 8)))
    assert qcap < n_s, "test scene too small to activate compaction"
    out = align_map_sharded(
        "vplane_icp", svm, meta, src, w, jnp.eye(4, dtype=jnp.float32), cfg, mesh
    )
    np.testing.assert_allclose(np.asarray(out.T), np.asarray(single.T), atol=1e-5)
    assert int(out.diagnostics.iterations) == int(single.diagnostics.iterations)
