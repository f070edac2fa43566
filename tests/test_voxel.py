import numpy as np
import jax
import jax.numpy as jnp
import pytest

from point_cloud_registration_tpu.ops import voxelize, hashgrid
from point_cloud_registration_tpu.ops.eigh3 import unpack_sym3
from oracles import voxel_stats_np


@pytest.fixture
def cloud():
    rng = np.random.RandomState(11)
    # clustered points so voxels have enough members
    centers = rng.rand(40, 3) * 10
    pts = (centers[:, None, :] + rng.randn(40, 60, 3) * 0.4).reshape(-1, 3)
    return pts.astype(np.float32)


def _cell_of(p, vs):
    return tuple(np.floor(p / vs).astype(np.int64))


def test_voxel_stats_match_oracle(cloud):
    vs = 1.0
    vm = voxelize.build_voxel_map(cloud, vs, min_points=1)
    oracle = voxel_stats_np(cloud, vs)
    means = np.asarray(jax.device_get(vm.means))
    counts = np.asarray(jax.device_get(vm.counts))
    covs = np.asarray(jax.device_get(unpack_sym3(vm.covs)))
    n_cells = int(jax.device_get(vm.grid.n_cells))
    assert n_cells == len(oracle)
    # map each oracle cell to its slot via the grid lookup
    cells = np.array(list(oracle.keys()), dtype=np.int64)
    keys = hashgrid.coords_to_key(
        jnp.asarray(cells, jnp.int32), vm.grid.origin_cell, vm.grid.dims
    )
    slots = np.asarray(jax.device_get(hashgrid.lookup_slots(vm.grid, keys)))
    assert np.all(slots >= 0)
    for (cell, (n, mean, cov)), slot in zip(oracle.items(), slots):
        assert counts[slot] == n
        np.testing.assert_allclose(means[slot], mean, atol=1e-4)
        np.testing.assert_allclose(covs[slot], cov, atol=1e-4)


def test_min_points_mask(cloud):
    vm = voxelize.build_voxel_map(cloud, 1.0, min_points=10)
    counts = np.asarray(jax.device_get(vm.counts))
    valid = np.asarray(jax.device_get(vm.valid))
    np.testing.assert_array_equal(valid, counts >= 10)


def test_normals_match_oracle_eigh(cloud):
    vm = voxelize.build_voxel_map(cloud, 1.0, min_points=5)
    covs = np.asarray(jax.device_get(unpack_sym3(vm.covs))).astype(np.float64)
    normals = np.asarray(jax.device_get(vm.normals))
    valid = np.asarray(jax.device_get(vm.valid))
    _, vecs = np.linalg.eigh(covs[valid])
    ref = vecs[:, :, 0]
    cos = np.abs(np.sum(normals[valid] * ref, axis=-1))
    assert np.quantile(cos, 0.02) > 1 - 1e-3


def test_icov_matches_inverse(cloud):
    vm = voxelize.build_voxel_map(cloud, 1.0, min_points=10, with_icov=True)
    valid = np.asarray(jax.device_get(vm.valid))
    covs = np.asarray(jax.device_get(unpack_sym3(vm.covs)))[valid].astype(np.float64)
    icovs = np.asarray(jax.device_get(unpack_sym3(vm.icovs)))[valid]
    ref = np.linalg.inv(covs)
    scale = np.abs(ref).max(axis=(1, 2), keepdims=True)
    np.testing.assert_allclose(icovs / scale, ref / scale, atol=2e-3)


def test_icov_singular_guard():
    # rank-deficient covariance: det == 0 -> guarded, finite output
    covs = jnp.asarray([[1.0, 1.0, 0.0, 0.0, 0.0, 0.0]], jnp.float32)
    icov = np.asarray(jax.device_get(voxelize.invert_cov_packed(covs)))
    assert np.all(np.isfinite(icov))


def test_voxel_filter_matches_oracle(cloud):
    vs = 0.8
    ours = voxelize.voxel_filter(cloud, vs)
    oracle = voxel_stats_np(cloud, vs)
    assert ours.shape == (len(oracle), 3)
    assert ours.dtype == np.float32
    ref = np.stack([m for (_, m, _) in oracle.values()])
    # order-independent comparison
    ours_sorted = ours[np.lexsort(ours.T)]
    ref_sorted = ref[np.lexsort(ref.T)]
    np.testing.assert_allclose(ours_sorted, ref_sorted, atol=1e-4)


def test_color_by_voxel_structure(cloud):
    rec = voxelize.color_by_voxel(cloud, 1.0)
    assert rec.dtype.names == ("xyz", "irgb")
    assert rec.shape[0] == len(cloud)
    # same voxel -> same color, different voxels -> (almost surely) different
    cells = [_cell_of(p, 1.0) for p in cloud]
    c0 = {}
    for cell, irgb in zip(cells, rec["irgb"]):
        c0.setdefault(cell, irgb)
        assert c0[cell] == irgb


def test_update_voxel_map_matches_batch_rebuild(cloud):
    """Incremental merge (Chan parallel formulas) must equal a from-scratch
    build over the union — the feature the reference only stubbed
    (registration.py:36-43)."""
    from point_cloud_registration_tpu.ops.voxelize import update_voxel_map

    # part A must span the full bounding box (a dense grid cannot grow);
    # pin the per-axis extreme points into it
    extremes = np.unique(
        np.concatenate([np.argmin(cloud, axis=0), np.argmax(cloud, axis=0)])
    )
    mask_a = np.zeros(len(cloud), bool)
    mask_a[: len(cloud) // 2] = True
    mask_a[extremes] = True
    part_a = cloud[mask_a]
    part_b = cloud[~mask_a]
    vm_inc = voxelize.build_voxel_map(part_a, 1.0, min_points=5, with_icov=True)
    vm_inc = update_voxel_map(vm_inc, part_b, min_points=5)
    vm_all = voxelize.build_voxel_map(cloud, 1.0, min_points=5, with_icov=True)

    np.testing.assert_array_equal(
        np.asarray(jax.device_get(vm_inc.counts)), np.asarray(jax.device_get(vm_all.counts))
    )
    np.testing.assert_array_equal(
        np.asarray(jax.device_get(vm_inc.valid)), np.asarray(jax.device_get(vm_all.valid))
    )
    valid = np.asarray(jax.device_get(vm_all.valid))
    np.testing.assert_allclose(
        np.asarray(jax.device_get(vm_inc.means))[valid],
        np.asarray(jax.device_get(vm_all.means))[valid],
        atol=1e-4,
    )
    np.testing.assert_allclose(
        np.asarray(jax.device_get(vm_inc.covs))[valid],
        np.asarray(jax.device_get(vm_all.covs))[valid],
        atol=1e-4,
    )
    # out-of-bounds points are dropped, not crashed on
    far = np.array([[1e4, 1e4, 1e4]], np.float32)
    vm2 = update_voxel_map(vm_inc, far, min_points=5)
    np.testing.assert_array_equal(
        np.asarray(jax.device_get(vm2.counts)), np.asarray(jax.device_get(vm_inc.counts))
    )


def test_solver_update_target(cloud):
    from point_cloud_registration_tpu import VPlaneICP

    vp = VPlaneICP(voxel_size=1.0)
    vp.set_target(cloud[:1500])
    n1 = int(np.asarray(vp.voxels.num_voxels))
    vp.update_target(cloud[1500:])
    n2 = int(np.asarray(vp.voxels.num_voxels))
    assert n2 >= n1
    # and alignment still works on the updated map
    T = vp.align(cloud[:800] + np.float32(0.05))
    assert np.all(np.isfinite(T))


def test_sqrt_icov_matches_cholesky(cloud):
    from point_cloud_registration_tpu.ops.voxelize import sqrt_icov_packed
    from point_cloud_registration_tpu.ops.eigh3 import unpack_sym3

    vm = voxelize.build_voxel_map(cloud, 1.0, min_points=10, with_icov=True)
    valid = np.asarray(jax.device_get(vm.valid))
    icov_full = np.asarray(jax.device_get(unpack_sym3(vm.icovs)))[valid].astype(np.float64)
    L_T = np.asarray(jax.device_get(sqrt_icov_packed(vm.icovs)))[valid]
    # reference contract (voxel.py:61-67): cholesky(icov) transposed
    ref = np.transpose(np.linalg.cholesky(icov_full), (0, 2, 1))
    scale = np.abs(ref).max(axis=(1, 2), keepdims=True)
    np.testing.assert_allclose(L_T / scale, ref / scale, atol=2e-3)
    # and the factorization reproduces icov: (L^T)^T (L^T) = L L^T
    np.testing.assert_allclose(
        np.einsum("nji,njk->nik", L_T, L_T) / scale,
        icov_full / scale,
        atol=2e-3,
    )


def test_voxelgrid_calc_sqrt_icov(cloud):
    from point_cloud_registration_tpu import VoxelGrid

    vg = VoxelGrid(1.0)
    vg.set_points(cloud)
    vg.calc_sqrt_icov()
    assert vg.sqrt_icov.shape == (len(vg.mean), 3, 3)
    # upper triangular
    assert np.allclose(vg.sqrt_icov[:, 1, 0], 0) and np.allclose(vg.sqrt_icov[:, 2, 0], 0)


def test_dense_blocks_transpose_matches_scatter(cloud):
    """dense_blocks_from_dense (pure-permutation fast path) must reproduce
    build_dense_blocks (scatter path) bit-for-bit on a dense-direct map."""
    from point_cloud_registration_tpu.ops.knn import (
        DENSE_BLOCK,
        build_dense_blocks,
        dense_blocks_from_dense,
    )

    vm = voxelize.build_voxel_map(cloud, 1.0, min_points=10)
    dims = tuple(int(x) for x in jax.device_get(vm.grid.dims))
    nb = tuple(-(-d // b) for d, b in zip(dims, DENSE_BLOCK))
    scatter = build_dense_blocks(vm.grid, vm.means, vm.valid, nb)
    transpose = dense_blocks_from_dense(vm.means, vm.valid, dims, nb)
    np.testing.assert_array_equal(
        np.asarray(jax.device_get(scatter)), np.asarray(jax.device_get(transpose))
    )


def test_voxel_filter_device_matches_host(cloud):
    """Device-resident variant: +inf-padded rows, count, content parity."""
    import jax.numpy as jnp

    vs = 0.8
    host = voxelize.voxel_filter(cloud, vs)
    means, n = voxelize.voxel_filter_device(cloud, vs)
    n = int(jax.device_get(n))
    means = np.asarray(jax.device_get(means))
    assert n == len(host)
    assert not np.isfinite(means[n:]).any()
    a = host[np.lexsort(host.T)]
    b = means[:n][np.lexsort(means[:n].T)]
    np.testing.assert_allclose(a, b, atol=1e-5)

    # sparse-branch parity: shrink the dense budget so the same cloud takes
    # the grid/sort path, results must agree
    import point_cloud_registration_tpu.ops.voxelize as vx

    orig = vx.DENSE_CELL_BUDGET
    try:
        vx.DENSE_CELL_BUDGET = 1
        means2, n2 = voxelize.voxel_filter_device(cloud, vs)
    finally:
        vx.DENSE_CELL_BUDGET = orig
    n2 = int(jax.device_get(n2))
    means2 = np.asarray(jax.device_get(means2))
    assert n2 == n
    c = means2[:n2][np.lexsort(means2[:n2].T)]
    np.testing.assert_allclose(a, c, atol=1e-5)
