"""Voxelized point-to-plane ICP — the flagship fast solver.

Same plane objective as PlaneICP but correspondences are the nearest *voxel
Gaussian* (mean + normal) of a voxel map — the reference solver at
/root/reference/point_cloud_registration/voxelized_plane_icp.py:12-64. The
reference finds the nearest voxel with a kd-tree over centroids
(voxel.py:165, :176); here it is a provably-covering neighbor-cell window
over the voxel grid itself (ops/knn.nearest_voxel) — no second index, no
pointer chasing, one gather per window cell.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from point_cloud_registration_tpu.core.config import VPlaneICPConfig
from point_cloud_registration_tpu.core.gn import GNStats, gauss_newton
from point_cloud_registration_tpu.core.se3 import makeRt, transform_points
from point_cloud_registration_tpu.models.base import AlignResult, Registration
from point_cloud_registration_tpu.ops.reduce import plane_stats
from point_cloud_registration_tpu.ops.voxelize import (
    VoxelMap,
    build_voxel_map,
    query_nearest_voxel,
)


def build_vplane_target(points, cfg: VPlaneICPConfig) -> VoxelMap:
    """Voxel map with Gaussian stats + normals (``VPlaneICP.set_target``,
    voxelized_plane_icp.py:18-21)."""
    return build_voxel_map(
        points, cfg.voxel_size, min_points=cfg.min_points, with_icov=False,
    )


def build_vplane_target_deferred(points, cfg: VPlaneICPConfig, *,
                                 use_hint: bool = True):
    """Geometry-hinted :func:`build_vplane_target`: ``(vm, n_dropped)``.

    Zero host syncs on a hint hit; the caller must carry the ``n_dropped``
    device scalar through its next sync (see ops.voxelize.
    build_voxel_map_deferred)."""
    from point_cloud_registration_tpu.ops.voxelize import (
        build_voxel_map_deferred,
    )

    return build_voxel_map_deferred(
        points, cfg.voxel_size, min_points=cfg.min_points, use_hint=use_hint,
    )


def vplane_stats(vmap_: VoxelMap, source, src_weight, T, cfg: VPlaneICPConfig) -> GNStats:
    """Nearest-voxel correspondence + plane linearization
    (voxelized_plane_icp.py:23-64)."""
    R, _ = makeRt(T)
    src_trans = transform_points(T, source)
    nn = query_nearest_voxel(
        vmap_,
        src_trans,
        voxel_size=cfg.voxel_size,
        max_dist=cfg.max_dist,
        fixed_tiers=cfg.fixed_tiers,
    )
    w = src_weight * (nn.dist < cfg.max_dist) * (nn.idx >= 0)
    safe = jnp.clip(nn.idx, 0, vmap_.means.shape[0] - 1)
    means = vmap_.means[safe]
    norms = vmap_.normals[safe]
    return plane_stats(source, src_trans, means, norms, w, R, huber_delta=cfg.huber_delta)


@partial(jax.jit, static_argnames=("cfg",))
def vplane_align(vmap_: VoxelMap, source, src_weight, init_T, cfg: VPlaneICPConfig) -> AlignResult:
    def stats_fn(T):
        return vplane_stats(vmap_, source, src_weight, T, cfg)

    T, diag = gauss_newton(stats_fn, init_T, cfg.max_iter, cfg.tol)
    return AlignResult(T=T, diagnostics=diag)


class VPlaneICP(Registration):
    """Reference-compatible shim (constructor of voxelized_plane_icp.py:13-16)."""

    def __init__(
        self,
        voxel_size: float = 1.0,
        max_iter: int = 30,
        max_dist: float = 2,
        tol: float = 1e-3,
        huber_delta: float | None = None,
    ):
        super().__init__(max_iter=max_iter, tol=tol)
        self.voxel_size = voxel_size
        self.max_dist = max_dist
        self.cfg = VPlaneICPConfig(
            voxel_size=voxel_size,
            max_iter=max_iter,
            max_dist=max_dist,
            tol=tol,
            huber_delta=huber_delta,
        )

    def set_target(self, target) -> None:
        # geometry-hinted deferred build: zero host syncs in the SLAM
        # steady state (same map region every scan); the n_dropped check
        # rides align's existing result sync (base.Registration)
        self._target_pts = target
        self._target, self._pending_drop = build_vplane_target_deferred(
            target, self.cfg
        )

    def _rebuild_target_exact(self) -> None:
        self._target, _ = build_vplane_target_deferred(
            self._target_pts, self.cfg, use_hint=False
        )

    def update_target(self, target) -> None:
        """Incremental map update — the capability the reference declares but
        never implements (registration.py:36-43)."""
        from point_cloud_registration_tpu.ops.voxelize import update_voxel_map

        if self._target is None:
            self.set_target(target)
            return
        self._verify_target()
        self._target = update_voxel_map(self._target, target, min_points=self.cfg.min_points)

    @property
    def voxels(self) -> VoxelMap:
        """Attribute parity with the reference (voxelized_plane_icp.py:19)."""
        self._verify_target()
        return self._target

    def _align_fn(self, target, source, src_weight, init_T) -> AlignResult:
        return vplane_align(target, source, src_weight, init_T, self.cfg)

    def _stats_fn(self, target, source, src_weight, T) -> GNStats:
        return _vplane_stats_jit(target, source, src_weight, T, self.cfg)


@partial(jax.jit, static_argnames=("cfg",))
def _vplane_stats_jit(target, source, src_weight, T, cfg) -> GNStats:
    return vplane_stats(target, source, src_weight, T, cfg)
