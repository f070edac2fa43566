"""NDT registration (Gauss-Newton on the Mahalanobis objective) on the device.

Objective ``sum_i (T p_i - mu_i)^T Sigma_i^{-1} (T p_i - mu_i)`` against
nearest-voxel Gaussians — the reference solver at
/root/reference/point_cloud_registration/ndt.py:12-57. As in the reference
this is plain GN on the Mahalanobis cost, *not* Magnusson's
exponential-likelihood NDT (SURVEY §2 C10). Inverse covariances use the
analytic adjugate form with the reference's singular guard
(voxel.py:69-102).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from point_cloud_registration_tpu.core.config import NDTConfig
from point_cloud_registration_tpu.core.gn import GNStats, gauss_newton
from point_cloud_registration_tpu.core.se3 import makeRt, transform_points
from point_cloud_registration_tpu.models.base import AlignResult, Registration
from point_cloud_registration_tpu.ops.reduce import ndt_stats
from point_cloud_registration_tpu.ops.voxelize import (
    VoxelMap,
    build_voxel_map,
    query_nearest_voxel,
)


def build_ndt_target(points, cfg: NDTConfig) -> VoxelMap:
    """Voxel map with inverse covariances (``NDT.set_target``, ndt.py:18-22)."""
    return build_voxel_map(
        points, cfg.voxel_size, min_points=cfg.min_points, with_icov=True,
    )


def build_ndt_target_deferred(points, cfg: NDTConfig, *, use_hint: bool = True):
    """Geometry-hinted :func:`build_ndt_target`: ``(vm, n_dropped)``.

    Zero host syncs on a hint hit; the caller must carry the ``n_dropped``
    device scalar through its next sync."""
    from point_cloud_registration_tpu.ops.voxelize import (
        build_voxel_map_deferred,
    )

    return build_voxel_map_deferred(
        points, cfg.voxel_size, min_points=cfg.min_points, with_icov=True,
        use_hint=use_hint,
    )


def ndt_solver_stats(vmap_: VoxelMap, source, src_weight, T, cfg: NDTConfig) -> GNStats:
    """Nearest-voxel correspondence + Mahalanobis linearization (ndt.py:24-57)."""
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
    icovs = vmap_.icovs[safe]
    return ndt_stats(source, src_trans, means, icovs, w, R, huber_delta=cfg.huber_delta)


@partial(jax.jit, static_argnames=("cfg",))
def ndt_align(vmap_: VoxelMap, source, src_weight, init_T, cfg: NDTConfig) -> AlignResult:
    def stats_fn(T):
        return ndt_solver_stats(vmap_, source, src_weight, T, cfg)

    T, diag = gauss_newton(stats_fn, init_T, cfg.max_iter, cfg.tol)
    return AlignResult(T=T, diagnostics=diag)


class NDT(Registration):
    """Reference-compatible shim (constructor of ndt.py:13-16)."""

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
        self.cfg = NDTConfig(
            voxel_size=voxel_size,
            max_iter=max_iter,
            max_dist=max_dist,
            tol=tol,
            huber_delta=huber_delta,
        )

    def set_target(self, target) -> None:
        # geometry-hinted deferred build (zero host syncs on a hint hit);
        # the n_dropped check rides align's existing result sync
        self._target_pts = target
        self._target, self._pending_drop = build_ndt_target_deferred(
            target, self.cfg
        )

    def _rebuild_target_exact(self) -> None:
        self._target, _ = build_ndt_target_deferred(
            self._target_pts, self.cfg, use_hint=False
        )

    def update_target(self, target) -> None:
        """Incremental map update (reference intent, registration.py:36-43)."""
        from point_cloud_registration_tpu.ops.voxelize import update_voxel_map

        if self._target is None:
            self.set_target(target)
            return
        self._verify_target()
        self._target = update_voxel_map(self._target, target, min_points=self.cfg.min_points)

    @property
    def voxels(self) -> VoxelMap:
        self._verify_target()
        return self._target

    def _align_fn(self, target, source, src_weight, init_T) -> AlignResult:
        return ndt_align(target, source, src_weight, init_T, self.cfg)

    def _stats_fn(self, target, source, src_weight, T) -> GNStats:
        return _ndt_stats_jit(target, source, src_weight, T, self.cfg)


@partial(jax.jit, static_argnames=("cfg",))
def _ndt_stats_jit(target, source, src_weight, T, cfg) -> GNStats:
    return ndt_solver_stats(target, source, src_weight, T, cfg)
