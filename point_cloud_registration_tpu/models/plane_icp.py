"""Point-to-plane ICP on the device.

Objective ``sum_i (n_i^T (T p_i - q_i))^2`` against the target's k-NN PCA
normals — the reference solver at
/root/reference/point_cloud_registration/plane_icp.py:13-69. Correspondences
are gated raw-point 1-NN exactly as in ICP; the residual is the scalar
projection on the matched point's normal. Supports the reference's
precomputed-index injection (plane_icp.py:19-28) so benchmarks can time
alignment separately from normal estimation (README.md:48).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from point_cloud_registration_tpu.core.config import PlaneICPConfig
from point_cloud_registration_tpu.core.gn import GNStats, gauss_newton
from point_cloud_registration_tpu.core.se3 import makeRt, transform_points
from point_cloud_registration_tpu.models._point_corr import (
    PointCorrTarget,
    build_point_corr,
    match_points,
)
from point_cloud_registration_tpu.models.base import AlignResult, Registration
from point_cloud_registration_tpu.ops.normals import estimate_normals
from point_cloud_registration_tpu.ops.reduce import plane_stats


class PlaneICPTarget(NamedTuple):
    """Raw-point correspondence target + per-point normals."""

    corr: PointCorrTarget
    normals: jax.Array  # (N, 3) f32


def build_plane_icp_target(
    points, cfg: PlaneICPConfig, *, normals=None
) -> PlaneICPTarget:
    """Index + (optionally) estimate normals (``PlaneICP.set_target``,
    plane_icp.py:19-28). Pass ``normals`` to reuse a precomputed field."""
    points = jnp.asarray(points, dtype=jnp.float32)
    if normals is None:
        normals = estimate_normals(points, k=cfg.k)
    normals = jnp.asarray(normals, dtype=jnp.float32)
    # the proxy tier serves voxel *planes*, so ask for enough points per voxel
    corr = build_point_corr(points, cfg.corr, cfg.max_dist, proxy_min_points=3,
                            proxy_normals=True)
    return PlaneICPTarget(corr=corr, normals=normals)


def plane_icp_stats(
    target: PlaneICPTarget, source, src_weight, T, cfg: PlaneICPConfig
) -> GNStats:
    """Fused correspondence + plane linearization (plane_icp.py:30-69).

    Raw matches use the matched point's k-NN PCA normal; proxy (far) matches
    use the proxy voxel's plane — i.e. PlaneICP degrades to VPlaneICP for
    correspondences beyond the packed tier's exactness radius, which only
    exist in early iterations.
    """
    R, _ = makeRt(T)
    src_trans = transform_points(T, source)
    m = match_points(target.corr, src_trans, cfg.corr, cfg.max_dist,
                     fixed_tiers=cfg.fixed_tiers)
    w = src_weight * m.weight
    safe_raw = jnp.clip(m.point_idx, 0, target.normals.shape[0] - 1)
    if target.corr.proxy is not None:
        safe_proxy = jnp.clip(m.proxy_slot, 0, target.corr.proxy.normals.shape[0] - 1)
        norms = jnp.where(
            (m.point_idx >= 0)[:, None],
            target.normals[safe_raw],
            target.corr.proxy.normals[safe_proxy],
        )
    else:
        norms = target.normals[safe_raw]
    return plane_stats(source, src_trans, m.target, norms, w, R, huber_delta=cfg.huber_delta)


@partial(jax.jit, static_argnames=("cfg",))
def plane_icp_align(
    target: PlaneICPTarget, source, src_weight, init_T, cfg: PlaneICPConfig
) -> AlignResult:
    def stats_fn(T):
        return plane_icp_stats(target, source, src_weight, T, cfg)

    T, diag = gauss_newton(stats_fn, init_T, cfg.max_iter, cfg.tol)
    return AlignResult(T=T, diagnostics=diag)


class PlaneICP(Registration):
    """Reference-compatible shim (constructor of plane_icp.py:14-17)."""

    def __init__(self, max_iter: int = 30, max_dist: float = 2, tol: float = 1e-3, k: int = 15,
                 huber_delta: float | None = None):
        super().__init__(max_iter=max_iter, tol=tol)
        self.max_dist = max_dist
        self.k = k
        self.cfg = PlaneICPConfig(
            max_iter=max_iter, max_dist=max_dist, tol=tol, k=k, huber_delta=huber_delta
        )

    def set_target(self, target, kdree=None, norm=None) -> None:
        """``kdree`` is accepted for signature parity (plane_icp.py:19) but
        unused: the grid index rebuild is cheap on device. ``norm`` injects
        precomputed normals, skipping estimation."""
        del kdree
        self._target = build_plane_icp_target(target, self.cfg, normals=norm)
        self.normal = self._target.normals  # attribute parity (plane_icp.py:23)

    def _align_fn(self, target, source, src_weight, init_T) -> AlignResult:
        return plane_icp_align(target, source, src_weight, init_T, self.cfg)

    def _stats_fn(self, target, source, src_weight, T) -> GNStats:
        return _plane_stats_jit(target, source, src_weight, T, self.cfg)


@partial(jax.jit, static_argnames=("cfg",))
def _plane_stats_jit(target, source, src_weight, T, cfg) -> GNStats:
    return plane_icp_stats(target, source, src_weight, T, cfg)
