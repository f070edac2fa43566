"""Point-to-point ICP on the device.

Objective ``sum_i || T p_i - q_i ||^2`` with kd-tree-gated nearest-neighbor
correspondences — the reference solver at
point_cloud_registration/icp.py:12-57 of the reference. Re-design for XLA:

* the target index is a CSR-bucketed voxel grid (cell = max_dist) instead of
  a kd-tree (icp.py:20-21); the 27-cell window provably covers the
  ``dist < max_dist`` gate (ops/hashgrid.search_offsets);
* mask compaction (icp.py:34-36) becomes 0/1 weights in the closed-form
  block reduction (ops/reduce.point_stats);
* the whole align loop is one jitted ``lax.while_loop`` program
  (core/gn.gauss_newton).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from point_cloud_registration_tpu.core.config import ICPConfig
from point_cloud_registration_tpu.core.gn import GNStats, gauss_newton
from point_cloud_registration_tpu.core.se3 import makeRt, transform_points
from point_cloud_registration_tpu.models._point_corr import (
    PointCorrTarget,
    build_point_corr,
    match_points,
)
from point_cloud_registration_tpu.models.base import AlignResult, Registration
from point_cloud_registration_tpu.ops.reduce import point_stats

# The ICP target is the generic raw-point correspondence target.
ICPTarget = PointCorrTarget


def build_icp_target(points, cfg: ICPConfig) -> ICPTarget:
    """Index the target cloud (replaces ``ICP.set_target``, icp.py:17-22)."""
    return build_point_corr(points, cfg.corr, cfg.max_dist)


def icp_stats(target: ICPTarget, source, src_weight, T, cfg: ICPConfig) -> GNStats:
    """Correspondence + linearization + reduction for one GN iteration
    (fuses icp.py:32-56)."""
    R, _ = makeRt(T)
    src_trans = transform_points(T, source)
    m = match_points(target, src_trans, cfg.corr, cfg.max_dist,
                     fixed_tiers=cfg.fixed_tiers)
    w = src_weight * m.weight
    return point_stats(source, src_trans, m.target, w, R, huber_delta=cfg.huber_delta)


@partial(jax.jit, static_argnames=("cfg",))
def icp_align(target: ICPTarget, source, src_weight, init_T, cfg: ICPConfig) -> AlignResult:
    """Full jitted align (registration.py:71-112 semantics)."""

    def stats_fn(T):
        return icp_stats(target, source, src_weight, T, cfg)

    T, diag = gauss_newton(stats_fn, init_T, cfg.max_iter, cfg.tol)
    return AlignResult(T=T, diagnostics=diag)


class ICP(Registration):
    """Reference-compatible shim (constructor signature of icp.py:13-15)."""

    def __init__(self, max_iter: int = 30, max_dist: float = 2, tol: float = 1e-3,
                 huber_delta: float | None = None):
        super().__init__(max_iter=max_iter, tol=tol)
        self.max_dist = max_dist
        self.cfg = ICPConfig(
            max_iter=max_iter, max_dist=max_dist, tol=tol, huber_delta=huber_delta
        )

    def set_target(self, target) -> None:
        self._target = build_icp_target(target, self.cfg)

    def _align_fn(self, target, source, src_weight, init_T) -> AlignResult:
        return icp_align(target, source, src_weight, init_T, self.cfg)

    def _stats_fn(self, target, source, src_weight, T) -> GNStats:
        return _icp_stats_jit(target, source, src_weight, T, self.cfg)


@partial(jax.jit, static_argnames=("cfg",))
def _icp_stats_jit(target, source, src_weight, T, cfg) -> GNStats:
    return icp_stats(target, source, src_weight, T, cfg)
