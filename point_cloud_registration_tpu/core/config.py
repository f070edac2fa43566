"""Frozen, hashable solver configurations.

The reference configures solvers through constructor hyperparameters and a
module-level edit-the-source backend flag (SURVEY §5: registration.py:11,
icp.py:13, kdtree.py:6-16). Here every knob lives in a frozen dataclass:
hashable, therefore usable as a jit static argument, and serializable for
experiment tracking.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GNConfig:
    """Gauss-Newton loop parameters (registration.py:11-19 defaults)."""

    max_iter: int = 30
    tol: float = 1e-3


@dataclasses.dataclass(frozen=True)
class CorrespondenceConfig:
    """Neighbor-search parameters for the raw-point correspondence engines.

    ``method``: ``"auto"`` picks ``"packed"`` (blocked packed-candidate
    tables + voxel-proxy fallback, ops/pointgrid.py) for large targets and
    ``"grid"`` (CSR bucket scan, exact within the window/cap) for small ones.
    ``cell_size``: bucket size for the grid method (None = max_dist / 2).
    ``cell_cap``: candidates per cell for the grid method.
    ``cell_fine``: fine-cell size for the packed method (None = max_dist / 4);
    it is also the provable-exactness radius of tier 1.
    ``packed_cap``: points packed per block (truncation knob).
    ``auto_threshold``: target size above which ``auto`` uses ``packed``.
    """

    method: str = "auto"
    cell_size: float | None = None
    cell_cap: int = 64
    cell_fine: float | None = None
    packed_cap: int = 32
    auto_threshold: int = 50_000

    def resolved_method(self, n_points: int) -> str:
        if self.method == "auto":
            return "packed" if n_points >= self.auto_threshold else "grid"
        return self.method


@dataclasses.dataclass(frozen=True)
class ICPConfig:
    """Point-to-point ICP (icp.py:12-15 defaults)."""

    max_iter: int = 30
    max_dist: float = 2.0
    tol: float = 1e-3
    huber_delta: float | None = None  # opt-in robust weighting (SURVEY M6)
    corr: CorrespondenceConfig = CorrespondenceConfig()
    # data-independent query tiers for vmapped/batched execution, where
    # lax.switch would execute every branch per element anyway
    fixed_tiers: bool = False


@dataclasses.dataclass(frozen=True)
class PlaneICPConfig:
    """Point-to-plane ICP (plane_icp.py:13-17 defaults)."""

    max_iter: int = 30
    max_dist: float = 2.0
    tol: float = 1e-3
    k: int = 15  # neighbors for normal estimation
    huber_delta: float | None = None
    corr: CorrespondenceConfig = CorrespondenceConfig()
    fixed_tiers: bool = False


@dataclasses.dataclass(frozen=True)
class VPlaneICPConfig:
    """Voxelized point-to-plane ICP (voxelized_plane_icp.py:12-16 defaults)."""

    voxel_size: float = 1.0
    max_iter: int = 30
    max_dist: float = 2.0
    tol: float = 1e-3
    min_points: int = 10  # voxel validity threshold (voxel.py:56)
    huber_delta: float | None = None
    # data-independent query tiers: set for vmapped/batched execution, where
    # lax.switch would execute every branch per element anyway
    fixed_tiers: bool = False


@dataclasses.dataclass(frozen=True)
class NDTConfig:
    """NDT (ndt.py:12-16 defaults)."""

    voxel_size: float = 1.0
    max_iter: int = 30
    max_dist: float = 2.0
    tol: float = 1e-3
    min_points: int = 10
    huber_delta: float | None = None
    fixed_tiers: bool = False
