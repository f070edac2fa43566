"""point_cloud_registration_tpu — point-cloud registration on JAX/XLA.

A from-scratch JAX/XLA re-design of the capabilities of
scomup/point-cloud-registration (reference mounted at /root/reference): four
rigid-registration solvers (point-to-point ICP, point-to-plane ICP,
voxelized point-to-plane ICP, NDT) sharing one on-device Gauss-Newton loop on
SE(3), plus the supporting geometry stack (voxel grids with per-voxel
Gaussian statistics, grid-based nearest-neighbor search, PCA normal
estimation, voxel downsampling, Caratheodory coresets) and data-parallel
multi-device execution via ``shard_map``.

The export list mirrors the reference public API
(/root/reference/point_cloud_registration/__init__.py:1-10) item for item so
reference code ports with an import change; everything is also available
through the functional modules (``core``, ``ops``, ``models``, ``parallel``).
"""

from point_cloud_registration_tpu.compat import KDTree, NeighborIndex, VoxelGrid
from point_cloud_registration_tpu.core.gn import GNDiagnostics, GNStats, gauss_newton
from point_cloud_registration_tpu.core.se3 import (
    expSO3,
    huber_weight,
    logSO3,
    makeRt,
    makeT,
    numerical_derivative,
    plus,
    skew,
    skew2,
    skew_time_vector,
    skews,
    transform_points,
)
from point_cloud_registration_tpu.models import (
    ICP,
    NDT,
    AlignResult,
    FastVPlaneICP,
    PlaneICP,
    Registration,
    VPlaneICP,
    caratheodory,
    create_gn_set,
    fast_caratheodory,
)
from point_cloud_registration_tpu.ops.normals import get_norm_lines
from point_cloud_registration_tpu.ops.voxelize import (
    VoxelMap,
    build_voxel_map,
    color_by_voxel,
    voxel_filter,
)


def estimate_normals(points, k: int = 15):
    """k-NN PCA normals, NumPy in/out (reference estimate_normals.py:11-24)."""
    import jax as _jax
    import numpy as _np

    from point_cloud_registration_tpu.ops.normals import estimate_normals as _fn

    return _np.asarray(_jax.device_get(_fn(points, k=k)))


def estimate_norm_with_tree(points, kdtree=None, k: int = 15):
    """k-NN PCA normals against a prebuilt neighbor index
    (reference estimate_normals.py:27-87).

    When ``kdtree`` is provided it is honored: neighbor indices come from
    ``kdtree.query(points, k)`` and — exactly like the reference — the
    PCA moments gather from ``points`` at those indices (so a tree built
    over a different cloud produces the reference's semantics, not a
    silent re-index). ``None`` re-derives the grid index from ``points``,
    which is cheap on device."""
    if kdtree is None:
        return estimate_normals(points, k=k)

    import jax as _jax
    import jax.numpy as _jnp
    import numpy as _np

    from point_cloud_registration_tpu.ops.normals import normals_from_neighbors

    _, idx = kdtree.query(points, k=k)
    pts = _jnp.asarray(points, _jnp.float32)
    nrm = normals_from_neighbors(pts, _jnp.asarray(idx, _jnp.int32), pts)
    return _np.asarray(_jax.device_get(nrm))


__all__ = [
    # solvers / base (reference __init__.py:1-6)
    "Registration",
    "ICP",
    "PlaneICP",
    "VPlaneICP",
    "NDT",
    "FastVPlaneICP",
    # indexing / maps (reference __init__.py:7-8)
    "KDTree",
    "NeighborIndex",
    "VoxelGrid",
    "VoxelMap",
    "build_voxel_map",
    "voxel_filter",
    "color_by_voxel",
    # normals (reference __init__.py:9)
    "estimate_normals",
    "estimate_norm_with_tree",
    "get_norm_lines",
    # coresets (reference __init__.py:10)
    "caratheodory",
    "fast_caratheodory",
    "create_gn_set",
    # math kernel (reference __init__.py:2)
    "makeRt",
    "expSO3",
    "logSO3",
    "makeT",
    "skew",
    "skews",
    "skew2",
    "skew_time_vector",
    "huber_weight",
    "plus",
    "transform_points",
    "numerical_derivative",
    # functional core
    "gauss_newton",
    "GNStats",
    "GNDiagnostics",
    "AlignResult",
]

__version__ = "0.1.0"
