"""Drop-in object wrappers matching the reference's non-solver classes.

The functional core (ops/) is the real API; these shims reproduce the
reference's stateful surfaces — ``VoxelGrid`` (voxel.py:52-179) and the
``KDTree`` ``query(points, k) -> (dist, idx)`` contract (kdtree.py:18-68) —
so reference scripts and tests port with an import change. The kd-tree
*capability* is served by the voxel-grid engine (SURVEY §2.4: kd-trees are
pointer-chasing and do not vectorize); exactness caveats are on the class
docstrings.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from point_cloud_registration_tpu.ops import knn as knn_ops
from point_cloud_registration_tpu.ops.eigh3 import unpack_sym3
from point_cloud_registration_tpu.ops.hashgrid import build_grid, search_offsets
from point_cloud_registration_tpu.ops.normals import sample_knn_radius
from point_cloud_registration_tpu.ops.voxelize import (
    VoxelMap,
    build_voxel_map,
    invert_cov_packed,
)


class NeighborIndex:
    """Grid-backed neighbor index with the reference ``KDTree`` contract.

    ``query(points, k=1) -> (dist, idx)`` like pykdtree/scipy
    (kdtree.py:18-68). Candidates come from a 3^3 cell window sized to the
    sampled k-NN radius (``radius_k``); the window pass is exact whenever the
    true neighbor lies within one cell and the per-cell cap is not exceeded.
    Queries the window cannot prove exact escape to the tiled brute-force
    oracle, so the returned result matches an exact kd-tree:

    * ``k = 1``: unresolved queries (best candidate farther than one cell, or
      none found) are re-searched exhaustively;
    * ``k > radius_k`` (beyond the sampled radius's provable coverage) or
      small targets (< ``exact_threshold`` points): brute force outright.
    """

    def __init__(self, points, cell_size: float | None = None, cell_cap: int = 32,
                 radius_k: int = 8, exact_threshold: int = 20_000):
        self.points = jnp.asarray(points, dtype=jnp.float32)
        if cell_size is None:
            cell_size = max(sample_knn_radius(self.points, radius_k), 1e-3)
        self.cell_size = float(cell_size)
        self.cell_cap = cell_cap
        self.radius_k = radius_k
        self.exact_threshold = exact_threshold
        self.grid, _, self.buckets = build_grid(
            self.points, self.cell_size, with_buckets=True
        )
        self._offsets = search_offsets(self.cell_size, self.cell_size)

    def query(self, points, k: int = 1):
        q = jnp.asarray(points, dtype=jnp.float32)
        small = self.points.shape[0] <= self.exact_threshold
        if k == 1:
            if small:
                res = knn_ops.brute_force_nn(q, self.points)
                return np.asarray(jax.device_get(res.dist)), np.asarray(jax.device_get(res.idx))
            res, over = knn_ops.nearest_point(
                self.grid, self.buckets, self.points, q, self._offsets,
                cap=self.cell_cap, with_overflow=True,
            )
            dist = np.array(jax.device_get(res.dist))
            idx = np.array(jax.device_get(res.idx))
            # Exactness escape hatch: a best match farther than one cell is
            # not provably the true nearest (the window covers radius
            # cell_size) — and neither is a sub-cell match whose window
            # touched a cell holding more than cell_cap points (the true
            # nearest may sit past the cap).
            unres = ~(dist < self.cell_size) | np.asarray(jax.device_get(over))
            if unres.any():
                sub = knn_ops.brute_force_nn(q[np.where(unres)[0]], self.points)
                dist[unres] = np.asarray(jax.device_get(sub.dist))
                idx[unres] = np.asarray(jax.device_get(sub.idx))
            return dist, idx
        if small or k > self.radius_k:
            d, i = knn_ops.brute_force_knn(q, self.points, k=k)
            return np.asarray(jax.device_get(d)), np.asarray(jax.device_get(i))
        d, i, over = knn_ops.knn_points(
            self.grid, self.buckets, self.points, q, self._offsets,
            cap=self.cell_cap, k=k, with_overflow=True,
        )
        d = np.array(jax.device_get(d))
        i = np.array(jax.device_get(i))
        # k-th neighbor beyond one cell -> window coverage unproven; a
        # cap-overflowing window cell likewise hides candidates: re-search.
        unres = ~(d[:, k - 1] < self.cell_size) | np.asarray(jax.device_get(over))
        if unres.any():
            rows = np.where(unres)[0]
            sd, si = knn_ops.brute_force_knn(q[rows], self.points, k=k)
            d[rows] = np.asarray(jax.device_get(sd))
            i[rows] = np.asarray(jax.device_get(si))
        return d, i


# Name parity with the reference export (kdtree.py / __init__.py:7).
KDTree = NeighborIndex


class VoxelGrid:
    """Stateful wrapper over :class:`~...ops.voxelize.VoxelMap`
    (reference voxel.py:52-179 surface).

    ``mean`` / ``cov`` / ``norm`` / ``icov`` are exposed compacted (valid
    voxels only) as NumPy for drop-in use; ``query`` serves the nearest
    *valid* voxel per point with requested fields plus ``dist``.
    """

    def __init__(self, voxel_size: float, min_points: int = 10,
                 query_max_dist: float | None = None):
        self.voxel_size = voxel_size
        self.min_points = min_points
        # Default windowed-search radius for query(); beyond it the exact
        # brute-force fallback takes over, so results match the reference's
        # unbounded kd-tree at any distance.
        self.query_max_dist = (
            query_max_dist if query_max_dist is not None else max(2.0, voxel_size)
        )
        self._map: VoxelMap | None = None
        self._compact: dict[str, np.ndarray] = {}

    @property
    def voxel_map(self) -> VoxelMap:
        if self._map is None:
            raise ValueError("set_points has not been called")
        return self._map

    def set_points(self, points) -> None:
        """Build per-voxel Gaussian stats (voxel.py:104-169)."""
        self._map = build_voxel_map(
            points, self.voxel_size, min_points=self.min_points, with_icov=False
        )
        self._compact = {}

    def update_points(self, points) -> None:
        """Incrementally merge points into the voxel statistics
        (update_voxel_map; reference's unimplemented update intent)."""
        from point_cloud_registration_tpu.ops.voxelize import update_voxel_map

        self._map = update_voxel_map(self.voxel_map, points, min_points=self.min_points)
        self._compact = {}

    def calc_icov(self) -> None:
        """Attach analytic inverse covariances (voxel.py:69-102)."""
        m = self.voxel_map
        self._map = m._replace(icovs=invert_cov_packed(m.covs))
        self._compact.pop("icov", None)

    def calc_sqrt_icov(self) -> None:
        """Attach upper-triangular icov square roots (voxel.py:61-67)."""
        from point_cloud_registration_tpu.ops.voxelize import sqrt_icov_packed

        m = self.voxel_map
        if m.icovs is None:
            self.calc_icov()
            m = self.voxel_map
        self.sqrt_icov = np.asarray(
            jax.device_get(sqrt_icov_packed(m.icovs))
        )[self._valid_order()]

    def _valid_order(self) -> np.ndarray:
        valid = np.asarray(jax.device_get(self.voxel_map.valid))
        return np.where(valid)[0]

    def _compacted(self, name: str) -> np.ndarray:
        if name not in self._compact:
            m = self.voxel_map
            sel = self._valid_order()
            if name == "mean":
                arr = np.asarray(jax.device_get(m.means))[sel]
            elif name == "norm":
                arr = np.asarray(jax.device_get(m.normals))[sel]
            elif name == "cov":
                arr = np.asarray(jax.device_get(unpack_sym3(m.covs)))[sel]
            elif name == "icov":
                if m.icovs is None:
                    raise ValueError("call calc_icov() first")
                arr = np.asarray(jax.device_get(unpack_sym3(m.icovs)))[sel]
            elif name == "count":
                arr = np.asarray(jax.device_get(m.counts))[sel]
            else:
                raise KeyError(name)
            self._compact[name] = arr
        return self._compact[name]

    mean = property(lambda self: self._compacted("mean"))
    norm = property(lambda self: self._compacted("norm"))
    cov = property(lambda self: self._compacted("cov"))
    icov = property(lambda self: self._compacted("icov"))

    def query(self, points, names, max_dist: float | None = None):
        """Nearest-valid-voxel fields for each query point (voxel.py:171-179).

        Returns ``{name: (N, ...) field, 'dist': (N,)}``. The fast path is a
        neighbor-cell window of radius ``max_dist`` (defaults to the ctor's
        ``query_max_dist``); queries with no valid voxel inside the window
        fall back to an exact tiled brute-force search over all valid voxel
        centroids, so — like the reference's kd-tree over means — every query
        gets its true nearest voxel at any distance.
        """
        from point_cloud_registration_tpu.ops.voxelize import query_nearest_voxel

        m = self.voxel_map
        q = jnp.asarray(points, dtype=jnp.float32)
        md = float(max_dist) if max_dist is not None else self.query_max_dist
        md_eff = max(md, self.voxel_size)
        res = query_nearest_voxel(
            m, q, voxel_size=self.voxel_size, max_dist=md_eff
        )
        dist = np.array(jax.device_get(res.dist))
        idx = np.array(jax.device_get(res.idx))
        # The window provably covers the true nearest only within md_eff; a
        # finite find beyond it can be a window-corner artifact while a
        # closer voxel sits just outside the probed cells — re-search those
        # exactly too, not only the inf misses.
        unres = ~(dist < md_eff)
        if unres.any():
            rows = np.where(unres)[0]
            sub = knn_ops.brute_force_nn(q[rows], m.means, ref_valid=m.valid)
            dist[rows] = np.asarray(jax.device_get(sub.dist))
            idx[rows] = np.asarray(jax.device_get(sub.idx))
        res = type(res)(dist=jnp.asarray(dist), idx=jnp.asarray(idx))
        slot = jnp.clip(res.idx, 0, m.means.shape[0] - 1)
        out = {"dist": np.asarray(jax.device_get(res.dist))}
        for name in names:
            if name == "mean":
                field = m.means[slot]
            elif name == "norm":
                field = m.normals[slot]
            elif name == "cov":
                field = unpack_sym3(m.covs)[slot]
            elif name == "icov":
                if m.icovs is None:
                    raise ValueError("call calc_icov() first")
                field = unpack_sym3(m.icovs)[slot]
            else:
                raise KeyError(name)
            out[name] = np.asarray(jax.device_get(field))
        return out
