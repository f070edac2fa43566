"""Shared raw-point correspondence engine for ICP / PlaneICP.

Wraps the two interchangeable backends behind one target representation:

* ``packed`` — blocked packed-candidate tables (ops/pointgrid.py), provably
  exact within ``cell_fine``; unresolved queries (match farther than
  ``cell_fine`` or none in-window) fall back to the nearest *voxel Gaussian*
  of a coarse proxy map — centroid as match point, voxel normal as plane
  normal — computed on a compacted subset so the fallback costs nothing once
  the solver has pulled correspondences sub-``cell_fine``. Far matches only
  steer early iterations; the converged fixed point equals the exact-NN
  solver's (asserted against the float64 kd-tree oracle in tests).
* ``grid`` — the CSR bucket scan (ops/knn.nearest_point), exact within the
  covering window up to the per-cell cap; right for small clouds and used by
  the parity test-suite.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import numpy as np
import jax.numpy as jnp

from point_cloud_registration_tpu.core.config import CorrespondenceConfig
from point_cloud_registration_tpu.ops.hashgrid import Buckets, Grid, build_grid, search_offsets
from point_cloud_registration_tpu.ops.knn import nearest_point
from point_cloud_registration_tpu.ops.pointgrid import (
    PackedPointGrid,
    nearest_point_packed,
    proxy_stats_from_packed,
)

_proxy_stats_jit = partial(
    jax.jit,
    static_argnames=("min_points", "with_normals", "nb_dims_static", "nb2_static"),
)(proxy_stats_from_packed)
from point_cloud_registration_tpu.ops.voxelize import (
    VoxelMap,
    build_voxel_map,
    query_nearest_voxel,
)

_BIG = np.float32(np.inf)  # numpy scalar: no backend init at import


class PointCorrTarget(NamedTuple):
    """Indexed target cloud; exactly one backend's fields are populated."""

    points: jax.Array  # (N, 3) f32
    packed: PackedPointGrid | None
    proxy: VoxelMap | None  # coarse Gaussian map for unresolved fallback
    grid: Grid | None
    buckets: Buckets | None


def build_point_corr(points, corr: CorrespondenceConfig, max_dist: float,
                     *, proxy_min_points: int = 1,
                     proxy_normals: bool = False) -> PointCorrTarget:
    raw = points  # keep the NumPy input for the host-side bounding box
    points = jnp.asarray(points, jnp.float32)
    method = corr.resolved_method(points.shape[0])
    if method == "packed":
        from point_cloud_registration_tpu.ops.pointgrid import (
            build_packed_grid_and_proxy,
        )

        cell_fine = corr.cell_fine if corr.cell_fine is not None else max_dist / 4
        pg, proxy = build_packed_grid_and_proxy(
            raw, cell_fine, cap=corr.packed_cap,
            min_points=proxy_min_points, with_normals=proxy_normals,
        )
        return PointCorrTarget(points=points, packed=pg, proxy=proxy, grid=None, buckets=None)
    cell = corr.cell_size if corr.cell_size is not None else max_dist / 2
    grid, _, buckets = build_grid(points, cell, with_buckets=True)
    return PointCorrTarget(points=points, packed=None, proxy=None, grid=grid, buckets=buckets)


def proxy_from_packed(pg, *, min_points: int, with_normals: bool) -> VoxelMap:
    """Derive the coarse proxy voxel map from the packed tables — no second
    pass over the raw points.

    A packed block IS an absolute voxel of size ``2 * cell_fine``
    (``origin_fine`` is even-aligned), so per-block count/mean/covariance are
    reductions over the packed rows: 131k-row elementwise work instead of a
    second 1.2M-point scatter. Statistics see only the first ``cap`` points
    of overflowing blocks — irrelevant for a far-match proxy.

    Standalone entry point over :func:`ops.pointgrid.proxy_stats_from_packed`
    (the fused build in ``build_point_corr`` traces the same function inside
    the pack program instead).
    """
    from point_cloud_registration_tpu.ops.knn import DENSE_BLOCK

    nb_dims = tuple(int(x) for x in jax.device_get(pg.nb_dims))
    nb2 = tuple(-(-d // b) for d, b in zip(nb_dims, DENSE_BLOCK))
    vm = _proxy_stats_jit(
        pg, min_points=min_points, with_normals=with_normals,
        nb_dims_static=nb_dims, nb2_static=nb2,
    )
    return vm._replace(nb_dims=np.asarray(nb2, np.int32))


class PointMatch(NamedTuple):
    """Per-query correspondence: target position (+ index when a raw point).

    ``weight`` already folds the ``dist < max_dist`` gate. ``target`` is the
    matched raw point or, for proxy-resolved queries, the voxel centroid.
    ``proxy_slot`` is the voxel slot (-1 for raw matches) so PlaneICP can
    fetch the proxy normal.
    """

    target: jax.Array  # (N, 3)
    weight: jax.Array  # (N,) f32 in {0, 1} before source weighting
    point_idx: jax.Array  # (N,) i32 — raw target index or -1
    proxy_slot: jax.Array  # (N,) i32 — proxy voxel slot or -1


def match_points(target: PointCorrTarget, query: jax.Array, corr: CorrespondenceConfig,
                 max_dist: float, fixed_tiers: bool = False) -> PointMatch:
    """Gated nearest-target lookup for transformed source points.

    ``fixed_tiers`` replaces the data-dependent ``lax.switch`` proxy tiering
    with an unconditional compacted pass — for vmapped/batched execution,
    where ``switch`` under ``vmap`` executes every branch per element anyway
    (same rationale as ops/knn.nearest_voxel_blocks's flag).
    """
    n = query.shape[0]
    if target.packed is None:
        cell = corr.cell_size if corr.cell_size is not None else max_dist / 2
        offsets = search_offsets(max_dist, cell)
        nn = nearest_point(
            target.grid, target.buckets, target.points, query, offsets, cap=corr.cell_cap
        )
        w = ((nn.dist < max_dist) & (nn.idx >= 0)).astype(jnp.float32)
        safe = jnp.clip(nn.idx, 0, target.points.shape[0] - 1)
        return PointMatch(
            target=target.points[safe],
            weight=w,
            point_idx=nn.idx,
            proxy_slot=jnp.full_like(nn.idx, -1),
        )

    t1 = nearest_point_packed(target.packed, query)
    mask = jnp.logical_not(t1.resolved)
    n_unres = jnp.sum(mask)
    # Tier-2 cost scales with the compaction capacity whether or not slots
    # are used; past the first iteration unresolved counts are far below
    # n/16, and the rare >cap iteration falls through to tier 3 anyway.
    # fixed_tiers (vmapped/batched) has NO tier-3 escape, so it gets the
    # pre-trim capacity back: first iterations with large offsets routinely
    # exceed n/16 and would silently drop correspondences otherwise.
    cap = max(n // 4, 1024) if fixed_tiers else max(n // 16, 1024)
    # the proxy's voxels are the packed blocks: 2 * cell_fine (static)
    cell_fine = corr.cell_fine if corr.cell_fine is not None else max_dist / 4
    proxy_vs = float(2 * cell_fine)

    inf_d = query[:, 0] * 0 + _BIG
    neg1 = jnp.zeros_like(t1.idx) - 1

    def tier0(_):
        return inf_d, neg1

    def tier2(_):
        idxs = jnp.nonzero(mask, size=cap, fill_value=0)[0]
        live = jnp.arange(cap) < n_unres
        nn = query_nearest_voxel(
            target.proxy, query[idxs], voxel_size=proxy_vs, max_dist=max_dist
        )
        d = inf_d.at[idxs].set(jnp.where(live, nn.dist, _BIG))
        s = neg1.at[idxs].set(jnp.where(live, nn.idx, -1))
        return d, s

    def tier3(_):
        nn = query_nearest_voxel(
            target.proxy, query, voxel_size=proxy_vs, max_dist=max_dist
        )
        return jnp.where(mask, nn.dist, _BIG), jnp.where(mask, nn.idx, -1)

    if fixed_tiers:
        # vmapped contexts pay every switch branch anyway; run the compacted
        # pass unconditionally (>cap overflow leaves the stragglers on the
        # tier-1 result, which only affects pathological first iterations)
        proxy_d, proxy_slot = tier2(0)
    else:
        tier = (n_unres > 0).astype(jnp.int32) + (n_unres > cap).astype(jnp.int32)
        proxy_d, proxy_slot = jax.lax.switch(tier, [tier0, tier2, tier3], 0)

    use_raw = t1.resolved
    dist = jnp.where(use_raw, t1.dist, proxy_d)
    safe_raw = jnp.clip(t1.idx, 0, target.points.shape[0] - 1)
    safe_proxy = jnp.clip(proxy_slot, 0, target.proxy.means.shape[0] - 1)
    tgt = jnp.where(
        use_raw[:, None], target.points[safe_raw], target.proxy.means[safe_proxy]
    )
    found = jnp.where(use_raw, t1.idx >= 0, proxy_slot >= 0)
    w = ((dist < max_dist) & found).astype(jnp.float32)
    return PointMatch(
        target=tgt,
        weight=w,
        point_idx=jnp.where(use_raw, t1.idx, -1),
        proxy_slot=jnp.where(use_raw, -1, proxy_slot),
    )
