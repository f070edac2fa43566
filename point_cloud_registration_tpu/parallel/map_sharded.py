"""Map-sharded alignment: voxel maps larger than one device's memory.

SURVEY §2.3's tensor-parallel row and the BASELINE north star mandate
sharding "map voxel blocks" across chips. The reference has no distribution
layer at all (its map is a kd-tree over voxel centroids, the reference's
point_cloud_registration/voxel.py:165); this design
shards the *dense-direct cell table* itself:

* the global cell grid is split into ``n_shards`` equal z-slabs (z is the
  slowest axis of the linear cell key, so a slab is a contiguous row range
  of every per-cell array); each device holds one slab plus its own blocked
  query table — per-device memory is ``1/S`` of the map, so capacity scales
  linearly with devices;
* per GN iteration every device queries the (small, replicated or
  data-sharded) scan against its local slab, a ``pmin`` over the ``model``
  axis elects the globally nearest voxel (lowest-rank tie-break), and the
  winner-masked partial H/g/e² ``psum`` into the global normal equations —
  two N-float collectives plus the ~40-float stats reduction per iteration;
* correctness contract: identical (to f32) results to the replicated-map
  ``align_sharded`` path, asserted in tests/test_map_sharded.py. One
  degenerate exception: two voxels on *different* slabs at exactly equal
  f32 distance tie-break by lowest shard rank here, while the replicated
  table breaks ties by block/probe scan order — symmetric, exactly gridded
  point clouds can therefore elect a different (equally near) voxel than
  the replicated path. Real scans never produce exact f32 ties.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from point_cloud_registration_tpu.core.gn import GNStats, gauss_newton
from point_cloud_registration_tpu.core.se3 import makeRt, transform_points
from point_cloud_registration_tpu.models.base import AlignResult
from point_cloud_registration_tpu.ops.hashgrid import Grid, _bbox_cells
from point_cloud_registration_tpu.ops.knn import DENSE_BLOCK
from point_cloud_registration_tpu.ops.reduce import ndt_stats, plane_stats
from point_cloud_registration_tpu.ops.voxelize import (
    VoxelMap,
    _build_voxel_map_dense,
    dense_blocks_from_dense,
    query_nearest_voxel,
)

# numpy (not jnp): a module-level jnp constant would initialize the XLA
# backend at import time, which breaks jax.distributed.initialize in
# multi-host programs that import this package before calling it.
_BIG_RANK = np.int32(1 << 30)


@dataclasses.dataclass(frozen=True)
class ShardedMapMeta:
    """Static geometry of a sharded map (host ints -> jit-static)."""

    n_shards: int
    dims_slab: tuple[int, int, int]  # cells per slab
    origin_cell: tuple[int, int, int]  # global min cell coordinate
    cell_size: float
    # shard axis: 2 (z) for the local reshape builder; the distributed
    # builder picks the widest bbox axis so slabs are thick relative to
    # max_dist (a query window then overlaps <= 2 slabs) and LiDAR-flat
    # scenes still balance
    axis: int = 2

    @property
    def slab_cells(self) -> int:
        nx, ny, nz = self.dims_slab
        return nx * ny * nz


class ShardedVoxelMap(NamedTuple):
    """Per-slab map arrays; leading axis = shard (sharded over ``model``)."""

    means: jax.Array  # (S, C_slab, 3)
    normals: jax.Array  # (S, C_slab, 3)
    counts: jax.Array  # (S, C_slab)
    valid: jax.Array  # (S, C_slab)
    icovs: jax.Array | None  # (S, C_slab, 6) for NDT
    dense_blocks: jax.Array  # (S, nby, nbz8_s, nbx, row_w)


def shard_voxel_map(
    points,
    voxel_size: float,
    n_shards: int,
    *,
    min_points: int = 10,
    with_icov: bool = False,
) -> tuple[ShardedVoxelMap, ShardedMapMeta]:
    """Build a z-slab-sharded dense voxel map.

    This builder materializes the global map on one device first (fine for
    maps that fit — it is the cheapest path and keeps z-slab semantics for
    the parity tests). For beyond-HBM maps use
    :func:`shard_voxel_map_on_mesh`, which builds each slab directly on its
    owning devices — the global dense array never exists anywhere.
    """
    points = jnp.asarray(points, jnp.float32)
    lo_cell, hi_cell = _bbox_cells(points, voxel_size)
    dims = [int(x) for x in (hi_cell - lo_cell + 1)]
    nz_slab = -(-dims[2] // n_shards)
    dims[2] = nz_slab * n_shards  # pad z so slabs are uniform
    vm = _build_voxel_map_dense(
        points,
        jnp.asarray(lo_cell, jnp.int32),
        jnp.float32(voxel_size),
        dims_static=tuple(dims),
        min_points=min_points,
        with_icov=with_icov,
        with_normals=True,
    )
    meta = ShardedMapMeta(
        n_shards=n_shards,
        dims_slab=(dims[0], dims[1], nz_slab),
        origin_cell=tuple(int(x) for x in lo_cell),
        cell_size=float(voxel_size),
    )
    c_slab = meta.slab_cells

    def split(a):
        return None if a is None else a.reshape((n_shards, c_slab) + a.shape[1:])

    means_s = split(vm.means)
    valid_s = split(vm.valid)
    nb_slab = tuple(-(-d // b) for d, b in zip(meta.dims_slab, DENSE_BLOCK))
    blocks = jax.vmap(
        lambda m, v: dense_blocks_from_dense(m, v, meta.dims_slab, nb_slab)
    )(means_s, valid_s)
    return (
        ShardedVoxelMap(
            means=means_s,
            normals=split(vm.normals),
            counts=split(vm.counts),
            valid=valid_s,
            icovs=split(vm.icovs),
            dense_blocks=blocks,
        ),
        meta,
    )


def _slab_origin(meta: ShardedMapMeta, rank):
    """Global origin cell of shard ``rank``'s slab (shifted along meta.axis)."""
    step = [jnp.int32(0)] * 3
    step[meta.axis] = rank * jnp.int32(meta.dims_slab[meta.axis])
    return jnp.asarray(meta.origin_cell, jnp.int32) + jnp.stack(step)


def shard_voxel_map_on_mesh(
    points,
    voxel_size: float,
    mesh: Mesh,
    *,
    min_points: int = 10,
    with_icov: bool = False,
    axis: str | int = "auto",
) -> tuple[ShardedVoxelMap, ShardedMapMeta]:
    """Build a slab-sharded voxel map DIRECTLY on the mesh: each device
    scatters the (replicated) points into its own slab's arrays, so no
    global dense array ever exists on any device — per-device memory is the
    slab plus the raw points, and map capacity scales linearly with the
    ``model`` axis. (Raw points are small next to a dense grid: 1.2M points
    are 14 MB while their 1 m dense map holds every cell of the bounding
    box.)

    ``axis="auto"`` shards along the widest bbox axis, so slabs stay thick
    relative to ``max_dist`` (a query's window then overlaps at most two
    slabs — what lets :func:`align_map_sharded` compact its per-slab query
    set) and flat LiDAR scenes still balance across shards.
    """
    n_shards = mesh.shape["model"]
    pts_np = np.asarray(points, np.float32)
    points = jnp.asarray(pts_np)
    lo_cell, hi_cell = _bbox_cells(pts_np, voxel_size)  # NumPy in: no sync
    dims = [int(x) for x in (hi_cell - lo_cell + 1)]
    ax = int(np.argmax(dims)) if axis == "auto" else int(axis)
    ns = -(-dims[ax] // n_shards)
    dims[ax] = ns * n_shards
    dims_slab = tuple(ns if i == ax else d for i, d in enumerate(dims))
    meta = ShardedMapMeta(
        n_shards=n_shards,
        dims_slab=dims_slab,
        origin_cell=tuple(int(x) for x in lo_cell),
        cell_size=float(voxel_size),
        axis=ax,
    )
    nb_slab = tuple(-(-d // b) for d, b in zip(dims_slab, DENSE_BLOCK))

    def build_slab(pts):
        rank = jax.lax.axis_index("model")
        origin = _slab_origin(meta, rank)
        vm = _build_voxel_map_dense(
            pts,
            origin,
            jnp.float32(voxel_size),
            dims_static=dims_slab,
            min_points=min_points,
            with_icov=with_icov,
            with_normals=True,
        )
        blocks = dense_blocks_from_dense(vm.means, vm.valid, dims_slab, nb_slab)
        add = lambda a: None if a is None else a[None]
        return ShardedVoxelMap(
            means=add(vm.means),
            normals=add(vm.normals),
            counts=add(vm.counts),
            valid=add(vm.valid),
            icovs=add(vm.icovs),
            dense_blocks=add(blocks),
        )

    svm = jax.jit(
        jax.shard_map(
            build_slab,
            mesh=mesh,
            in_specs=(P(),),
            out_specs=jax.tree.map(lambda _: P("model"), ShardedVoxelMap(
                means=0, normals=0, counts=0, valid=0,
                icovs=0 if with_icov else None, dense_blocks=0,
            )),
        )
    )(points)
    return svm, meta


def _local_voxel_map(svm_slab: ShardedVoxelMap, meta: ShardedMapMeta, rank) -> VoxelMap:
    """Reassemble one device's slab as a self-contained :class:`VoxelMap`
    whose grid origin is shifted to the slab's global offset."""
    c_slab = meta.slab_cells
    identity = jnp.arange(c_slab, dtype=jnp.int32)
    origin = _slab_origin(meta, rank)
    nb_slab = tuple(-(-d // b) for d, b in zip(meta.dims_slab, DENSE_BLOCK))
    grid = Grid(
        origin_cell=origin,
        cell_size=jnp.float32(meta.cell_size),
        dims=jnp.asarray(meta.dims_slab, jnp.int32),
        keys=identity,
        n_cells=jnp.sum(svm_slab.counts > 0).astype(jnp.int32),
        dense=identity,
    )
    return VoxelMap(
        grid=grid,
        means=svm_slab.means,
        covs=jnp.zeros((c_slab, 6), jnp.float32),
        normals=svm_slab.normals,
        counts=svm_slab.counts,
        valid=svm_slab.valid,
        icovs=svm_slab.icovs,
        dense_blocks=svm_slab.dense_blocks,
        nb_dims=jnp.asarray(nb_slab, jnp.int32),
    )


@partial(jax.jit, static_argnames=("kind", "meta", "cfg", "mesh"))
def align_map_sharded(
    kind: str,
    svm: ShardedVoxelMap,
    meta: ShardedMapMeta,
    source,
    src_weight,
    init_T,
    cfg,
    mesh: Mesh,
) -> AlignResult:
    """Align against a map sharded over the mesh's ``model`` axis.

    ``source``/``src_weight`` are sharded over ``data`` (pad so the length
    divides) and replicated over ``model``. Supported kinds: ``vplane_icp``
    (plane residual against voxel mean/normal) and ``ndt`` (Mahalanobis).
    """
    if kind not in ("vplane_icp", "ndt"):
        raise ValueError(f"map sharding supports voxel-map kinds, not {kind!r}")
    if kind == "ndt" and svm.icovs is None:
        raise ValueError(
            "align_map_sharded(kind='ndt') needs per-voxel icovs: build the "
            "map with shard_voxel_map(..., with_icov=True)"
        )

    def shard_fn(svm_slab, source_s, w_s, T0):
        svm_local = jax.tree.map(lambda a: a[0], svm_slab)  # drop shard axis
        rank = jax.lax.axis_index("model")
        vm = _local_voxel_map(svm_local, meta, rank)
        c_slab = meta.slab_cells

        n_s = source_s.shape[0]
        radius = int(np.ceil(cfg.max_dist / meta.cell_size - 1e-9))
        ns_ax = meta.dims_slab[meta.axis]
        # per-slab query compaction capacity: a query's window overlaps at
        # most ceil(2 * radius / slab_thickness) + 1 slabs, so the expected
        # overlap set is that fraction of the scan; pad 2x for density skew
        # along the shard axis, floor for tiny scans. A scalar lax.cond
        # falls back to querying everything when the set overflows anyway —
        # compaction is a throughput optimization, never a correctness one.
        slabs_per_window = 2 * radius // max(ns_ax, 1) + 2
        qcap = int(
            min(n_s, max(512, -(-2 * slabs_per_window * n_s) // max(meta.n_shards, 1)))
        )

        def stats_fn(T):
            R, _ = makeRt(T)
            q = transform_points(T, source_s)
            # full_window, not tiers: most queries' true voxels live on
            # OTHER shards, so the compacted unresolved tier would silently
            # overflow its capacity and leave stale near-pass results —
            # in-overlap queries probe the full max_dist window on the slab.
            c_ax = (
                jnp.floor(q[:, meta.axis] * np.float32(1.0 / meta.cell_size))
                .astype(jnp.int32)
                - meta.origin_cell[meta.axis]
            )
            lo = rank * ns_ax - radius
            hi = (rank + 1) * ns_ax + radius
            ov = (c_ax >= lo) & (c_ax < hi) & (w_s > 0)
            n_ov = jnp.sum(ov)

            def query_all(_):
                nn = query_nearest_voxel(
                    vm, q, voxel_size=meta.cell_size, max_dist=cfg.max_dist,
                    full_window=True,
                )
                return nn.dist, nn.idx

            def query_compact(_):
                # only the queries whose window can intersect this slab:
                # ~2/S of the scan for thick slabs — the map-sharded align's
                # per-iteration gather volume scales DOWN with shard count
                idxs = jnp.nonzero(ov, size=qcap, fill_value=0)[0]
                live = jnp.arange(qcap) < n_ov
                nn = query_nearest_voxel(
                    vm, q[idxs], voxel_size=meta.cell_size,
                    max_dist=cfg.max_dist, full_window=True,
                )
                # dead slots scatter OUT OF RANGE (mode=drop), never to a
                # fill index 0 — a duplicate-index scatter-set applies an
                # unspecified update and could clobber query 0's result
                scat = jnp.where(live, idxs, n_s)
                d0 = jnp.full((n_s,), jnp.inf, jnp.float32)
                i0 = jnp.full((n_s,), -1, jnp.int32)
                d = d0.at[scat].set(nn.dist, mode="drop")
                i = i0.at[scat].set(nn.idx, mode="drop")
                return d, i

            if qcap >= n_s:
                dist, idx = query_all(0)
            else:
                dist, idx = jax.lax.cond(n_ov > qcap, query_all, query_compact, 0)
            d = jnp.where(idx >= 0, dist, jnp.inf)
            d_best = jax.lax.pmin(d, "model")
            win = (d == d_best) & jnp.isfinite(d)
            first = jax.lax.pmin(jnp.where(win, rank, _BIG_RANK), "model")
            win = win & (rank == first)
            w_eff = w_s * win.astype(jnp.float32) * (d < cfg.max_dist)
            safe = jnp.clip(idx, 0, c_slab - 1)
            if kind == "vplane_icp":
                st = plane_stats(
                    source_s, q, vm.means[safe], vm.normals[safe], w_eff, R,
                    huber_delta=cfg.huber_delta,
                )
            else:
                st = ndt_stats(
                    source_s, q, vm.means[safe], vm.icovs[safe], w_eff, R,
                    huber_delta=cfg.huber_delta,
                )
            return GNStats(
                H=jax.lax.psum(st.H, ("model", "data")),
                g=jax.lax.psum(st.g, ("model", "data")),
                e2=jax.lax.psum(st.e2, ("model", "data")),
                n_inliers=jax.lax.psum(st.n_inliers, ("model", "data")),
            )

        T, diag = gauss_newton(stats_fn, T0, cfg.max_iter, cfg.tol)
        return AlignResult(T=T, diagnostics=diag)

    return jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P("model"), P("data"), P("data"), P()),
        out_specs=P(),
    )(svm, source, src_weight, init_T)


def make_map_mesh(model: int, data: int | None = None, *, devices=None) -> Mesh:
    """(model, data) mesh for map-sharded alignment."""
    if devices is None:
        devices = jax.devices()
    if data is None:
        data = len(devices) // model
    n = model * data
    if n > len(devices):
        raise ValueError(f"mesh {model}x{data} needs {n} devices, have {len(devices)}")
    return Mesh(np.asarray(devices[:n]).reshape(model, data), ("model", "data"))
