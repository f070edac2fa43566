"""Packed-block point table: fast gated 1-NN / k-NN over raw points.

The device replacement for the reference's kd-tree over raw target points
(ICP correspondence icp.py:33, PlaneICP plane_icp.py:42, and the k-NN of
normal estimation estimate_normals.py:39). Candidates are packed so one
gather row serves a whole spatial block:

* target points are bucketed into *fine* cells (``cell_fine``), fine cells
  grouped 2x2x2 into blocks, and each occupied block's points packed into one
  fixed-width table row (coordinates) plus a parallel index row;
* a query probes the <= 2^3 blocks overlapping its radius-1 fine-cell window:
  8 fat gathers replace hundreds of per-candidate gathers;
* coverage guarantee: any point within ``cell_fine`` of the query lies in
  the window, so a best match closer than ``cell_fine`` is *provably exact*;
* queries whose best is farther (or absent) are reported unresolved; solvers
  resolve them against the voxel map as a proxy (centroid / voxel plane) —
  beyond-``cell_fine`` matches only steer early Gauss-Newton iterations, and
  the converged correspondences are all sub-``cell_fine``, so the fixed point
  matches the exact-NN solver (validated against the float64 kd-tree oracle
  in tests).

The per-block capacity ``cap`` is the one truncation knob: blocks holding
more points keep a uniform pseudo-random subsample of ``cap`` of them (see
the hashed secondary sort key in ``_keys_sort_count``).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from point_cloud_registration_tpu.ops.hashgrid import cell_coords

_BIG = np.float32(np.inf)  # numpy scalar: no backend init at import
_BLOCK = 2  # fine cells per block edge
# transient HBM allowance for the pack's phase-shifted source copies
# (N * 512 B); clouds beyond it take the row-scatter path
_PACK_GATHER_BUDGET = 2 << 30


class PackedPointGrid(NamedTuple):
    """Blocked packed candidate tables for one target cloud (a pytree).

    ``origin_fine`` is rounded down to an even multiple so blocks coincide
    with absolute cells of size ``2 * cell_fine`` (lets the proxy voxel map
    share this table — see models/_point_corr.proxy_from_packed).

    ``pts_packed`` rows hold ``cap`` slots of xyz.
    """

    origin_fine: jax.Array  # (3,) i32 — min fine-cell coordinate (even)
    cell_fine: jax.Array  # () f32
    nb_dims: jax.Array  # (3,) i32 — block-grid dims
    block_row: jax.Array  # (NB,) i32 — block key -> packed row (-1 empty)
    row_key: jax.Array  # (R+1,) i32 — packed row -> block key (-1 padding)
    pts_packed: jax.Array  # (R+1, cap*width) f32 — block points, +inf padded
    idx_packed: jax.Array  # (R+1, cap) i32 — original point indices, -1 padded

    @property
    def cap(self) -> int:
        return self.idx_packed.shape[1]


class PointNN(NamedTuple):
    dist: jax.Array  # (N,) f32 — inf when nothing found in the window
    idx: jax.Array  # (N,) i32 — original target-point index (-1 when none)
    resolved: jax.Array  # (N,) bool — dist < cell_fine: provably exact


def build_packed_grid(points, cell_fine: float, cap: int = 32) -> PackedPointGrid:
    """Build the packed tables. Host syncs: ONE tiny meta transfer (bbox +
    dims + occupied-block count ride one vector); the heavy sort/pack is one
    jitted program on each side of it."""
    if points.shape[0] == 0:
        raise ValueError("empty point cloud: at least one point is required")
    points = jnp.asarray(points, jnp.float32)
    skey, spts, sidx, meta_dev = _keys_sort_count(points, jnp.float32(cell_fine))
    meta = np.asarray(jax.device_get(meta_dev))
    lo_cell, nb_dims, n_occ = meta[:3], tuple(int(d) for d in meta[3:6]), int(meta[6])
    nb_total = nb_dims[0] * nb_dims[1] * nb_dims[2]  # Python ints: no wrap
    if nb_total >= np.iinfo(np.int32).max:
        # the traced keys already wrapped inside the sort program, so no
        # result derived from them may escape — raising here guarantees that
        raise ValueError("block grid exceeds int32 keyspace; increase cell_fine")
    r_cap = 1 << max(0, (n_occ - 1).bit_length())

    pg = _pack(skey, spts, sidx, jnp.asarray(lo_cell, jnp.int32), jnp.float32(cell_fine),
               nb_dims=nb_dims, r_cap=r_cap, cap=cap)
    # Geometry is host-known: store as NumPy so downstream reads need no
    # device sync.
    return pg._replace(
        origin_fine=np.asarray(lo_cell, np.int32),
        cell_fine=np.float32(cell_fine),
        nb_dims=np.asarray(nb_dims, np.int32),
    )


@jax.jit
def _keys_sort_count(points, cell_fine):
    """Bounding box + keys + sort + occupied count as ONE program, so the
    pre-sync half of the build is a single dispatch and everything the host
    needs (bbox cells, grid dims, counts) travels back in ONE tiny ``meta``
    vector -> one combined device_get instead of a bbox sync plus a count
    sync.

    The bbox is reduced in CELL space (min/max of the int32 fine-cell
    coordinates), so by construction every point's key is in range — no
    f32-vs-f64 one-past boundary case exists on this path (cf. the host
    ``_bbox_cells`` guard).

    Multi-operand ``lax.sort`` carries the coordinates (+ the original
    index) WITH the key instead of an argsort followed by ``points[order]``
    row gathers (same layout as the voxel-map build,
    ops/voxelize._build_voxel_map_dense).

    Returns ``(skey, spts (N, 3), sidx, meta)`` in key-sorted order, where
    ``meta`` (i32) = [lo_block*2 (3), n_blocks (3), n_occ] — ``lo`` is
    pre-aligned to the 2-cell block grid.
    """
    fine = cell_coords(points, cell_fine)  # (N, 3) i32
    lo_f = jnp.min(fine, axis=0)
    hi_f = jnp.max(fine, axis=0)
    lo_f = jnp.floor_divide(lo_f, _BLOCK) * _BLOCK  # block-align (even cells)
    nb = jnp.floor_divide(hi_f - lo_f, _BLOCK) + 1  # (3,) block-grid dims
    b = jnp.floor_divide(fine - lo_f, _BLOCK)
    bkeys = b[:, 0] + nb[0] * (b[:, 1] + nb[1] * b[:, 2])
    n = points.shape[0]
    w = points.shape[1]
    arange = jnp.arange(n, dtype=jnp.int32)
    # Secondary sort key = hashed index, so the within-block order is
    # deterministic pseudo-random. A stable key-only sort keeps INPUT order
    # inside each block, and input order is spatially correlated (scene
    # generators and real LiDAR logs emit points ring-by-ring), so the
    # packer's cap truncation kept a spatially-clustered CORNER subsample
    # of each over-full block. Measured on the ray-cast LiDAR family
    # (range-skewed density, 61% of the map over cap): +9.5 cm mean NN
    # excess with a nonzero mean residual that biased converged ICP 1.5 cm
    # off ground truth. Hashing makes the kept cap points a uniform
    # subsample of the block — the NN error becomes ~zero-mean noise that
    # the 100k-point GN reduction averages away.
    x = arange
    x = (x ^ (x >> 16)) * jnp.int32(0x45D9F3B)
    x = (x ^ (x >> 16)) * jnp.int32(0x45D9F3B)
    h = x ^ (x >> 16)
    ops = (
        (bkeys, h)
        + tuple(points[:, i] for i in range(w))
        + (arange,)
    )
    sorted_ops = jax.lax.sort(ops, dimension=0, num_keys=2, is_stable=True)
    skey = sorted_ops[0]
    spts = jnp.stack(sorted_ops[2 : 2 + w], axis=-1)
    sidx = sorted_ops[2 + w]
    n_occ = jnp.sum(skey[1:] != skey[:-1]) + 1
    return skey, spts, sidx, jnp.concatenate([lo_f, nb, n_occ[None]])


@partial(jax.jit, static_argnames=("nb_dims", "r_cap", "cap"))
def _pack(skeys, spts, sidx, origin_fine, cell_fine, *, nb_dims, r_cap, cap):
    """Pack KEY-SORTED points into the fixed-width block tables with ONE
    wide row gather (or, for very large clouds, ONE row scatter)."""
    n = spts.shape[0]
    w = spts.shape[1]
    new_block = jnp.concatenate([jnp.ones((1,), bool), skeys[1:] != skeys[:-1]])

    nb_total = int(np.prod(nb_dims))
    # Block<->row maps from the ~n_occ run starts only (compacted via
    # nonzero), not an N-row scatter: row r's start is the r-th new_block
    # position, so row_key needs NO scatter at all and block_row a small one.
    starts = jnp.nonzero(new_block, size=r_cap + 1, fill_value=n)[0]
    n_occ = jnp.sum(new_block).astype(jnp.int32)
    live_row = jnp.arange(r_cap + 1, dtype=jnp.int32) < n_occ
    # per-row point count (next start - start)
    sizes = jnp.concatenate([starts[1:], jnp.full((1,), n, starts.dtype)]) - starts
    key_at = skeys[jnp.clip(starts, 0, max(n - 1, 0))]
    row_key = jnp.where(live_row, key_at, jnp.int32(-1))
    block_row = jnp.full((nb_total,), -1, jnp.int32).at[
        jnp.where(live_row, key_at, jnp.int32(nb_total))
    ].set(jnp.arange(r_cap + 1, dtype=jnp.int32), mode="drop")

    # The rows carry coordinates AND the original index (bitcast to f32).
    # The index bits are biased by 0x40000000 (floats in [2, 4)) BEFORE the
    # bitcast: a raw small index bitcasts to a DENORMAL f32, which any
    # flush-to-zero stage on the data path would zero.
    idx_bits = jax.lax.bitcast_convert_type(
        sidx | jnp.int32(0x40000000), jnp.float32
    )
    src = jnp.concatenate([spts, idx_bits[:, None]], axis=1)
    w1 = w + 1
    # Placement: block b's points are CONTIGUOUS in the sorted array, so
    # packed row r is the (cap, w1) window of ``src`` at ``starts[r]``.
    # Instead of an N-row slot scatter we materialize every 128-float-aligned
    # phase shift of the flat source (PH copies of g floats per slot each —
    # N * 512 B total regardless of g) and fetch each packed row with ONE
    # wide row gather; the output is bit-identical to the scatter branch.
    g = 1 << max(0, (w1 - 1).bit_length())  # slot stride: pow2 -> divides 128
    if g <= 128 and n * 512 <= _PACK_GATHER_BUDGET:
        if g != w1:
            src = jnp.concatenate(
                [src, jnp.full((n, g - w1), jnp.inf, jnp.float32)], axis=1
            )
        PH = 128 // g
        H = -(-(cap * g) // 128)  # 128-lane chunks per packed row
        M = ((n + cap) * g) // 128 + H + 1
        flat = jnp.concatenate(
            [src.reshape(-1),
             jnp.full(((M + 1) * 128 - n * g,), jnp.inf, jnp.float32)]
        )
        stack = jnp.stack(
            [jax.lax.dynamic_slice(flat, (p * g,), (M * 128,)).reshape(M, 128)
             for p in range(PH)]
        ).reshape(PH * M, 128)
        off = starts * g
        rowi = off // 128
        phase = (off % 128) // g
        chunks = [stack[phase * M + rowi + h] for h in range(H)]
        rows = chunks[0] if H == 1 else jnp.concatenate(chunks, axis=1)
        packed = rows[:, : cap * g].reshape(r_cap + 1, cap, g)[..., :w1]
        ok = (
            jnp.arange(cap, dtype=jnp.int32)[None, :]
            < jnp.minimum(sizes, cap)[:, None]
        )
        packed = jnp.where(ok[..., None], packed, jnp.inf)
    else:
        # row-scatter fallback for very large clouds (the phase copies cost
        # N * 512 B of transient device memory)
        arange = jnp.arange(n, dtype=jnp.int32)
        row = jnp.cumsum(new_block).astype(jnp.int32) - 1
        seg_start = jax.lax.associative_scan(
            jnp.maximum, jnp.where(new_block, arange, 0)
        )
        rank = arange - seg_start
        keep = rank < cap
        slot = jnp.where(keep, row * cap + rank, jnp.int32((r_cap + 1) * cap))
        packed = jnp.full(((r_cap + 1) * cap, w1), jnp.inf, jnp.float32)
        packed = packed.at[slot].set(src, mode="drop").reshape(
            r_cap + 1, cap, w1
        )
    pts_rows = packed[..., :w]
    idx_f = packed[..., w]
    idx_rows = jnp.where(
        jnp.isfinite(idx_f),
        jax.lax.bitcast_convert_type(idx_f, jnp.int32) & jnp.int32(0x3FFFFFFF),
        jnp.int32(-1),
    )

    return PackedPointGrid(
        origin_fine=origin_fine,
        cell_fine=cell_fine,
        nb_dims=jnp.asarray(nb_dims, jnp.int32),
        block_row=block_row,
        row_key=row_key,
        pts_packed=pts_rows.reshape(r_cap + 1, cap * w),
        idx_packed=idx_rows,
    )


def proxy_stats_from_packed(pg: PackedPointGrid, *, min_points: int,
                            with_normals: bool, nb_dims_static, nb2_static):
    """Coarse proxy voxel map derived from the packed tables (a packed block
    IS an absolute voxel of size ``2 * cell_fine``; see
    models/_point_corr.proxy_from_packed for the original derivation) —
    per-block count/mean/cov reductions over the packed rows plus the
    blocked query table, traceable inside one program.
    """
    from point_cloud_registration_tpu.ops.eigh3 import smallest_eigvec_sym3
    from point_cloud_registration_tpu.ops.hashgrid import Grid
    from point_cloud_registration_tpu.ops.knn import build_dense_blocks
    from point_cloud_registration_tpu.ops.voxelize import VoxelMap

    r1 = pg.pts_packed.shape[0]
    cap = pg.idx_packed.shape[1]
    pts = pg.pts_packed.reshape(r1, cap, -1)[..., :3]
    mask = jnp.isfinite(pts[..., 0])
    cnt = jnp.sum(mask, axis=1).astype(jnp.int32)  # (R+1,)
    safe = jnp.where(mask[..., None], pts, 0.0)
    denom = jnp.maximum(cnt, 1).astype(jnp.float32)[:, None]
    means = jnp.sum(safe, axis=1) / denom
    if with_normals:
        centered = jnp.where(mask[..., None], pts - means[:, None, :], 0.0)
        cov6 = jnp.stack(
            [
                jnp.sum(centered[..., 0] * centered[..., 0], axis=1),
                jnp.sum(centered[..., 1] * centered[..., 1], axis=1),
                jnp.sum(centered[..., 2] * centered[..., 2], axis=1),
                jnp.sum(centered[..., 0] * centered[..., 1], axis=1),
                jnp.sum(centered[..., 0] * centered[..., 2], axis=1),
                jnp.sum(centered[..., 1] * centered[..., 2], axis=1),
            ],
            axis=-1,
        ) / jnp.maximum(cnt - 1, 1).astype(jnp.float32)[:, None]
        normals = smallest_eigvec_sym3(cov6)
    else:
        cov6 = jnp.zeros((r1, 6), jnp.float32)
        normals = jnp.zeros((r1, 3), jnp.float32)
    valid = cnt >= min_points
    grid = Grid(
        origin_cell=pg.origin_fine // 2,
        cell_size=pg.cell_fine * 2.0,
        dims=jnp.asarray(nb_dims_static, jnp.int32),
        keys=pg.row_key,
        n_cells=jnp.sum(cnt > 0).astype(jnp.int32),
        dense=pg.block_row,
    )
    vm = VoxelMap(
        grid=grid,
        means=means,
        covs=cov6,
        normals=normals,
        counts=cnt,
        valid=valid,
        icovs=None,
        dense_blocks=None,
        nb_dims=None,
    )
    blocks = build_dense_blocks(vm.grid, vm.means, vm.valid, nb2_static)
    return vm._replace(dense_blocks=blocks)


@partial(jax.jit, static_argnames=(
    "nb_dims", "r_cap", "cap", "min_points", "with_normals", "nb2_static"))
def _pack_with_proxy(skey, spts, sidx, origin_fine, cell_fine, *,
                     nb_dims, r_cap, cap, min_points, with_normals, nb2_static):
    pg = _pack(skey, spts, sidx, origin_fine, cell_fine,
               nb_dims=nb_dims, r_cap=r_cap, cap=cap)
    proxy = proxy_stats_from_packed(
        pg, min_points=min_points, with_normals=with_normals,
        nb_dims_static=nb_dims, nb2_static=nb2_static,
    )
    return pg, proxy


def build_packed_grid_and_proxy(points, cell_fine: float, cap: int,
                                *, min_points: int, with_normals: bool):
    """Packed tables + coarse proxy voxel map in TWO programs + ONE sync
    (bbox/keys/sort/count with a single meta transfer, then pack+proxy
    fused).
    """
    from point_cloud_registration_tpu.ops.knn import DENSE_BLOCK

    if points.shape[0] == 0:
        raise ValueError("empty point cloud: at least one point is required")
    points = jnp.asarray(points, jnp.float32)
    skey, spts, sidx, meta_dev = _keys_sort_count(points, jnp.float32(cell_fine))
    meta = np.asarray(jax.device_get(meta_dev))
    lo_cell, nb_dims, n_occ = meta[:3], tuple(int(d) for d in meta[3:6]), int(meta[6])
    nb_total = nb_dims[0] * nb_dims[1] * nb_dims[2]  # Python ints: no wrap
    if nb_total >= np.iinfo(np.int32).max:
        raise ValueError("block grid exceeds int32 keyspace; increase cell_fine")
    r_cap = 1 << max(0, (n_occ - 1).bit_length())
    nb2 = tuple(-(-d // b) for d, b in zip(nb_dims, DENSE_BLOCK))
    pg, proxy = _pack_with_proxy(
        skey, spts, sidx, jnp.asarray(lo_cell, jnp.int32),
        jnp.float32(cell_fine), nb_dims=nb_dims, r_cap=r_cap, cap=cap,
        min_points=min_points, with_normals=with_normals, nb2_static=nb2,
    )
    pg = pg._replace(
        origin_fine=np.asarray(lo_cell, np.int32),
        cell_fine=np.float32(cell_fine),
        nb_dims=np.asarray(nb_dims, np.int32),
    )
    proxy = proxy._replace(nb_dims=np.asarray(nb2, np.int32))
    return pg, proxy


def nearest_point_packed(pg: PackedPointGrid, query: jax.Array) -> PointNN:
    """Tier-1 nearest raw point via 8 fat block gathers (see module doc)."""
    cap = pg.cap
    n = query.shape[0]
    nbx, nby, nbz = pg.nb_dims[0], pg.nb_dims[1], pg.nb_dims[2]
    r_sentinel = jnp.int32(pg.pts_packed.shape[0] - 1)

    fine = cell_coords(query, pg.cell_fine) - pg.origin_fine
    lo_b = jnp.floor_divide(fine - 1, _BLOCK)  # (N, 3)

    best_d2 = query[:, 0] * 0 + _BIG
    best_row = jnp.zeros_like(fine[:, 0]) + r_sentinel
    best_slot = jnp.zeros_like(fine[:, 0])
    for dbx in range(2):
        for dby in range(2):
            for dbz in range(2):
                b3 = lo_b + jnp.asarray([dbx, dby, dbz], jnp.int32)
                ok = jnp.all((b3 >= 0) & (b3 < pg.nb_dims), axis=-1)
                bkey = b3[:, 0] + nbx * (b3[:, 1] + nby * b3[:, 2])
                row = pg.block_row[jnp.where(ok, bkey, 0)]
                row = jnp.where(ok & (row >= 0), row, r_sentinel)
                cand = pg.pts_packed[row].reshape(n, cap, -1)[..., :3]
                diff = query[:, None, :] - cand
                d2 = (
                    diff[..., 0] * diff[..., 0]
                    + diff[..., 1] * diff[..., 1]
                    + diff[..., 2] * diff[..., 2]
                )
                arg = jnp.argmin(d2, axis=1)
                d2m = jnp.take_along_axis(d2, arg[:, None], axis=1)[:, 0]
                better = d2m < best_d2
                best_d2 = jnp.where(better, d2m, best_d2)
                best_row = jnp.where(better, row, best_row)
                best_slot = jnp.where(better, arg.astype(jnp.int32), best_slot)
    idx_row = pg.idx_packed[best_row]  # (N, cap) — one extra fat gather
    idx = jnp.take_along_axis(idx_row, best_slot[:, None], axis=1)[:, 0]
    dist = jnp.sqrt(best_d2)
    resolved = dist < pg.cell_fine
    return PointNN(dist=dist, idx=jnp.where(jnp.isfinite(dist), idx, -1), resolved=resolved)


def _knn_window_pass(pg: PackedPointGrid, query: jax.Array, k: int, radius: int, chunk: int):
    """Chunked k-NN over the blocks covering fine-cell ``radius``: the block
    span per axis is ``(2*radius + 1)/2`` rounded up at worst alignment."""
    cap = pg.cap
    n = query.shape[0]
    n_pad = -(-n // chunk) * chunk
    qpad = jnp.concatenate([query, jnp.zeros((n_pad - n, 3), query.dtype)], axis=0)
    nbx, nby = pg.nb_dims[0], pg.nb_dims[1]
    r_sentinel = jnp.int32(pg.pts_packed.shape[0] - 1)
    span = (2 * radius + _BLOCK - 1) // _BLOCK + 1

    def one_chunk(q):
        m = q.shape[0]
        fine = cell_coords(q, pg.cell_fine) - pg.origin_fine
        lo_b = jnp.floor_divide(fine - radius, _BLOCK)
        d2s, idxs = [], []
        for dbx in range(span):
            for dby in range(span):
                for dbz in range(span):
                    b3 = lo_b + jnp.asarray([dbx, dby, dbz], jnp.int32)
                    ok = jnp.all((b3 >= 0) & (b3 < pg.nb_dims), axis=-1)
                    bkey = b3[:, 0] + nbx * (b3[:, 1] + nby * b3[:, 2])
                    row = pg.block_row[jnp.where(ok, bkey, 0)]
                    row = jnp.where(ok & (row >= 0), row, r_sentinel)
                    cand = pg.pts_packed[row].reshape(m, cap, -1)[..., :3]
                    diff = q[:, None, :] - cand
                    d2s.append(
                        diff[..., 0] ** 2 + diff[..., 1] ** 2 + diff[..., 2] ** 2
                    )
                    idxs.append(pg.idx_packed[row])
        d2 = jnp.concatenate(d2s, axis=1)  # (m, span^3 * cap)
        idx = jnp.concatenate(idxs, axis=1)
        neg_top, arg = jax.lax.top_k(-d2, k)
        top_idx = jnp.take_along_axis(idx, arg, axis=1)
        top_idx = jnp.where(jnp.isfinite(neg_top), top_idx, -1)
        return jnp.sqrt(-neg_top), top_idx

    d, i = jax.lax.map(one_chunk, qpad.reshape(-1, chunk, 3))
    return d.reshape(n_pad, k)[:n], i.reshape(n_pad, k)[:n]


def knn_packed(pg: PackedPointGrid, query: jax.Array, k: int, chunk: int = 16384,
               exact_tail: bool = True):
    """k-NN over the packed blocks: (dist (N, k), idx (N, k)) ascending.

    Two tiers: the 8-block near window is *provably exact* for neighborhoods
    within ``cell_fine`` of the query; with ``exact_tail`` the queries whose
    k-th neighbor lands at or beyond that radius are compacted (capacity N/4)
    and re-searched at double the radius (27-block window), pushing the
    provable-exactness radius to ``2 * cell_fine`` — beyond which only
    pathological neighborhoods (several cells wide vs the sampled median
    radius) remain approximate.
    """
    n = query.shape[0]
    d, i = _knn_window_pass(pg, query, k, radius=1, chunk=chunk)
    if not exact_tail or n < 64:
        return d, i
    cf = jnp.asarray(pg.cell_fine)
    mask = jnp.logical_not(d[:, k - 1] < cf)  # k-th neighbor not provably exact
    n_unres = jnp.sum(mask)
    cap_q = max(n // 4, 64)

    def wide(_):
        idxs = jnp.nonzero(mask, size=cap_q, fill_value=0)[0]
        live = jnp.arange(cap_q) < n_unres
        wd, wi = _knn_window_pass(pg, query[idxs], k, radius=2, chunk=min(chunk, 4096))
        d_new = d.at[idxs].set(jnp.where(live[:, None], wd, d[idxs]))
        i_new = i.at[idxs].set(jnp.where(live[:, None], wi, i[idxs]))
        return d_new, i_new

    return jax.lax.cond(n_unres > 0, wide, lambda _: (d, i), 0)
