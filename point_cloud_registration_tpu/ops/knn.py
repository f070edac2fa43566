"""Fixed-shape nearest-neighbor queries over the voxel grid.

These replace every ``KDTree.query`` call site in the reference
(/root/reference/point_cloud_registration/kdtree.py contract:
``query(points, k) -> (dist, idx)``):

* :func:`nearest_voxel` — nearest occupied-voxel centroid (the VPlaneICP/NDT
  correspondence, reference voxel.py:171-179 which kd-trees over centroids);
* :func:`nearest_point` — gated 1-NN over raw points (ICP/PlaneICP,
  icp.py:33 / plane_icp.py:42);
* :func:`knn_points` — k-NN over raw points (normal estimation,
  estimate_normals.py:39);
* :func:`brute_force_nn` / :func:`brute_force_knn` — exact tiled fallbacks
  used as validation oracles (SURVEY §7: exact mode for bit-level parity).

Grid queries are *exact* for any match inside ``max_dist`` as long as the
per-cell candidate cap is not exceeded (the offset table provably covers the
gated radius — see ``hashgrid.search_offsets``); the cap is the one
approximation, and the brute-force paths quantify it in tests.

Everything is branchless ``lax.scan``/``fori_loop`` over static offset tables:
no data-dependent shapes, no host sync, safe under jit/vmap/shard_map.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from point_cloud_registration_tpu.ops.hashgrid import (
    INVALID_KEY,
    Buckets,
    Grid,
    cell_coords,
    coords_to_key,
    lookup_slots,
)

_BIG = np.float32(np.inf)  # numpy scalar: no backend init at import

# Finite miss sentinel for empty block-table cells. 1e30 squared overflows to
# inf, so sentinel candidates can never win a distance comparison.
MISS_COORD = np.float32(1e30)


def padded_row_width(n_floats: int) -> int:
    """Round a planar block-row width up to a multiple of 128 floats."""
    return -(-n_floats // 128) * 128


def padded_z_blocks(nbz: int) -> int:
    """Round the z block count up to a multiple of 8."""
    return -(-nbz // 8) * 8


class NNResult(NamedTuple):
    dist: jax.Array  # (N,) f32 — Euclidean distance (inf when no candidate)
    idx: jax.Array  # (N,) i32 — matched slot/point index (-1 when none)


def _query_cell_keys(grid: Grid, query: jax.Array, offsets: jax.Array) -> jax.Array:
    """Keys of ``query``'s cell shifted by each offset: (K, N) i32."""
    qc = cell_coords(query, grid.cell_size)  # (N, 3)
    keys = jax.vmap(lambda off: coords_to_key(qc + off, grid.origin_cell, grid.dims))(offsets)
    return keys


def nearest_voxel(
    grid: Grid,
    means: jax.Array,
    valid: jax.Array,
    query: jax.Array,
    offsets: np.ndarray | jax.Array,
) -> NNResult:
    """Nearest valid voxel centroid within the offset window.

    Replaces the reference's kd-tree over voxel means (voxel.py:165, :176).
    ``means`` is the (C, 3) capacity-padded centroid table, ``valid`` the
    min_points mask (voxel.py:151-153). One centroid gather per offset; the
    winning slot is returned for a single post-hoc field gather by the caller.
    """
    offsets = jnp.asarray(offsets, jnp.int32)
    keys = _query_cell_keys(grid, query, offsets)  # (K, N)
    n = query.shape[0]

    def step(carry, key_row):
        best_d2, best_slot = carry
        slot = lookup_slots(grid, key_row)  # (N,)
        safe = jnp.clip(slot, 0, means.shape[0] - 1)
        ok = (slot >= 0) & valid[safe]
        diff = query - means[safe]
        d2 = jnp.where(ok, jnp.sum(diff * diff, axis=-1), _BIG)
        better = d2 < best_d2
        return (
            jnp.where(better, d2, best_d2),
            jnp.where(better, slot, best_slot),
        ), None

    # Derive the scan carry from the (possibly sharded) query so its type —
    # including shard_map's varying-manual-axes annotation — matches the body
    # output; a plain jnp.full would be device-invariant and reject under
    # vmap-of-shard_map.
    init = (query[:, 0] * 0 + _BIG, jnp.zeros_like(query[:, 0], jnp.int32) - 1)
    (best_d2, best_slot), _ = jax.lax.scan(step, init, keys)
    return NNResult(dist=jnp.sqrt(best_d2), idx=best_slot)


# Cells per dense block along (x, y, z). A block is one gather row of
# bx*by*bz*3 floats; bigger blocks cut the gather-row count at the cost of
# distance math on a cell superset. With (4, 8, 4) every axis span of the
# radius-2 window is 2 blocks, so a full-window query probes 8 blocks.
DENSE_BLOCK = (4, 8, 4)


def _block_span(radius_cells: int, b: int) -> int:
    """Max blocks of size ``b`` a (2*radius+1)-cell window can intersect:
    ceil((L-1)/b) + 1 for a window of L cells at worst alignment."""
    return (2 * radius_cells + b - 1) // b + 1


def nearest_voxel_blocks(
    grid: Grid,
    dense_blocks: jax.Array,
    nb_dims: jax.Array,
    query: jax.Array,
    radius_near: int,
    radius_full: int,
    fixed_tiers: bool = False,
    full_window: bool = False,
) -> NNResult:
    """Nearest-voxel query against a blocked dense centroid table.

    ``full_window`` probes the ``radius_full`` window for EVERY query in one
    pass — no tiers, no compaction capacity. Required when most queries are
    expected unresolved (e.g. sharded-map slabs, where a query's true voxel
    usually lives on another shard and the compacted tier would silently
    overflow); with the (4, 8, 4) block the full window is the same 8 block
    probes as the near pass, so this costs no extra gathers.

    ``dense_blocks`` is (nby, nbz8, nbx, row_w) in *planar* layout —
    entry [bz, by, bx] holds that block's cell centroids as
    ``[x_0..x_{w-1}, y_0.., z_0..]`` (``MISS_COORD`` where empty/invalid/
    out-of-grid). One fetched block row serves bx*by*bz candidate cells,
    cutting the gather-row count vs per-cell probing; the extra cells a
    block window covers beyond the exact cell window only ever *improve*
    the candidate set.

    Two-tier exactness: the near pass covers cell radius ``radius_near``; a
    query whose best distance is below ``radius_near * cell_size`` is
    provably exact. Unresolved queries are compacted (capacity N/4) and
    re-searched at ``radius_full`` (the max_dist-covering radius); a
    pathological all-unresolved iteration falls back to a full-width pass.

    Returns the best *cell key* in ``idx`` (sentinel: out-of-table key).
    """
    bx, by, bz = DENSE_BLOCK
    w = bx * by * bz
    # table layout (nby, nbz8, nbx, row_w): z blocks padded to a multiple
    # of 8, rows to a multiple of 128 floats
    nbz8 = dense_blocks.shape[1]
    row_w = dense_blocks.shape[3]
    flat_blocks = dense_blocks.reshape(-1, row_w)
    nbx, nby, nbz = nb_dims[0], nb_dims[1], nb_dims[2]
    gnx, gny = grid.dims[0], grid.dims[1]  # true cell-grid dims for final keys
    cell_sentinel = jnp.int32(np.iinfo(np.int32).max)
    qc = cell_coords(query, grid.cell_size)
    rel = qc - grid.origin_cell  # (N, 3)
    block = jnp.asarray(DENSE_BLOCK, jnp.int32)

    # Local cell coordinates inside a block, in row layout order
    # col = lx + bx * (ly + by * lz).
    lx = jnp.arange(w, dtype=jnp.int32) % bx
    ly = (jnp.arange(w, dtype=jnp.int32) // bx) % by
    lz = jnp.arange(w, dtype=jnp.int32) // (bx * by)

    def block_pass(q, r, radius):
        lo_b = jnp.floor_divide(r - radius, block)  # (M, 3) first block per axis
        spans = [_block_span(radius, b) for b in DENSE_BLOCK]
        best_d2 = q[:, 0] * 0 + _BIG
        best_key = jnp.zeros_like(r[:, 0]) + cell_sentinel
        for dbx in range(spans[0]):
            for dby in range(spans[1]):
                for dbz in range(spans[2]):
                    b3 = lo_b + jnp.asarray([dbx, dby, dbz], jnp.int32)
                    ok = jnp.all((b3 >= 0) & (b3 < nb_dims), axis=-1)
                    row = (b3[:, 1] * nbz8 + b3[:, 2]) * nbx + b3[:, 0]
                    row = jnp.where(ok, row, 0)
                    cells = flat_blocks[row][:, : 3 * w].reshape(-1, 3, w)  # planar
                    diff = q[:, :, None] - cells
                    d2 = (
                        diff[:, 0, :] * diff[:, 0, :]
                        + diff[:, 1, :] * diff[:, 1, :]
                        + diff[:, 2, :] * diff[:, 2, :]
                    )  # (M, w)
                    d2 = jnp.where(ok[:, None], d2, _BIG)
                    arg = jnp.argmin(d2, axis=1)
                    d2m = jnp.take_along_axis(d2, arg[:, None], axis=1)[:, 0]
                    cx = b3[:, 0] * bx + lx[arg]
                    cy = b3[:, 1] * by + ly[arg]
                    cz = b3[:, 2] * bz + lz[arg]
                    # true-grid linear key (cells beyond the true dims carry
                    # MISS_COORD in the table and can never win)
                    key = cx + gnx * (cy + gny * cz)
                    better = d2m < best_d2
                    best_d2 = jnp.where(better, d2m, best_d2)
                    best_key = jnp.where(better, key, best_key)
        return best_d2, best_key

    if full_window:
        best_d2, best_key = block_pass(query, rel, radius_full)
        return NNResult(dist=jnp.sqrt(best_d2), idx=best_key)

    best_d2, best_key = block_pass(query, rel, radius_near)

    if radius_full > radius_near:
        exact_r = radius_near * grid.cell_size
        mask = best_d2 >= exact_r * exact_r  # not provably exact
        n_unres = jnp.sum(mask)
        cap = max(query.shape[0] // 4, 1024)

        def compact_pass(carry):
            d2_all, key_all = carry
            idxs = jnp.nonzero(mask, size=cap, fill_value=0)[0]
            live = jnp.arange(cap) < n_unres
            sd2, skey = block_pass(query[idxs], rel[idxs], radius_full)
            d2_new = d2_all.at[idxs].set(jnp.where(live, sd2, d2_all[idxs]))
            key_new = key_all.at[idxs].set(jnp.where(live, skey, key_all[idxs]))
            return d2_new, key_new

        def full_pass(carry):
            fd2, fkey = block_pass(query, rel, radius_full)
            better = fd2 < carry[0]
            return jnp.where(better, fd2, carry[0]), jnp.where(better, fkey, carry[1])

        if fixed_tiers:
            # Batched/vmapped contexts: lax.switch under vmap executes every
            # branch for every element, so data-dependent tiering costs the
            # worst case anyway. Run the compacted full-radius pass
            # unconditionally instead (its capacity bound still applies; the
            # >cap overflow falls back to near-pass results, which only
            # affects pathological all-unresolved iterations).
            best_d2, best_key = compact_pass((best_d2, best_key))
        else:
            # Tier 1: everything provably exact -> done. Tier 2: few
            # unresolved -> full radius on a compacted subset. Tier 3
            # (pathological, >cap unresolved, e.g. the very first iteration
            # of a badly-initialized align): full radius on everything.
            tier = (n_unres > 0).astype(jnp.int32) + (n_unres > cap).astype(jnp.int32)
            best_d2, best_key = jax.lax.switch(
                tier,
                [lambda c: c, compact_pass, full_pass],
                (best_d2, best_key),
            )
    return NNResult(dist=jnp.sqrt(best_d2), idx=best_key)


def dense_blocks_from_dense(
    means: jax.Array,
    valid: jax.Array,
    dims_static: tuple[int, int, int],
    nb_dims_static: tuple[int, int, int],
) -> jax.Array:
    """Blocked planar table for a *dense-direct* map (slot == linear cell).

    When the voxel slot IS the linear cell key (voxelize dense-direct
    builds), the blocked table is a pure permutation of the per-cell arrays:
    reshape cells to (nz, ny, nx), pad each axis to a block multiple, split
    into (block, intra-block) axes, and transpose to the planar row order.
    One fused XLA copy replaces the per-component scatters of
    :func:`build_dense_blocks`. Same output layout/value contract as
    :func:`build_dense_blocks`.
    """
    bx, by, bz = DENSE_BLOCK
    nx, ny, nz = dims_static
    nbx, nby, nbz = nb_dims_static
    nbz8 = padded_z_blocks(nbz)
    w = bx * by * bz

    def to_blocks(vals, fill):
        # (d_total, K) cell values -> (nby, nbz8, nbx, K*w) planar rows
        k = vals.shape[1]
        a = vals.reshape(nz, ny, nx, k)
        a = jnp.pad(
            a,
            ((0, nbz8 * bz - nz), (0, nby * by - ny), (0, nbx * bx - nx), (0, 0)),
            constant_values=fill,
        )
        a = a.reshape(nbz8, bz, nby, by, nbx, bx, k)
        # planar row order: component slowest, then (lz, ly, lx) — matches
        # the scatter path's col = lx + bx*(ly + by*lz) + comp*w
        a = a.transpose(2, 0, 4, 6, 1, 3, 5)
        a = a.reshape(nby, nbz8, nbx, k * w)
        pad_w = padded_row_width(k * w) - k * w
        if pad_w:
            a = jnp.pad(
                a, ((0, 0), (0, 0), (0, 0), (0, pad_w)), constant_values=fill
            )
        return a

    return to_blocks(jnp.where(valid[:, None], means, MISS_COORD), MISS_COORD)


def build_dense_blocks(
    grid: Grid,
    means: jax.Array,
    valid: jax.Array,
    nb_dims_static: tuple[int, int, int],
) -> jax.Array:
    """(nby, nbz8, nbx, row_w) planar blocked table for
    :func:`nearest_voxel_blocks`.

    Planar row layout: centroids ``[x_0..x_{w-1}, y_0.., z_0..]``
    (structure-of-arrays, so component lanes are contiguous slices of a
    fetched row), padded to a multiple of 128 floats. Empty / invalid /
    out-of-grid cells hold ``MISS_COORD``. ``nb_dims_static`` are host ints
    (block grid dims) because they size the array.
    """
    bx, by, bz = DENSE_BLOCK
    w = bx * by * bz
    row_w = padded_row_width(3 * w)
    nbx, nby, nbz = nb_dims_static
    nbz8 = padded_z_blocks(nbz)
    nb = nbx * nby * nbz8
    # cell coords of every slot from its linear key
    keys = grid.keys
    nx, ny = grid.dims[0], grid.dims[1]
    # Bound-check the key itself: packed/proxy grids can carry sentinel keys
    # (out-of-bbox rows, -1 padding) that are not INVALID_KEY; deriving cell
    # coords from them would alias into a wrong block slot.
    total = grid.dims[0] * grid.dims[1] * grid.dims[2]
    ok = (keys != INVALID_KEY) & (keys >= 0) & (keys < total) & valid
    safe_keys = jnp.where(ok, keys, 0)
    cx = safe_keys % nx
    cy = (safe_keys // nx) % ny
    cz = safe_keys // (nx * ny)
    brow = ((cy // by) * nbz8 + (cz // bz)) * nbx + (cx // bx)
    col = (cx % bx) + bx * ((cy % by) + by * (cz % bz))
    flat_base = brow * row_w + col
    table = jnp.full((nb * row_w,), MISS_COORD, jnp.float32)
    oob = jnp.int32(nb * row_w)  # dropped by the scatter

    # Compact the valid slots before scattering: typically only ~15% of a
    # dense-direct map's cells pass min_points.
    c_rows = keys.shape[0]
    cap = min(max(c_rows // 4, 65536), c_rows)
    n_ok = jnp.sum(ok)

    def compacted(table):
        sel = jnp.nonzero(ok, size=cap, fill_value=0)[0]
        live = jnp.arange(cap) < n_ok
        base_c = jnp.where(live, flat_base[sel], oob)
        for comp in range(3):
            table = table.at[base_c + comp * w].set(means[sel, comp], mode="drop")
        return table

    def full(table):
        for comp in range(3):
            idx = jnp.where(ok, flat_base + comp * w, oob)
            table = table.at[idx].set(means[:, comp], mode="drop")
        return table

    table = jax.lax.cond(n_ok <= cap, compacted, full, table)
    return table.reshape(nby, nbz8, nbx, row_w)


def nearest_point(
    grid: Grid,
    buckets: Buckets,
    points: jax.Array,
    query: jax.Array,
    offsets: np.ndarray | jax.Array,
    cap: int,
    with_overflow: bool = False,
) -> NNResult:
    """Gated 1-NN over raw points via CSR buckets.

    ``cap`` bounds candidates scanned per cell (fixed shapes); cells holding
    more points contribute only their first ``cap`` entries in insertion
    order — the accuracy/throughput dial quantified in tests against
    :func:`brute_force_nn`. With ``with_overflow`` additionally returns a
    per-query bool marking queries whose window touched a cell holding more
    than ``cap`` points — for those the result is NOT provably exact even
    inside the covering radius (the true nearest may sit past the cap), so
    exactness-contract callers re-search them.
    """
    offsets = jnp.asarray(offsets, jnp.int32)
    keys = _query_cell_keys(grid, query, offsets)  # (K, N)
    n = query.shape[0]
    n_pts = points.shape[0]

    def step(carry, key_row):
        best_d2_c, best_idx_c, over_c = carry
        slot = lookup_slots(grid, key_row)
        safe_slot = jnp.clip(slot, 0, buckets.starts.shape[0] - 1)
        start = buckets.starts[safe_slot]
        count = jnp.where(slot >= 0, buckets.counts[safe_slot], 0)
        over_c = jnp.logical_or(over_c, count > cap)

        def inner(j, c):
            best_d2, best_idx = c
            pos = jnp.clip(start + j, 0, n_pts - 1)
            pidx = buckets.perm[pos]
            ok = j < count
            diff = query - points[pidx]
            d2 = jnp.where(ok, jnp.sum(diff * diff, axis=-1), _BIG)
            better = d2 < best_d2
            return (
                jnp.where(better, d2, best_d2),
                jnp.where(better, pidx, best_idx),
            )

        best_d2_c, best_idx_c = jax.lax.fori_loop(0, cap, inner, (best_d2_c, best_idx_c))
        return (best_d2_c, best_idx_c, over_c), None

    # Carry derived from the query for vma-type stability (see nearest_voxel).
    init = (
        query[:, 0] * 0 + _BIG,
        jnp.zeros_like(query[:, 0], jnp.int32) - 1,
        query[:, 0] > _BIG,  # all-False, query-derived
    )
    (best_d2, best_idx, overflow), _ = jax.lax.scan(step, init, keys)
    res = NNResult(dist=jnp.sqrt(best_d2), idx=best_idx)
    if with_overflow:
        return res, overflow
    return res


def knn_points(
    grid: Grid,
    buckets: Buckets,
    points: jax.Array,
    query: jax.Array,
    offsets: np.ndarray | jax.Array,
    cap: int,
    k: int,
    chunk: int = 16384,
    with_overflow: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """k-NN over raw points: returns ``(dist (N, k), idx (N, k))`` ascending.

    Candidates from the offset window are materialized per query chunk and
    ranked with ``lax.top_k`` (build-time only: this feeds normal estimation,
    estimate_normals.py:39, which the reference itself amortizes out of the
    align timing — README.md:48). ``chunk`` bounds the (chunk, K*cap)
    candidate buffer to keep HBM pressure flat for million-point clouds.
    ``with_overflow`` additionally returns a per-query bool: the window
    touched a cell with more than ``cap`` points, so the k-NN set is not
    provably complete even within the covering radius.
    """
    offsets = jnp.asarray(offsets, jnp.int32)
    n = query.shape[0]
    n_pad = -(-n // chunk) * chunk
    qpad = jnp.concatenate([query, jnp.zeros((n_pad - n, 3), query.dtype)], axis=0)
    qchunks = qpad.reshape(n_pad // chunk, chunk, 3)

    n_pts = points.shape[0]
    n_off = offsets.shape[0]

    def one_chunk(q):
        keys = _query_cell_keys(grid, q, offsets)  # (K, chunk)
        slot = lookup_slots(grid, keys)  # (K, chunk)
        safe_slot = jnp.clip(slot, 0, buckets.starts.shape[0] - 1)
        start = buckets.starts[safe_slot]
        count = jnp.where(slot >= 0, buckets.counts[safe_slot], 0)
        j = jnp.arange(cap, dtype=jnp.int32)  # (cap,)
        pos = jnp.clip(start[..., None] + j, 0, n_pts - 1)  # (K, chunk, cap)
        ok = j < count[..., None]
        pidx = buckets.perm[pos]
        diff = q[None, :, None, :] - points[pidx]  # (K, chunk, cap, 3)
        d2 = jnp.where(ok, jnp.sum(diff * diff, axis=-1), _BIG)
        # (chunk, K*cap) candidate matrix -> top-k smallest
        d2 = jnp.moveaxis(d2, 1, 0).reshape(chunk, n_off * cap)
        pidx = jnp.moveaxis(pidx, 1, 0).reshape(chunk, n_off * cap)
        neg_top, arg = jax.lax.top_k(-d2, k)
        top_idx = jnp.take_along_axis(pidx, arg, axis=-1)
        top_idx = jnp.where(jnp.isfinite(neg_top), top_idx, -1)
        over = jnp.any(count > cap, axis=0)  # (chunk,)
        return jnp.sqrt(-neg_top), top_idx, over

    dists, idxs, overs = jax.lax.map(one_chunk, qchunks)
    if with_overflow:
        return (
            dists.reshape(n_pad, k)[:n],
            idxs.reshape(n_pad, k)[:n],
            overs.reshape(n_pad)[:n],
        )
    return dists.reshape(n_pad, k)[:n], idxs.reshape(n_pad, k)[:n]


@partial(jax.jit, static_argnames=("tile",))
def brute_force_nn(query: jax.Array, ref: jax.Array, ref_valid: jax.Array | None = None, tile: int = 4096) -> NNResult:
    """Exact 1-NN by tiled exhaustive search (validation oracle / exact mode)."""
    n_ref = ref.shape[0]
    pad = -(-n_ref // tile) * tile - n_ref
    ref_p = jnp.concatenate([ref, jnp.full((pad, 3), 1e30, ref.dtype)], axis=0)
    if ref_valid is None:
        valid_p = jnp.concatenate([jnp.ones((n_ref,), bool), jnp.zeros((pad,), bool)])
    else:
        valid_p = jnp.concatenate([ref_valid, jnp.zeros((pad,), bool)])
    tiles = ref_p.reshape(-1, tile, 3)
    vtiles = valid_p.reshape(-1, tile)
    base = jnp.arange(tile, dtype=jnp.int32)

    def step(carry, xs):
        best_d2, best_idx = carry
        rt, vt, t_i = xs
        diff = query[:, None, :] - rt[None, :, :]
        d2 = jnp.sum(diff * diff, axis=-1)
        d2 = jnp.where(vt[None, :], d2, _BIG)
        ti = jnp.argmin(d2, axis=1)
        td = jnp.take_along_axis(d2, ti[:, None], axis=1)[:, 0]
        better = td < best_d2
        gidx = t_i * tile + base[ti]
        return (jnp.where(better, td, best_d2), jnp.where(better, gidx, best_idx)), None

    init = (jnp.full((query.shape[0],), _BIG), jnp.full((query.shape[0],), -1, jnp.int32))
    (d2, idx), _ = jax.lax.scan(
        step, init, (tiles, vtiles, jnp.arange(tiles.shape[0], dtype=jnp.int32))
    )
    return NNResult(dist=jnp.sqrt(d2), idx=idx)


@partial(jax.jit, static_argnames=("k", "chunk"))
def brute_force_knn(query: jax.Array, ref: jax.Array, k: int, chunk: int = 2048) -> tuple[jax.Array, jax.Array]:
    """Exact k-NN by chunked exhaustive search (validation oracle)."""
    n = query.shape[0]
    n_pad = -(-n // chunk) * chunk
    qpad = jnp.concatenate([query, jnp.zeros((n_pad - n, 3), query.dtype)], axis=0)

    def one_chunk(q):
        diff = q[:, None, :] - ref[None, :, :]
        d2 = jnp.sum(diff * diff, axis=-1)
        neg_top, arg = jax.lax.top_k(-d2, k)
        return jnp.sqrt(-neg_top), arg.astype(jnp.int32)

    d, i = jax.lax.map(one_chunk, qpad.reshape(-1, chunk, 3))
    return d.reshape(n_pad, k)[:n], i.reshape(n_pad, k)[:n]
