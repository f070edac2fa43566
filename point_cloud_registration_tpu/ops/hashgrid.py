"""Voxel-grid spatial index — the device replacement for the kd-tree.

The reference answers every neighbor query through pointer-chasing C/C++
kd-trees behind a shim (/root/reference/point_cloud_registration/kdtree.py:18-65)
and uses a spatial hash only to *group* points during voxel construction
(voxel.py:12-21, :165). Pointer-chasing does not vectorize, so here the grid IS
the index (SURVEY §2.4 item 1):

* cells are absolute integer coordinates ``floor(p / cell_size)`` — identical
  grouping semantics to the reference hash (voxel.py:16) without its modular
  hash (we key by position inside the map's bounding box, which is collision
  free and fits int32);
* occupied cells live in a sorted, capacity-padded key array (binary-search
  lookup) plus an optional dense cell->slot table for O(1) lookups when the
  bounding box is small enough;
* raw points are bucketed CSR-style (sort by cell, start/count per cell) so a
  fixed-shape candidate scan replaces the kd-tree descent.

Everything after the one-time host-side bounding-box read is fixed-shape,
jit-compatible, and shardable.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# Padding key for unoccupied slots: sorts after every real key.
INVALID_KEY = np.iinfo(np.int32).max
# Default ceiling for the dense lookup table (cells). 2**26 int32 = 256 MB HBM.
DENSE_CELL_BUDGET = 1 << 26


class Grid(NamedTuple):
    """Spatial index over the occupied cells of one point set (a pytree)."""

    origin_cell: jax.Array  # (3,) i32 — minimum absolute cell coordinate
    cell_size: jax.Array  # () f32
    dims: jax.Array  # (3,) i32 — cells per axis inside the bounding box
    keys: jax.Array  # (C,) i32 — sorted unique linear cell keys, INVALID_KEY padded
    n_cells: jax.Array  # () i32 — number of occupied cells (<= C)
    dense: jax.Array | None  # (D,) i32 — cell key -> slot, -1 if empty; None if too big


class Buckets(NamedTuple):
    """CSR point buckets: points of cell ``slot`` are ``perm[starts[s] : starts[s]+counts[s]]``."""

    perm: jax.Array  # (N,) i32 — point indices sorted by cell slot
    starts: jax.Array  # (C,) i32
    counts: jax.Array  # (C,) i32


def cell_coords(points: jax.Array, cell_size) -> jax.Array:
    """Absolute integer cell coordinates ``floor(p / cell_size)`` -> (..., 3) i32.

    Matches the reference voxelization grouping (voxel.py:16:
    ``floor(points / voxel_size).astype(int64)``) so voxel contents are
    bit-identical modulo float32 division rounding.
    """
    return jnp.floor(points / cell_size).astype(jnp.int32)


def coords_to_key(coords: jax.Array, origin_cell: jax.Array, dims: jax.Array) -> jax.Array:
    """Linear bounding-box key for (..., 3) cell coords; -1 when out of range.

    Key = ``x + nx * (y + ny * z)`` relative to ``origin_cell``. Queries that
    fall outside the indexed bounding box simply find no neighbor, matching
    the max_dist gating semantics of every solver.
    """
    rel = coords - origin_cell
    in_range = jnp.all((rel >= 0) & (rel < dims), axis=-1)
    key = rel[..., 0] + dims[0] * (rel[..., 1] + dims[1] * rel[..., 2])
    return jnp.where(in_range, key, jnp.int32(-1))


def lookup_slots(grid: Grid, query_keys: jax.Array) -> jax.Array:
    """Map linear cell keys -> compact slot indices (-1 if cell unoccupied).

    Dense path: one gather. Sparse path: vectorized binary search over the
    sorted key array (log2(C) gather rounds).
    """
    if grid.dense is not None:
        safe = jnp.clip(query_keys, 0, grid.dense.shape[0] - 1)
        slots = grid.dense[safe]
        return jnp.where(query_keys >= 0, slots, jnp.int32(-1))
    pos = jnp.searchsorted(grid.keys, query_keys).astype(jnp.int32)
    pos_safe = jnp.clip(pos, 0, grid.keys.shape[0] - 1)
    hit = (grid.keys[pos_safe] == query_keys) & (query_keys >= 0)
    return jnp.where(hit, pos_safe, jnp.int32(-1))


def _round_up_pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


def _bbox_cells(points, cell_size: float) -> tuple[np.ndarray, np.ndarray]:
    """Host-side bounding box in cell units.

    NumPy inputs are reduced on the host (zero device syncs — the common
    ``set_target(np.ndarray)`` path); device inputs cost ONE combined
    device->host sync. Both reduce in float32, so the resulting cells are
    identical regardless of where the input lives.
    """
    if points.shape[0] == 0:
        raise ValueError("empty point cloud: at least one point is required")
    if isinstance(points, np.ndarray):
        pts32 = points if points.dtype == np.float32 else points.astype(np.float32)
        lo = pts32.min(axis=0).astype(np.float64)
        hi = pts32.max(axis=0).astype(np.float64)
    else:
        p32 = jnp.asarray(points, jnp.float32)
        lo, hi = jax.device_get((jnp.min(p32, axis=0), jnp.max(p32, axis=0)))
        lo = np.asarray(lo, np.float64)
        hi = np.asarray(hi, np.float64)
    lo_cell = np.floor(lo / cell_size).astype(np.int64)
    hi_cell = np.floor(hi / cell_size).astype(np.int64)
    return lo_cell, hi_cell


def build_grid(
    points: jax.Array,
    cell_size: float,
    *,
    capacity: int | None = None,
    with_buckets: bool = False,
    dense_budget: int = DENSE_CELL_BUDGET,
) -> tuple[Grid, jax.Array, Buckets | None]:
    """Build the grid index for ``points`` (N, 3).

    Returns ``(grid, inverse, buckets)`` where ``inverse[i]`` is the compact
    slot of point i's cell (used by the voxel-stats segment reductions) and
    ``buckets`` is the CSR layout (only when ``with_buckets``).

    Host orchestration: only the bounding box crosses to the host (to fix
    static shapes); the sort/unique/segment work is one jitted XLA program.
    ``capacity`` defaults to N rounded up to a power of two, which bounds
    compilation cache churn across differently-sized maps.
    """
    lo_cell, hi_cell = _bbox_cells(points, cell_size)  # NumPy input: no sync
    points = jnp.asarray(points, dtype=jnp.float32)
    n = points.shape[0]
    dims64 = hi_cell - lo_cell + 1
    total_cells = int(np.prod(dims64))
    if total_cells >= np.iinfo(np.int32).max:
        raise ValueError(
            f"grid of {dims64} cells ({total_cells}) exceeds int32 keyspace; "
            "increase cell_size"
        )
    if capacity is None:
        capacity = _round_up_pow2(min(n, total_cells))
    dense_size = _round_up_pow2(total_cells) if total_cells <= dense_budget else None

    grid, inverse, buckets = _build_grid_device(
        points,
        jnp.asarray(lo_cell, jnp.int32),
        jnp.float32(cell_size),
        jnp.asarray(dims64, jnp.int32),
        capacity=capacity,
        dense_size=dense_size,
        with_buckets=with_buckets,
    )
    # Geometry is host-known: store as NumPy so later device_gets are free.
    grid = grid._replace(
        origin_cell=np.asarray(lo_cell, np.int32),
        cell_size=np.float32(cell_size),
        dims=np.asarray(dims64, np.int32),
    )
    return grid, inverse, buckets


@partial(jax.jit, static_argnames=("capacity", "dense_size", "with_buckets"))
def _build_grid_device(points, origin_cell, cell_size, dims, *, capacity, dense_size, with_buckets):
    coords = cell_coords(points, cell_size)
    keys = coords_to_key(coords, origin_cell, dims)
    # f32/f64 boundary guard: coords_to_key returns -1 for a point whose
    # device-side cell falls one past the host-side bbox; without this remap
    # the -1 becomes a real unique slot whose points are unreachable by
    # lookup_slots (silently dropped from queries). INVALID_KEY merges them
    # into the padding slot instead, which every query path already skips.
    keys = jnp.where(keys < 0, jnp.int32(INVALID_KEY), keys)
    unique_keys, inverse = jnp.unique(
        keys, return_inverse=True, size=capacity, fill_value=INVALID_KEY
    )
    inverse = inverse.astype(jnp.int32)
    n_cells = jnp.sum(unique_keys != INVALID_KEY).astype(jnp.int32)

    dense = None
    if dense_size is not None:
        dense = jnp.full((dense_size,), -1, dtype=jnp.int32)
        slot_ids = jnp.arange(capacity, dtype=jnp.int32)
        # INVALID_KEY padding lands out of range and is dropped by the scatter.
        dense = dense.at[unique_keys].set(slot_ids, mode="drop")

    buckets = None
    if with_buckets:
        counts = jnp.zeros((capacity,), jnp.int32).at[inverse].add(1)
        starts = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32), jnp.cumsum(counts)[:-1].astype(jnp.int32)]
        )
        perm = jnp.argsort(inverse, stable=True).astype(jnp.int32)
        buckets = Buckets(perm=perm, starts=starts, counts=counts)

    grid = Grid(
        origin_cell=origin_cell,
        cell_size=cell_size,
        dims=dims,
        keys=unique_keys,
        n_cells=n_cells,
        dense=dense,
    )
    return grid, inverse, buckets


def search_offsets(max_dist: float, cell_size: float) -> np.ndarray:
    """Static (K, 3) table of neighbor-cell offsets that exactly cover a
    ``dist < max_dist`` gated nearest-neighbor query.

    A cell at per-axis offset ``k`` can contain a point closer than
    ``max_dist`` iff the per-axis gaps ``max(0, |k| - 1) * cell_size`` satisfy
    ``sum(gap^2) < max_dist^2``; offsets violating it are pruned. For the
    reference benchmark configuration (voxel_size=1, max_dist=2:
    speed_test_comparison.py:166-170) this is the full 5^3 = 125 window, while
    cell_size = max_dist (the raw-point 1-NN default) needs only 3^3 = 27.
    """
    k_max = int(np.ceil(max_dist / cell_size - 1e-9))
    rng = np.arange(-k_max, k_max + 1)
    ox, oy, oz = np.meshgrid(rng, rng, rng, indexing="ij")
    offs = np.stack([ox.ravel(), oy.ravel(), oz.ravel()], axis=-1)
    gap = np.maximum(0, np.abs(offs) - 1) * cell_size
    keep = np.sum(gap * gap, axis=-1) < max_dist * max_dist
    offs = offs[keep]
    # Visit the likeliest-nearest cells first (better early best-distance).
    order = np.argsort(np.sum(offs * offs, axis=-1), kind="stable")
    return offs[order].astype(np.int32)
