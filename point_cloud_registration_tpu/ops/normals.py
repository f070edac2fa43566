"""k-NN PCA normal estimation on the device.

Re-designs the reference pipeline (/root/reference/point_cloud_registration/
estimate_normals.py:11-87): kd-tree k-NN + per-neighbor accumulation loop +
LAPACK ``eigh`` becomes grid k-NN (``ops.knn.knn_points``) + a gathered,
query-centered covariance + the closed-form 3x3 eigensolver.

Numerical note (deliberate improvement, same algorithm): the reference
accumulates raw second moments ``sum p p^T`` in float32
(estimate_normals.py:50-63) and forms ``cov = E[pp^T] - mu mu^T``, which
catastrophically cancels for clouds far from the origin. We compute the same
covariance from *query-centered* coordinates (p - q), which is exact algebra
and float32-stable at any range. The covariance divisor is k (not k-1),
matching estimate_normals.py:70-72.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from point_cloud_registration_tpu.ops.eigh3 import smallest_eigvec_sym3


def sample_knn_radius(points: jax.Array, k: int, n_sample: int = 256, seed: int = 0) -> float:
    """Median k-th-NN distance of a random sample (host float).

    Used to auto-pick the k-NN grid cell size: a 3^3 window of cells of this
    size almost always contains the true k nearest neighbors.
    """
    points = jnp.asarray(points, jnp.float32)
    n = points.shape[0]
    rng = np.random.RandomState(seed)
    m_sub = 1 << 17
    big = n > 2 * m_sub
    # For big clouds, randint (with replacement): choice(replace=False)
    # permutes all N on the host (~200 ms at 1.2M) just to draw samples.
    if big:
        sel = jnp.asarray(rng.randint(0, n, size=min(n_sample, n)))
    else:
        sel = jnp.asarray(rng.choice(n, size=min(n_sample, n), replace=False))
    queries = points[sel]
    # Big clouds also estimate against a reference SUBSAMPLE: expected
    # neighbor counts within r scale linearly with sample size, so the
    # ceil(k*M/N)-th NN radius in an M-subsample matches (slightly
    # overestimates — the safe direction, it only widens the window) the
    # k-th radius in the full cloud, at a fraction of the distance work.
    if big:
        ref_sel = jnp.asarray(rng.randint(0, n, size=m_sub))
        refs = points[ref_sel]
        k_eff = max(2, int(np.ceil(k * m_sub / n)))
    else:
        refs, k_eff = points, k
    d, _ = _sampled_knn(queries, refs, k_eff)
    return float(jax.device_get(jnp.median(d[:, -1])))


@partial(jax.jit, static_argnames=("k", "tile"))
def _sampled_knn(queries, points, k, tile: int = 65536):
    """Exact k-NN for a few queries against a big cloud, ref-tiled."""
    n_ref = points.shape[0]
    pad = -(-n_ref // tile) * tile - n_ref
    ref_p = jnp.concatenate([points, jnp.full((pad, 3), 1e30, points.dtype)], axis=0)
    tiles = ref_p.reshape(-1, tile, 3)
    nq = queries.shape[0]

    def step(carry, rt):
        best_d2 = carry  # (nq, k)
        diff = queries[:, None, :] - rt[None, :, :]
        d2 = jnp.sum(diff * diff, axis=-1)
        cand = jnp.concatenate([best_d2, d2], axis=1)
        neg_top, _ = jax.lax.top_k(-cand, k)
        return -neg_top, None

    init = jnp.full((nq, k), jnp.inf, jnp.float32)
    best_d2, _ = jax.lax.scan(step, init, tiles)
    return jnp.sqrt(best_d2), None  # ascending: top_k(-d2) sorts d2 ascending


def normals_from_neighbors(points: jax.Array, neighbor_idx: jax.Array, query: jax.Array) -> jax.Array:
    """PCA normals given (N, k) neighbor indices (k-divisor covariance).

    Invalid slots (idx < 0, from padded candidate sets) are excluded by
    weighting; the divisor stays k for parity with estimate_normals.py:70-72
    when all k neighbors are present.
    """
    k = neighbor_idx.shape[1]
    safe = jnp.clip(neighbor_idx, 0, points.shape[0] - 1)
    neigh = points[safe]  # (N, k, 3)
    w = (neighbor_idx >= 0).astype(points.dtype)[..., None]  # (N, k, 1)
    centered = (neigh - query[:, None, :]) * w
    denom = jnp.maximum(jnp.sum(w, axis=1), 1.0)  # (N, 1)
    mean = jnp.sum(centered, axis=1) / denom  # (N, 3)
    # E[cc^T] - mean mean^T with k divisor (reference semantics)
    m2 = jnp.einsum("nkd,nke->nde", centered, centered, precision=jax.lax.Precision.HIGHEST) / denom[..., None]
    cov = m2 - jnp.einsum("nd,ne->nde", mean, mean)
    packed = jnp.stack(
        [
            cov[:, 0, 0],
            cov[:, 1, 1],
            cov[:, 2, 2],
            cov[:, 0, 1],
            cov[:, 0, 2],
            cov[:, 1, 2],
        ],
        axis=-1,
    )
    return smallest_eigvec_sym3(packed)


def estimate_normals(
    points,
    k: int = 15,
    *,
    cell_size: float | None = None,
    cell_cap: int | None = None,
) -> jax.Array:
    """Estimate unit normals for every point of a cloud (N, 3) -> (N, 3).

    Functional equivalent of the reference ``estimate_normals``
    (estimate_normals.py:11-24): the point's own k-neighborhood (including
    itself) defines the tangent plane. Neighbors come from the packed-block
    k-NN (``ops/pointgrid.knn_packed``), provably exact out to
    ``2 * cell_size``; wider tail neighborhoods are approximate (quantified
    in tests, harmless for PCA normals).
    """
    from point_cloud_registration_tpu.ops.pointgrid import build_packed_grid

    points = jnp.asarray(points, jnp.float32)
    if cell_size is None:
        cell_size = max(sample_knn_radius(points, k), 1e-3)
    if cell_cap is None:
        cell_cap = max(32, 3 * k)
    pg = build_packed_grid(points, cell_size, cap=cell_cap)
    # ONE jitted program for the k-NN + PCA chain: executed eagerly these
    # are dozens of sequential dispatches (lax.map chunks, the tail cond).
    return _knn_normals_jit(pg, points, k)


@partial(jax.jit, static_argnames=("k",))
def _knn_normals_jit(pg, points, k):
    from point_cloud_registration_tpu.ops.pointgrid import knn_packed

    _, idx = knn_packed(pg, points, k)
    return normals_from_neighbors(points, idx, points)


def get_norm_lines(points, normals, length: float = 0.1) -> np.ndarray:
    """Interleave points with offset tips for normal visualization
    (estimate_normals.py:91-105): (N, 3) -> (2N, 3)."""
    points = np.asarray(points)
    normals = np.asarray(normals)
    offset_points = points + normals * length
    lines = np.empty((2 * points.shape[0], points.shape[1]), dtype=points.dtype)
    lines[::2] = points
    lines[1::2] = offset_points
    return lines
