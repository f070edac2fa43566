"""Independent NumPy/SciPy oracles reproducing the reference semantics.

These are written from the algorithm definitions (see SURVEY.md §2/§3 and the
reference file:line cites in each docstring) as straightforward float64
NumPy — deliberately naive, loop-or-einsum style — so the device implementations
can be checked against a second, independently-written realization of the same
math. This mirrors the reference's own "fused vs naive" test pattern
(tests/test_icp.py:20-38 in the reference).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def exp_so3_np(omega: np.ndarray) -> np.ndarray:
    """Rodrigues with the reference's small-angle branch (math_tools.py:80-98)."""
    omega = np.asarray(omega, dtype=np.float64)
    theta2 = float(omega @ omega)
    W = np.array(
        [
            [0.0, -omega[2], omega[1]],
            [omega[2], 0.0, -omega[0]],
            [-omega[1], omega[0], 0.0],
        ]
    )
    if theta2 <= 1e-5:
        return np.eye(3) + W
    theta = np.sqrt(theta2)
    K = W / theta
    return np.eye(3) + np.sin(theta) * K + (1.0 - np.cos(theta)) * (K @ K)


def make_T_np(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def plus_np(T: np.ndarray, dx: np.ndarray) -> np.ndarray:
    """Boxplus T @ makeT(exp(dx[3:]), dx[:3]) (math_tools.py:101-108)."""
    return T @ make_T_np(exp_so3_np(dx[3:]), dx[:3])


def transform_np(T: np.ndarray, points: np.ndarray) -> np.ndarray:
    return points @ T[:3, :3].T + T[:3, 3]


def voxel_stats_np(points: np.ndarray, voxel_size: float):
    """Per-voxel count/mean/cov grouped by floor(p / vs) (voxel.py:104-148).

    Returns dict: cell tuple -> (count, mean, cov 3x3 with (n-1) divisor).
    """
    coords = np.floor(np.asarray(points, np.float64) / voxel_size).astype(np.int64)
    out = {}
    order = {}
    for i, c in enumerate(map(tuple, coords)):
        order.setdefault(c, []).append(i)
    for c, idxs in order.items():
        pts = points[idxs].astype(np.float64)
        n = len(idxs)
        mean = pts.mean(axis=0)
        dev = pts - mean
        cov = dev.T @ dev / max(n - 1, 1)
        out[c] = (n, mean, cov)
    return out


def icp_stats_np(target, source, T, max_dist):
    """Point-to-point H/g/e2 with kd-tree gating (icp.py:24-57), float64 loop."""
    tree = cKDTree(np.asarray(target, np.float64))
    src_trans = transform_np(T, np.asarray(source, np.float64))
    dist, idx = tree.query(src_trans, k=1)
    mask = dist < max_dist
    R = T[:3, :3]
    H = np.zeros((6, 6))
    g = np.zeros(6)
    e2 = 0.0
    for i in np.where(mask)[0]:
        p = source[i].astype(np.float64)
        S = np.array([[0, -p[2], p[1]], [p[2], 0, -p[0]], [-p[1], p[0], 0]])
        J = np.hstack([np.eye(3), -R @ S])
        r = src_trans[i] - target[idx[i]]
        H += J.T @ J
        g += J.T @ r
        e2 += r @ r
    return H, g, e2, int(mask.sum())


def plane_stats_np(target, normals, source, T, max_dist):
    """Point-to-plane H/g/e2 (plane_icp.py:30-69), float64 loop."""
    tree = cKDTree(np.asarray(target, np.float64))
    src_trans = transform_np(T, np.asarray(source, np.float64))
    dist, idx = tree.query(src_trans, k=1)
    mask = dist < max_dist
    R = T[:3, :3]
    H = np.zeros((6, 6))
    g = np.zeros(6)
    e2 = 0.0
    for i in np.where(mask)[0]:
        p = source[i].astype(np.float64)
        n = normals[idx[i]].astype(np.float64)
        q = target[idx[i]].astype(np.float64)
        S = np.array([[0, -p[2], p[1]], [p[2], 0, -p[0]], [-p[1], p[0], 0]])
        r = n @ (src_trans[i] - q)
        J = np.concatenate([n, S @ (R.T @ n)])
        H += np.outer(J, J)
        g += J * r
        e2 += r * r
    return H, g, e2, int(mask.sum())


def make_scene(rng, n_floor=4000, n_wall=2000, extent=10.0, height=3.0, noise=0.01):
    """Structured 'room' scene (floor + two walls) — dense enough for voxel
    statistics (>= 10 pts per 1m voxel) and geometrically constrained in all
    six DoF so every solver can converge."""
    floor = np.stack(
        [
            rng.rand(n_floor) * extent,
            rng.rand(n_floor) * extent,
            rng.randn(n_floor) * noise,
        ],
        axis=1,
    )
    wall_y = np.stack(
        [
            rng.rand(n_wall) * extent,
            rng.randn(n_wall) * noise,
            rng.rand(n_wall) * height,
        ],
        axis=1,
    )
    wall_x = np.stack(
        [
            rng.randn(n_wall) * noise,
            rng.rand(n_wall) * extent,
            rng.rand(n_wall) * height,
        ],
        axis=1,
    )
    # a sloped panel pins the remaining symmetry
    panel = np.stack(
        [
            rng.rand(n_wall) * 3 + 5,
            rng.rand(n_wall) * 3 + 5,
            0.4 * (rng.rand(n_wall) * 3) + 0.5,
        ],
        axis=1,
    )
    panel[:, 2] += rng.randn(n_wall) * noise
    return np.vstack([floor, wall_y, wall_x, panel]).astype(np.float32)


def make_scan(rng, map_points, dx, n_points=3000, noise=0.005):
    """Benchmark-style scan: transformed random subsample + Gaussian noise
    (benchmark/test_data.py:21-44 protocol)."""
    T = plus_np(np.eye(4), np.asarray(dx, np.float64))
    sel = rng.choice(len(map_points), size=min(n_points, len(map_points)), replace=False)
    scan = transform_np(T, map_points[sel].astype(np.float64))
    scan = scan + rng.randn(*scan.shape) * noise
    return scan.astype(np.float32), T


def gn_align_np(stats_fn, init_T=None, max_iter=30, tol=1e-3):
    """Reference GN loop oracle (registration.py:89-111 ordering)."""
    T = np.eye(4) if init_T is None else np.asarray(init_T, np.float64)
    iters = 0
    for _ in range(max_iter):
        H, g, e2 = stats_fn(T)[:3]
        iters += 1
        dx = -np.linalg.solve(H, g)
        if np.linalg.norm(dx) < tol:
            break
        T = plus_np(T, dx)
    return T, iters


def voxel_map_np(points, voxel_size, min_points=10):
    """Valid-voxel arrays: (means, covs, normals, icovs) in insertion order."""
    stats = voxel_stats_np(points, voxel_size)
    means, covs = [], []
    for n, mean, cov in stats.values():
        if n >= min_points:
            means.append(mean)
            covs.append(cov)
    means = np.array(means)
    covs = np.array(covs)
    _, vecs = np.linalg.eigh(covs)
    normals = vecs[:, :, 0]
    icovs = np.linalg.inv(covs)
    return means, covs, normals, icovs


def vplane_stats_np(means, normals, source, T, max_dist):
    """Voxelized plane H/g/e2: nearest-centroid correspondence
    (voxelized_plane_icp.py:23-64), float64 loop."""
    src_trans = transform_np(T, np.asarray(source, np.float64))
    d2 = ((src_trans[:, None, :] - means[None, :, :]) ** 2).sum(-1)
    idx = d2.argmin(axis=1)
    dist = np.sqrt(d2[np.arange(len(idx)), idx])
    mask = dist < max_dist
    R = T[:3, :3]
    H = np.zeros((6, 6))
    g = np.zeros(6)
    e2 = 0.0
    for i in np.where(mask)[0]:
        p = source[i].astype(np.float64)
        n = normals[idx[i]]
        mu = means[idx[i]]
        S = np.array([[0, -p[2], p[1]], [p[2], 0, -p[0]], [-p[1], p[0], 0]])
        r = n @ (src_trans[i] - mu)
        J = np.concatenate([n, S @ (R.T @ n)])
        H += np.outer(J, J)
        g += J * r
        e2 += r * r
    return H, g, e2, int(mask.sum())


def ndt_stats_np(means, icovs, source, T, max_dist):
    """NDT H/g/e2: nearest-centroid + Mahalanobis (ndt.py:24-57), float64."""
    src_trans = transform_np(T, np.asarray(source, np.float64))
    d2 = ((src_trans[:, None, :] - means[None, :, :]) ** 2).sum(-1)
    idx = d2.argmin(axis=1)
    dist = np.sqrt(d2[np.arange(len(idx)), idx])
    mask = dist < max_dist
    R = T[:3, :3]
    H = np.zeros((6, 6))
    g = np.zeros(6)
    e2 = 0.0
    for i in np.where(mask)[0]:
        p = source[i].astype(np.float64)
        S = np.array([[0, -p[2], p[1]], [p[2], 0, -p[0]], [-p[1], p[0], 0]])
        J = np.hstack([np.eye(3), -R @ S])
        d = src_trans[i] - means[idx[i]]
        ic = icovs[idx[i]]
        H += J.T @ ic @ J
        g += J.T @ ic @ d
        e2 += d @ ic @ d
    return H, g, e2, int(mask.sum())


def knn_np(points, queries, k):
    """Exact k-NN oracle via scipy cKDTree."""
    tree = cKDTree(np.asarray(points, np.float64))
    dist, idx = tree.query(np.asarray(queries, np.float64), k=k)
    if k == 1:
        dist, idx = dist[:, None], idx[:, None]
    return dist, idx


def pca_normal_np(neighbor_pts):
    """Smallest-eigenvector normal of a neighborhood, k-divisor covariance
    (estimate_normals.py:55-77 semantics: cov = E[pp^T] - mean mean^T)."""
    pts = np.asarray(neighbor_pts, np.float64)
    mean = pts.mean(axis=0)
    cov = pts.T @ pts / len(pts) - np.outer(mean, mean)
    _, vecs = np.linalg.eigh(cov)
    return vecs[:, 0]
