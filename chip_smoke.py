#!/usr/bin/env python3
"""Smoke run of the registration path on NVIDIA GPUs, checked against plain
float64 references.

    python chip_smoke.py                # one card, the B-01 protocol scale
    python chip_smoke.py --four-cards   # four cards: the multi-device paths

One card runs, in one process and through ``import point_cloud_registration_tpu
as pcr``, at the reference's B-01 protocol scale (a 1.2M-point map and a
100k-point scan offset by t = [0, 0, 0.3], ``max_iter=30``, ``tol=1e-3``,
``voxel_size=1``, ``max_dist=2``):

1. device       — fails unless JAX's first device is a GPU;
2. solvers      — VPlaneICP, NDT, ICP, PlaneICP and FastVPlaneICP, each
                  ``set_target(map)`` -> ``align(scan)``;
3. normals      — ``estimate_normals(map, k=15)``;
4. voxel_filter — ``voxel_filter(map, 1.0)``;
5. batched      — 8 scans of 16k points through ``align_batched_sharded``.

``--four-cards`` runs only the three multi-device paths (data-sharded,
batch-sharded, map-sharded), each against the single-card result on card 0.

Each phase prints one line of its own numbers: compile time of the first call
(first call minus the warm time), the warm wall time (minimum of 3) and its
comparison with the reference. Any failed comparison raises and the script
exits nonzero; on success the last line is the JSON device record.

Tolerances, each with its reason:

* ``STATS_RTOL`` 1e-3 — H/g/e2 at ``init_T`` against the float64 oracle on a
  fixed 2,000-point sample, as ``|a - b| / |b|`` with Frobenius norms. The
  device sums in float32 (relative error ~1e-6 over 2,000 terms); what the
  bar leaves room for is a rare point whose correspondence differs from the
  oracle's (an exact distance tie), each worth ~1/2,000 of the sums.
* ``STEP_TOL`` = ``tol`` — at the returned T the float64 oracle's own
  Gauss-Newton step over the whole scan must be below the solver's
  convergence tolerance: the card stopped where the plain reference stops.

The objective of ICP and PlaneICP is defined by their packed index
(ops/pointgrid.py, models/_point_corr.py): a 1 m block keeps at most
``packed_cap`` (32) of its points, a uniform pseudo-random subsample; a
query's match is the nearest kept point when that lies within
``cell_fine = max_dist / 4``, and otherwise the centroid (PlaneICP: the
plane) of the nearest 1 m proxy voxel of kept points. Their oracle evaluates
exactly that objective in float64; the phase line also prints the step of
an oracle that searches every map point (``exact_nn_step_at_T``), which is
information, not a bar.
* ``T_ATOL`` 1e-3 — two device paths that each converge at ``tol=1e-3``
  agree to that tolerance, element-wise on T.
* ``NORMAL_COS`` 0.99 and ``NORMAL_SHARE_MARGIN`` 0.005 — the packed-window
  k-NN is approximate by design, so the share of sampled normals with
  ``|n . n_ref| >= 0.99`` is compared with the share the same program reaches
  on the CPU backend, in this process, on the same map; the card may lose at
  most half a percentage point to summation order.
* ``VF_ATOL`` 1e-4 — voxel_filter means against the float64 cell means:
  coordinates reach 200 m, where one float32 ulp is 1.5e-5.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

MAX_ITER, TOL, VOXEL, MAX_DIST = 30, 1e-3, 1.0, 2.0
N_MAP, N_SCAN = 1_200_000, 100_000
N_STATS_SAMPLE = 2_000
N_NORMAL_SAMPLE = 20_000
NORMALS_K = 15
BATCH, BATCH_POINTS = 8, 16_384

STATS_RTOL = 1e-3
STEP_TOL = TOL
T_ATOL = 1e-3
NORMAL_COS = 0.99
NORMAL_SHARE_MARGIN = 0.005
VF_ATOL = 1e-4

# solver name -> the objective its float64 oracle evaluates
SOLVERS = {
    "VPlaneICP": "vplane",
    "NDT": "ndt",
    "ICP": "point",
    "PlaneICP": "plane",
    "FastVPlaneICP": "vplane",
}


class SmokeFailure(AssertionError):
    """A phase's result disagreed with its reference."""


def check(ok, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def report(phase: str, **numbers) -> dict:
    print(f"phase {phase}: " + json.dumps(numbers), flush=True)
    return numbers


def timed(fn, reps: int = 3):
    """(last result, first-call seconds, warm seconds = min of ``reps``).

    ``fn`` must block until its device work is done (return host data)."""
    t0 = time.perf_counter()
    out = fn()
    first = time.perf_counter() - t0
    warm = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        warm = min(warm, time.perf_counter() - t0)
    return out, first, warm


def timing(first: float, warm: float) -> dict:
    """First-call and warm seconds; their difference is the compile time
    (near zero when the persistent cache already held the program)."""
    return {"first_s": first, "compile_s": first - warm, "warm_s": warm}


# ---------------------------------------------------------------------------
# float64 references (tests/oracles.py semantics, vectorized, with cKDTree
# nearest searches so they run at the 1.2M-point map size)
# ---------------------------------------------------------------------------


def skew_np(p: np.ndarray) -> np.ndarray:
    """(m, 3) -> (m, 3, 3) cross-product matrices."""
    z = np.zeros(len(p))
    return np.stack(
        [
            np.stack([z, -p[:, 2], p[:, 1]], -1),
            np.stack([p[:, 2], z, -p[:, 0]], -1),
            np.stack([-p[:, 1], p[:, 0], z], -1),
        ],
        axis=-2,
    )


def voxel_oracle(points: np.ndarray, voxel_size: float, min_points: int = 0,
                 with_icov: bool = False) -> dict:
    """Per-cell count/mean/cov ((n-1) divisor) grouped by floor(p / vs)
    (voxel.py:104-148), cells with at least ``min_points`` points only; for
    ``min_points > 0`` also their normals (smallest eigenvector), optionally
    inverse covariances, and a kd-tree over the kept means."""
    from scipy.spatial import cKDTree

    pts = np.asarray(points, np.float64)
    c = np.floor(pts / voxel_size).astype(np.int64)
    c -= c.min(axis=0)
    dims = c.max(axis=0) + 1
    key = c[:, 0] + dims[0] * (c[:, 1] + dims[1] * c[:, 2])
    _, inv, counts = np.unique(key, return_inverse=True, return_counts=True)
    means = np.stack(
        [np.bincount(inv, pts[:, j], minlength=len(counts)) for j in range(3)], -1
    ) / counts[:, None]
    dev = pts - means[inv]
    cov = np.empty((len(counts), 3, 3))
    for i in range(3):
        for j in range(i, 3):
            s = np.bincount(inv, dev[:, i] * dev[:, j], minlength=len(counts))
            cov[:, i, j] = cov[:, j, i] = s / np.maximum(counts - 1, 1)
    keep = counts >= min_points
    out = {"counts": counts[keep], "means": means[keep], "covs": cov[keep]}
    if min_points > 0:
        _, vecs = np.linalg.eigh(out["covs"])
        out["normals"] = vecs[:, :, 0]
        if with_icov:
            out["icovs"] = np.linalg.inv(out["covs"])
        out["tree"] = cKDTree(out["means"])
    return out


def oracle_stats(kind: str, ref: dict, source: np.ndarray, T: np.ndarray,
                 max_dist: float = MAX_DIST):
    """float64 H, g, e2 of one objective at ``T`` over ``source``.

    ``kind``: "point" (icp.py:24-57), "plane" (plane_icp.py:30-69), "vplane"
    (voxelized_plane_icp.py:23-64) or "ndt" (ndt.py:24-57). ``ref`` holds
    the target: ``tree`` + ``points`` (+ ``normals``) for the raw-point
    kinds, a :func:`voxel_oracle` map for the voxel kinds.
    """
    T = np.asarray(T, np.float64)
    R, t = T[:3, :3], T[:3, 3]
    src = np.asarray(source, np.float64)
    q = src @ R.T + t
    dist, idx = ref["tree"].query(q, k=1, workers=-1)
    if kind in ("point", "plane"):
        qt = ref["points"][idx]
        nt = ref["normals"][idx] if kind == "plane" else None
        far = dist >= ref["cell_fine"]
        if far.any():  # beyond the exact tier: the proxy voxel's centroid/plane
            proxy = ref["proxy"]
            dist[far], pidx = proxy["tree"].query(q[far], k=1, workers=-1)
            qt[far] = proxy["means"][pidx]
            if nt is not None:
                nt[far] = proxy["normals"][pidx]
    m = dist < max_dist
    src, q, idx = src[m], q[m], idx[m]
    S = skew_np(src)
    if kind in ("point", "ndt"):
        J = np.concatenate(
            [np.broadcast_to(np.eye(3), (len(src), 3, 3)), -np.einsum("ij,mjk->mik", R, S)],
            axis=-1,
        )  # (m, 3, 6)
        if kind == "point":
            r = q - qt[m]
            return (np.einsum("mki,mkj->ij", J, J), np.einsum("mki,mk->i", J, r),
                    float(np.sum(r * r)))
        d = q - ref["means"][idx]
        ic = ref["icovs"][idx]
        icJ = np.einsum("mkl,mlj->mkj", ic, J)
        icd = np.einsum("mkl,ml->mk", ic, d)
        return (np.einsum("mki,mkj->ij", J, icJ), np.einsum("mki,mk->i", J, icd),
                float(np.sum(d * icd)))
    if kind == "plane":
        n, qt = nt[m], qt[m]
    else:  # vplane
        n, qt = ref["normals"][idx], ref["means"][idx]
    r = np.sum(n * (q - qt), axis=-1)
    J = np.concatenate([n, np.einsum("mij,mj->mi", S, n @ R)], axis=-1)  # S R^T n
    return J.T @ J, J.T @ r, float(r @ r)


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def point_oracle(points: np.ndarray, normals: np.ndarray | None = None, *,
                 corr=None, exact: bool = False, proxy_min_points: int = 1) -> dict:
    """Target of the raw-point objectives under correspondence config
    ``corr`` (default: the solvers' default): on the packed method the
    points the packed index keeps plus their proxy voxels (see the module
    doc); on the grid method, or with ``exact``, every point, nearest
    neighbour only."""
    from scipy.spatial import cKDTree

    from point_cloud_registration_tpu.core.config import CorrespondenceConfig

    corr = corr or CorrespondenceConfig()
    packed = not exact and corr.resolved_method(len(points)) == "packed"
    keep = packed_retained(points, corr) if packed else np.arange(len(points))
    pts = np.asarray(points, np.float64)[keep]
    cell_fine = corr.cell_fine or MAX_DIST / 4
    ref = {"points": pts, "tree": cKDTree(pts),
           "cell_fine": cell_fine if packed else np.inf}
    if normals is not None:
        ref["normals"] = np.asarray(normals, np.float64)[keep]
    if packed:
        ref["proxy"] = voxel_oracle(pts, 2 * cell_fine, min_points=proxy_min_points)
    return ref


def packed_retained(map_np: np.ndarray, corr) -> np.ndarray:
    """Indices of the map points the packed index of ``corr`` holds."""
    import jax

    from point_cloud_registration_tpu.core.config import ICPConfig
    from point_cloud_registration_tpu.models import build_icp_target

    cfg = ICPConfig(max_dist=MAX_DIST, corr=corr)
    idx = np.asarray(jax.device_get(build_icp_target(map_np, cfg).packed.idx_packed))
    return np.unique(idx[idx >= 0])


def pca_normals_np(points: np.ndarray, queries: np.ndarray, k: int) -> np.ndarray:
    """k-NN PCA normals (tests/oracles.py knn_np + pca_normal_np:
    cov = E[pp^T] - mean mean^T, smallest eigenvector)."""
    from scipy.spatial import cKDTree

    pts = np.asarray(points, np.float64)
    _, idx = cKDTree(pts).query(np.asarray(queries, np.float64), k=k, workers=-1)
    nb = pts[idx]  # (m, k, 3)
    mean = nb.mean(axis=1)
    cov = np.einsum("mki,mkj->mij", nb, nb) / k - np.einsum("mi,mj->mij", mean, mean)
    return np.linalg.eigh(cov)[1][:, :, 0]


# ---------------------------------------------------------------------------
# phases (sizes are arguments, so the tests run each at a tiny size)
# ---------------------------------------------------------------------------


def make_solver(pcr, name: str, voxel_size: float = VOXEL):
    common = dict(max_iter=MAX_ITER, max_dist=MAX_DIST, tol=TOL)
    if name in ("VPlaneICP", "NDT", "FastVPlaneICP"):
        return getattr(pcr, name)(voxel_size=voxel_size, **common)
    return getattr(pcr, name)(**common)


def phase_device(require_count: int = 1) -> dict:
    import jax

    from point_cloud_registration_tpu.utils.runtime import (
        card_name_and_power_limit,
        require_gpu,
    )

    devices = require_gpu()
    check(len(devices) >= require_count,
          f"need {require_count} GPUs, JAX found {len(devices)}")
    cards = card_name_and_power_limit()
    print(f"nvidia-smi name, power.limit: {cards}", flush=True)
    return report(
        "device", platform=devices[0].platform, kind=devices[0].device_kind,
        count=len(devices), jax=jax.__version__,
        xla_flags=os.environ.get("XLA_FLAGS", ""), cards=cards,
    )


def phase_solvers(map_np: np.ndarray, scan_np: np.ndarray, *, seed: int,
                  n_sample: int = N_STATS_SAMPLE, voxel_size: float = VOXEL,
                  names=tuple(SOLVERS)) -> dict:
    """Each solver: set_target(map) -> align(scan), checked against the
    float64 oracle of its objective. Returns {name: T}."""
    import point_cloud_registration_tpu as pcr

    rng = np.random.RandomState(seed)
    sample = scan_np[rng.choice(len(scan_np), min(n_sample, len(scan_np)), replace=False)]
    T0 = np.eye(4)
    refs = {}
    if any(SOLVERS[n] in ("vplane", "ndt") for n in names):
        refs["voxel"] = voxel_oracle(map_np, voxel_size, min_points=10, with_icov=True)
    Ts = {}
    for name in names:
        kind = SOLVERS[name]
        solver = make_solver(pcr, name, voxel_size)

        def run():
            solver.set_target(map_np)
            return solver.align(scan_np)

        T, first, warm = timed(run)
        diag = solver.last_diagnostics
        check(bool(diag.converged), f"{name}: not converged in {MAX_ITER} iterations")
        check(np.all(np.isfinite(T)), f"{name}: non-finite T")
        if kind in ("point", "plane"):
            # PlaneICP's normal field is the one its set_target estimated;
            # its proxy voxels need 3 points for a plane
            normals = np.asarray(solver.normal) if kind == "plane" else None
            ref = point_oracle(map_np, normals,
                               proxy_min_points=3 if kind == "plane" else 1)
            exact = point_oracle(map_np, normals, exact=True)
        else:
            ref = refs["voxel"]
        H, g, e2 = solver.calc_H_g_e2(T0, sample)
        Hr, gr, e2r = oracle_stats(kind, ref, sample, T0)
        errs = {"H": rel_err(H, Hr), "g": rel_err(g, gr), "e2": rel_err(e2, e2r)}
        Hs, gs, _ = oracle_stats(kind, ref, scan_np, T)
        step = float(np.linalg.norm(np.linalg.solve(Hs, gs)))
        rec = {
            **timing(first, warm), "iterations": int(diag.iterations),
            "t": [float(x) for x in T[:3, 3]],
            "stats_rel_err": errs, "oracle_step_at_T": step,
        }
        if kind in ("point", "plane"):
            He, ge, _ = oracle_stats(kind, exact, scan_np, T)
            rec["exact_nn_step_at_T"] = float(np.linalg.norm(np.linalg.solve(He, ge)))
        if name == "FastVPlaneICP" and "VPlaneICP" in Ts:
            rec["T_diff_vs_VPlaneICP"] = float(np.abs(T - Ts["VPlaneICP"]).max())
        report(f"solvers.{name}", **rec)
        for key, err in errs.items():
            check(err <= STATS_RTOL, f"{name}: {key} rel err {err:.3g} > {STATS_RTOL}")
        check(step < STEP_TOL, f"{name}: oracle GN step {step:.3g} at T >= tol {STEP_TOL}")
        if "T_diff_vs_VPlaneICP" in rec:
            check(rec["T_diff_vs_VPlaneICP"] <= T_ATOL,
                  f"FastVPlaneICP T differs from VPlaneICP by {rec['T_diff_vs_VPlaneICP']:.3g}")
        Ts[name] = T
    return Ts


def phase_normals(map_np: np.ndarray, *, seed: int, n_sample: int = N_NORMAL_SAMPLE,
                  k: int = NORMALS_K) -> dict:
    """estimate_normals on the default device and, as the pass bar, the same
    program on the CPU backend; both against float64 k-NN PCA normals."""
    import jax

    import point_cloud_registration_tpu as pcr

    normals, first, warm = timed(lambda: pcr.estimate_normals(map_np, k=k))
    check(normals.shape == map_np.shape and np.all(np.isfinite(normals)),
          "normals: non-finite or misshapen output")
    rng = np.random.RandomState(seed)
    sel = rng.choice(len(map_np), min(n_sample, len(map_np)), replace=False)
    ref = pca_normals_np(map_np, map_np[sel], k)

    def share(n):
        return float(np.mean(np.abs(np.sum(n[sel] * ref, axis=-1)) >= NORMAL_COS))

    with jax.default_device(jax.devices("cpu")[0]):
        normals_cpu = pcr.estimate_normals(map_np, k=k)
    rec = report("normals", **timing(first, warm), share=share(normals),
                 cpu_share=share(normals_cpu), sample=len(sel))
    check(rec["share"] >= rec["cpu_share"] - NORMAL_SHARE_MARGIN,
          f"normals: share {rec['share']:.4f} below CPU share {rec['cpu_share']:.4f} "
          f"- {NORMAL_SHARE_MARGIN}")
    return rec


def phase_voxel_filter(map_np: np.ndarray, voxel_size: float = VOXEL) -> dict:
    from scipy.spatial import cKDTree

    import point_cloud_registration_tpu as pcr

    out, first, warm = timed(lambda: pcr.voxel_filter(map_np, voxel_size))
    ref = voxel_oracle(map_np, voxel_size)["means"]
    dist, idx = cKDTree(out.astype(np.float64)).query(ref, k=1, p=np.inf)
    rec = report("voxel_filter", **timing(first, warm), cells=len(out),
                 ref_cells=len(ref), max_abs_err=float(dist.max()))
    check(len(out) == len(ref), f"voxel_filter: {len(out)} cells, reference {len(ref)}")
    check(len(np.unique(idx)) == len(ref), "voxel_filter: cells do not match one to one")
    check(rec["max_abs_err"] <= VF_ATOL,
          f"voxel_filter: mean error {rec['max_abs_err']:.3g} > {VF_ATOL}")
    return rec


def make_batch(map_np: np.ndarray, seed: int, batch: int = BATCH,
               n_points: int = BATCH_POINTS) -> np.ndarray:
    import bench

    return np.stack([
        bench.make_scan(np.random.RandomState(seed + 100 + b), map_np, n_points)
        for b in range(batch)
    ])


def vplane_config(voxel_size: float = VOXEL):
    from point_cloud_registration_tpu.core.config import VPlaneICPConfig

    return VPlaneICPConfig(voxel_size=voxel_size, max_iter=MAX_ITER,
                           max_dist=MAX_DIST, tol=TOL)


def batched_align(map_np, scans, mesh, voxel_size: float = VOXEL):
    """align_batched_sharded over ``mesh`` -> (result, first s, warm s)."""
    import jax
    import jax.numpy as jnp

    from point_cloud_registration_tpu.models import build_vplane_target
    from point_cloud_registration_tpu.parallel import align_batched_sharded

    cfg = vplane_config(voxel_size)
    target = build_vplane_target(map_np, cfg)
    B, n = scans.shape[:2]
    src = jnp.asarray(scans)
    w = jnp.ones((B, n), jnp.float32)
    T0 = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (B, 4, 4))

    def run():
        out = align_batched_sharded("vplane_icp", target, src, w, T0, cfg, mesh)
        return jax.device_get(out)

    return timed(run)


def phase_batched(map_np: np.ndarray, *, seed: int, batch: int = BATCH,
                  n_points: int = BATCH_POINTS, voxel_size: float = VOXEL) -> dict:
    import point_cloud_registration_tpu as pcr
    from point_cloud_registration_tpu.parallel import make_mesh

    scans = make_batch(map_np, seed, batch, n_points)
    out, first, warm = batched_align(map_np, scans, make_mesh(batch=1, data=1),
                                     voxel_size)
    solver = make_solver(pcr, "VPlaneICP", voxel_size)
    solver.set_target(map_np)
    diff = max(float(np.abs(out.T[b] - solver.align(scans[b])).max())
               for b in range(batch))
    rec = report("batched", **timing(first, warm), regs_per_s=batch / warm,
                 converged=int(np.sum(out.diagnostics.converged)),
                 T_diff_vs_single=diff)
    check(np.all(out.diagnostics.converged), "batched: a problem did not converge")
    check(diff <= T_ATOL, f"batched: T differs from single align by {diff:.3g}")
    return rec


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------


def check_spread(name: str, arr, devices) -> None:
    """Every addressable shard of ``arr`` sits on its own device of
    ``devices``, and together they cover all of them."""
    on = [s.device for s in arr.addressable_shards]
    check(len(set(on)) == len(on) == len(devices) and set(on) == set(devices),
          f"{name}: shards on {on}, expected one on each of {list(devices)}")


def phase_four_cards(map_np: np.ndarray, scan_np: np.ndarray, *, seed: int,
                     devices, batch: int = BATCH, n_points: int = BATCH_POINTS,
                     voxel_size: float = VOXEL) -> dict:
    """Data-, batch- and map-sharded align on ``devices`` (4), each against
    the single-card result on ``devices[0]``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from point_cloud_registration_tpu.models import build_vplane_target
    from point_cloud_registration_tpu.models.base import pad_points
    from point_cloud_registration_tpu.parallel import (
        align_map_sharded,
        align_sharded,
        make_map_mesh,
        make_mesh,
        shard_voxel_map_on_mesh,
    )

    n_dev = len(devices)
    cfg = vplane_config(voxel_size)
    eye = jnp.eye(4, dtype=jnp.float32)
    src, w = pad_points(scan_np)
    one = make_mesh(batch=1, data=1, devices=devices[:1])
    target = build_vplane_target(map_np, cfg)
    single = jax.device_get(
        align_sharded("vplane_icp", target, src, w, eye, cfg, one).T)

    # data-sharded: scan points over a (1, 4) mesh, GN stats psum'd
    mesh = make_mesh(batch=1, data=n_dev, devices=devices)
    src_s = jax.device_put(src, NamedSharding(mesh, P("data")))
    w_s = jax.device_put(w, NamedSharding(mesh, P("data")))
    check_spread("data-sharded scan", src_s, devices)

    def run_data():
        return jax.device_get(
            align_sharded("vplane_icp", target, src_s, w_s, eye, cfg, mesh).T)

    T, first, warm = timed(run_data)
    diff = float(np.abs(T - single).max())
    report("four_cards.data_sharded", **timing(first, warm), T_diff_vs_card0=diff)
    check(diff <= T_ATOL, f"data-sharded T differs from card 0 by {diff:.3g}")

    # batch-sharded: 8 scans over a (4, 1) mesh
    scans = make_batch(map_np, seed, batch, n_points)
    ref, _, _ = batched_align(map_np, scans, one, voxel_size)
    out, first, warm = batched_align(
        map_np, scans, make_mesh(batch=n_dev, data=1, devices=devices), voxel_size)
    diff = float(np.abs(out.T - ref.T).max())
    report("four_cards.batch_sharded", **timing(first, warm),
           regs_per_s=len(scans) / warm, T_diff_vs_card0=diff)
    check(diff <= T_ATOL, f"batch-sharded T differs from card 0 by {diff:.3g}")

    # map-sharded: voxel slabs over a model=4 mesh, built on their own cards
    mmesh = make_map_mesh(model=n_dev, data=1, devices=devices)
    svm, meta = shard_voxel_map_on_mesh(map_np, voxel_size, mmesh)
    for field in ("means", "dense_blocks"):
        arr = getattr(svm, field)
        check_spread(f"map slab {field}", arr, devices)
        check(all(s.data.shape[0] == 1 for s in arr.addressable_shards),
              f"map slab {field}: a card holds more than its own slab")

    def run_map():
        return jax.device_get(
            align_map_sharded("vplane_icp", svm, meta, src, w, eye, cfg, mmesh).T)

    T, first, warm = timed(run_map)
    diff = float(np.abs(T - single).max())
    in_use = [(d.memory_stats() or {}).get("bytes_in_use") for d in devices]
    report("four_cards.map_sharded", **timing(first, warm), T_diff_vs_card0=diff,
           shard_axis=meta.axis, bytes_in_use=in_use)
    check(diff <= T_ATOL, f"map-sharded T differs from card 0 by {diff:.3g}")
    return {"devices": n_dev}


# ---------------------------------------------------------------------------


def make_problem(seed: int, n_map: int = N_MAP, n_scan: int = N_SCAN):
    import bench

    rng = np.random.RandomState(seed)
    map_np = bench.make_city_map(rng, n_map)
    return map_np, bench.make_scan(rng, map_np, n_scan)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device phases, on 4 GPUs")
    args = ap.parse_args(argv)

    from point_cloud_registration_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    try:
        dev = phase_device(require_count=4 if args.four_cards else 1)
    except (RuntimeError, SmokeFailure) as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    import jax

    map_np, scan_np = make_problem(args.seed)
    if args.four_cards:
        devices = jax.devices()[:4]
        phase_four_cards(map_np, scan_np, seed=args.seed, devices=devices)
        count = len(devices)
    else:
        phase_solvers(map_np, scan_np, seed=args.seed)
        phase_normals(map_np, seed=args.seed)
        phase_voxel_filter(map_np)
        phase_batched(map_np, seed=args.seed)
        count = dev["count"]
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"], "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
