"""Sharded and batched alignment via ``shard_map`` + ``psum``.

The device realization of SURVEY §2.3's mandated parallelism:

* **data parallel**: scan points are sharded over the mesh's ``data`` axis;
  every solver's per-iteration statistics (H, g, e2, n) are linear in the
  points, so a ``psum`` of the per-shard partial sums reconstructs the exact
  single-device normal equations. The whole Gauss-Newton ``while_loop`` runs
  *inside* ``shard_map`` — each device executes the identical trajectory after
  the all-reduce, so there is exactly one ~40-float collective per iteration
  and zero host round-trips.
* **batch parallel**: ``vmap`` over (scan, init_T) problems within a shard,
  problems sharded over the ``batch`` axis — many registrations per step
  against a replicated map (SLAM front-end throughput,
  BASELINE.json configs[4]).

The target map pytree is passed replicated (in_spec ``P()``), so these
wrappers work unchanged for every solver family.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from point_cloud_registration_tpu.core.gn import GNStats, gauss_newton
from point_cloud_registration_tpu.models.base import AlignResult
from point_cloud_registration_tpu.models.icp import icp_stats
from point_cloud_registration_tpu.models.ndt import ndt_solver_stats
from point_cloud_registration_tpu.models.plane_icp import plane_icp_stats
from point_cloud_registration_tpu.models.voxelized_plane_icp import vplane_stats

# Solver registry: kind -> stats(target, source, src_weight, T, cfg) -> GNStats.
# (The config/registry replacement for the reference's edit-the-source backend
# flag, SURVEY §5.)
STATS_FNS: dict[str, Callable] = {
    "icp": icp_stats,
    "plane_icp": plane_icp_stats,
    "vplane_icp": vplane_stats,
    "ndt": ndt_solver_stats,
}


def _psum_stats(stats: GNStats, axis: str) -> GNStats:
    return GNStats(
        H=jax.lax.psum(stats.H, axis),
        g=jax.lax.psum(stats.g, axis),
        e2=jax.lax.psum(stats.e2, axis),
        n_inliers=jax.lax.psum(stats.n_inliers, axis),
    )


@partial(jax.jit, static_argnames=("kind", "cfg", "mesh"))
def align_sharded(kind, target, source, src_weight, init_T, cfg, mesh: Mesh) -> AlignResult:
    """One alignment with scan points sharded over the mesh's ``data`` axis.

    ``source``/``src_weight`` leading dim must divide by the data-axis size
    (use ``models.base.pad_points`` — padding weight 0 contributes nothing).
    """
    stats_fn_kind = STATS_FNS[kind]

    def shard_fn(source_s, w_s, T0):
        def stats_fn(T):
            return _psum_stats(stats_fn_kind(target, source_s, w_s, T, cfg), "data")

        T, diag = gauss_newton(stats_fn, T0, cfg.max_iter, cfg.tol)
        return AlignResult(T=T, diagnostics=diag)

    return jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P("data"), P("data"), P()),
        out_specs=P(),
    )(source, src_weight, init_T)


@partial(jax.jit, static_argnames=("kind", "cfg", "mesh"))
def align_batched_sharded(
    kind, target, sources, src_weights, init_Ts, cfg, mesh: Mesh
) -> AlignResult:
    """Batched multi-scan registration: problems sharded over ``batch``,
    each problem's points sharded over ``data``.

    ``sources``: (B, N, 3); ``src_weights``: (B, N); ``init_Ts``: (B, 4, 4).
    Returns stacked results with leading dim B.
    """
    import dataclasses

    if hasattr(cfg, "fixed_tiers") and not cfg.fixed_tiers:
        # under vmap, data-dependent tier switching executes every branch per
        # problem — force the data-independent variant
        cfg = dataclasses.replace(cfg, fixed_tiers=True)
    stats_fn_kind = STATS_FNS[kind]

    def one(source_s, w_s, T0):
        def stats_fn(T):
            return _psum_stats(stats_fn_kind(target, source_s, w_s, T, cfg), "data")

        T, diag = gauss_newton(stats_fn, T0, cfg.max_iter, cfg.tol)
        return AlignResult(T=T, diagnostics=diag)

    def shard_fn(sources_s, weights_s, T0_s):
        return jax.vmap(one)(sources_s, weights_s, T0_s)

    return jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P("batch", "data"), P("batch", "data"), P("batch")),
        out_specs=P("batch"),
    )(sources, src_weights, init_Ts)
