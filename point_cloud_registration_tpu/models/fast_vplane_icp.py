"""Coreset-accelerated voxelized plane ICP.

A working realization of the reference's *experimental, bit-rotted* intent
(/root/reference/point_cloud_registration/fast_voxelized_plane_icp.py:22-99,
see SURVEY §2 C12): run full-cloud Gauss-Newton until the step shrinks below
a switch threshold, then extract an exact Caratheodory coreset of the current
linearization (<= N_target weighted points reproducing H/g/e^2 exactly at the
switch transform) and finish the iterations on the coreset.

Structure: THREE device programs and TWO host syncs in total, so the
number of host round trips does not grow with the phase-one iteration
count:

* phase 1 is ONE on-device GN program — the plain solver's align
  (models/voxelized_plane_icp.vplane_align) with the switch threshold as
  its convergence tolerance, so the data-dependent switch is observed once
  at the end instead of per iteration;
* the linearization at the switch transform is fetched in the SAME sync as
  phase 1's result, and the float64 Caratheodory lift runs on the host by
  design (exactness needs f64 — models/coreset.py);
* phase 2 is one fixed-shape jitted GN program over the N_target coreset
  (dynamic iteration budget = max_iter - phase-1 iterations).

Phase-boundary semantics vs the reference loop: the reference applies the
switch iteration's step and reuses its (J, r, w) for the lift. Here phase 1
freezes T on the breaking step (core/gn contract) and the lift runs at that
frozen transform; because the coreset reproduces H/g exactly there, phase 2's
first step IS the step the reference applied — one extra (cheap, N_target-
sized) linearization in exchange for zero per-iteration host rounds.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from point_cloud_registration_tpu.core.config import VPlaneICPConfig
from point_cloud_registration_tpu.core.gn import (
    GNDiagnostics,
    GNStats,
    solve_6x6,
)
from point_cloud_registration_tpu.core.se3 import (
    makeRt,
    plus,
    skew_time_vector,
    transform_points,
)
from point_cloud_registration_tpu.models.base import Registration, pad_points
from point_cloud_registration_tpu.models.coreset import create_gn_set, fast_caratheodory
from point_cloud_registration_tpu.models.voxelized_plane_icp import (
    _vplane_stats_jit,
    build_vplane_target_deferred,
    vplane_align,
)
from point_cloud_registration_tpu.ops.reduce import reduce_H_g_e2
from point_cloud_registration_tpu.ops.voxelize import VoxelMap, query_nearest_voxel


@partial(jax.jit, static_argnames=("cfg",))
def vplane_linearize(vmap_: VoxelMap, source, src_weight, T, cfg: VPlaneICPConfig):
    """Materialized (J (N,6), r (N,), w (N,)) for the plane residual.

    The explicit-Jacobian form of the fused path
    (fast_voxelized_plane_icp.py:40-54) — needed because the coreset lift
    consumes per-point (J, r).
    """
    R, _ = makeRt(T)
    src_trans = transform_points(T, source)
    nn = query_nearest_voxel(
        vmap_,
        src_trans,
        voxel_size=cfg.voxel_size,
        max_dist=cfg.max_dist,
        fixed_tiers=cfg.fixed_tiers,
    )
    w = src_weight * (nn.dist < cfg.max_dist) * (nn.idx >= 0)
    safe = jnp.clip(nn.idx, 0, vmap_.means.shape[0] - 1)
    means = vmap_.means[safe]
    norms = vmap_.normals[safe]
    diff = src_trans - means
    r = jnp.sum(norms * diff, axis=-1)
    Rt_n = jnp.einsum("nj,ji->ni", norms, R, precision=jax.lax.Precision.HIGHEST)
    Jr = skew_time_vector(source, Rt_n)
    J = jnp.concatenate([norms, Jr], axis=-1)
    return J, r, w


@jax.jit
def _gn_step_from_stats(T, H, g):
    dx = solve_6x6(H, g)
    dx_norm = jnp.linalg.norm(dx)
    return plus(T, dx), dx_norm


@jax.jit
def _weighted_stats(J, r, w):
    H, g, e2 = reduce_H_g_e2(J, r, w)
    return GNStats(H=H, g=g, e2=e2, n_inliers=jnp.sum(w))


@partial(jax.jit, static_argnames=("cfg", "max_iter"))
def _phase2_align(vmap_, src_sub, w_sub, init_T, iters_left, cfg, max_iter: int):
    """Coreset GN: fixed-shape program, DYNAMIC iteration budget.

    ``iters_left`` is a device scalar (max_iter minus phase 1's count) so a
    varying phase-1 length never recompiles phase 2. Histories are sized by
    the static ``max_iter`` and merged with phase 1's host-side.
    """
    live = (w_sub > 0).astype(jnp.float32)

    def stats_fn(T):
        J, r, w_lin = _linearize_body(vmap_, src_sub, live, T, cfg)
        # coreset weights carry the moment-preserving scale; the
        # linearization gate re-applies max_dist masking
        wsc = w_sub * (w_lin > 0)
        H, g, e2 = reduce_H_g_e2(J, r, wsc)
        return GNStats(H=H, g=g, e2=e2, n_inliers=jnp.sum(wsc))

    def cond(c):
        T, it, done = c[0], c[1], c[2]
        return jnp.logical_and(it < iters_left, jnp.logical_not(done))

    def body(c):
        T, it, done, failed, conv, e2h, dxh, inh, fin = c
        stats = stats_fn(T)
        dx = solve_6x6(stats.H, stats.g)
        dx_norm = jnp.linalg.norm(dx)
        bad = jnp.logical_not(jnp.isfinite(dx_norm))
        conv_now = dx_norm < cfg.tol
        done_now = jnp.logical_or(conv_now, bad)
        T_new = jnp.where(done_now, T, plus(T, dx))
        return (
            T_new,
            it + 1,
            done_now,
            jnp.logical_or(failed, bad),
            jnp.logical_or(conv, conv_now),
            e2h.at[it].set(stats.e2),
            dxh.at[it].set(dx_norm),
            inh.at[it].set(stats.n_inliers.astype(jnp.int32)),
            stats.e2,
        )

    zero = jnp.float32(0)
    init = (
        jnp.asarray(init_T, jnp.float32),
        jnp.int32(0),
        jnp.asarray(False),
        jnp.asarray(False),
        jnp.asarray(False),
        jnp.zeros((max_iter,), jnp.float32),
        jnp.zeros((max_iter,), jnp.float32),
        jnp.zeros((max_iter,), jnp.int32),
        zero,
    )
    T, it, _, failed, conv, e2h, dxh, inh, fin = jax.lax.while_loop(cond, body, init)
    return T, it, failed, conv, e2h, dxh, inh, fin


def _linearize_body(vmap_, source, src_weight, T, cfg):
    """vplane_linearize's traced body (shared by the jitted wrapper above —
    calling the jitted function inside another jit would nest dispatch)."""
    R, _ = makeRt(T)
    src_trans = transform_points(T, source)
    nn = query_nearest_voxel(
        vmap_, src_trans, voxel_size=cfg.voxel_size, max_dist=cfg.max_dist,
        fixed_tiers=cfg.fixed_tiers,
    )
    w = src_weight * (nn.dist < cfg.max_dist) * (nn.idx >= 0)
    safe = jnp.clip(nn.idx, 0, vmap_.means.shape[0] - 1)
    means = vmap_.means[safe]
    norms = vmap_.normals[safe]
    diff = src_trans - means
    r = jnp.sum(norms * diff, axis=-1)
    Rt_n = jnp.einsum("nj,ji->ni", norms, R, precision=jax.lax.Precision.HIGHEST)
    Jr = skew_time_vector(source, Rt_n)
    J = jnp.concatenate([norms, Jr], axis=-1)
    return J, r, w


class FastVPlaneICP(Registration):
    """Reference-compatible shim (fast_voxelized_plane_icp.py:23-30 signature)."""

    # Breakeven for the "auto" coreset mode, in remaining GN iterations.
    # Both sides scale linearly in the live-point count n, so the ratio is
    # scale-free: the host float64 Caratheodory lift must cost less than the
    # full-cloud iterations it saves. 48 exceeds any max_iter=30 run, so
    # "auto" runs phase 1 only (== plain VPlaneICP); "always" forces the
    # coreset. Where the crossover lies on the current device is an open
    # measurement (ROADMAP S6).
    CORESET_BREAKEVEN_ITERS = 48

    def __init__(
        self,
        voxel_size: float = 1.0,
        max_iter: int = 30,
        max_dist: float = 2,
        tol: float = 1e-3,
        N_target: int = 1024,
        debug: bool = False,
        coreset_switch: float = 1e-2,
        coreset_clusters: int = 64,
        coreset: str = "auto",
    ):
        super().__init__(max_iter=max_iter, tol=tol)
        if coreset not in ("auto", "always", "never"):
            raise ValueError(f"unknown coreset mode {coreset!r}")
        self.voxel_size = voxel_size
        self.max_dist = max_dist
        self.N_target = N_target
        self.debug = debug
        self.coreset_switch = coreset_switch  # switch heuristic (ref :63, 1e-2)
        self.coreset_clusters = coreset_clusters  # ref :34 (k=64)
        self.coreset_mode = coreset
        self.cfg = VPlaneICPConfig(
            voxel_size=voxel_size, max_iter=max_iter, max_dist=max_dist, tol=tol
        )

    def set_target(self, target) -> None:
        self._target_pts = target
        self._target, self._pending_drop = build_vplane_target_deferred(
            target, self.cfg
        )

    def _rebuild_target_exact(self) -> None:
        self._target, _ = build_vplane_target_deferred(
            self._target_pts, self.cfg, use_hint=False
        )

    def _stats_fn(self, target, source, src_weight, T) -> GNStats:
        # the objective is plain VPlaneICP's (calc_H_g_e2)
        return _vplane_stats_jit(target, source, src_weight, T, self.cfg)

    def align(self, source, init_T=None, verbose: bool = False) -> np.ndarray:
        if not self.is_target_set():
            raise ValueError("Target is not set.")
        if init_T is None:
            init_T = np.eye(4)
        src, w_src = pad_points(source)
        T0 = jnp.asarray(init_T, jnp.float32)

        # Phase 1: full-cloud GN to the switch threshold, ONE device program.
        # In "auto"/"never" mode (see CORESET_BREAKEVEN_ITERS) phase 1 runs
        # at the TRUE tolerance — there is no switch to observe, so the
        # align is exactly plain VPlaneICP plus nothing.
        may_engage = self.coreset_mode == "always" or (
            self.coreset_mode == "auto"
            and self.max_iter > self.CORESET_BREAKEVEN_ITERS
        )
        switch = max(self.coreset_switch, self.tol) if may_engage else self.tol
        cfg1 = dataclasses.replace(self.cfg, tol=switch)
        phase1 = vplane_align(self._target, src, w_src, T0, cfg1)
        T1, diag1 = phase1.T, phase1.diagnostics
        if may_engage:
            # Linearize at the switch transform for the coreset lift; fetch
            # it in the SAME host sync as phase 1's outcome (+ the
            # deferred-build validity scalar when one is pending).
            J, r, w = vplane_linearize(self._target, src, w_src, T1, self.cfg)
            fetch = (T1, diag1, J, r, w)
        else:
            fetch = (T1, diag1)
        pending = self._pending_drop
        self._pending_drop = None
        if pending is not None:
            (*got, nd) = jax.device_get((*fetch, pending))
            if int(nd) > 0:
                self._rebuild_target_exact()
                return self.align(source, init_T, verbose)
        else:
            got = jax.device_get(fetch)
        if may_engage:
            T1_np, diag1_np, J_np, r_np, w_np = got
        else:
            T1_np, diag1_np = got
        iters1 = int(diag1_np.iterations)
        iters_left = self.max_iter - iters1

        def finish(T_np, diag):
            self.last_diagnostics = diag
            if verbose or self.debug:
                for i in range(int(diag.iterations)):
                    print(
                        f"iter {i}, points {diag.inlier_history[i]}, "
                        f"error {diag.e2_history[i]}"
                    )
            return np.asarray(T_np, dtype=np.float64)

        # Coreset disabled, no budget left, solver failure, already at the
        # TRUE tolerance, or never reached the switch: phase 1's answer
        # stands (the reference only switches when the step actually shrank
        # below the threshold).
        reached_switch = bool(diag1_np.converged) and not bool(diag1_np.solver_failed)
        true_converged = (
            iters1 > 0 and float(diag1_np.dx_norm_history[iters1 - 1]) < self.tol
        )
        if (not may_engage or iters_left <= 0 or not reached_switch
                or true_converged):
            return finish(T1_np, diag1_np)

        # Host-side float64 Caratheodory lift at the frozen switch transform.
        live = np.where(w_np > 0)[0]
        if len(live) == 0:
            return finish(T1_np, diag1_np)
        P = create_gn_set(J_np[live], r_np[live])
        _, w_core, sel = fast_caratheodory(
            P, w_np[live].astype(np.float64), self.coreset_clusters, self.N_target
        )
        chosen = live[sel]
        src_np = np.asarray(jax.device_get(src))[chosen]
        pad = self.N_target - len(chosen)
        if pad > 0:
            src_np = np.vstack([src_np, np.zeros((pad, 3), np.float32)])
            w_core = np.concatenate([w_core, np.zeros(pad)])

        # Phase 2: coreset GN, one fixed-shape program, dynamic budget.
        T2, it2, failed2, conv2, e2h2, dxh2, inh2, fin2 = jax.device_get(
            _phase2_align(
                self._target,
                jnp.asarray(src_np, jnp.float32),
                jnp.asarray(w_core, jnp.float32),
                jnp.asarray(T1_np, jnp.float32),
                jnp.int32(iters_left),
                self.cfg,
                self.max_iter,
            )
        )
        it2 = int(it2)
        iterations = iters1 + it2
        e2_hist = np.zeros(self.max_iter, np.float32)
        dxn_hist = np.zeros(self.max_iter, np.float32)
        inl_hist = np.zeros(self.max_iter, np.int32)
        e2_hist[:iters1] = diag1_np.e2_history[:iters1]
        dxn_hist[:iters1] = diag1_np.dx_norm_history[:iters1]
        inl_hist[:iters1] = diag1_np.inlier_history[:iters1]
        e2_hist[iters1:iterations] = e2h2[:it2]
        dxn_hist[iters1:iterations] = dxh2[:it2]
        inl_hist[iters1:iterations] = inh2[:it2]
        diag = GNDiagnostics(
            iterations=np.int32(iterations),
            converged=np.bool_(bool(conv2)),
            solver_failed=np.bool_(bool(failed2)),
            e2_history=e2_hist,
            dx_norm_history=dxn_hist,
            inlier_history=inl_hist,
            final_e2=np.float32(fin2 if it2 > 0 else diag1_np.final_e2),
        )
        return finish(T2, diag)
