"""Solver base: functional alignment result + the reference-compatible class shim.

The framework's real API is functional — immutable target pytrees and
pure ``align(target, source, init_T, cfg)`` functions (SURVEY §7 architecture
sketch). This module adds the thin object layer that mirrors the reference
``Registration`` surface (/root/reference/point_cloud_registration/
registration.py:9-112) so reference scripts port with an import change:
``__init__(hyperparams)``, ``set_target``, ``align(source, init_T, verbose)``,
``is_target_set``, ``calc_H_g_e2``.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from point_cloud_registration_tpu.core.gn import GNDiagnostics


class AlignResult(NamedTuple):
    """Transform + structured diagnostics (replaces verbose printing)."""

    T: jax.Array  # (4, 4) f32
    diagnostics: GNDiagnostics


def pad_points(points, bucket: int = 8192) -> tuple[jax.Array, jax.Array]:
    """Pad (N, 3) to the next multiple of ``bucket`` with a validity mask.

    Keeps jit cache churn bounded across scan sizes: shapes quantize to
    buckets instead of recompiling per exact N.
    """
    points = jnp.asarray(points, dtype=jnp.float32)
    n = points.shape[0]
    n_pad = -(-n // bucket) * bucket
    padded = jnp.concatenate([points, jnp.zeros((n_pad - n, 3), jnp.float32)], axis=0)
    w = (jnp.arange(n_pad) < n).astype(jnp.float32)
    return padded, w


class Registration:
    """Reference-compatible stateful wrapper around the functional core.

    Subclasses set ``self._target`` in ``set_target`` and implement
    ``_align_fn(target, source, src_weight, init_T) -> AlignResult`` plus
    ``_stats_fn(target, source, src_weight, T) -> GNStats``.
    """

    def __init__(self, max_iter: int = 30, tol: float = 1e-3):
        self.max_iter = max_iter
        self.tol = tol
        self._target: Any = None
        self.last_diagnostics: GNDiagnostics | None = None

    def is_target_set(self) -> bool:
        return self._target is not None

    def set_target(self, target) -> None:
        raise NotImplementedError("set_target is not implemented.")

    def update_target(self, target) -> None:
        """Incremental map update — declared-but-unimplemented in the
        reference too (registration.py:36-43)."""
        raise NotImplementedError("update_target is not implemented.")

    def _align_fn(self, target, source, src_weight, init_T) -> AlignResult:
        raise NotImplementedError

    def _stats_fn(self, target, source, src_weight, T):
        raise NotImplementedError

    # --- deferred target validity (geometry-hinted builds) ---------------
    # Solvers whose set_target uses ops.voxelize.build_voxel_map_deferred
    # stash the device n_dropped scalar in ``self._pending_drop``; it rides
    # the next host sync for free. Nonzero means the hinted region
    # under-covered the cloud: ``_rebuild_target_exact`` (subclass hook)
    # rebuilds with a fresh bbox and the operation transparently re-runs,
    # so no caller can ever observe a clipped map.

    _pending_drop = None

    def _rebuild_target_exact(self) -> None:
        raise NotImplementedError

    def _verify_target(self) -> None:
        """Force the deferred check NOW (one sync) — for consumers that
        read the target outside align/calc_H_g_e2 (``voxels`` property,
        ``update_target``)."""
        pending = self._pending_drop
        if pending is not None:
            self._pending_drop = None
            if int(jax.device_get(pending)) > 0:
                self._rebuild_target_exact()

    def align(self, source, init_T=None, verbose: bool = False) -> np.ndarray:
        """Gauss-Newton alignment; returns the (4, 4) transform as NumPy.

        Signature and semantics of registration.py:71-112; the per-iteration
        error trace is available in ``self.last_diagnostics`` regardless of
        ``verbose`` (which just prints it afterwards).
        """
        if not self.is_target_set():
            raise ValueError("Target is not set.")
        if init_T is None:
            init_T = np.eye(4)
        src, w = pad_points(source)
        result = self._align_fn(self._target, src, w, jnp.asarray(init_T, jnp.float32))
        # ONE host sync for transform + diagnostics + the deferred target
        # check.
        pending = self._pending_drop
        if pending is not None:
            self._pending_drop = None
            T_np, self.last_diagnostics, nd = jax.device_get(
                (result.T, result.diagnostics, pending)
            )
            if int(nd) > 0:
                # hinted region under-covered the cloud: rebuild exactly
                # and redo — the clipped result must never escape
                self._rebuild_target_exact()
                return self.align(source, init_T, verbose)
        else:
            T_np, self.last_diagnostics = jax.device_get(
                (result.T, result.diagnostics)
            )
        if verbose:
            d = self.last_diagnostics
            for i in range(int(d.iterations)):
                print(f"iter {i}, error {d.e2_history[i]}")
        return np.asarray(T_np, dtype=np.float64)

    def calc_H_g_e2(self, cur_T, source):
        """One linearization at ``cur_T`` -> (H, g, e2) as NumPy.

        Matches the reference test surface (e.g. icp.py:24-57) for
        fused-vs-oracle consistency checks.
        """
        if not self.is_target_set():
            raise ValueError("Target is not set.")
        src, w = pad_points(source)
        stats = self._stats_fn(self._target, src, w, jnp.asarray(cur_T, jnp.float32))
        pending = self._pending_drop
        if pending is not None:
            self._pending_drop = None
            H, g, e2, nd = jax.device_get((stats.H, stats.g, stats.e2, pending))
            if int(nd) > 0:
                self._rebuild_target_exact()
                return self.calc_H_g_e2(cur_T, source)
        else:
            H, g, e2 = jax.device_get((stats.H, stats.g, stats.e2))
        return np.asarray(H, np.float64), np.asarray(g, np.float64), float(e2)
