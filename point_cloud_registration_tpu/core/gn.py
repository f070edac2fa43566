"""On-device Gauss-Newton driver for SE(3) registration.

Device re-design of the reference optimizer loop
(/root/reference/point_cloud_registration/registration.py:71-112): the Python
``for``-loop with a data-dependent ``break`` becomes a ``jax.lax.while_loop``
whose carry holds the transform, so a full ``align`` — correspondence search,
linearization, 6x6 solve, convergence test — compiles to a single XLA program
with no host round-trips per iteration.

Iteration semantics match the reference exactly (registration.py:89-111):

    for i in range(max_iter):
        H, g, e2 = stats(T)              # solver-specific, fused
        dx = -solve(H, g)                # 6x6
        if ||dx|| < tol: break           # T NOT updated on the breaking step
        T = T boxplus dx

Instead of printing per-iteration errors (registration.py:91-92) the driver
returns a :class:`GNDiagnostics` struct with fixed-shape histories — the
structured-observability replacement called for in SURVEY §5.

Robustness: a singular 6x6 system must not take down a batched step, so a
non-finite ``dx`` terminates the loop with ``solver_failed`` set instead of
propagating NaNs (the reference lets ``np.linalg.solve`` raise,
registration.py:103).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from point_cloud_registration_tpu.core.se3 import plus


class GNStats(NamedTuple):
    """One linearization: normal equations + bookkeeping.

    ``H`` is the 6x6 Gauss-Newton Hessian ``sum_i w_i J_i^T J_i``, ``g`` the
    gradient ``sum_i w_i J_i^T r_i``, ``e2`` the weighted squared error and
    ``n_inliers`` the number of gated correspondences (dist < max_dist).
    Under data-parallel sharding these four are the *only* cross-device traffic
    (a ~40-float psum per iteration — SURVEY §2.3).
    """

    H: jax.Array
    g: jax.Array
    e2: jax.Array
    n_inliers: jax.Array


class GNDiagnostics(NamedTuple):
    """Fixed-shape per-align diagnostics (replaces the reference's verbose prints)."""

    iterations: jax.Array  # i32 — number of linearizations performed
    converged: jax.Array  # bool — ||dx|| < tol reached
    solver_failed: jax.Array  # bool — non-finite update encountered
    e2_history: jax.Array  # (max_iter,) f32, padded with last value's -1 slots as 0
    dx_norm_history: jax.Array  # (max_iter,) f32
    inlier_history: jax.Array  # (max_iter,) i32
    final_e2: jax.Array  # f32


class _Carry(NamedTuple):
    T: jax.Array
    it: jax.Array
    done: jax.Array
    failed: jax.Array
    converged: jax.Array
    e2_hist: jax.Array
    dxn_hist: jax.Array
    inl_hist: jax.Array
    final_e2: jax.Array


def solve_6x6(H: jax.Array, g: jax.Array) -> jax.Array:
    """Solve ``H dx = -g`` for the GN step (registration.py:103).

    Design note: ``jnp.linalg.solve`` lowers to a generic batched LU whose
    inner matmuls run at the backend's default matmul precision, which may
    truncate operands and inject noise into the step near convergence (the
    solver then oscillates instead of hitting ``tol``). H is symmetric PSD
    by construction, so this is a fully unrolled scalar Cholesky after
    Jacobi (diagonal) scaling: exact float32 elementwise arithmetic, no
    matmul path, negligible cost, and well-conditioned even though the
    translation and rotation blocks differ by orders of magnitude. A
    singular H yields NaNs, which the driver catches as ``solver_failed``.
    """
    d = jnp.diagonal(H)
    s = jax.lax.rsqrt(jnp.maximum(d, jnp.asarray(1e-30, H.dtype)))
    Hs = H * s[:, None] * s[None, :]
    b = -(g * s)

    # Unrolled Cholesky factorization Hs = L L^T (lower-triangular scalars).
    L = [[None] * 6 for _ in range(6)]
    for i in range(6):
        for j in range(i + 1):
            acc = Hs[i, j]
            for k in range(j):
                acc = acc - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(acc)
            else:
                L[i][j] = acc / L[j][j]
    # Forward substitution L y = b.
    y = [None] * 6
    for i in range(6):
        acc = b[i]
        for k in range(i):
            acc = acc - L[i][k] * y[k]
        y[i] = acc / L[i][i]
    # Back substitution L^T x = y.
    x = [None] * 6
    for i in reversed(range(6)):
        acc = y[i]
        for k in range(i + 1, 6):
            acc = acc - L[k][i] * x[k]
        x[i] = acc / L[i][i]
    return jnp.stack(x) * s


def gauss_newton(
    stats_fn: Callable[[jax.Array], GNStats],
    init_T: jax.Array,
    max_iter: int,
    tol: float,
) -> tuple[jax.Array, GNDiagnostics]:
    """Run the GN loop on device and return ``(T, diagnostics)``.

    ``stats_fn(T) -> GNStats`` encapsulates everything solver-specific
    (correspondence + linearization + reduction); under ``shard_map`` it is
    expected to ``psum`` its outputs so this driver is oblivious to sharding.
    ``max_iter`` and ``tol`` are static (compiled into the loop bounds).
    """
    init_T = jnp.asarray(init_T, dtype=jnp.float32)
    dtype = init_T.dtype

    def cond(c: _Carry) -> jax.Array:
        return jnp.logical_and(c.it < max_iter, jnp.logical_not(c.done))

    def body(c: _Carry) -> _Carry:
        stats = stats_fn(c.T)
        dx = solve_6x6(stats.H, stats.g)
        dx_norm = jnp.linalg.norm(dx)
        bad = jnp.logical_not(jnp.isfinite(dx_norm))
        converged_now = dx_norm < tol
        done_now = jnp.logical_or(converged_now, bad)
        # Reference ordering: the transform is NOT updated on the breaking step.
        T_new = jnp.where(done_now, c.T, plus(c.T, dx))
        return _Carry(
            T=T_new,
            it=c.it + 1,
            done=done_now,
            failed=jnp.logical_or(c.failed, bad),
            converged=jnp.logical_or(c.converged, converged_now),
            e2_hist=c.e2_hist.at[c.it].set(stats.e2.astype(dtype)),
            dxn_hist=c.dxn_hist.at[c.it].set(dx_norm.astype(dtype)),
            inl_hist=c.inl_hist.at[c.it].set(stats.n_inliers.astype(jnp.int32)),
            final_e2=stats.e2.astype(dtype),
        )

    # Derive every carry leaf from init_T so type annotations beyond
    # shape/dtype (shard_map's varying-manual-axes) match the body outputs —
    # plain jnp.zeros would be device-invariant and fail under
    # vmap-of-shard_map batched alignment.
    zero = init_T[0, 0] * 0
    izero = zero.astype(jnp.int32)
    false = zero > 1
    init = _Carry(
        T=init_T,
        it=izero,
        done=false,
        failed=false,
        converged=false,
        e2_hist=jnp.zeros((max_iter,), dtype) + zero,
        dxn_hist=jnp.zeros((max_iter,), dtype) + zero,
        inl_hist=jnp.zeros((max_iter,), jnp.int32) + izero,
        final_e2=zero,
    )
    out = jax.lax.while_loop(cond, body, init)
    diag = GNDiagnostics(
        iterations=out.it,
        converged=out.converged,
        solver_failed=out.failed,
        e2_history=out.e2_hist,
        dx_norm_history=out.dxn_hist,
        inlier_history=out.inl_hist,
        final_e2=out.final_e2,
    )
    return out.T, diag
