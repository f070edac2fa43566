"""SE(3)/SO(3) Lie-group math for the registration stack.

Functional parity target: the reference NumPy math kernel
(/root/reference/point_cloud_registration/math_tools.py:15-127), re-designed for
XLA: every op is branchless (``jnp.where`` instead of Python ``if``), batched
over leading axes, and keeps a static dtype so it traces cleanly under ``jit``,
``vmap`` and ``shard_map``.

Conventions
-----------
* Transforms ``T`` are (4, 4) row-major homogeneous matrices.
* A GN update ``dx`` is a 6-vector ``[t(3), omega(3)]`` — translation first,
  rotation second — matching the reference boxplus (math_tools.py:101-108).
* Default dtype is float32; float64 never appears on device.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Small-angle cutoff for the SO(3) exponential, matching the reference
# (math_tools.py:12: epsilon = 1e-5 compared against theta**2).
_SO3_EPS = 1e-5


def skew(v: jax.Array) -> jax.Array:
    """Skew-symmetric (cross-product) matrix of ``v``: shape (..., 3) -> (..., 3, 3).

    Batched generalization of the reference ``skew``/``skews`` pair
    (math_tools.py:34-41, :61-64) — one function covers both because leading
    axes broadcast.
    """
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    rows = jnp.stack(
        [
            jnp.stack([zero, -z, y], axis=-1),
            jnp.stack([z, zero, -x], axis=-1),
            jnp.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )
    return rows


# Alias kept for API parity with the reference export list (__init__.py:2).
skews = skew


def skew_time_vector(v1: jax.Array, v2: jax.Array) -> jax.Array:
    """Fused ``skew(v1) @ v2`` for batches: (..., 3), (..., 3) -> (..., 3).

    Mirrors math_tools.py:22-31; avoids materializing the (..., 3, 3) skews.
    """
    x, y, z = v1[..., 0], v1[..., 1], v1[..., 2]
    a, b, c = v2[..., 0], v2[..., 1], v2[..., 2]
    return jnp.stack([-z * b + y * c, z * a - x * c, -y * a + x * b], axis=-1)


def skew2(v: jax.Array, weights: jax.Array | None = None) -> jax.Array:
    """Weighted ``sum_i w_i * skew(v_i).T @ skew(v_i)`` -> (3, 3).

    Mirrors math_tools.py:44-58 with an optional weight vector so the same
    reduction serves masked (fixed-shape) pipelines.
    """
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    if weights is not None:
        wx, wy, wz = x * weights, y * weights, z * weights
    else:
        wx, wy, wz = x, y, z
    x2 = jnp.sum(wx * x)
    y2 = jnp.sum(wy * y)
    z2 = jnp.sum(wz * z)
    xy = jnp.sum(wx * y)
    xz = jnp.sum(wx * z)
    yz = jnp.sum(wy * z)
    return jnp.stack(
        [
            jnp.stack([z2 + y2, -xy, -xz]),
            jnp.stack([-xy, x2 + z2, -yz]),
            jnp.stack([-xz, -yz, x2 + y2]),
        ]
    )


def huber_weight(r: jax.Array, d: float = 1.0) -> jax.Array:
    """IRLS Huber weights: 1 where ``r <= d`` else ``d / r`` (math_tools.py:15-19)."""
    safe_r = jnp.where(r > d, r, jnp.ones_like(r))
    return jnp.where(r > d, d / safe_r, jnp.ones_like(r))


def expSO3(omega: jax.Array) -> jax.Array:
    """SO(3) exponential map, batched: (..., 3) -> (..., 3, 3).

    Rodrigues formula with the reference's small-angle branch
    (math_tools.py:80-98: ``theta2 <= 1e-5`` -> ``I + W``) expressed as a
    branchless ``where`` so it vectorizes/jits. Gradients are safe at
    ``theta == 0`` because the singular factors are evaluated at a clamped
    angle and discarded by the ``where``.
    """
    omega = jnp.asarray(omega)
    theta2 = jnp.sum(omega * omega, axis=-1)
    near_zero = theta2 <= _SO3_EPS
    # Clamp to keep rsqrt/sin well-defined on the untaken branch.
    theta2_safe = jnp.where(near_zero, jnp.ones_like(theta2), theta2)
    theta = jnp.sqrt(theta2_safe)
    W = skew(omega)
    WW = jnp.einsum("...ij,...jk->...ik", W, W, precision=jax.lax.Precision.HIGHEST)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=omega.dtype), W.shape)
    k1 = (jnp.sin(theta) / theta)[..., None, None]
    k2 = ((1.0 - jnp.cos(theta)) / theta2_safe)[..., None, None]
    exact = eye + k1 * W + k2 * WW
    taylor = eye + W
    return jnp.where(near_zero[..., None, None], taylor, exact)


def logSO3(R: jax.Array) -> jax.Array:
    """SO(3) logarithm, batched: (..., 3, 3) -> (..., 3).

    Not present in the reference (its API never inverts the exp map); provided
    because diagnostics and tests need rotation-error magnitudes.
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(cos_theta)
    w = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    small = theta < 1e-4
    theta_safe = jnp.where(small, jnp.ones_like(theta), theta)
    scale = jnp.where(small, 0.5, 0.5 * theta_safe / jnp.sin(theta_safe))
    return w * scale[..., None]


def makeT(R: jax.Array, t: jax.Array) -> jax.Array:
    """Assemble homogeneous transform(s) from (..., 3, 3) and (..., 3).

    Mirrors math_tools.py:67-72 (3-D case), batched.
    """
    R = jnp.asarray(R)
    t = jnp.asarray(t)
    batch = R.shape[:-2]
    top = jnp.concatenate([R, t[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=R.dtype), batch + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def makeRt(T: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Split (..., 4, 4) -> ((..., 3, 3), (..., 3)). Mirrors math_tools.py:75-77."""
    return T[..., :3, :3], T[..., :3, 3]


def plus(T: jax.Array, dx: jax.Array) -> jax.Array:
    """SE(3) boxplus: ``T ⊞ dx = T @ makeT(expSO3(dx[3:]), dx[:3])``.

    Exactly the reference update rule (math_tools.py:101-108), batched over
    leading axes of both arguments.
    """
    dR = expSO3(dx[..., 3:])
    dt = dx[..., :3]
    return jnp.einsum(
        "...ij,...jk->...ik", T, makeT(dR, dt), precision=jax.lax.Precision.HIGHEST
    )


def transform_points(T: jax.Array, points: jax.Array) -> jax.Array:
    """Apply (..., 4, 4) transform to (..., N, 3) points (math_tools.py:111-113).

    Written as broadcast multiplies/adds rather than ``points @ R.T``: a tiny
    K=3 matmul at a backend's default precision may truncate its operands
    (bfloat16 or TF32 inputs), quantizing coordinates — fatal for
    registration residuals. The elementwise form is exact float32 and the
    op is bandwidth-bound either way.
    """
    R, t = makeRt(T)
    x = points[..., 0:1] * R[..., None, :, 0] # broadcast over the point axis
    y = points[..., 1:2] * R[..., None, :, 1]
    z = points[..., 2:3] * R[..., None, :, 2]
    return x + y + z + t[..., None, :]


def numerical_derivative(func, param, idx, plus_op=None, minus_op=None, delta=1e-5):
    """Finite-difference Jacobian checker (math_tools.py:116-127).

    Host-side NumPy utility (test/debug only — never on the device compute path).
    ``func(*param)`` must return a 1-D array; the Jacobian is w.r.t.
    ``param[idx]`` perturbed through ``plus_op``.
    """
    import numpy as np

    if plus_op is None:
        plus_op = lambda a, b: a + b
    if minus_op is None:
        minus_op = lambda a, b: a - b
    r = np.asarray(func(*param))
    m = r.shape[0]
    n = np.asarray(param[idx]).shape[0]
    J = np.zeros([m, n])
    for j in range(n):
        dx = np.zeros(n)
        dx[j] = delta
        param_delta = list(param).copy()
        param_delta[idx] = plus_op(param[idx], dx)
        J[:, j] = minus_op(np.asarray(func(*param_delta)), r) / delta
    return J
