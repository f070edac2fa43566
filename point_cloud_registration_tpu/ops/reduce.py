"""Fused H / g / e^2 reductions for the three residual families.

Each Gauss-Newton iteration collapses N per-point linearizations into the
6x6 normal equations. The reference hand-fuses this per solver
(/root/reference/point_cloud_registration/icp.py:24-57,
plane_icp.py:30-69, ndt.py:24-57); here the same closed forms are expressed
as weighted, fixed-shape jnp reductions so XLA fuses the whole chain
(transform -> residual -> Jacobian -> block reduction) into a handful of
memory-bandwidth-bound passes, with the dense 6xN @ Nx6 contractions as
matrix products.

The crucial re-design: the reference *compacts* correspondences with a
boolean mask (e.g. ``idx = idx[mask]``, icp.py:34-36) which is a dynamic
shape. Dropping a row is mathematically identical to giving it weight 0 in
the sums — exactly what the generic reducer (registration.py:62-68) already
expresses — so every function here takes a dense ``weights`` vector instead
and the shapes never change (SURVEY §7 "fixed-shape discipline").
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from point_cloud_registration_tpu.core.gn import GNStats
from point_cloud_registration_tpu.core.se3 import huber_weight, skew2, skew_time_vector
from point_cloud_registration_tpu.ops.eigh3 import unpack_sym3

# All small contractions run at HIGHEST precision: default-precision float32
# matmuls may truncate their operands (bfloat16 passes, or TF32 on tensor
# cores), which injects up to ~1e-2 relative noise into H/g and stalls
# convergence near tol (see core/gn.py).
_HI = jax.lax.Precision.HIGHEST


def _sym_block(H_ll: jax.Array, H_lr: jax.Array, H_rr: jax.Array) -> jax.Array:
    top = jnp.concatenate([H_ll, H_lr], axis=1)
    bot = jnp.concatenate([H_lr.T, H_rr], axis=1)
    return jnp.concatenate([top, bot], axis=0)


def point_stats(
    source: jax.Array,
    src_trans: jax.Array,
    targets: jax.Array,
    weights: jax.Array,
    R: jax.Array,
    huber_delta: float | None = None,
) -> GNStats:
    """Point-to-point closed form (reference icp.py:24-57, weighted).

    Jacobian ``J = [I | -R skew(p_src)]`` gives ``H_ll = (sum w) I``,
    ``H_lr = -R skew(sum w p)``, ``H_rr = sum w skew(p)^T skew(p)`` and
    ``g = [sum w r ; sum w skew(p) R^T r]`` without materializing any J.
    ``huber_delta`` enables opt-in IRLS Huber robust weighting on the
    residual norm (the reference exports huber_weight but never wires it
    into a solver — math_tools.py:15-19; SURVEY §7 M6).
    """
    rs = src_trans - targets
    if huber_delta is not None:
        weights = weights * huber_weight(
            jnp.sqrt(jnp.sum(rs * rs, axis=-1)), huber_delta
        )
    w = weights[:, None]
    n = jnp.sum(weights)
    p_sum = jnp.sum(source * w, axis=0)
    H_ll = n * jnp.eye(3, dtype=source.dtype)
    S_sum = jnp.stack(
        [
            jnp.stack([jnp.zeros((), source.dtype), -p_sum[2], p_sum[1]]),
            jnp.stack([p_sum[2], jnp.zeros((), source.dtype), -p_sum[0]]),
            jnp.stack([-p_sum[1], p_sum[0], jnp.zeros((), source.dtype)]),
        ]
    )
    H_lr = -jnp.einsum("ij,jk->ik", R, S_sum, precision=_HI)
    H_rr = skew2(source, weights)
    g0 = jnp.sum(rs * w, axis=0)
    # g1 = sum w skew(p) (R^T r)  (icp.py:52-55 in einsum form)
    Rt_r = jnp.einsum("nj,ji->ni", rs, R, precision=_HI)
    g1 = jnp.sum(skew_time_vector(source, Rt_r) * w, axis=0)
    g = jnp.concatenate([g0, g1])
    e2 = jnp.sum(rs * rs * w)
    return GNStats(H=_sym_block(H_ll, H_lr, H_rr), g=g, e2=e2, n_inliers=n)


def plane_stats(
    source: jax.Array,
    src_trans: jax.Array,
    means: jax.Array,
    normals: jax.Array,
    weights: jax.Array,
    R: jax.Array,
    huber_delta: float | None = None,
) -> GNStats:
    """Point-to-plane scalar-residual form (reference plane_icp.py:30-69, weighted).

    ``r = n^T (T p - mu)``, ``J = [n^T | (skew(p) R^T n)^T]``. The six
    Jacobian columns are assembled as one (N, 6) matrix so the block
    reduction is a single matrix product.
    """
    diff = src_trans - means
    rs = jnp.sum(normals * diff, axis=-1)  # (N,)
    if huber_delta is not None:
        weights = weights * huber_weight(jnp.abs(rs), huber_delta)
    Jr = skew_time_vector(source, jnp.einsum("nj,ji->ni", normals, R, precision=_HI))  # skew(p) @ (R^T n)
    J6 = jnp.concatenate([normals, Jr], axis=-1)  # (N, 6)
    Jw = J6 * weights[:, None]
    H = jnp.dot(Jw.T, J6, preferred_element_type=jnp.float32, precision=_HI)
    g = jnp.sum(Jw * rs[:, None], axis=0)
    e2 = jnp.sum(rs * rs * weights)
    return GNStats(H=H, g=g, e2=e2, n_inliers=jnp.sum(weights))


def ndt_stats(
    source: jax.Array,
    src_trans: jax.Array,
    means: jax.Array,
    icov_packed: jax.Array,
    weights: jax.Array,
    R: jax.Array,
    huber_delta: float | None = None,
) -> GNStats:
    """Mahalanobis form (reference ndt.py:24-57, weighted).

    ``d = T p - mu``, per-point metric ``Sigma^{-1}`` (packed symmetric 6),
    ``J1 = -R skew(p)``: ``H_ll = sum w S``, ``H_lr = sum w S J1``,
    ``H_rr = sum w J1^T S J1``, ``g = [sum w S d ; sum w J1^T S d]``,
    ``e2 = sum w d^T S d``.
    """
    icov = unpack_sym3(icov_packed)  # (N, 3, 3)
    diff = src_trans - means  # (N, 3)
    if huber_delta is not None:
        # robustify on the Mahalanobis residual magnitude
        icd = jnp.einsum("nij,nj->ni", icov, diff, precision=_HI)
        mah = jnp.sqrt(jnp.maximum(jnp.sum(diff * icd, axis=-1), 0.0))
        weights = weights * huber_weight(mah, huber_delta)
    w = weights[:, None, None]
    # J1 = -R @ skew(p) : build via column cross products, (N, 3, 3)
    Sp = jnp.stack(
        [
            jnp.stack([jnp.zeros_like(source[:, 0]), -source[:, 2], source[:, 1]], axis=-1),
            jnp.stack([source[:, 2], jnp.zeros_like(source[:, 0]), -source[:, 0]], axis=-1),
            jnp.stack([-source[:, 1], source[:, 0], jnp.zeros_like(source[:, 0])], axis=-1),
        ],
        axis=-2,
    )
    J1 = -jnp.einsum("ij,njk->nik", R, Sp, precision=_HI)
    icov_J1 = jnp.einsum("nij,njk->nik", icov, J1, precision=_HI)
    H_ll = jnp.sum(icov * w, axis=0)
    H_lr = jnp.sum(icov_J1 * w, axis=0)
    H_rr = jnp.einsum("nji,njk,n->ik", J1, icov_J1, weights, precision=_HI)
    icov_d = jnp.einsum("nij,nj->ni", icov, diff, precision=_HI)
    g0 = jnp.sum(icov_d * weights[:, None], axis=0)
    g1 = jnp.einsum("nji,nj,n->i", J1, icov_d, weights, precision=_HI)
    g = jnp.concatenate([g0, g1])
    e2 = jnp.einsum("ni,ni,n->", diff, icov_d, weights, precision=_HI)
    return GNStats(
        H=_sym_block(H_ll, H_lr, H_rr), g=g, e2=e2, n_inliers=jnp.sum(weights)
    )


def reduce_H_g_e2(Js: jax.Array, rs: jax.Array, weights: jax.Array):
    """Generic weighted reducer for explicit (N, m, 6) Jacobians.

    Mirrors the reference base-class einsum path (registration.py:55-68):
    ``H = sum w J^T J``, ``g = sum w J^T r``, ``e2 = sum w r^T r``. Used by
    the coreset-accelerated solver, which needs materialized (J, r) pairs.
    """
    if Js.ndim == 2:  # scalar residual: (N, 6) / (N,)
        Js = Js[:, None, :]
        rs = rs[:, None]
    H = jnp.einsum("nmi,nmj,n->ij", Js, Js, weights, precision=_HI)
    g = jnp.einsum("nmi,nm,n->i", Js, rs, weights, precision=_HI)
    e2 = jnp.einsum("nm,nm,n->", rs, rs, weights, precision=_HI)
    return H, g, e2
