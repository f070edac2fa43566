"""Closed-form batched symmetric 3x3 eigendecomposition.

The reference leans on LAPACK for tiny fixed-size problems — ``np.linalg.eigh``
over (N, 3, 3) covariance stacks for voxel normals
(/root/reference/point_cloud_registration/voxel.py:157-158) and k-NN PCA
normals (estimate_normals.py:76-77). On the device those become host
round-trips or generic iterative loops, so this module computes eigenvalues
analytically (trigonometric solution of the characteristic cubic, a la Smith
1961 / Eberly) and eigenvectors via spectral projectors — pure element-wise
math, batched over any leading shape, branchless.

Packed symmetric layout used throughout the framework: ``(..., 6)`` ordered
``[a00, a11, a22, a01, a02, a12]`` (diagonal first, then upper triangle).

Layout note: every minor-dim slice ``s[..., i]`` of a packed ``(N, 6)``
array is a strided read, so all internals unpack ONCE via a single
(..., 6) -> (6, ...) transpose and compute on contiguous per-component
arrays (inside a fused build program XLA fuses either form, so the public
API is unchanged).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-20


def pack_sym3(A: jax.Array) -> jax.Array:
    """(..., 3, 3) symmetric -> packed (..., 6)."""
    return jnp.stack(
        [A[..., 0, 0], A[..., 1, 1], A[..., 2, 2], A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]],
        axis=-1,
    )


def unpack_sym3(s: jax.Array) -> jax.Array:
    """Packed (..., 6) -> full (..., 3, 3)."""
    a00, a11, a22, a01, a02, a12 = (s[..., i] for i in range(6))
    return jnp.stack(
        [
            jnp.stack([a00, a01, a02], axis=-1),
            jnp.stack([a01, a11, a12], axis=-1),
            jnp.stack([a02, a12, a22], axis=-1),
        ],
        axis=-2,
    )


def _unpack6(s: jax.Array):
    """One (..., 6) -> (6, ...) transpose; components are contiguous."""
    sT = jnp.moveaxis(s, -1, 0)
    return tuple(sT[i] for i in range(6))


def _scaled6(c):
    """Pre-scale components by their max magnitude (float32 conditioning
    for the tiny covariances a voxel grid produces): (comps, scale)."""
    a = [jnp.abs(x) for x in c]
    scale = jnp.maximum(
        jnp.maximum(jnp.maximum(a[0], a[1]), jnp.maximum(a[2], a[3])),
        jnp.maximum(a[4], jnp.maximum(a[5], _EPS)),
    )
    return tuple(x / scale for x in c), scale


def _eigvals_c(c):
    """Eigenvalues from pre-scaled components, ascending 3-tuple.

    Trigonometric solution of the characteristic polynomial; exactly-
    diagonal inputs (p1 == 0) take the bit-exact sorted-diagonal path.
    """
    a00, a11, a22, a01, a02, a12 = c
    q = (a00 + a11 + a22) / 3.0
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = jnp.sqrt(jnp.maximum(p2 / 6.0, _EPS))
    # det(B) / 2 with B = (A - q I) / p
    detb = (
        b00 * (b11 * b22 - a12 * a12)
        - a01 * (a01 * b22 - a12 * a02)
        + a02 * (a01 * a12 - b11 * a02)
    )
    r = jnp.clip(detb / (2.0 * p * p * p), -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    two_pi_3 = 2.0 * jnp.pi / 3.0
    lam_hi = q + 2.0 * p * jnp.cos(phi)
    lam_lo = q + 2.0 * p * jnp.cos(phi + two_pi_3)
    lam_mid = 3.0 * q - lam_hi - lam_lo
    # exactly-diagonal input: sort the diagonal directly (elementwise
    # 3-sort: min / max / remainder)
    d_lo = jnp.minimum(jnp.minimum(a00, a11), a22)
    d_hi = jnp.maximum(jnp.maximum(a00, a11), a22)
    d_mid = a00 + a11 + a22 - d_lo - d_hi
    diag = p1 <= _EPS
    return (
        jnp.where(diag, d_lo, lam_lo),
        jnp.where(diag, d_mid, lam_mid),
        jnp.where(diag, d_hi, lam_hi),
    )


def eigvals_sym3(s: jax.Array) -> jax.Array:
    """Eigenvalues of packed symmetric 3x3, ascending: (..., 6) -> (..., 3)."""
    c, scale = _scaled6(_unpack6(s))
    lam_lo, lam_mid, lam_hi = _eigvals_c(c)
    return jnp.stack([lam_lo, lam_mid, lam_hi], axis=-1) * scale[..., None]


def _projector_column_c(c, lam_a, lam_b):
    """Largest column of ``(A - lam_a I)(A - lam_b I)`` from component tuple.

    For distinct eigenvalues this product is proportional to the rank-1
    projector onto the remaining eigenvector, so its dominant column IS that
    eigenvector (up to sign/scale). Fully scalar (per-component) arithmetic:
    ``M = A^2 - (lam_a + lam_b) A + lam_a lam_b I`` — both factors are
    polynomials in A, so M is symmetric and its 6 distinct entries come from
    elementwise math over the component arrays (an ``einsum`` form
    materializing (..., 3, 3) stacks, and any per-column re-slicing of the
    packed array, are strided reads — see module docstring).
    Returns the (vx, vy, vz) component tuple.
    """
    a00, a11, a22, a01, a02, a12 = c
    t = lam_a + lam_b
    d = lam_a * lam_b
    # A^2 (symmetric): diagonal then upper triangle
    s00 = a00 * a00 + a01 * a01 + a02 * a02
    s11 = a01 * a01 + a11 * a11 + a12 * a12
    s22 = a02 * a02 + a12 * a12 + a22 * a22
    s01 = a00 * a01 + a01 * a11 + a02 * a12
    s02 = a00 * a02 + a01 * a12 + a02 * a22
    s12 = a01 * a02 + a11 * a12 + a12 * a22
    m00 = s00 - t * a00 + d
    m11 = s11 - t * a11 + d
    m22 = s22 - t * a22 + d
    m01 = s01 - t * a01
    m02 = s02 - t * a02
    m12 = s12 - t * a12
    # column squared norms of the symmetric M
    n0 = m00 * m00 + m01 * m01 + m02 * m02
    n1 = m01 * m01 + m11 * m11 + m12 * m12
    n2 = m02 * m02 + m12 * m12 + m22 * m22
    # branchless argmax over the three columns
    use1 = (n1 >= n0) & (n1 >= n2)
    use2 = (n2 >= n0) & (n2 > n1)
    vx = jnp.where(use2, m02, jnp.where(use1, m01, m00))
    vy = jnp.where(use2, m12, jnp.where(use1, m11, m01))
    vz = jnp.where(use2, m22, jnp.where(use1, m12, m02))
    return vx, vy, vz


def _normalize_c(vx, vy, vz, fb_x, fb_y, fb_z):
    n2 = vx * vx + vy * vy + vz * vz
    ok = n2 > _EPS
    r = jax.lax.rsqrt(jnp.where(ok, n2, 1.0))
    return (
        jnp.where(ok, vx * r, fb_x),
        jnp.where(ok, vy * r, fb_y),
        jnp.where(ok, vz * r, fb_z),
    )


def smallest_eigvec_sym3(s: jax.Array) -> jax.Array:
    """Unit eigenvector of the smallest eigenvalue: (..., 6) -> (..., 3).

    This is the "voxel/PCA normal" primitive (replaces
    ``np.linalg.eigh(covs)[1][:, :, 0]``, voxel.py:157-158). Sign is
    arbitrary — as in the reference — and all downstream GN math is quadratic
    in the normal, so sign never affects solver parity (SURVEY §7 hard parts).
    Near-degenerate (isotropic) inputs fall back to +z.
    """
    c, _ = _scaled6(_unpack6(s))
    _, lam_mid, lam_hi = _eigvals_c(c)
    vx, vy, vz = _projector_column_c(c, lam_hi, lam_mid)
    zero = jnp.zeros_like(vx)
    vx, vy, vz = _normalize_c(vx, vy, vz, zero, zero, jnp.ones_like(vx))
    return jnp.stack([vx, vy, vz], axis=-1)


def eigh_sym3(s: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Full decomposition of packed symmetric 3x3: eigenvalues ascending plus
    an orthonormal eigenvector matrix with columns ``V[..., :, i]`` matching
    ``np.linalg.eigh`` conventions: (..., 6) -> ((..., 3), (..., 3, 3)).
    """
    c, scale = _scaled6(_unpack6(s))
    lam_lo, lam_mid, lam_hi = _eigvals_c(c)
    lams = jnp.stack([lam_lo, lam_mid, lam_hi], axis=-1) * scale[..., None]
    zero = jnp.zeros_like(lam_lo)
    one = jnp.ones_like(lam_lo)
    lx, ly, lz = _projector_column_c(c, lam_hi, lam_mid)
    lx, ly, lz = _normalize_c(lx, ly, lz, zero, zero, one)
    hx, hy, hz = _projector_column_c(c, lam_lo, lam_mid)
    hx, hy, hz = _normalize_c(hx, hy, hz, one, zero, zero)
    # Re-orthogonalize v_hi against v_lo (defensive for near-degenerate
    # input), then complete the right-handed frame.
    dot = hx * lx + hy * ly + hz * lz
    hx, hy, hz = _normalize_c(
        hx - dot * lx, hy - dot * ly, hz - dot * lz, one, zero, zero
    )
    # v_mid = v_hi x v_lo
    mx = hy * lz - hz * ly
    my = hz * lx - hx * lz
    mz = hx * ly - hy * lx
    v_lo = jnp.stack([lx, ly, lz], axis=-1)
    v_mid = jnp.stack([mx, my, mz], axis=-1)
    v_hi = jnp.stack([hx, hy, hz], axis=-1)
    V = jnp.stack([v_lo, v_mid, v_hi], axis=-1)
    return lams, V
