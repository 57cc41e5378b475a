"""Primitive intersection kernels (batched jnp).

All kernels are pure functions over arrays: rays are (o, d) with non-unit d
allowed (t is preserved across affine ray transforms exactly as in the
reference, which never renormalizes the object-space direction —
src/mesh.cpp:164-165).
"""

from __future__ import annotations

import jax.numpy as jnp

INF = jnp.float32(jnp.inf)


def ray_aabb(o, d, bb_min, bb_max, min_t):
    """Slab test matching BoundingBox::doesIntersectWith (src/shape.hpp:78-100).

    Returns True when tmax > 0 and tmax >= tmin and tmin < min_t.
    Division by zero produces ±inf like the C++ float math.
    """
    inv = 1.0 / d
    t1 = (bb_min - o) * inv
    t2 = (bb_max - o) * inv
    tx1, tx2 = t1[..., 0], t2[..., 0]
    tmin = jnp.minimum(tx1, tx2)
    tmax = jnp.maximum(tx1, tx2)
    tmin = jnp.maximum(tmin, jnp.minimum(t1[..., 1], t2[..., 1]))
    tmax = jnp.minimum(tmax, jnp.maximum(t1[..., 1], t2[..., 1]))
    tmin = jnp.maximum(tmin, jnp.minimum(t1[..., 2], t2[..., 2]))
    tmax = jnp.minimum(tmax, jnp.maximum(t1[..., 2], t2[..., 2]))
    return (tmax > 0) & (tmax >= tmin) & (tmin < min_t)


def ray_triangle(o, d, v0, v1, v2):
    """Cramer's-rule triangle test (Mesh::IntersectFace, src/mesh.cpp:201-236).

    Returns (t, beta, gamma, valid): valid requires detA != 0, beta >= 0,
    gamma >= 0, beta+gamma <= 1, t > 0.  Broadcasts over leading dims.
    """
    e1 = v0 - v1  # col 0 of A
    e2 = v0 - v2  # col 1 of A
    b = v0 - o    # rhs

    # detA = det[e1 | e2 | d]  (column-major 3x3, matching determinant())
    def det3(c0, c1, c2):
        return (
            c0[..., 0] * (c1[..., 1] * c2[..., 2] - c2[..., 1] * c1[..., 2])
            - c1[..., 0] * (c0[..., 1] * c2[..., 2] - c2[..., 1] * c0[..., 2])
            + c2[..., 0] * (c0[..., 1] * c1[..., 2] - c1[..., 1] * c0[..., 2])
        )

    det_a = det3(e1, e2, d)
    safe = jnp.where(det_a == 0.0, 1.0, det_a)
    beta = det3(b, e2, d) / safe
    gamma = det3(e1, b, d) / safe
    t = det3(e1, e2, b) / safe
    valid = (
        (det_a != 0.0)
        & (beta >= 0.0)
        & (gamma >= 0.0)
        & (beta + gamma <= 1.0)
        & (t > 0.0)
    )
    return t, beta, gamma, valid


def ray_sphere(o, d, center, radius):
    """Quadratic sphere test (Sphere::Intersect, src/sphere.cpp:31-64).

    Returns (t, valid) with the reference's root choice: the smallest
    positive root; if both are negative the returned t is negative and valid
    is False via the caller's t>0 check.
    """
    oc = o - center
    c = jnp.sum(oc * oc, axis=-1) - radius * radius
    b = 2.0 * jnp.sum(d * oc, axis=-1)
    a = jnp.sum(d * d, axis=-1)
    delta = b * b - 4.0 * a * c
    # double-where keeps reverse-mode AD finite at delta <= 0 (grad of
    # sqrt(0) is inf; those lanes are masked invalid anyway)
    sq = jnp.sqrt(jnp.where(delta > 0.0, delta, 1.0))
    sq = jnp.where(delta > 0.0, sq, 0.0)
    # degenerate rays (d = 0) give a = 0; keep the division AD-safe
    denom = jnp.where(a > 0.0, 2.0 * a, 1.0)
    t1 = (-b + sq) / denom
    t2 = (-b - sq) / denom
    lo = jnp.minimum(t1, t2)
    hi = jnp.maximum(t1, t2)
    t = jnp.where(lo > 0.0, lo, hi)
    valid = (delta >= 0.0) & (t > 0.0) & (a > 0.0)
    return t, valid


def _matvec3(m, v):
    """(..., 3, 3+) @ (..., 3) via explicit FMA.

    Deliberately NOT einsum/dot: a matrix unit may run those at reduced
    precision by default (TF32 on a GPU's tensor cores) — enough to visibly
    perturb ray geometry.  Elementwise multiply-add stays in full f32 (and
    is faster for 3-vectors anyway).
    """
    return (
        m[..., :, 0] * v[..., 0:1] + m[..., :, 1] * v[..., 1:2]
        + m[..., :, 2] * v[..., 2:3]
    )


def transform_ray(minv_3x4, o, d):
    """Apply a packed (3,4) inverse transform: point w=1, vector w=0
    (src/matrix.hpp:113-122)."""
    rot = minv_3x4[..., :3, :3]
    trans = minv_3x4[..., :3, 3]
    return _matvec3(rot, o) + trans, _matvec3(rot, d)


def transform_vector(m3x3, v):
    return _matvec3(m3x3, v)


def transform_point(m3x4, p):
    return _matvec3(m3x4[..., :3, :3], p) + m3x4[..., :3, 3]
