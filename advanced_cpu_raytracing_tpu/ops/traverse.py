"""Scene-level closest-hit and occlusion queries.

Two execution strategies, chosen statically at pack time:

  * **brute** (small scenes): every (entity, face) work item is tested against
    every ray as one dense masked min-reduction — no pointer chasing.  XLA
    fuses the (W, R) test into its argmin reduction and gathers, so the
    (W, R) intermediates are never materialised (measured on an H100: 0.58
    GB peak at W = 2048, R = 640k).  Triangles are pre-transformed to world
    space at pack time; this is algebraically equivalent to the reference's
    ray-to-object transform (src/mesh.cpp:161-165) because beta/gamma/t are
    invariant under the affine map, and motion blur becomes a world-space
    origin offset ``o + M_rot·motion·time`` (local ``o_l + motion·time``,
    mesh.cpp:167-170).

  * **bvh** (large scenes): per entity, rays are transformed to object space
    and a stackful ``lax.while_loop`` walks the flattened BVH (semantics of
    BVH::IntersectBVH, src/bvh.cpp:5-31: AABB reject at node entry, leaves
    test their face range, interiors push both children).

Both return a Hit record; shading derives normals/UVs from it.

Occlusion ("in shadow") mirrors Raytracer::CastShadowRay
(src/raytracer.cpp:585-623): triangle geometry belonging to emissive
(light-mesh) entities is skipped, spheres are not; a hit counts only when
``t < light_t`` given the initial ``minT = light_t + 0.01``.

Differentiable mode (``differentiable=True``) uses the standard
stop-gradient-on-topology decomposition: WHICH primitive wins is decided by
the non-differentiable path (the dense brute force or the BVH
while_loop, on stop_gradient'd rays), then (t, beta, gamma) are recomputed
differentiably on ONLY the winning triangle — O(R) work and O(R) reverse
residuals instead of O(W*R).  The recompute runs in the winning entity's
object space, so gradients flow to the ray (o, d) AND to the shared vertex
table ``pack.verts`` (first-order geometry gradients; the visibility
function itself stays locally constant, diff/params.py).  Occlusion is a
boolean — under AD it is a pure topology query and runs entirely on
stop-gradients, which also makes the BVH strategy reverse-differentiable
(lax.while_loop only ever sees constants).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from advanced_cpu_raytracing_tpu.ops.intersect import (
    ray_aabb,
    ray_sphere,
    ray_triangle,
    transform_ray,
)

INF = jnp.float32(jnp.inf)

KIND_NONE = jnp.int32(-1)
KIND_TRI = jnp.int32(0)
KIND_SPHERE = jnp.int32(1)


class Hit(NamedTuple):
    t: jnp.ndarray  # (R,)
    valid: jnp.ndarray  # (R,) bool
    kind: jnp.ndarray  # (R,) -1 none / 0 tri / 1 sphere
    index: jnp.ndarray  # (R,) entity index (tri) or sphere index
    face: jnp.ndarray  # (R,) global face index (tri only)
    beta: jnp.ndarray  # (R,)
    gamma: jnp.ndarray  # (R,)


def _empty_hit(n: int) -> Hit:
    z = jnp.zeros(n, jnp.float32)
    zi = jnp.zeros(n, jnp.int32)
    return Hit(jnp.full(n, INF), jnp.zeros(n, bool), jnp.full(n, -1, jnp.int32),
               zi, zi, z, z)


# --------------------------------------------------------------------------
# Triangles — brute force
# --------------------------------------------------------------------------

def _brute_hits(o, d, v0, v1, v2, offset=None):
    """Dense closest hit over a triangle table: the (W, R) broadcast of
    ``ray_triangle`` reduced by argmin (rays on the last axis).  ``offset``
    (W, R, 3) shifts each item's ray origin (motion blur).  Returns
    (t, idx, beta, gamma) with t = inf and idx = -1 on a miss."""
    ow = o[None, :, :] if offset is None else o[None, :, :] + offset
    t, beta, gamma, valid = ray_triangle(
        ow, d[None, :, :], v0[:, None, :], v1[:, None, :], v2[:, None, :])
    t = jnp.where(valid, t, INF)
    best = jnp.argmin(t, axis=0)  # (R,)
    r = jnp.arange(t.shape[1])
    t_best = t[best, r]
    return (t_best, jnp.where(t_best < INF, best, -1), beta[best, r],
            gamma[best, r])


def _brute_tri_best(pack, o, d, time, skip_emissive: bool):
    """Best triangle hit over all work items. o,d: (R,3); returns per-ray
    (t, ent, face, beta, gamma, valid).  Occlusion queries
    (``skip_emissive``) use the shadow table, which already excludes
    emissive entities, and read only (t, valid)."""
    if skip_emissive:
        tab = (pack.ws_v0, pack.ws_v1, pack.ws_v2, pack.ws_motion)
    else:
        tab = (pack.wi_v0, pack.wi_v1, pack.wi_v2, pack.wi_motion)
    offset = None
    if pack.static.has_motion:
        offset = tab[3][:, None, :] * time[None, :, None]
    t, idx, beta, gamma = _brute_hits(o, d, *tab[:3], offset)
    valid = idx >= 0
    idx0 = jnp.maximum(idx, 0)
    if skip_emissive:
        return t, idx0, idx0, beta, gamma, valid
    return t, pack.wi_ent[idx0], pack.wi_face[idx0], beta, gamma, valid


# --------------------------------------------------------------------------
# Triangles — BVH traversal
# --------------------------------------------------------------------------

def _bvh_entity_best(pack, ent_idx: int, o, d, time, min_t0):
    """Traverse one entity's BVH for a batch of rays.

    Returns (t, face, beta, gamma) with t == min_t0 when no closer hit.
    Vectorized over rays via vmap of a stackful while_loop.
    """
    st = pack.static
    stack_size = st.bvh_max_depth + 2
    minv = pack.ent_minv[ent_idx]
    root = pack.ent_root[ent_idx]
    motion = pack.ent_motion[ent_idx]

    o_l, d_l = transform_ray(minv, o, d)
    if st.has_motion:
        o_l = o_l + motion[None, :] * time[:, None]

    node_min, node_max = pack.node_min, pack.node_max
    node_left, node_right = pack.node_left, pack.node_right
    node_first, node_count = pack.node_first, pack.node_count
    verts, tri_vidx = pack.verts, pack.tri_vidx

    def one_ray(o1, d1, t0):
        def face_body(i, carry):
            t_best, f_best, b_best, g_best = carry
            vi = tri_vidx[i]
            t, beta, gamma, valid = ray_triangle(
                o1, d1, verts[vi[0]], verts[vi[1]], verts[vi[2]]
            )
            better = valid & (t < t_best)
            return (
                jnp.where(better, t, t_best),
                jnp.where(better, i, f_best),
                jnp.where(better, beta, b_best),
                jnp.where(better, gamma, g_best),
            )

        def body(state):
            sp, stack, t_best, f_best, b_best, g_best = state
            node = stack[sp - 1]
            sp = sp - 1
            hit_box = ray_aabb(o1, d1, node_min[node], node_max[node], t_best)
            left = node_left[node]
            is_leaf = left < 0

            # Leaf: scan its face range (bvh.cpp:13-20)
            first = node_first[node]
            count = jnp.where(hit_box & is_leaf, node_count[node], 0)
            t_best, f_best, b_best, g_best = jax.lax.fori_loop(
                first, first + count, face_body, (t_best, f_best, b_best, g_best)
            )

            # Interior: push children (bvh.cpp:22-27)
            push = hit_box & ~is_leaf
            stack = stack.at[sp].set(jnp.where(push, left, stack[sp]))
            sp1 = sp + jnp.where(push, 1, 0)
            stack = stack.at[sp1].set(jnp.where(push, node_right[node], stack[sp1]))
            sp = sp1 + jnp.where(push, 1, 0)
            return sp, stack, t_best, f_best, b_best, g_best

        def cond(state):
            return state[0] > 0

        stack = jnp.zeros(stack_size, jnp.int32).at[0].set(root)
        init = (jnp.int32(1), stack, t0, jnp.int32(-1),
                jnp.float32(0.0), jnp.float32(0.0))
        _, _, t_best, f_best, b_best, g_best = jax.lax.while_loop(cond, body, init)
        return t_best, f_best, b_best, g_best

    return jax.vmap(one_ray)(o_l, d_l, min_t0)


def _bvh_tri_best(pack, o, d, time, skip_emissive: bool):
    st = pack.static
    n = o.shape[0]
    t_best = jnp.full(n, INF)
    ent_best = jnp.zeros(n, jnp.int32)
    face_best = jnp.zeros(n, jnp.int32)
    b_best = jnp.zeros(n, jnp.float32)
    g_best = jnp.zeros(n, jnp.float32)
    for e in range(st.n_entities):
        if skip_emissive:
            # static per-entity skip is not possible (emissive is an array);
            # traverse and mask the update instead
            pass
        t_e, f_e, b_e, g_e = _bvh_entity_best(pack, e, o, d, time, t_best)
        better = t_e < t_best
        if skip_emissive:
            better = better & ~pack.ent_emissive[e]
        t_best = jnp.where(better, t_e, t_best)
        ent_best = jnp.where(better, e, ent_best)
        face_best = jnp.where(better, f_e, face_best)
        b_best = jnp.where(better, b_e, b_best)
        g_best = jnp.where(better, g_e, g_best)
    return t_best, ent_best, face_best, b_best, g_best, t_best < INF


# --------------------------------------------------------------------------
# Spheres
# --------------------------------------------------------------------------

def _sphere_best(pack, o, d, time):
    """Best sphere hit (Sphere::Intersect, src/sphere.cpp:13-80).

    Returns (t, idx, valid) per ray.
    """
    st = pack.static
    # (S,R,3) local rays; S is small.
    o_l, d_l = transform_ray(pack.sph_minv[:, None, :, :], o[None], d[None])
    if st.has_motion:
        o_l = o_l + pack.sph_motion[:, None, :] * time[None, :, None]
    t, valid = ray_sphere(o_l, d_l, pack.sph_center[:, None, :],
                          pack.sph_radius[:, None])
    t = jnp.where(valid, t, INF)
    best = jnp.argmin(t, axis=0)
    r = jnp.arange(t.shape[1])
    t_best = t[best, r]
    return t_best, best.astype(jnp.int32), t_best < INF


# --------------------------------------------------------------------------
# Public queries
# --------------------------------------------------------------------------

def _tri_recompute(pack, o, d, time, ent, face):
    """Differentiable (t, beta, gamma) on each ray's WINNING triangle only.

    The Cramer solve runs in the winning entity's object space (ray
    transformed by the gathered M⁻¹, motion as a local origin offset —
    Mesh::Intersect, src/mesh.cpp:161-170), so gradients reach both the ray
    and ``pack.verts``.  t and the barycentrics are invariant under the
    affine map (module docstring), so the values agree with whichever fast
    path selected the winner up to fp rounding.
    """
    minv = pack.ent_minv[ent]  # (R,3,4)
    o_l, d_l = transform_ray(minv, o, d)
    if pack.static.has_motion:
        o_l = o_l + pack.ent_motion[ent] * time[:, None]
    vi = pack.tri_vidx[face]  # (R,3)
    t, beta, gamma, _ = ray_triangle(
        o_l, d_l, pack.verts[vi[:, 0]], pack.verts[vi[:, 1]],
        pack.verts[vi[:, 2]],
    )
    return t, beta, gamma


def closest_hit(pack, o, d, time=None, skip_emissive: bool = False,
                differentiable: bool = False) -> Hit:
    """Closest intersection along each ray (IntersectObjects,
    src/raytracer.cpp:625-643)."""
    st = pack.static
    n = o.shape[0]
    if time is None:
        time = jnp.zeros(n, jnp.float32)

    hit = _empty_hit(n)
    t = hit.t
    if st.n_faces > 0 and st.n_entities > 0:
        if differentiable:
            # stop-grad topology from the fastest path + winner recompute
            sg = jax.lax.stop_gradient
            o_sg, d_sg, t_sg = sg(o), sg(d), sg(time)
            if st.use_bvh:
                _, ent, face, _, _, v_tri = _bvh_tri_best(
                    pack, o_sg, d_sg, t_sg, skip_emissive)
            else:
                _, ent, face, _, _, v_tri = _brute_tri_best(
                    pack, o_sg, d_sg, t_sg, skip_emissive)
            ent, face, v_tri = sg(ent), sg(face), sg(v_tri)
            t_r, b_r, g_r = _tri_recompute(pack, o, d, time, ent, face)
            # misses gathered garbage rows: mask them out at the source so
            # no cotangent (or inf/NaN) ever touches those lanes
            t_tri = jnp.where(v_tri, t_r, INF)
            beta = jnp.where(v_tri, b_r, 0.0)
            gamma = jnp.where(v_tri, g_r, 0.0)
        elif st.use_bvh:
            t_tri, ent, face, beta, gamma, v_tri = _bvh_tri_best(
                pack, o, d, time, skip_emissive
            )
        else:
            t_tri, ent, face, beta, gamma, v_tri = _brute_tri_best(
                pack, o, d, time, skip_emissive
            )
        hit = Hit(
            t=jnp.where(v_tri, t_tri, hit.t),
            valid=hit.valid | v_tri,
            kind=jnp.where(v_tri, KIND_TRI, hit.kind),
            index=jnp.where(v_tri, ent, hit.index),
            face=jnp.where(v_tri, face, hit.face),
            beta=jnp.where(v_tri, beta, hit.beta),
            gamma=jnp.where(v_tri, gamma, hit.gamma),
        )

    if st.n_spheres > 0:
        t_s, idx_s, v_s = _sphere_best(pack, o, d, time)
        closer = v_s & (t_s < hit.t)
        hit = Hit(
            t=jnp.where(closer, t_s, hit.t),
            valid=hit.valid | closer,
            kind=jnp.where(closer, KIND_SPHERE, hit.kind),
            index=jnp.where(closer, idx_s, hit.index),
            face=hit.face,
            beta=hit.beta,
            gamma=hit.gamma,
        )
    return hit


def occluded(pack, o, d, light_t, time=None,
             differentiable: bool = False) -> jnp.ndarray:
    """True where something (non-emissive for meshes) blocks the segment
    to the light: min-hit with init ``light_t + 0.01`` compared against
    ``light_t`` (IsInShadow, src/raytracer.cpp:567-583).

    The result is boolean, so under AD this is a pure topology query:
    ``differentiable=True`` stops gradients at the inputs, which keeps the
    BVH while_loop usable inside reverse-mode renders."""
    st = pack.static
    n = o.shape[0]
    if time is None:
        time = jnp.zeros(n, jnp.float32)
    if differentiable:
        sg = jax.lax.stop_gradient
        o, d, light_t, time = sg(o), sg(d), sg(light_t), sg(time)
    blocked = jnp.zeros(n, bool)
    if st.n_faces > 0 and st.n_entities > 0:
        if st.use_bvh:
            t_tri, _, _, _, _, v = _bvh_tri_best(pack, o, d, time, True)
        else:
            t_tri, _, _, _, _, v = _brute_tri_best(pack, o, d, time, True)
        blocked = blocked | (v & (t_tri < light_t))
    if st.n_spheres > 0:
        t_s, _, v_s = _sphere_best(pack, o, d, time)
        blocked = blocked | (v_s & (t_s < light_t))
    return blocked
