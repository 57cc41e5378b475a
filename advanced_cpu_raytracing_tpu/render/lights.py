"""Direct lighting: shadow rays + per-light irradiance over all six light
types (SampleDirectLighting, src/raytracer.cpp:701-806).

Each light type is a static Python branch (counts are compile-time facts) and
is vectorized over (rays x lights of that type).  Sampling randomness is
threaded via explicit keys — replacing the reference's per-light mt19937
members (areaLight.h:50-52, meshLight.h:53-56).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from advanced_cpu_raytracing_tpu.ops.intersect import transform_point
from advanced_cpu_raytracing_tpu.ops.traverse import occluded
from advanced_cpu_raytracing_tpu.ops.texture import sample_nearest
from advanced_cpu_raytracing_tpu.render.shading import Surface, shade
from advanced_cpu_raytracing_tpu.utils.math3d import dot, length

PI = jnp.float32(jnp.pi)


def env_sample_radiance(pack, d):
    """Lat-long environment lookup * 2pi
    (SphericalEnvironmentLight::GetSample, sphericalEnvironmentLight.h:22-35)."""
    u = (1.0 + jnp.arctan2(d[:, 0], -d[:, 2]) / PI) / 2.0
    v = jnp.arccos(jnp.clip(d[:, 1], -1.0, 1.0)) / PI
    img = pack.env_img[0]
    idx = jnp.full(d.shape[0], img, jnp.int32)
    return sample_nearest(pack.img_atlas, pack.img_w, pack.img_h, idx, u, v) * (2.0 * PI)


def direct_lighting(pack, surf: Surface, w_o, time, key, skip_mlight=None,
                    mat_rows=None,
                    differentiable: bool = False):
    """Sum of all direct-light contributions at the surface points.

    ``skip_mlight`` (R,) holds a mesh-light index to skip for NEE
    double-count suppression (raytracer.cpp:778-781) or -1.

    Shadow rays for ALL lights are batched into ONE occlusion query (a
    (L*R,)-lane `occluded` call): the intersection work is identical to L
    serial passes, but fixed per-dispatch costs are paid once and the
    device stays saturated.  The reference scans lights serially per shading point
    (SampleDirectLighting, raytracer.cpp:701-806).
    """
    st = pack.static
    r = surf.point.shape[0]
    total = jnp.zeros((r, 3), jnp.float32)
    # texture-modulated reflectances are light-independent; compute once
    from advanced_cpu_raytracing_tpu.render.shading import (
        diffuse_reflectance,
        specular_reflectance,
    )

    kd = diffuse_reflectance(
        pack, surf, None if mat_rows is None else mat_rows.diffuse)
    ks = specular_reflectance(
        pack, surf, None if mat_rows is None else mat_rows.specular)

    shadow_o = surf.point + surf.normal * pack.shadow_eps

    # ---- phase 1: per-light sample directions + unoccluded irradiance ----
    w_is = []  # each (R,3) unit towards the light
    limits = []  # each (R,) occlusion distance
    irrs = []  # each (R,3) irradiance if unblocked
    gates = []  # each (R,) bool: contribution allowed at all

    def towards(target):
        v = target - surf.point
        dist = length(v)
        return v / jnp.maximum(dist, 1e-20)[:, None], dist

    # point lights (raytracer.cpp:706-718)
    for i in range(st.n_point):
        w_i, dist = towards(jnp.broadcast_to(pack.pl_pos[i], (r, 3)))
        w_is.append(w_i)
        limits.append(dist)
        irrs.append(pack.pl_intensity[i]
                    / jnp.maximum(dist * dist, 1e-20)[:, None])
        gates.append(jnp.ones(r, bool))

    # area lights (raytracer.cpp:720-740, areaLight.h:34-41)
    for i in range(st.n_area):
        key, sub = jax.random.split(key)
        offs = jax.random.uniform(sub, (r, 2), minval=-0.5, maxval=0.5)
        sample_pos = (
            pack.al_pos[i]
            + pack.al_u[i] * (pack.al_extent[i] * offs[:, 0:1])
            + pack.al_v[i] * (pack.al_extent[i] * offs[:, 1:2])
        )
        w_i, dist = towards(sample_pos)
        l_cos = dot(jnp.broadcast_to(pack.al_normal[i], (r, 3)), -w_i)
        l_cos = jnp.where(l_cos < 0, -l_cos, l_cos)  # two-sided (733-736)
        w_is.append(w_i)
        limits.append(dist)
        irrs.append(pack.al_radiance[i] * (
            pack.al_area[i] * l_cos / jnp.maximum(dist * dist, 1e-20)
        )[:, None])
        gates.append(jnp.ones(r, bool))

    # directional lights (raytracer.cpp:757-765): shadow ray to infinity
    for i in range(st.n_directional):
        w_is.append(jnp.broadcast_to(-pack.dl_dir[i], (r, 3)))
        limits.append(jnp.full(r, jnp.inf))
        irrs.append(jnp.broadcast_to(pack.dl_radiance[i], (r, 3)))
        gates.append(jnp.ones(r, bool))

    # spot lights (raytracer.cpp:767-776, spotLight.h:33-57)
    for i in range(st.n_spot):
        w_i, dist = towards(jnp.broadcast_to(pack.sl_pos[i], (r, 3)))
        to_point = -w_i  # unit vector light -> point
        cos_alpha = jnp.clip(
            dot(jnp.broadcast_to(pack.sl_dir[i], (r, 3)), to_point),
            -1.0, 1.0)
        alpha_deg = jnp.rad2deg(jnp.arccos(cos_alpha))
        irr = pack.sl_intensity[i] / jnp.maximum(dist * dist, 1e-20)[:, None]
        # falloff: ((cos a - cos(cov/2)) / (cos(fall/2) - cos(cov/2)))^4
        s = jnp.power(
            jnp.maximum(
                (cos_alpha - pack.sl_cos_half_cov[i])
                / jnp.maximum(
                    pack.sl_cos_half_fall[i] - pack.sl_cos_half_cov[i],
                    1e-9),
                0.0,
            ),
            4.0,
        )
        in_falloff = alpha_deg > (pack.sl_falloff_deg[i] / 2.0)
        irr = jnp.where(in_falloff[:, None], irr * s[:, None], irr)
        outside = (alpha_deg <= 0) | (alpha_deg > pack.sl_coverage_deg[i] / 2.0)
        irr = jnp.where(outside[:, None], 0.0, irr)
        w_is.append(w_i)
        limits.append(dist)
        irrs.append(irr)
        gates.append(jnp.ones(r, bool))

    # mesh lights (raytracer.cpp:778-803, meshLight.h:27-50)
    for i in range(st.n_mesh_lights):
        key, k1, k2 = jax.random.split(key, 3)
        fsel = jax.random.randint(
            k1, (r,), 0, jnp.maximum(pack.ml_face_count[i], 1)
        ) + pack.ml_face_start[i]
        weight = pack.tri_area[fsel] / jnp.maximum(pack.ml_area[i], 1e-20)
        r12 = jax.random.uniform(k2, (r, 2))
        vi = pack.tri_vidx[fsel]
        a = pack.verts[vi[:, 0]]
        b = pack.verts[vi[:, 1]]
        c = pack.verts[vi[:, 2]]
        sq = jnp.sqrt(r12[:, 0:1])
        q = b * (1 - r12[:, 1:2]) + c * r12[:, 1:2]
        pos = a * (1 - sq) + q * sq
        ent = pack.ml_ent[i]
        pos = transform_point(pack.ent_fwd[ent], pos)

        w_i, dist = towards(pos)
        # (the reference computes but never applies the meshlight cosine —
        # its irradiance is radiance*weight*2pi, raytracer.cpp:800)
        skip = (jnp.zeros(r, bool) if skip_mlight is None
                else (skip_mlight == i))
        w_is.append(w_i)
        limits.append(dist)
        irrs.append(pack.ml_radiance[i] * (weight * 2.0 * PI)[:, None])
        gates.append(~skip)

    # ---- phase 2: ONE occlusion sweep over all (light, ray) pairs ----
    n_shadow = len(w_is)
    if n_shadow == 1:
        blocked_all = occluded(pack, shadow_o, w_is[0], limits[0], time,
                               differentiable)[None]
    elif n_shadow > 1:
        big_o = jnp.tile(shadow_o, (n_shadow, 1))
        big_d = jnp.concatenate(w_is, axis=0)
        big_lim = jnp.concatenate(limits, axis=0)
        big_t = jnp.tile(time, n_shadow)
        blocked_all = occluded(pack, big_o, big_d, big_lim, big_t,
                               differentiable).reshape(n_shadow, r)

    # ---- phase 3: shading per light (cheap, elementwise) ----
    for li in range(n_shadow):
        contrib = shade(pack, surf, w_is[li], w_o, irrs[li], kd, ks, mat_rows)
        ok = gates[li] & ~blocked_all[li]
        total = total + jnp.where(ok[:, None], contrib, 0.0)

    # ---- environment lights (raytracer.cpp:741-755): rejection-sampled
    # upper-hemisphere direction, no shadow ray (reference leaves it TODO),
    # and w_i passed to Shade is the *surface normal* (line 753). ----
    for i in range(st.n_env):
        key, sub = jax.random.split(key)
        d = _hemisphere_rejection(sub, surf.normal)
        u = (1.0 + jnp.arctan2(d[:, 0], -d[:, 2]) / PI) / 2.0
        v = jnp.arccos(jnp.clip(d[:, 1], -1.0, 1.0)) / PI
        idx = jnp.full(r, pack.env_img[i], jnp.int32)
        irr = sample_nearest(pack.img_atlas, pack.img_w, pack.img_h,
                             idx, u, v) * (2.0 * PI)
        contrib = shade(pack, surf, surf.normal, w_o, irr, kd, ks, mat_rows)
        total = total + contrib

    return total


def _hemisphere_rejection(key, normal):
    """Upper-hemisphere direction via rejection sampling
    (SphericalEnvironmentLight::GetDirection, sphericalEnvironmentLight.h:37-64).

    The reference loops until success (and never normalizes the accepted
    candidate — its `candidate / length` result is discarded); we draw a
    fixed batch of 16 candidates and take the first valid one, falling back
    to the normal itself.  Matches the reference's *distribution* (uniform
    solid-angle-biased-by-length candidates in the upper hemisphere, unnormalized).
    """
    r = normal.shape[0]
    cands = jax.random.uniform(key, (16, r, 3), minval=-1.0, maxval=1.0)
    ln = length(cands)
    ok = (ln <= 1.0) & (jnp.sum(cands * normal[None], axis=-1) > 0.0)
    first = jnp.argmax(ok, axis=0)  # first True (or 0 if none)
    any_ok = jnp.any(ok, axis=0)
    pick = jnp.take_along_axis(cands, first[None, :, None], axis=0)[0]
    return jnp.where(any_ok[:, None], pick, normal)
