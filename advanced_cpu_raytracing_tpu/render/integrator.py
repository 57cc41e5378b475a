"""Wavefront integrator: the reference's recursive shading tree re-expressed
as a per-lane ray *stack* iterated by one ``lax.while_loop``.

The reference recurses (PerformShading, src/raytracer.cpp:65-134): mirrors and
conductors spawn one child ray, dielectrics split into two
(raytracer.cpp:261-415), path tracing adds a sampled GI child
(raytracer.cpp:135-191).  Here recursion becomes: every lane owns a small
LIFO stack of pending rays {origin, dir, weight, absorption, medium, depth,
env-on-miss}; each loop iteration pops one entry per lane, traces the whole
batch, accumulates ``weight x local_radiance`` and pushes children.  This
reproduces the recursive tree's arithmetic exactly — a node's contribution is
its local radiance times the product of branch weights (mirror color, Fresnel
ratios, Beer attenuation) along the path from the root, and those products are
tracked in the stacked weight.

Beer's law (raytracer.cpp:416-423) is folded in at pop time: a child carries
the absorption coefficient chosen at push (zero unless its medium check
passed, mirroring the per-branch thresholds at raytracer.cpp:306/345/398) and
the popped hit applies ``exp(-c * t)``.

Russian roulette follows the reference's *intent* (survive with probability
max-throughput once depth exhausted, then divide — raytracer.cpp:137-147) but
tracks real path throughput; the reference's own throughput plumbing never
accumulates before the RR test (Shade mutates it only after the recursive
call), which would recurse forever — we also apply a hard depth floor.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp

from advanced_cpu_raytracing_tpu.ops.traverse import Hit, KIND_TRI, closest_hit
from advanced_cpu_raytracing_tpu.render import camera as cam_mod
from advanced_cpu_raytracing_tpu.render.lights import (
    direct_lighting,
    env_sample_radiance,
)
from advanced_cpu_raytracing_tpu.render.shading import (
    _sample_tex_rgb,
    gather_materials,
    shade_weight,
    surface_at,
)
from advanced_cpu_raytracing_tpu.scene.pack import SLOT_REPLACE_ALL, ScenePack
from advanced_cpu_raytracing_tpu.scene.types import MaterialType
from advanced_cpu_raytracing_tpu.utils.math3d import (
    dot,
    normalize,
    orthonormal_basis,
)

PI = jnp.float32(jnp.pi)
RR_DEPTH_FLOOR = 8  # extra bounces allowed past depth 0 under Russian roulette


@dataclass(frozen=True)
class RenderOptions:
    """Static (compile-time) renderer switches — RendererParams
    (src/rendererParams.h:6-26) plus engine knobs."""

    path_tracing: bool = False
    importance_sampling: bool = False
    next_event_estimation: bool = False
    russian_roulette: bool = False
    max_depth: int = 0
    max_iters: int = 0  # 0 -> auto
    # Reverse-mode AD cannot cross lax.while_loop; the differentiable path
    # runs a fixed-trip-count fori_loop instead (fully masked body, so the
    # result is identical — only early exit is lost).
    differentiable: bool = False
    # Dielectric hits sample ONE child (reflect with probability r_refl, else
    # refract) instead of splitting into both.  The Fresnel weight cancels
    # against the selection probability, so the child weight equals the
    # parent's — an unbiased estimator of the deterministic split (reference
    # raytracer.cpp:313-410) with a FLAT ray population: iterations stay
    # O(depth) instead of O(2^depth).  The MC default for path tracing;
    # Whitted golden renders keep the deterministic split.
    stochastic_dielectric: bool = False
    # PT at a specular hit spawns BOTH a GI child and a specular child
    # (raytracer.cpp:135-191 + 261-472 together).  This mode samples ONE:
    # where both exist, a replayed fair coin picks GI or specular and the
    # chosen child's weight doubles — unbiased, and every node pushes at
    # most one child, so the population stays a linear chain (requires
    # stochastic_dielectric when dielectrics are present).
    stochastic_spec_gi: bool = False

    def auto_iters(self, branching: int = 2) -> int:
        """Upper bound on processed tree nodes per lane.

        ``branching`` = max children per node (1 for pure specular chains,
        2 with dielectric splits or PT+specular, 3 for PT+dielectric); a
        b-ary tree of depth d has at most (b^(d+1)-1)/(b-1) nodes.
        """
        if self.max_iters:
            return self.max_iters
        d = self.max_depth + (RR_DEPTH_FLOOR if self.russian_roulette else 0)
        if branching <= 1:
            return d + 2
        return min((branching ** (min(d, 9) + 1)) // (branching - 1) + 16, 4096)


class _Stack(NamedTuple):
    o: jnp.ndarray  # (R,K,3)
    d: jnp.ndarray  # (R,K,3)
    w: jnp.ndarray  # (R,K,3)
    absorb: jnp.ndarray  # (R,K,3)
    medium: jnp.ndarray  # (R,K)
    depth: jnp.ndarray  # (R,K)
    envmiss: jnp.ndarray  # (R,K) bool
    primary: jnp.ndarray  # (R,K) bool — miss resolves to the bg color
    sp: jnp.ndarray  # (R,)


def _make_stack(r: int, k: int) -> _Stack:
    # directions initialized to +z so that popped *empty* entries (masked
    # lanes in the loop) never trace degenerate d = 0 rays — their NaNs
    # would leak through jnp.where in reverse-mode AD
    d0 = jnp.zeros((r, k, 3)).at[:, :, 2].set(1.0)
    return _Stack(
        o=jnp.zeros((r, k, 3)), d=d0,
        w=jnp.zeros((r, k, 3)), absorb=jnp.zeros((r, k, 3)),
        medium=jnp.ones((r, k)), depth=jnp.zeros((r, k), jnp.int32),
        envmiss=jnp.zeros((r, k), bool), primary=jnp.zeros((r, k), bool),
        sp=jnp.zeros(r, jnp.int32),
    )


def _push(stack: _Stack, mask, o, d, w, absorb, medium, depth, envmiss,
          primary=None) -> _Stack:
    """Push one entry per masked lane at its stack pointer.

    Implemented as a one-hot select over the (small, static) K axis rather
    than a dynamic-index scatter: per-lane scatters cost tens of ms at 500k
    lanes on TPU, while the masked broadcast is a plain bandwidth-bound
    elementwise op.
    """
    r = mask.shape[0]
    k = stack.o.shape[1]
    if primary is None:
        primary = jnp.zeros(r, bool)
    slot = (jnp.arange(k)[None, :] == stack.sp[:, None]) & mask[:, None]  # (R,K)

    def set2(arr, val):
        if arr.ndim == 3:
            return jnp.where(slot[..., None], val[:, None, :], arr)
        return jnp.where(slot, val[:, None], arr)

    return _Stack(
        o=set2(stack.o, o), d=set2(stack.d, d), w=set2(stack.w, w),
        absorb=set2(stack.absorb, absorb),
        medium=set2(stack.medium, medium),
        depth=set2(stack.depth, depth),
        envmiss=set2(stack.envmiss, envmiss),
        primary=set2(stack.primary, primary),
        sp=stack.sp + mask.astype(jnp.int32),
    )


def _pop(stack: _Stack):
    """Pop the top entry per lane (masked one-hot reduction over K)."""
    r = stack.sp.shape[0]
    k = stack.o.shape[1]
    active = stack.sp > 0
    idx = jnp.maximum(stack.sp - 1, 0)
    slot = jnp.arange(k)[None, :] == idx[:, None]  # (R,K)

    def get2(arr, default=0.0):
        if arr.ndim == 3:
            return jnp.sum(jnp.where(slot[..., None], arr, 0), axis=1)
        if arr.dtype == jnp.bool_:
            return jnp.any(slot & arr, axis=1)
        return jnp.sum(jnp.where(slot, arr, 0), axis=1)

    entry = (
        get2(stack.o), get2(stack.d), get2(stack.w), get2(stack.absorb),
        get2(stack.medium), get2(stack.depth), get2(stack.envmiss),
        get2(stack.primary),
    )
    new_stack = stack._replace(sp=jnp.where(active, stack.sp - 1, stack.sp))
    return new_stack, active, entry


def _reflect_rough(n, w_o, rough, key):
    """Reflect with optional roughness perturbation
    (Raytracer::Reflect, src/raytracer.cpp:424-440)."""
    r = normalize(n * (2.0 * dot(n, w_o))[:, None] - w_o)
    u, v = orthonormal_basis(r)
    psi = jax.random.uniform(key, r.shape[:1] + (2,)) - 0.5
    perturbed = normalize(r + (u * psi[:, 0:1] + v * psi[:, 1:2]) * rough[:, None])
    return jnp.where((rough > 0.001)[:, None], perturbed, r)


def _perturb_dir(d, rough, key):
    """Roughness perturbation of an arbitrary direction (refraction case,
    raytracer.cpp:366-376)."""
    u, v = orthonormal_basis(d)
    psi = jax.random.uniform(key, d.shape[:1] + (2,)) - 0.5
    perturbed = normalize(d + (u * psi[:, 0:1] + v * psi[:, 1:2]) * rough[:, None])
    return jnp.where((rough > 0.001)[:, None], perturbed, normalize(d))


def _process_hit(pack: ScenePack, opts: RenderOptions, o, d, w_in, absorb,
                 medium, depth, time, key, hit: Hit, L, stack: _Stack):
    """Shade one popped batch of rays and push children.

    Mirrors PerformShading (src/raytracer.cpp:65-134) with the branch weights
    applied at push time.  Returns (L, stack).
    """
    st = pack.static
    r = o.shape[0]
    valid = hit.valid
    t_safe = jnp.where(valid, hit.t, 0.0)
    atten = jnp.exp(-absorb * t_safe[:, None])
    w = w_in * atten

    surf = surface_at(pack, o, d, time, hit)
    w_o = -d
    m = surf.mat
    mr = gather_materials(pack, m)
    mtype = mr.type
    eps = pack.shadow_eps
    n = surf.normal
    p = surf.point
    rough = mr.rough

    active = valid
    any_specular = st.has_mirror or st.has_dielectric or st.has_conductor

    # emissive: radiance * 2pi, nothing else (raytracer.cpp:81-84)
    is_emissive = mtype == int(MaterialType.EMISSIVE)
    L = L + jnp.where((active & is_emissive)[:, None],
                      w * mr.radiance * (2.0 * PI), 0.0)
    active = active & ~is_emissive

    # replace_all texture short-circuits shading (raytracer.cpp:87-89)
    if st.n_textures > 0:
        ra_slot = surf.tex[:, SLOT_REPLACE_ALL]
        has_ra = ra_slot >= 0
        ra_col = _sample_tex_rgb(pack, ra_slot, surf.uv)
        L = L + jnp.where((active & has_ra)[:, None], w * ra_col, 0.0)
        active = active & ~has_ra

    # travellingInsideAnObject (raytracer.cpp:77-78); the medium can only
    # exceed vacuum when dielectric materials exist (static gate)
    if st.has_dielectric:
        inside = medium > 1.00001
    else:
        inside = jnp.zeros(r, bool)

    key, k_gi, k_rr, k_dl, k_m, k_c, k_t, k_rl, k_rf = jax.random.split(key, 9)

    # ---- path tracing: sampled GI bounce (raytracer.cpp:135-191) ----
    skip_ml = jnp.full(r, -1, jnp.int32)
    if opts.path_tracing:
        if opts.russian_roulette:
            max_thr = jnp.max(w, axis=-1)
            prob = jnp.clip(max_thr, 1e-4, 1.0)
            kill = (jax.random.uniform(k_rr, (r,)) > prob) & (depth <= 0)
            gi_alive = active & ~kill & (depth > -RR_DEPTH_FLOOR)
            rr_scale = jnp.where(depth <= 0, 1.0 / prob, 1.0)
        else:
            gi_alive = active & (depth > 0)
            rr_scale = jnp.ones(r)

        r12 = jax.random.uniform(k_gi, (r, 2))
        phi = 2.0 * PI * r12[:, 0]
        theta = jnp.where(
            opts.importance_sampling,
            jnp.arcsin(jnp.sqrt(r12[:, 1])),
            jnp.arccos(r12[:, 1]),
        )
        u_b, v_b = orthonormal_basis(n)
        # eps guard: dead/miss lanes can carry a degenerate basis (zero
        # normal) — an unguarded 0/0 here poisons the whole frame's
        # reverse-mode gradients through 0 * NaN cotangent products even
        # though the lanes themselves are masked out of the push
        gi_dir = normalize(
            u_b * (jnp.sin(theta) * jnp.cos(phi))[:, None]
            + n * jnp.cos(theta)[:, None]
            + v_b * (jnp.sin(theta) * jnp.sin(phi))[:, None],
            eps=1e-20,
        )
        gi_o = p + n * 1e-4  # hardcoded GI epsilon (raytracer.cpp:174)
        gi_hit = closest_hit(pack, gi_o, gi_dir, time,
                              differentiable=opts.differentiable)
        # NEE double-count suppression: if the GI ray hits an emissive mesh
        # light, the parent's direct sampling skips that light
        # (raytracer.cpp:180-188, 778-781)
        if st.n_mesh_lights > 0:
            gi_ent = jnp.clip(gi_hit.index, 0, max(st.n_entities - 1, 0))
            gi_em = gi_hit.valid & (gi_hit.kind == KIND_TRI) & pack.ent_emissive[gi_ent]
            skip_ml = jnp.where(gi_alive & gi_em, pack.ent_mlight[gi_ent], -1)

        gi_w = w * shade_weight(pack, surf, gi_dir, w_o, mr) * (2.0 * PI) \
            * rr_scale[:, None]
        if opts.stochastic_spec_gi:
            # deferred: pushed after the specular children are built so the
            # replayed coin can pick one of the two (see below)
            assert opts.stochastic_dielectric or not st.has_dielectric
        else:
            stack = _push(
                stack, gi_alive & gi_hit.valid, gi_o, gi_dir, gi_w,
                jnp.zeros((r, 3)), medium, depth - 1, jnp.zeros(r, bool),
            )

    # ---- ambient + direct lighting (raytracer.cpp:98-108) ----
    sample_direct = (not opts.path_tracing) or opts.next_event_estimation
    if sample_direct:
        lit = active & ~inside
        amb = pack.ambient_light * mr.ambient
        contrib = amb
        n_lights = (st.n_point + st.n_area + st.n_env + st.n_directional
                    + st.n_spot + st.n_mesh_lights)
        if n_lights > 0:
            contrib = contrib + direct_lighting(
                pack, surf, w_o, time, k_dl, skip_ml,
                differentiable=opts.differentiable, mat_rows=mr)
        L = L + jnp.where(lit[:, None], w * contrib, 0.0)

    can_recurse = depth > 0

    # ---- specular children ----
    # Mirror / conductor / dielectric are mutually exclusive per material, so
    # all "reflection-like" children (mirror raytracer.cpp:442-472, conductor
    # 208-254, dielectric TIR 292-311 and partial reflection 326-356) merge
    # into ONE masked push; the refraction leg (358-410) is the second.
    any_reflect = jnp.zeros(r, bool)
    refl_o = p
    refl_d = w_o
    refl_w = w
    refl_absorb = jnp.zeros((r, 3))
    refl_medium = jnp.ones(r)
    refl_env = jnp.zeros(r, bool)

    if st.has_mirror or st.has_conductor:
        w_rn = _reflect_rough(n, w_o, rough, k_m)

    if st.has_mirror:
        is_mirror = active & (mtype == int(MaterialType.MIRROR)) & can_recurse
        any_reflect |= is_mirror
        mm = is_mirror[:, None]
        refl_o = jnp.where(mm, p + n * eps, refl_o)
        refl_d = jnp.where(mm, w_rn, refl_d)
        refl_w = jnp.where(mm, w * mr.mirror, refl_w)
        # mirror miss samples the env light (461-469)
        refl_env |= is_mirror & bool(st.has_env)

    if st.has_conductor:
        cos_t = dot(w_o, n)
        n2 = mr.ior
        k2 = mr.cond_k
        n2k2 = n2 * n2 + k2 * k2
        two_n2cos = 2.0 * n2 * cos_t
        cos2 = cos_t * cos_t
        rs = (n2k2 - two_n2cos + cos2) / jnp.maximum(n2k2 + two_n2cos + cos2, 1e-20)
        rp = (n2k2 * cos2 - two_n2cos + 1.0) / jnp.maximum(n2k2 * cos2 + two_n2cos + 1.0, 1e-20)
        ratio = 0.5 * (rs + rp)
        is_cond = (active & (mtype == int(MaterialType.CONDUCTOR))
                   & can_recurse & (ratio > 1e-4))
        any_reflect |= is_cond
        cm = is_cond[:, None]
        refl_o = jnp.where(cm, p + n * eps, refl_o)
        refl_d = jnp.where(cm, w_rn, refl_d)
        refl_w = jnp.where(cm, w * mr.mirror * ratio[:, None], refl_w)
        # conductor miss contributes 0 (242-247): refl_env stays False

    if st.has_dielectric:
        is_diel = mtype == int(MaterialType.DIELECTRIC)
        cos0 = -dot(d, n)
        entering = cos0 > 0.0
        n_mod = jnp.where(entering[:, None], n, -n)
        cos_i = jnp.abs(cos0)
        n1 = jnp.where(entering, medium, mr.ior)
        n2d = jnp.where(entering, mr.ior, 1.0)
        obj_n = jnp.where(entering, mr.ior, 1.0)
        ratio_n = n1 / jnp.maximum(n2d, 1e-20)
        sin2 = 1.0 - cos_i * cos_i
        crit = ratio_n * ratio_n * sin2
        tir = crit > 1.0
        mat_abs = mr.absorption
        w_rd = _reflect_rough(n_mod, w_o, rough, k_t)

        # TIR: reflect only, weight 1, medium copied (292-311)
        is_tir = active & is_diel & tir & can_recurse
        any_reflect |= is_tir
        tm = is_tir[:, None]
        refl_o = jnp.where(tm, p + n_mod * eps, refl_o)
        refl_d = jnp.where(tm, w_rd, refl_d)
        refl_w = jnp.where(tm, w, refl_w)
        refl_absorb = jnp.where(
            tm & (medium > 1.0001)[:, None], mat_abs, refl_absorb)
        refl_medium = jnp.where(is_tir, medium, refl_medium)

        # partial reflection (313-356); both children take objN as medium.
        # NaN-guard: sqrt'(0) = inf; on TIR lanes (crit >= 1) the argument
        # clamps to the 0 constant and reverse-mode 0 * inf = NaN would leak
        # through the masked selects below, so feed sqrt a safe argument on
        # lanes whose value is discarded anyway.
        cos_p = jnp.sqrt(jnp.where(tir, 1.0, jnp.maximum(1.0 - crit, 1e-20)))
        cos_p = jnp.where(tir, 0.0, cos_p)
        n2cos = n2d * cos_i
        n1cosp = n1 * cos_p
        rpar = (n2cos - n1cosp) / jnp.maximum(n2cos + n1cosp, 1e-20)
        rperp = (n1 * cos_i - n2d * cos_p) / jnp.maximum(
            n1 * cos_i + n2d * cos_p, 1e-20)
        r_refl = 0.5 * (rpar * rpar + rperp * rperp)
        r_refr = 1.0 - r_refl
        child_medium = obj_n

        is_rl = active & is_diel & ~tir & can_recurse
        refr_dir = (d + n_mod * cos_i[:, None]) * ratio_n[:, None] \
            - n_mod * cos_p[:, None]
        refr_dir = _perturb_dir(refr_dir, rough, k_rf)
        absorb_rf = jnp.where((child_medium > 1.001)[:, None], mat_abs, 0.0)

        if opts.stochastic_dielectric:
            # single-path mode: pick reflect w.p. r_refl else refract; the
            # Fresnel weight cancels against the selection probability, so
            # the child's weight is exactly the parent's
            choose_refl = jax.random.uniform(k_rl, (r,)) < r_refl
            is_refl_c = is_rl & choose_refl
            is_refr_c = is_rl & ~choose_refl
            any_reflect |= is_rl
            fm = is_refl_c[:, None]
            refl_o = jnp.where(fm, p + n_mod * eps, refl_o)
            refl_d = jnp.where(fm, w_rd, refl_d)
            refl_w = jnp.where(fm, w, refl_w)
            refl_absorb = jnp.where(
                fm & (child_medium > 1.00001)[:, None], mat_abs, refl_absorb)
            gm = is_refr_c[:, None]
            refl_o = jnp.where(gm, p - n_mod * eps, refl_o)
            refl_d = jnp.where(gm, refr_dir, refl_d)
            refl_w = jnp.where(gm, w, refl_w)
            refl_absorb = jnp.where(gm, absorb_rf, refl_absorb)
            refl_medium = jnp.where(is_rl, child_medium, refl_medium)
            refl_env |= is_rl & bool(st.has_env)
        else:
            any_reflect |= is_rl
            rm = is_rl[:, None]
            refl_o = jnp.where(rm, p + n_mod * eps, refl_o)
            refl_d = jnp.where(rm, w_rd, refl_d)
            refl_w = jnp.where(rm, w * r_refl[:, None], refl_w)
            refl_absorb = jnp.where(
                rm & (child_medium > 1.00001)[:, None], mat_abs, refl_absorb)
            refl_medium = jnp.where(is_rl, child_medium, refl_medium)
            refl_env |= is_rl & bool(st.has_env)

    if opts.path_tracing and opts.stochastic_spec_gi:
        # single-child estimator: where a GI child AND a specular
        # child both exist, a replayed fair coin (k_c) picks one and its
        # weight doubles; single-child lanes push as usual.  E over the
        # coin = GI + specular = the reference's two-child recursion.
        gi_would = gi_alive & gi_hit.valid
        spec_would = any_reflect if any_specular else jnp.zeros(r, bool)
        both = gi_would & spec_would
        choose_gi = jax.random.uniform(k_c, (r,)) < 0.5
        two = jnp.where(both, 2.0, 1.0)[:, None]
        stack = _push(
            stack, gi_would & (~spec_would | choose_gi), gi_o, gi_dir,
            gi_w * two, jnp.zeros((r, 3)), medium, depth - 1,
            jnp.zeros(r, bool),
        )
        if any_specular:
            stack = _push(
                stack, spec_would & (~gi_would | ~choose_gi), refl_o,
                refl_d, refl_w * two, refl_absorb, refl_medium, depth - 1,
                refl_env,
            )
    elif any_specular:
        stack = _push(stack, any_reflect, refl_o, refl_d, refl_w,
                      refl_absorb, refl_medium, depth - 1, refl_env)

    if st.has_dielectric and not opts.stochastic_dielectric:
        # deterministic split: the refraction leg is a SECOND child
        # (358-410)
        stack = _push(
            stack, is_rl,
            p - n_mod * eps, refr_dir, w * r_refr[:, None],
            absorb_rf, child_medium, depth - 1, jnp.full(r, st.has_env),
        )

    return L, stack


def trace_radiance(pack: ScenePack, cam, px, py, key, opts: RenderOptions):
    """Full radiance for a batch of (fractional) pixel coordinates.

    Replicates PerPixel (src/raytracer.cpp:38-63): primary ray (with DoF and
    motion-blur time), background resolution order on miss (bg texture ->
    env light -> flat color), then the shading tree.  The primary ray is
    pushed onto the stack like any other node, so the loop body is the single
    compiled trace+shade instance.
    """
    st = pack.static
    r = px.shape[0]
    key, k_time, k_lens, k_loop = jax.random.split(key, 4)

    time = jax.random.uniform(k_time, (r,)) if st.has_motion else jnp.zeros(r)
    lens = jax.random.uniform(k_lens, (r, 2), minval=-1.0, maxval=1.0)
    o, d = cam_mod.generate_rays(cam, px, py, lens, dof=cam.use_dof)

    # primary miss color (raytracer.cpp:49-62): bg texture -> env -> flat
    if st.bg_tex >= 0:
        u = px / cam.width
        v = py / cam.height
        ti = jnp.full(r, st.bg_tex, jnp.int32)
        miss_col = _sample_tex_rgb(pack, ti, jnp.stack([u, v], axis=-1))
    elif st.has_env:
        miss_col = env_sample_radiance(pack, d)
    else:
        miss_col = jnp.broadcast_to(pack.bg_color, (r, 3))

    # stack capacity: with P push-branches per node, DFS depth grows by at
    # most (P-1) per level.  P = specular chain (1) + GI (PT) + the extra
    # dielectric split (elided in stochastic single-path mode).
    branches = 1 + (1 if opts.path_tracing else 0) + (
        1 if st.has_dielectric and not opts.stochastic_dielectric else 0)
    if opts.path_tracing and opts.stochastic_spec_gi:
        # single-child estimator: every node pushes at most one child
        branches = 1
    depth_total = opts.max_depth + (RR_DEPTH_FLOOR if opts.russian_roulette else 0)
    if branches == 1:
        # pure specular chains push at most ONE pending child between pops —
        # a deep stack only wastes one-hot push/pop bandwidth
        k_stack = 2
    else:
        k_stack = (branches - 1) * max(depth_total, 1) + 4
    stack = _make_stack(r, k_stack)
    ones = jnp.ones(r, bool)
    stack = _push(stack, ones, o, d, jnp.ones((r, 3)), jnp.zeros((r, 3)),
                  jnp.ones(r), jnp.full(r, opts.max_depth, jnp.int32),
                  jnp.zeros(r, bool), primary=ones)

    L = jnp.zeros((r, 3))
    max_iters = opts.auto_iters(branching=branches) + 1

    def cond(state):
        it, _, _, stack = state
        return (it < max_iters) & jnp.any(stack.sp > 0)

    def body(state):
        it, key, L, stack = state
        key, k_it = jax.random.split(key)
        stack, active, (eo, ed, ew, eabs, emed, edep, eenv, eprim) = _pop(stack)
        hit = closest_hit(pack, eo, ed, time,
                          differentiable=opts.differentiable)
        hit = hit._replace(valid=hit.valid & active)
        # miss resolution: primary -> bg color stack; secondary -> env only
        # where the spawning branch samples it (else 0)
        missed = active & ~hit.valid
        L = L + jnp.where((missed & eprim)[:, None], ew * miss_col, 0.0)
        if st.has_env:
            env_c = env_sample_radiance(pack, ed)
            L = L + jnp.where((missed & ~eprim & eenv)[:, None],
                              ew * env_c, 0.0)
        L, stack = _process_hit(
            pack, opts, eo, ed, ew, eabs, emed, edep, time, k_it, hit, L, stack,
        )
        return it + 1, key, L, stack

    init = (jnp.int32(0), k_loop, L, stack)
    if opts.differentiable:
        # Fixed-trip fori_loop lowers to scan (reverse-differentiable); the
        # scan keeps every iteration's residuals (no rematerialization).
        _, _, L, _ = jax.lax.fori_loop(0, max_iters, lambda i, s: body(s), init)
    else:
        _, _, L, _ = jax.lax.while_loop(cond, body, init)
    return L
