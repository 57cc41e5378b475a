"""Production-scale inverse rendering through the differentiable wavefront.

Recovers material colors, light intensity and vertex positions from a
multisampled 800x800 target image of the in-repo Whitted Cornell box
(scenes/cornell_whitted.xml): Adam over ``trace_radiance`` with the
parameters injected into the pack (``inject_params``, as
diff/optimize.py::make_loss does), loss summed over S stratified sample
grids per step — every step is S fwd+bwd passes over the full frame.

Identifiability: diffuse shading constrains only the PRODUCT
k_diffuse * intensity (the albedo/illumination gauge ambiguity — only
specular-highlight pixels see intensity alone).  The default scene
(``--scene gauge``) BREAKS the gauge with a known (unoptimized)
directional anchor light — see ``gauge_broken_scene`` — so mat_diffuse
and pl_intensity recover individually; ``--scene whitted`` is the
single-light run where only the product identifies.  Vertex positions are
fully identifiable and use a ~30x smaller Adam step (see the
multi_transform note below).

    python tools/inverse_render.py [--steps N] [--spp S] [--res W]
        [--scene {gauge,whitted}] [--texture] [--out FILE]

``--texture`` switches to INVERSE TEXTURE RECOVERY: a 64x64 bilinear
replace_kd texture is recovered from renders (the atlas is a
differentiable leaf of the pack), starting from flat grey + noise.
Prints per-step losses and a summary line; ``--out`` also writes the
summary as JSON.
"""

from __future__ import annotations

import json
import os
import pathlib
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp
import optax

from advanced_cpu_raytracing_tpu.diff.params import (
    extract_params,
    inject_params,
)
from advanced_cpu_raytracing_tpu.render.camera import build_camera
from advanced_cpu_raytracing_tpu.render.integrator import (
    RenderOptions,
    trace_radiance,
)
from advanced_cpu_raytracing_tpu.scene.pack import pack_scene
from advanced_cpu_raytracing_tpu.scene.xml_parser import load_scene

SCENE = str(pathlib.Path(__file__).resolve().parents[1] / "scenes"
            / "cornell_whitted.xml")
FIELDS = ("mat_diffuse", "pl_intensity", "verts")


def gauge_broken_scene(workdir: pathlib.Path) -> str:
    """Author the GAUGE-BROKEN inverse scene.

    Diffuse shading constrains only the product kd * intensity: scaling
    every optimized albedo by alpha and every optimized light by 1/alpha
    preserves all diffuse pixels, so the single-light run can only recover
    the product.  Adding a DirectionalLight with KNOWN (unoptimized)
    radiance anchors the albedos absolutely — kd is pinned by the
    known-light term, and the point-light intensity then separates.  The
    scene is the Whitted Cornell box plus that one anchor light."""
    xml = pathlib.Path(SCENE).read_text()
    anchor = """<DirectionalLight id="1">
            <Direction>0.35 -1 -0.45</Direction>
            <Radiance>40 40 40</Radiance>
        </DirectionalLight>
    """
    assert "DirectionalLight" not in xml
    xml = xml.replace("</Lights>", anchor + "</Lights>")
    out = workdir / "inverse_gauge.xml"
    out.write_text(xml)
    return str(out)


def texture_scene(workdir: pathlib.Path, n: int = 64) -> str:
    """Authored scene for INVERSE TEXTURE RECOVERY: an n x n bilinear
    replace_kd texture on a tilted floor quad filling most of the frame +
    a point light.  The texture is the unknown."""
    from advanced_cpu_raytracing_tpu.post.writers import write_png

    ys, xs = np.mgrid[0:n, 0:n] / float(n)
    tex = np.stack([
        40 + 170 * xs,
        30 + 60 * ((np.floor(xs * 8) + np.floor(ys * 8)) % 2),
        220 * ys,
    ], axis=-1).clip(0, 255).astype(np.uint8)
    td = workdir
    write_png(str(td / "tex.png"), tex)
    xml = f"""<Scene>
  <BackgroundColor>5 5 5</BackgroundColor>
  <MaxRecursionDepth>2</MaxRecursionDepth>
  <Cameras><Camera id="1">
    <Position>0 3.4 3.6</Position><Gaze>0 -0.72 -1</Gaze><Up>0 1 0</Up>
    <NearPlane>-1 1 -1 1</NearPlane><NearDistance>1</NearDistance>
    <ImageResolution>800 800</ImageResolution>
    <ImageName>invtex.png</ImageName>
  </Camera></Cameras>
  <Lights>
    <AmbientLight>20 20 20</AmbientLight>
    <PointLight id="1"><Position>1 4 2</Position>
      <Intensity>1200 1200 1200</Intensity></PointLight>
  </Lights>
  <Materials>
    <Material id="1"><AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.5 0.5 0.5</DiffuseReflectance>
      <SpecularReflectance>0.1 0.1 0.1</SpecularReflectance>
      <PhongExponent>10</PhongExponent></Material>
  </Materials>
  <Textures>
    <Images><Image id="1">{td}/tex.png</Image></Images>
    <TextureMap id="1" type="image">
      <DecalMode>replace_kd</DecalMode><ImageId>1</ImageId>
      <Interpolation>bilinear</Interpolation>
    </TextureMap>
  </Textures>
  <VertexData>
    -2.2 -0.5 1.6   2.2 -0.5 1.6   2.2 0.2 -2.8   -2.2 0.2 -2.8
  </VertexData>
  <TexCoordData>
    0 1   1 1   1 0   0 0
  </TexCoordData>
  <Objects>
    <Mesh id="1"><Material>1</Material><Textures>1</Textures>
      <Faces>1 2 3  1 3 4</Faces></Mesh>
  </Objects>
</Scene>"""
    p = td / "invtex.xml"
    p.write_text(xml)
    return str(p)


def main() -> int:
    def arg(flag, default, cast):
        return cast(sys.argv[sys.argv.index(flag) + 1]) \
            if flag in sys.argv else default

    steps = arg("--steps", 60, int)
    spp = arg("--spp", 4, int)
    res = arg("--res", 800, int)
    lr = arg("--lr", 5e-3, float)
    variant = arg("--scene", "gauge", str)
    if "--texture" in sys.argv:
        variant = "texture"
    out_path = arg("--out", None, str)

    workdir = pathlib.Path(tempfile.mkdtemp(prefix="inverse_render_"))
    fields = FIELDS
    if variant == "whitted":
        scene_path = SCENE
    elif variant == "texture":
        scene_path = texture_scene(workdir)
        fields = ("img_atlas",)
    else:
        scene_path = gauge_broken_scene(workdir)
        # the gauge demo separates MATERIAL from LIGHT with known
        # geometry; joint vertex recovery under the anchor's hard
        # directional shadows random-walks (visibility gradients are
        # stop-grad) and is shown by the whitted variant
        fields = ("mat_diffuse", "pl_intensity")
    cfg = load_scene(scene_path)
    pack = pack_scene(cfg)
    cam_cfg = cfg.cameras[0]
    cam = build_camera(cam_cfg)
    depth = cfg.max_recursion_depth
    # fixed-trip differentiable wavefront; dielectrics take the stochastic
    # single-path estimator, and one fixed key makes the target and every
    # step see the same draws
    opts = RenderOptions(max_depth=depth, differentiable=True,
                         max_iters=depth + 2,
                         stochastic_dielectric=pack.static.has_dielectric)
    key = jax.random.PRNGKey(0)

    def render(params, px, py):
        return trace_radiance(inject_params(pack, params), cam, px, py, key,
                              opts)

    # stratified sample grid: spp fixed jitters of the res x res pixel grid
    # (the reference's n^2 stratified cells, main.cpp:44-76, with one fixed
    # psi per cell so target and optimization see identical sample points)
    n = res * res
    ys, xs = np.divmod(np.arange(n, dtype=np.int64), res)
    sx = cam_cfg.width / res
    sy = cam_cfg.height / res
    jit = np.random.default_rng(7).uniform(0, 1, (spp, 2)).astype(np.float32)
    rays = []
    for s in range(spp):
        px = jnp.asarray((xs + jit[s, 0]) * sx, jnp.float32)
        py = jnp.asarray((ys + jit[s, 1]) * sy, jnp.float32)
        rays.append((px, py))

    true_params = extract_params(pack, fields)

    @jax.jit
    def render_target(params, px, py):
        return render(params, px, py)

    targets = [render_target(true_params, px, py) for (px, py) in rays]
    jax.block_until_ready(targets)

    # perturb: materials darkened, light brightened, geometry nudged; the
    # texture variant instead degrades the texture to flat grey + noise
    rng = np.random.default_rng(3)
    start = dict(true_params)
    if variant == "texture":
        a = np.asarray(true_params["img_atlas"])
        start["img_atlas"] = jnp.asarray(
            np.full_like(a, 128.0)
            + rng.normal(0, 20, a.shape).astype(np.float32))
    else:
        start["mat_diffuse"] = true_params["mat_diffuse"] * 0.45
        start["pl_intensity"] = true_params["pl_intensity"] * 1.7
        if "verts" in fields:
            start["verts"] = true_params["verts"] + jnp.asarray(
                rng.normal(0, 0.01, true_params["verts"].shape)
                .astype(np.float32))

    # optimize in a per-field NORMALIZED space: u = p / scale with scale =
    # a per-field magnitude, so one Adam learning rate serves parameters
    # spanning 5 orders of magnitude (diffuse ~1, intensity ~1e5, verts
    # ~1-5); without this, verts blow up while intensities barely move
    scales = {k: jnp.maximum(jnp.max(jnp.abs(v)), 1e-3)
              for k, v in true_params.items()}

    def to_p(u):
        return {k: u[k] * scales[k] for k in u}

    u_start = {k: v / scales[k] for k, v in start.items()}

    def loss_fn(u, px, py, target):
        img = render(to_p(u), px, py)
        return jnp.mean(((img - target) / 255.0) ** 2)

    # verts get a ~30x smaller step than color/intensity fields: an Adam
    # step of lr in u-space moves a vertex lr*max|verts| world units per
    # step (0.05 at lr=1e-2 — 5x the perturbation being recovered), and
    # silhouette motion is invisible to the fixed-topology gradient, so
    # oversized vertex steps random-walk the geometry instead of descending
    # (measured: joint loss plateaus at 1.6e-2 with one shared lr, reaches
    # 1.6e-4 with the split)
    tx = optax.multi_transform(
        {"fast": optax.adam(lr), "verts": optax.adam(lr * 0.03)},
        {k: ("verts" if k == "verts" else "fast") for k in fields})
    opt_state = tx.init(u_start)

    @jax.jit
    def step_one(u, opt_state, px, py, target):
        loss, grads = jax.value_and_grad(loss_fn)(u, px, py, target)
        updates, opt_state = tx.update(grads, opt_state)
        u = optax.apply_updates(u, updates)
        return u, opt_state, loss

    u = u_start
    # warmup / compile
    u, opt_state, loss0 = step_one(u, opt_state, *rays[0], targets[0])
    jax.block_until_ready(loss0)
    # observability: parameters whose loss gradient is exactly zero at the
    # TRUE optimum across every sample grid have no image footprint from
    # this view (occluded / zero-weighted) — no estimator can recover
    # them, so recovery errors are reported both raw and over the
    # observable set
    gsum = None
    for s in range(spp):
        g = jax.jit(jax.grad(loss_fn))(
            {k: true_params[k] / scales[k] for k in true_params},
            *rays[s], targets[s] * 0.9)
        g = {k: jnp.abs(v) for k, v in g.items()}
        gsum = g if gsum is None else {k: gsum[k] + g[k] for k in g}
    observable = {k: np.asarray(v) > 1e-12 for k, v in gsum.items()}
    u, opt_state = u_start, tx.init(u_start)

    history = []
    t0 = time.perf_counter()
    for i in range(steps):
        total = 0.0
        for s in range(spp):
            u, opt_state, loss = step_one(u, opt_state, *rays[s],
                                          targets[s])
            total += float(loss)
        history.append(total / spp)
        if i % 10 == 0 or i == steps - 1:
            print(f"step {i}: loss {history[-1]:.6f}", flush=True)
    dt = time.perf_counter() - t0
    rate = steps * spp * n / dt
    params = to_p(u)

    def err(k, mask=None):
        a = np.asarray(params[k])
        b = np.asarray(true_params[k])
        if mask is not None:
            m = mask[k]
            if not m.any():
                return 0.0
            a, b = np.where(m, a, b), b
        if k == "img_atlas":
            # only the real texel region (the atlas pads to Hmax x Wmax)
            ih = int(np.asarray(pack.img_h)[0])
            iw = int(np.asarray(pack.img_w)[0])
            a, b = a[0, :ih, :iw], b[0, :ih, :iw]
        scale = max(float(np.abs(b).max()), 1e-6)
        return float(np.abs(a - b).max() / scale)

    if variant != "texture":
        # diffuse shading sees only the PRODUCT diffuse*intensity (the
        # classic albedo/illumination gauge ambiguity — only the few
        # specular-highlight pixels identify intensity alone), so the
        # identifiable combination is reported alongside the raw per-field
        # errors
        prod = np.einsum("mc,pc->mpc", np.asarray(params["mat_diffuse"]),
                         np.asarray(params["pl_intensity"]))
        prod_true = np.einsum("mc,pc->mpc",
                              np.asarray(true_params["mat_diffuse"]),
                              np.asarray(true_params["pl_intensity"]))
        prod_err = float(np.abs(prod - prod_true).max()
                         / max(float(np.abs(prod_true).max()), 1e-6))
    else:
        ih = int(np.asarray(pack.img_h)[0])
        iw = int(np.asarray(pack.img_w)[0])
        a = np.asarray(params["img_atlas"])[0, :ih, :iw]
        b = np.asarray(true_params["img_atlas"])[0, :ih, :iw]
        tex_mse = float(np.mean((a - b) ** 2))
        prod_err = None
    final = np.asarray(render_target(params, *rays[0]))
    tgt0 = np.asarray(targets[0])
    mse = float(np.mean((final - tgt0) ** 2))
    psnr = 10.0 * np.log10(255.0 ** 2 / max(mse, 1e-12))

    summary = {
        "scene": {
            "whitted": "cornell_whitted",
            "gauge": "cornell_whitted + known directional anchor "
                     "(gauge-broken)",
            "texture": "authored 64x64 bilinear replace_kd floor "
                       "(inverse TEXTURE recovery)",
        }[variant],
        "resolution": [res, res],
        "spp": spp,
        "steps": steps,
        "wall_s": round(dt, 3),
        "steps_per_s": round(steps / dt, 3),
        "rays_per_s": round(rate / 1e6, 3),
        "loss_first": history[0],
        "loss_last": history[-1],
        "loss_curve_every5": history[::5],
        "max_rel_err": {k: err(k) for k in fields},
        "max_rel_err_observable": {k: err(k, observable) for k in fields},
        "unobservable_entries": {
            k: int((~observable[k]).sum()) for k in fields},
        "image_psnr_db": round(psnr, 2),
    }
    if variant == "texture":
        summary["texture_mse"] = round(tex_mse, 4)
        summary["texture_psnr_db"] = round(
            10.0 * np.log10(255.0 ** 2 / max(tex_mse, 1e-12)), 2)
    else:
        summary["gauge"] = (
            "ambiguous (single optimized light)" if variant == "whitted"
            else "broken: known DirectionalLight anchors albedo, so "
                 "mat_diffuse and pl_intensity separate")
        summary["diffuse_x_intensity_rel_err"] = prod_err
    print(json.dumps(summary), flush=True)
    if out_path:
        pathlib.Path(out_path).write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
