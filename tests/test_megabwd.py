"""The differentiable jnp wavefront against frozen value-and-gradient
outputs of the fused fwd+bwd Pallas kernel this repository used to carry.

Oracle: the kernel (ops/pallas/megabwd.py, removed; git keeps it) replayed
the wavefront's key schedule, so at these scenes its loss and gradients
matched jax.grad of trace_radiance(differentiable=True) lane for lane.  Its
outputs — run in interpret mode at the parent commit, see
tests/data/fused_oracle/README.md — are committed, and each test checks the
wavefront's value and gradients against them at the tolerance the
kernel-vs-wavefront test had, plus the wavefront's own gradient against
finite differences where the original test probed the kernel's.
"""

import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from advanced_cpu_raytracing_tpu.diff.params import extract_params, inject_params
from advanced_cpu_raytracing_tpu.render.camera import build_camera
from advanced_cpu_raytracing_tpu.render.integrator import (
    RR_DEPTH_FLOOR,
    RenderOptions,
    trace_radiance,
)
from advanced_cpu_raytracing_tpu.render.renderer import options_for_camera
from advanced_cpu_raytracing_tpu.scene.pack import pack_scene
from advanced_cpu_raytracing_tpu.scene.xml_parser import load_scene

ORACLE = pathlib.Path(__file__).parent / "data" / "fused_oracle"
PARAMS = ("mat_ambient", "mat_diffuse", "mat_specular", "mat_mirror",
          "mat_phong", "pl_intensity", "dl_radiance", "bg_color", "verts")
PT_PARAMS = ("mat_ambient", "mat_diffuse", "mat_specular", "mat_phong",
             "mat_radiance", "ml_radiance", "bg_color", "verts")


def _setup(path, n, seed):
    cfg = load_scene(str(path))
    pack = pack_scene(cfg)
    cam_cfg = cfg.cameras[0]
    cam = build_camera(cam_cfg)
    rng = np.random.default_rng(seed)
    px = jnp.asarray(rng.uniform(0, cam_cfg.width, n).astype(np.float32))
    py = jnp.asarray(rng.uniform(0, cam_cfg.height, n).astype(np.float32))
    return cfg, pack, cam, px, py


def _cos_loss(img):
    return jnp.sum(img * jnp.cos(0.01 * img))  # non-trivial cotangent


def _wavefront_loss(pack, cam, px, py, d_opts, reduce=_cos_loss):
    def loss(p):
        img = trace_radiance(inject_params(pack, p), cam, px, py,
                             jax.random.PRNGKey(0), d_opts)
        return reduce(img)
    return loss


def _check(name, loss, params, atol_scale=5e-4):
    """Wavefront value and gradients vs the frozen kernel's."""
    ref = np.load(ORACLE / f"{name}.npz")
    v0, g0 = jax.value_and_grad(loss)(params)
    np.testing.assert_allclose(float(ref["v"]), float(v0), rtol=2e-4)
    for k in params:
        a, b = np.asarray(g0[k]), ref["g_" + k]
        if a.size == 0:
            continue
        assert np.all(np.isfinite(a)), f"wavefront NaN: {k}"
        scale = max(np.abs(a).max(), 1e-6)
        np.testing.assert_allclose(b, a, rtol=5e-3, atol=atol_scale * scale,
                                   err_msg=k)
    return ref, g0


def _fd(loss, params, field, index, h, ref_vals):
    """Central difference of the wavefront loss along one parameter entry;
    its probe values must equal the frozen kernel's."""
    vals = []
    for s in (+h, -h):
        p2 = dict(params)
        p2[field] = jnp.asarray(params[field]).at[index].add(s)
        vals.append(float(loss(p2)))
    np.testing.assert_allclose(vals, ref_vals, rtol=2e-4)
    return (vals[0] - vals[1]) / (2 * h)


SPOT_AREA_ML_SCENE = (pathlib.Path(__file__).resolve().parents[1]
                      / "scenes" / "feat_spotareaml.xml")

ALL_PARAMS = PARAMS + ("mat_radiance", "sl_intensity", "al_radiance",
                       "ml_radiance")


def test_megabwd_spot_area_meshlight_emissive():
    """Spot + area + emissive mesh light (Whitted NEE of all three): the
    emissive hit (raytracer.cpp:81-84) and mesh-light NEE (778-803)
    gradients flow to mat_radiance / ml_radiance / the light mesh's
    vertices."""
    cfg, pack, cam, px, py = _setup(SPOT_AREA_ML_SCENE, 256, 5)
    st = pack.static
    assert (st.n_spot, st.n_area, st.n_mesh_lights) == (1, 1, 1)
    assert st.has_emissive_mat
    opts = options_for_camera(cfg, cfg.cameras[0])
    d_opts = RenderOptions(max_depth=opts.max_depth, differentiable=True,
                           max_iters=opts.max_depth + 2)
    params = extract_params(pack, ALL_PARAMS)
    _, g = _check("bwd_spot_area_meshlight_emissive",
                  _wavefront_loss(pack, cam, px, py, d_opts), params)
    for k in ("sl_intensity", "al_radiance", "ml_radiance", "mat_radiance"):
        assert np.abs(np.asarray(g[k])).sum() > 0, k


_PT_ORACLE = {
    "NextEventEstimation ImportanceSampling": "bwd_path_tracing_nee_is",
    "NextEventEstimation": "bwd_path_tracing_nee",
    "": "bwd_path_tracing_plain",
}


@pytest.mark.parametrize("renderer_params", list(_PT_ORACLE))
def test_megabwd_path_tracing_matches_wavefront(tmp_path, renderer_params):
    """Path tracing in all three RendererParams modes
    (raytracer.cpp:135-191): the GI continuation, and NEE that skips the
    mesh light each lane's GI ray hit."""
    from tests.scene_builders import cornell_pt_xml

    (tmp_path / "pt.xml").write_text(
        cornell_pt_xml(depth=2, res=32, spp=1, params=renderer_params))
    cfg, pack, cam, px, py = _setup(tmp_path / "pt.xml", 256, 3)
    opts = options_for_camera(cfg, cfg.cameras[0])
    assert opts.path_tracing
    d_opts = RenderOptions(
        max_depth=opts.max_depth, differentiable=True,
        max_iters=opts.max_depth + 2, path_tracing=True,
        next_event_estimation=opts.next_event_estimation,
        importance_sampling=opts.importance_sampling)
    params = extract_params(pack, PT_PARAMS)
    loss = _wavefront_loss(pack, cam, px, py, d_opts)
    ref, g = _check(_PT_ORACLE[renderer_params], loss, params)
    # GI bounces actually carry gradient: the light's radiance reaches the
    # camera only through the sampled chain in the non-NEE mode
    assert np.abs(np.asarray(g["mat_diffuse"])).sum() > 0
    assert (np.abs(np.asarray(g["mat_radiance"])).sum()
            + np.abs(np.asarray(g["ml_radiance"])).sum()) > 0
    if "fd" in ref:
        # finite differences on the wall diffuse (the estimator is
        # deterministic given the key, so central differences are exact up
        # to fp noise)
        fd = _fd(loss, params, "mat_diffuse", (0, 0), 1e-3, ref["fd"])
        np.testing.assert_allclose(float(g["mat_diffuse"][0, 0]), fd,
                                   rtol=2e-3)


def test_megabwd_path_tracing_russian_roulette(tmp_path):
    """RR: kill draws, the differentiable 1/prob reweight on the same
    throughput the kill used, and RR_DEPTH_FLOOR extra iterations
    (integrator.py).  The loss is log1p: RR fireflies (1/prob up to 1e4)
    make oscillatory losses chaotic in fp32."""
    from tests.scene_builders import cornell_pt_xml

    (tmp_path / "pt.xml").write_text(cornell_pt_xml(
        depth=1, res=32, spp=1,
        params="NextEventEstimation ImportanceSampling RussianRoulette"))
    cfg, pack, cam, px, py = _setup(tmp_path / "pt.xml", 128, 3)
    opts = options_for_camera(cfg, cfg.cameras[0])
    assert opts.russian_roulette
    d_opts = RenderOptions(
        max_depth=opts.max_depth, differentiable=True,
        max_iters=opts.max_depth + RR_DEPTH_FLOOR + 2, path_tracing=True,
        next_event_estimation=True, importance_sampling=True,
        russian_roulette=True)
    params = extract_params(pack, PT_PARAMS)
    loss = _wavefront_loss(pack, cam, px, py, d_opts,
                           reduce=lambda img: jnp.sum(jnp.log1p(img)))
    _, g = _check("bwd_path_tracing_russian_roulette", loss, params,
                  atol_scale=1e-3)
    # the RR tail actually fires: some lane survives past depth 0
    assert float(jnp.sum(jnp.abs(g["mat_radiance"]))) > 0


@pytest.mark.parametrize("dielectric", [False, True])
def test_megabwd_path_tracing_specular(tmp_path, dielectric):
    """PT + specular mixtures: mirror and conductor walls (and optionally a
    glass sphere) in the PT cornell box.  Where a hit spawns both a GI child
    and a specular child, a coin picks one and doubles its weight (the
    stochastic_spec_gi estimator; raytracer.cpp:135-191 + 261-472)."""
    from tests.scene_builders import cornell_pt_spec_xml

    (tmp_path / "pts.xml").write_text(cornell_pt_spec_xml(
        depth=2, res=32, spp=1, params="NextEventEstimation",
        dielectric=dielectric))
    cfg, pack, cam, px, py = _setup(tmp_path / "pts.xml", 256, 5)
    assert pack.static.has_mirror and pack.static.has_conductor
    assert pack.static.has_dielectric == dielectric
    opts = options_for_camera(cfg, cfg.cameras[0])
    assert opts.path_tracing
    d_opts = RenderOptions(
        max_depth=opts.max_depth, differentiable=True,
        max_iters=opts.max_depth + 2, path_tracing=True,
        next_event_estimation=True,
        stochastic_dielectric=dielectric, stochastic_spec_gi=True)
    params = extract_params(pack, PT_PARAMS + ("mat_mirror", "pl_intensity"))
    loss = _wavefront_loss(pack, cam, px, py, d_opts)
    name = ("bwd_path_tracing_specular_dielectric" if dielectric
            else "bwd_path_tracing_specular")
    ref, g = _check(name, loss, params)
    # mirror gradients actually flow (a specular chain was taken)
    g_mir = np.asarray(g["mat_mirror"])
    assert np.abs(g_mir).sum() > 0
    row = int(np.argmax(np.abs(ref["g_mat_mirror"]).sum(axis=1)))
    fd = _fd(loss, params, "mat_mirror", (row, 0), 1e-3, ref["fd"])
    np.testing.assert_allclose(float(g_mir[row, 0]), fd, rtol=5e-3,
                               atol=1e-4)


TEX_BWD_SCENE = """<Scene>
  <BackgroundColor>2 2 2</BackgroundColor>
  <MaxRecursionDepth>2</MaxRecursionDepth>
  <Cameras><Camera id="1">
    <Position>0 0.6 3.5</Position><Gaze>0 -0.1 -1</Gaze><Up>0 1 0</Up>
    <NearPlane>-1 1 -0.75 0.75</NearPlane><NearDistance>1</NearDistance>
    <ImageResolution>320 240</ImageResolution>
    <ImageName>texbwd.png</ImageName>
  </Camera></Cameras>
  <Lights>
    <AmbientLight>15 15 15</AmbientLight>
    <PointLight id="1"><Position>1 3 3</Position>
      <Intensity>400 400 400</Intensity></PointLight>
  </Lights>
  <Materials>
    <Material id="1"><AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.5 0.4 0.3</DiffuseReflectance>
      <SpecularReflectance>0.2 0.2 0.2</SpecularReflectance>
      <PhongExponent>12</PhongExponent></Material>
    <Material id="2" type="mirror"><AmbientReflectance>0 0 0</AmbientReflectance>
      <DiffuseReflectance>0.05 0.05 0.05</DiffuseReflectance>
      <SpecularReflectance>0 0 0</SpecularReflectance>
      <MirrorReflectance>0.8 0.8 0.8</MirrorReflectance></Material>
  </Materials>
  <Textures>
    <Images>
      <Image id="1">{img1}</Image>
      <Image id="2">{img2}</Image>
    </Images>
    <TextureMap id="1" type="image">
      <DecalMode>replace_kd</DecalMode><ImageId>1</ImageId>
      <Interpolation>nearest</Interpolation>
    </TextureMap>
    <TextureMap id="2" type="image">
      <DecalMode>blend_kd</DecalMode><ImageId>2</ImageId>
      <Interpolation>bilinear</Interpolation>
    </TextureMap>
  </Textures>
  <VertexData>
    -4 -1 3   4 -1 3   4 -1 -6   -4 -1 -6
    -2.5 -1 -2   2.5 -1 -2   2.5 2 -2   -2.5 2 -2
  </VertexData>
  <TexCoordData>
    0 2   2 2   2 0   0 0
    0 1   1 1   1 0   0 0
  </TexCoordData>
  <Objects>
    <Mesh id="1"><Material>1</Material><Textures>1</Textures>
      <Faces>1 2 3  1 3 4</Faces></Mesh>
    <Mesh id="2"><Material>1</Material><Textures>2</Textures>
      <Faces vertexOffset="4" textureOffset="4">1 2 3  1 3 4</Faces></Mesh>
    <Sphere id="1"><Material>2</Material><Center>1</Center>
      <Radius>0.5</Radius></Sphere>
  </Objects>
</Scene>"""


def test_megabwd_texture_gradients(tmp_path):
    """Image textures are differentiable leaves: d(img_atlas) flows through
    bilinear weights and uv, which stay differentiable through the
    winner's barycentrics; plus finite differences on single texels."""
    from advanced_cpu_raytracing_tpu.post.writers import write_png

    rng = np.random.default_rng(7)
    img1 = tmp_path / "t1.png"
    img2 = tmp_path / "t2.png"
    write_png(str(img1), rng.integers(0, 256, (12, 16, 3), dtype=np.uint8))
    write_png(str(img2), rng.integers(0, 256, (9, 8, 3), dtype=np.uint8))
    p = tmp_path / "texbwd.xml"
    p.write_text(TEX_BWD_SCENE.format(img1=img1, img2=img2))
    cfg, pack, cam, px, py = _setup(p, 512, 3)
    assert pack.static.n_textures == 2
    opts = options_for_camera(cfg, cfg.cameras[0])
    d_opts = RenderOptions(max_depth=opts.max_depth, differentiable=True,
                           max_iters=opts.max_depth + 2)
    params = extract_params(pack, ("mat_diffuse", "mat_mirror",
                                   "pl_intensity", "verts", "img_atlas"))
    loss = _wavefront_loss(pack, cam, px, py, d_opts)
    ref, g = _check("bwd_texture_gradients", loss, params)
    # texel gradients actually flow, on BOTH textures
    ga = np.asarray(g["img_atlas"])
    assert np.abs(ga[0]).sum() > 0 and np.abs(ga[1]).sum() > 0
    # finite differences on the two most-visible texels (one per texture);
    # h = 4 texel units: the f32 loss (~1e5) resolves deltas only to ~1e-2,
    # and the modulation is linear in the texel value
    for img_i in (0, 1):
        flat = np.abs(ref["g_img_atlas"][img_i]).sum(-1).reshape(-1)
        jj, ii = divmod(int(np.argmax(flat)), ga.shape[2])
        fd = _fd(loss, params, "img_atlas", (img_i, jj, ii, 1), 4.0,
                 ref[f"fd{img_i}"])
        np.testing.assert_allclose(float(ga[img_i, jj, ii, 1]), fd,
                                   rtol=2e-2, atol=1e-5)
