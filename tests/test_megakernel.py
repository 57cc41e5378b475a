"""The jnp wavefront integrator against frozen outputs of the fused Pallas
megakernel that this repository used to carry.

The kernel (ops/pallas/megakernel.py, removed; git keeps it) was a
transcription of render/integrator.py's shading tree and was tested against
the wavefront at these scenes and sizes.  Its outputs — run in interpret
mode at the parent commit, see tests/data/fused_oracle/README.md — are
committed, and each test now checks that the wavefront still produces what
the kernel produced, at the tolerance the kernel-vs-wavefront test had.
Deterministic scenes compare per ray; Monte-Carlo scenes compare per-seed
means by a Welch z-test (the two estimators drew different random streams).
"""

import pathlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from advanced_cpu_raytracing_tpu.render import camera as cam_mod
from advanced_cpu_raytracing_tpu.render.camera import build_camera
from advanced_cpu_raytracing_tpu.render.integrator import (
    RenderOptions,
    trace_radiance,
)
from advanced_cpu_raytracing_tpu.render.renderer import options_for_camera
from advanced_cpu_raytracing_tpu.scene.pack import pack_scene
from advanced_cpu_raytracing_tpu.scene.xml_parser import load_scene

ORACLE = pathlib.Path(__file__).parent / "data" / "fused_oracle"


def frozen(name):
    return np.load(ORACLE / f"{name}.npz")


def _pixels(seed, n, w, h):
    rng = np.random.default_rng(seed)
    px = jnp.asarray(rng.uniform(0, w, n).astype(np.float32))
    py = jnp.asarray(rng.uniform(0, h, n).astype(np.float32))
    return px, py


def _wavefront(pack, cfg, px, py, opts=None):
    cam = build_camera(cfg.cameras[0])
    if opts is None:
        opts = options_for_camera(cfg, cfg.cameras[0])
    return np.asarray(trace_radiance(pack, cam, px, py,
                                     jax.random.PRNGKey(0), opts))


def _check_det(name, pack, cfg, seed, n, w=320, h=240, mean_tol=0.01,
               q=0.999, q_tol=0.5):
    """Deterministic scene: the wavefront radiance per ray vs the frozen
    kernel radiance; only fp reassociation at silhouettes may differ."""
    px, py = _pixels(seed, n, w, h)
    l_kernel = frozen(name)["kernel"]
    l_jnp = _wavefront(pack, cfg, px, py)
    diff = np.abs(l_kernel - l_jnp)
    assert np.mean(diff) < mean_tol, np.mean(diff)
    assert np.quantile(diff, q) < q_tol, np.quantile(diff, q)
    return l_kernel, l_jnp


def _load(tmp_path, xml, name="scene.xml"):
    p = tmp_path / name
    p.write_text(xml)
    cfg = load_scene(str(p))
    return cfg, pack_scene(cfg)


def _mc_compare(name, pack, cfg, opts, n_seeds=24):
    """The wavefront estimator and the frozen kernel estimator must agree
    in expectation.  The estimator is heavy-tailed (rare light hits carry
    radiance*(2pi)^2 weights), so the check is a Welch z-test over per-seed
    GLOBAL means — per-lane stderr wildly understates tail variance."""
    cam = build_camera(cfg.cameras[0])
    px, py = _pixels(9, 1024, 128, 128)
    f = jax.jit(lambda k: trace_radiance(pack, cam, px, py, k, opts))
    m_arr = frozen(name)["seed_means"]
    assert m_arr.shape == (n_seeds,)
    j_arr = np.array([float(np.asarray(f(jax.random.PRNGKey(200 + s))).mean())
                      for s in range(n_seeds)])
    z = abs(m_arr.mean() - j_arr.mean()) / np.sqrt(
        m_arr.var() / n_seeds + j_arr.var() / n_seeds + 1e-12)
    assert z < 4.0, (m_arr.mean(), j_arr.mean(), z)


def test_renderer_tiled_mega_route_matches_wavefront():
    """render_camera (the jnp wavefront) on the small demo scene matches
    the frozen image the fused route rendered — including its 32x32 tile
    permutation for divergent dielectric scenes."""
    import re
    import tempfile

    import __graft_entry__ as ge
    from advanced_cpu_raytracing_tpu.render.renderer import render_camera

    # demo scene minus its AreaLight (the fused route did not take them)
    xml = re.sub(r"<AreaLight.*?</AreaLight>", "", ge._demo_scene_xml(),
                 flags=re.S)
    with tempfile.NamedTemporaryFile("w", suffix=".xml", delete=False) as f:
        f.write(xml)
        path = f.name
    cfg = load_scene(path)
    pack = pack_scene(cfg)
    got = render_camera(pack, cfg, cfg.cameras[0], seed=0)
    diff = np.abs(got - frozen("renderer_tiled_route")["kernel"])
    assert np.mean(diff) < 0.05
    assert np.quantile(diff, 0.999) < 1.0


def _pt_box_scene(tmp_path, renderer: str, pt: bool = True):
    """Small closed box with an emissive LightMesh ceiling panel.

    kd is darkened to ~0.35 and depth capped at 3 so the replicated
    reference estimator (per-bounce gain ~kd*(2/3)*2pi, divergent for
    kd > ~0.24 — see PARITY.md) stays tame enough for statistical
    comparison."""
    from tests.test_golden_features import PT_BOX

    xml = PT_BOX.format(name="megapt", spp=1, params=renderer)
    xml = (xml.replace("0.7 0.7 0.7", "0.35 0.35 0.35")
              .replace("0.7 0.12 0.12", "0.35 0.1 0.1")
              .replace("0.12 0.7 0.12", "0.1 0.35 0.1")
              .replace("<MaxRecursionDepth>4</MaxRecursionDepth>",
                       "<MaxRecursionDepth>3</MaxRecursionDepth>"))
    if not pt:
        # strip the PathTracing renderer for the Whitted variant
        xml = xml.replace("<Renderer>PathTracing</Renderer>", "")
        xml = xml.replace("<RendererParams></RendererParams>", "")
    return _load(tmp_path, xml, "megapt.xml")


_PT_ORACLE = {
    "NextEventEstimation ImportanceSampling": "path_tracing_nee_is",
    "NextEventEstimation ImportanceSampling RussianRoulette":
        "path_tracing_nee_is_rr",
    "": "path_tracing_plain",
}


@pytest.mark.parametrize("params", list(_PT_ORACLE))
def test_megakernel_path_tracing(tmp_path, params):
    """PT (GI continuation + NEE mesh-light loop + RR) in expectation over
    seeds."""
    name = _PT_ORACLE[params]
    cfg, pack = _pt_box_scene(tmp_path, params)
    opts = options_for_camera(cfg, cfg.cameras[0])
    assert opts.path_tracing
    _mc_compare(name, pack, cfg, opts)


def test_megakernel_whitted_meshlight(tmp_path):
    """Whitted + LightMesh (emissive hit radiance + MC mesh-light NEE)."""
    cfg, pack = _pt_box_scene(tmp_path, "", pt=False)
    opts = options_for_camera(cfg, cfg.cameras[0])
    assert not opts.path_tracing
    _mc_compare("whitted_meshlight", pack, cfg, opts)


def _authored(src_fn, name):
    """The XML template of an authored golden_features test, by name."""
    import inspect
    import re

    from tests.test_golden_features import CAM  # noqa: F401 — used in eval

    m = re.search(r'xml = f"""(<Scene>.*?</Scene>)"""',
                  inspect.getsource(src_fn), re.S)
    return eval(f'f"""{m.group(1)}"""')  # noqa: S307 — our own template


def test_megakernel_spot_and_directional(tmp_path):
    """Spot + directional lights (deterministic, exact compare)."""
    from tests.test_golden_features import test_spot_and_directional_lights

    cfg, pack = _load(tmp_path, _authored(test_spot_and_directional_lights,
                                          "megaspot"))
    _check_det("spot_and_directional", pack, cfg, seed=3, n=1024)


def test_megakernel_area_light(tmp_path):
    """Area light (MC rectangle sampling) in expectation over seeds."""
    import __graft_entry__ as ge

    # demo scene: mesh floor + mirror + dielectric spheres + point&area light
    cfg, pack = _load(tmp_path, ge._demo_scene_xml(), "megaarea.xml")
    assert pack.static.n_area == 1
    opts = options_for_camera(cfg, cfg.cameras[0])
    _mc_compare("area_light", pack, cfg, opts, n_seeds=16)


def test_megakernel_motion_and_roughness(tmp_path):
    """Motion blur (per-face/per-sphere offsets + per-primary time draw)
    and glossy roughness, in expectation."""
    xml = """<Scene>
  <MaxRecursionDepth>3</MaxRecursionDepth>
  <BackgroundColor>4 4 8</BackgroundColor>
  <Cameras><Camera id="1">
    <Position>0 1 4</Position><Gaze>0 -0.1 -1</Gaze><Up>0 1 0</Up>
    <NearPlane>-1 1 -1 1</NearPlane><NearDistance>1</NearDistance>
    <ImageResolution>64 64</ImageResolution><ImageName>m.png</ImageName>
  </Camera></Cameras>
  <Lights>
    <AmbientLight>10 10 10</AmbientLight>
    <PointLight id="1"><Position>2 4 2</Position>
      <Intensity>600 600 600</Intensity></PointLight>
  </Lights>
  <Materials>
    <Material id="1"><AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.6 0.6 0.6</DiffuseReflectance>
      <SpecularReflectance>0.2 0.2 0.2</SpecularReflectance>
      <PhongExponent>20</PhongExponent></Material>
    <Material id="2" type="mirror"><AmbientReflectance>0 0 0</AmbientReflectance>
      <DiffuseReflectance>0.1 0.1 0.1</DiffuseReflectance>
      <SpecularReflectance>0 0 0</SpecularReflectance>
      <MirrorReflectance>0.9 0.9 0.9</MirrorReflectance>
      <Roughness>0.15</Roughness></Material>
  </Materials>
  <VertexData>
    -5 0 -5   5 0 -5   5 0 5   -5 0 5   -0.9 0.7 0   0.9 0.7 0
  </VertexData>
  <Objects>
    <Mesh id="1"><Material>1</Material><Faces>1 3 2 1 4 3</Faces>
      <MotionBlur>0.6 0 0</MotionBlur></Mesh>
    <Sphere id="1"><Material>2</Material><Center>5</Center>
      <Radius>0.7</Radius></Sphere>
    <Sphere id="2"><Material>1</Material><Center>6</Center>
      <Radius>0.7</Radius><MotionBlur>0 0.8 0</MotionBlur></Sphere>
  </Objects>
</Scene>"""
    cfg, pack = _load(tmp_path, xml, "m.xml")
    assert pack.static.has_motion and pack.static.has_rough
    opts = options_for_camera(cfg, cfg.cameras[0])
    _mc_compare("motion_and_roughness", pack, cfg, opts, n_seeds=16)


@pytest.mark.parametrize("extra_mat,extra_obj", [
    # mirror sphere in the PT box: specular chain + pushed GI children
    ("""<Material id="5" type="mirror"><AmbientReflectance>0 0 0</AmbientReflectance>
      <DiffuseReflectance>0.05 0.05 0.05</DiffuseReflectance>
      <SpecularReflectance>0 0 0</SpecularReflectance>
      <MirrorReflectance>0.85 0.85 0.85</MirrorReflectance></Material>""",
     """<Sphere id="1"><Material>5</Material><Center>13</Center>
      <Radius>0.4</Radius></Sphere>"""),
    # dielectric sphere: 3-way branching (reflect cont + refract & GI pushes)
    ("""<Material id="5" type="dielectric"><AmbientReflectance>0 0 0</AmbientReflectance>
      <DiffuseReflectance>0 0 0</DiffuseReflectance>
      <SpecularReflectance>0 0 0</SpecularReflectance>
      <RefractionIndex>1.5</RefractionIndex>
      <AbsorptionCoefficient>0.05 0.02 0.01</AbsorptionCoefficient></Material>""",
     """<Sphere id="1"><Material>5</Material><Center>13</Center>
      <Radius>0.4</Radius></Sphere>"""),
])
def test_megakernel_specular_path_tracing(tmp_path, extra_mat, extra_obj):
    """PT with specular materials: a specular chain continues while GI
    children (and dielectric refraction legs) push onto the stack.  The
    wavefront's PT default is the stochastic single-path dielectric
    estimator; the kernel's deterministic split has the same
    expectation."""
    from tests.test_golden_features import PT_BOX

    xml = PT_BOX.format(name="megaptspec", spp=1,
                        params="NextEventEstimation ImportanceSampling")
    xml = (xml.replace("0.7 0.7 0.7", "0.35 0.35 0.35")
              .replace("0.7 0.12 0.12", "0.35 0.1 0.1")
              .replace("0.12 0.7 0.12", "0.1 0.35 0.1")
              .replace("<MaxRecursionDepth>4</MaxRecursionDepth>",
                       "<MaxRecursionDepth>3</MaxRecursionDepth>")
              .replace("</Materials>", extra_mat + "</Materials>")
              .replace("-0.35 0.999 -0.25", "-0.35 0.999 -0.25   0 -0.5 0")
              .replace("</Objects>", extra_obj + "</Objects>"))
    cfg, pack = _load(tmp_path, xml, "megaptspec.xml")
    assert pack.static.has_mirror or pack.static.has_dielectric
    opts = options_for_camera(cfg, cfg.cameras[0])
    assert opts.path_tracing
    kind = "dielectric" if pack.static.has_dielectric else "mirror"
    _mc_compare(f"specular_path_tracing_{kind}", pack, cfg, opts)


def test_megakernel_brdf_zoo(tmp_path):
    """All five pluggable BRDF models (deterministic scene)."""
    from tests.test_golden_features import test_brdf_models_vs_reference

    cfg, pack = _load(tmp_path, _authored(test_brdf_models_vs_reference,
                                          "megabrdf"))
    assert pack.static.n_brdfs == 5
    _check_det("brdf_zoo", pack, cfg, seed=4, n=2048)


PERLIN_SCENE = """<Scene>
  <BackgroundColor>4 4 8</BackgroundColor>
  <MaxRecursionDepth>3</MaxRecursionDepth>
  <ShadowRayEpsilon>1e-3</ShadowRayEpsilon>
  <Cameras><Camera id="1">
    <Position>0 1.2 4</Position><Gaze>0 -0.25 -1</Gaze><Up>0 1 0</Up>
    <NearPlane>-1 1 -0.75 0.75</NearPlane><NearDistance>1</NearDistance>
    <ImageResolution>320 240</ImageResolution>
    <ImageName>megaperlin.png</ImageName>
  </Camera></Cameras>
  <Lights>
    <AmbientLight>25 25 25</AmbientLight>
    <PointLight id="1"><Position>2 4 2</Position>
      <Intensity>900 900 900</Intensity></PointLight>
  </Lights>
  <Materials>
    <Material id="1"><AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.7 0.5 0.4</DiffuseReflectance>
      <SpecularReflectance>0.3 0.3 0.3</SpecularReflectance>
      <PhongExponent>25</PhongExponent></Material>
    <Material id="2"><AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.2 0.4 0.8</DiffuseReflectance>
      <SpecularReflectance>0.5 0.5 0.5</SpecularReflectance>
      <PhongExponent>60</PhongExponent></Material>
    <Material id="3" type="mirror"><AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.1 0.1 0.1</DiffuseReflectance>
      <SpecularReflectance>0.1 0.1 0.1</SpecularReflectance>
      <MirrorReflectance>0.9 0.9 0.9</MirrorReflectance>
      <PhongExponent>5</PhongExponent></Material>
  </Materials>
  <Textures>
    <TextureMap id="1" type="perlin">
      <DecalMode>replace_kd</DecalMode>
      <NoiseConversion>absval</NoiseConversion>
      <NoiseScale>3</NoiseScale>
    </TextureMap>
    <TextureMap id="2" type="perlin">
      <DecalMode>blend_kd</DecalMode>
      <NoiseConversion>linear</NoiseConversion>
      <NoiseScale>1.5</NoiseScale>
    </TextureMap>
    <TextureMap id="3" type="perlin">
      <DecalMode>bump_normal</DecalMode>
      <NoiseConversion>linear</NoiseConversion>
      <NoiseScale>2.2</NoiseScale>
      <BumpFactor>3</BumpFactor>
    </TextureMap>
    <TextureMap id="4" type="perlin">
      <DecalMode>replace_ks</DecalMode>
      <NoiseConversion>absval</NoiseConversion>
      <NoiseScale>4</NoiseScale>
    </TextureMap>
  </Textures>
  <VertexData>
    -8 -1 4   8 -1 4   8 -1 -12   -8 -1 -12
    -8 -1 -6   8 -1 -6   8 7 -6   -8 7 -6
    -3 -1 1   -1 -1 1   -1 1 1    -3 1 1
    1 -1 0.5   3 -1 0.5   3 1 0.5   1 1 0.5
  </VertexData>
  <TexCoordData>
    0 1   1 1   1 0   0 0
    0 1   1 1   1 0   0 0
    0 1   1 1   1 0   0 0
    0 1   1 1   1 0   0 0
  </TexCoordData>
  <Objects>
    <Mesh id="1"><Material>1</Material><Textures>1 3</Textures>
      <Faces>1 2 3  1 3 4</Faces></Mesh>
    <Mesh id="2"><Material>2</Material><Textures>2 4</Textures>
      <Faces>5 6 7  5 7 8</Faces></Mesh>
    <Mesh id="3"><Material>3</Material>
      <Faces>9 10 11  9 11 12</Faces></Mesh>
    <Mesh id="4"><Material>2</Material><Textures>2</Textures>
      <Faces>13 14 15  13 15 16</Faces></Mesh>
  </Objects>
</Scene>"""


def test_megakernel_perlin_textures(tmp_path):
    """Procedural Perlin textures — replace_kd (absval), blend_kd (linear),
    replace_ks, and bump_normal, with a mirror bouncing onto the textured
    floor; deterministic, exact compare."""
    cfg, pack = _load(tmp_path, PERLIN_SCENE, "megaperlin.xml")
    assert pack.static.n_textures == 4
    _check_det("perlin_textures", pack, cfg, seed=11, n=2048)


def test_mesh_bump_requires_texcoords(tmp_path):
    """The reference's whole mesh normal/bump block is gated on the mesh
    having UV data (mesh.cpp:245) — perlin bump on a UV-less mesh silently
    no-ops.  The pack replicates that quirk by clearing the normal/bump
    slots (scene/pack.py::tex_slots)."""
    import re

    from advanced_cpu_raytracing_tpu.scene.pack import SLOT_BUMP, SLOT_DIFFUSE

    xml = re.sub(r"<TexCoordData>.*?</TexCoordData>", "", PERLIN_SCENE,
                 flags=re.S)
    assert xml != PERLIN_SCENE
    cfg, pack = _load(tmp_path, xml, "nouv.xml")
    et = np.asarray(pack.ent_tex)
    assert (et[:, SLOT_BUMP] == -1).all()  # bump gated off
    assert (et[:, SLOT_DIFFUSE] >= 0).any()  # kd texture unaffected


IMAGE_SCENE = """<Scene>
  <BackgroundColor>6 6 10</BackgroundColor>
  <MaxRecursionDepth>3</MaxRecursionDepth>
  <ShadowRayEpsilon>1e-3</ShadowRayEpsilon>
  <Cameras><Camera id="1">
    <Position>0 1.2 4</Position><Gaze>0 -0.25 -1</Gaze><Up>0 1 0</Up>
    <NearPlane>-1 1 -0.75 0.75</NearPlane><NearDistance>1</NearDistance>
    <ImageResolution>320 240</ImageResolution>
    <ImageName>megaimage.png</ImageName>
  </Camera></Cameras>
  <Lights>
    <AmbientLight>25 25 25</AmbientLight>
    <PointLight id="1"><Position>2 4 2</Position>
      <Intensity>900 900 900</Intensity></PointLight>
  </Lights>
  <Materials>
    <Material id="1"><AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.7 0.5 0.4</DiffuseReflectance>
      <SpecularReflectance>0.3 0.3 0.3</SpecularReflectance>
      <PhongExponent>25</PhongExponent></Material>
    <Material id="2"><AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.2 0.4 0.8</DiffuseReflectance>
      <SpecularReflectance>0.5 0.5 0.5</SpecularReflectance>
      <PhongExponent>60</PhongExponent></Material>
    <Material id="3" type="mirror"><AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.1 0.1 0.1</DiffuseReflectance>
      <SpecularReflectance>0.1 0.1 0.1</SpecularReflectance>
      <MirrorReflectance>0.9 0.9 0.9</MirrorReflectance>
      <PhongExponent>5</PhongExponent></Material>
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
    <TextureMap id="3" type="image">
      <DecalMode>replace_ks</DecalMode><ImageId>2</ImageId>
      <Interpolation>bilinear</Interpolation>
    </TextureMap>
    <TextureMap id="4" type="perlin">
      <DecalMode>replace_kd</DecalMode>
      <NoiseConversion>absval</NoiseConversion>
      <NoiseScale>3</NoiseScale>
    </TextureMap>
  </Textures>
  <VertexData>
    -8 -1 4   8 -1 4   8 -1 -12   -8 -1 -12
    -8 -1 -6   8 -1 -6   8 7 -6   -8 7 -6
    -3 -1 1   -1 -1 1   -1 1 1    -3 1 1
    1 -1 0.5   3 -1 0.5   3 1 0.5   1 1 0.5
  </VertexData>
  <TexCoordData>
    0 3   3 3   3 0   0 0
    0 1   1 1   1 0   0 0
    0 1   1 1   1 0   0 0
    -0.25 1.3   1.3 1.3   1.3 -0.25   -0.25 -0.25
  </TexCoordData>
  <Objects>
    <Mesh id="1"><Material>1</Material><Textures>1</Textures>
      <Faces>1 2 3  1 3 4</Faces></Mesh>
    <Mesh id="2"><Material>2</Material><Textures>2 3</Textures>
      <Faces>5 6 7  5 7 8</Faces></Mesh>
    <Mesh id="3"><Material>3</Material>
      <Faces>9 10 11  9 11 12</Faces></Mesh>
    <Mesh id="4"><Material>2</Material><Textures>3 4</Textures>
      <Faces>13 14 15  13 15 16</Faces></Mesh>
  </Objects>
</Scene>"""


def _write_test_png(path, w, h, seed):
    from advanced_cpu_raytracing_tpu.post.writers import write_png

    rng = np.random.default_rng(seed)
    write_png(str(path), rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


def test_megakernel_image_textures(tmp_path):
    """LDR image textures — nearest replace_kd with UV tiling (0..3 range),
    bilinear blend_kd, bilinear replace_ks mixed with a perlin replace_kd on
    the same entity, negative-UV clamping, plus a mirror bouncing onto the
    textured floor."""
    img1 = tmp_path / "t1.png"
    img2 = tmp_path / "t2.png"
    _write_test_png(img1, 16, 16, 3)
    _write_test_png(img2, 33, 7, 4)  # odd sizes: edge clamps
    cfg, pack = _load(tmp_path, IMAGE_SCENE.format(img1=img1, img2=img2),
                      "megaimage.xml")
    assert pack.static.n_textures == 4
    _check_det("image_textures", pack, cfg, seed=12, n=2048)


def _env_scene(tmp_path, mirror: bool = True, w: int = 64, h: int = 32):
    """Env-lit scene: lat-long EXR (default 64x32) + floor mesh + mirror
    sphere (mirror children sample the env on miss)."""
    from advanced_cpu_raytracing_tpu.scene.images import write_exr
    ys, xs = np.mgrid[0:h, 0:w]
    env = np.stack([
        1.0 + 3.0 * xs / w,
        0.5 + 2.0 * ys / h,
        2.0 + np.where((ys > 8) & (ys < 14), 6.0, 0.0),
    ], axis=-1).astype(np.float32)
    write_exr(str(tmp_path / "env.exr"), env)
    sphere = """<Sphere id="1"><Material>2</Material><Center>5</Center>
      <Radius>1.0</Radius></Sphere>""" if mirror else ""
    xml = f"""<Scene>
  <BackgroundColor>0 0 0</BackgroundColor>
  <MaxRecursionDepth>2</MaxRecursionDepth>
  <Cameras><Camera id="1">
    <Position>0 1 4</Position><Gaze>0 -0.1 -1</Gaze><Up>0 1 0</Up>
    <NearPlane>-1 1 -0.75 0.75</NearPlane><NearDistance>1</NearDistance>
    <ImageResolution>320 240</ImageResolution>
    <ImageName>t.png</ImageName>
  </Camera></Cameras>
  <Lights>
    <AmbientLight>5 5 5</AmbientLight>
    <SphericalDirectionalLight id="1"><ImageId>1</ImageId>
    </SphericalDirectionalLight>
  </Lights>
  <Materials>
    <Material id="1"><AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.6 0.6 0.6</DiffuseReflectance>
      <SpecularReflectance>0.2 0.2 0.2</SpecularReflectance>
      <PhongExponent>20</PhongExponent></Material>
    <Material id="2" type="Mirror"><AmbientReflectance>0 0 0</AmbientReflectance>
      <DiffuseReflectance>0.1 0.1 0.1</DiffuseReflectance>
      <SpecularReflectance>0 0 0</SpecularReflectance>
      <MirrorReflectance>0.9 0.9 0.9</MirrorReflectance>
      <PhongExponent>1</PhongExponent></Material>
  </Materials>
  <Textures><Images><Image id="1">env.exr</Image></Images></Textures>
  <VertexData>
    -6 -1 4   6 -1 4   6 -1 -8   -6 -1 -8
    0 0 -2
  </VertexData>
  <Objects>
    <Mesh id="1"><Material>1</Material><Faces>1 2 3  1 3 4</Faces></Mesh>
    {sphere}
  </Objects>
</Scene>"""
    p = tmp_path / "env_scene.xml"
    p.write_text(xml)
    cfg = load_scene(str(p))
    return cfg, pack_scene(cfg)


def test_megakernel_env_light(tmp_path):
    """Spherical env light.  The env BACKGROUND (primary + mirror-child
    misses) is deterministic and must match the frozen kernel exactly; the
    surface direct term uses rejection-sampled directions (different RNG
    streams), so expectations compare over seeds."""
    from advanced_cpu_raytracing_tpu.ops.traverse import closest_hit

    cfg, pack = _env_scene(tmp_path)
    cam = build_camera(cfg.cameras[0])
    n = 2048
    px, py = _pixels(0, n, 320, 240)
    o, d = cam_mod.generate_rays(cam, px, py, jnp.zeros((n, 2)), dof=False)
    w_opts = RenderOptions(max_depth=cfg.max_recursion_depth)
    ref = frozen("env_light")
    img_j = _wavefront(pack, cfg, px, py, w_opts)
    hit = np.asarray(closest_hit(pack, o, d, jnp.zeros(n)).valid)
    assert (~hit).sum() > 200
    np.testing.assert_allclose(ref["kernel"][~hit], img_j[~hit], rtol=1e-5,
                               atol=1e-5)

    f = jax.jit(lambda k: trace_radiance(pack, cam, px, py, k, w_opts))
    n_seeds = 12
    ka = np.array([float(m[hit].mean()) for m in ref["mc"]])
    ja = np.array([float(np.asarray(f(jax.random.PRNGKey(200 + s)))[hit]
                         .mean()) for s in range(n_seeds)])
    assert ka.shape == (n_seeds,)
    z = abs(ka.mean() - ja.mean()) / np.sqrt(
        ka.var() / n_seeds + ja.var() / n_seeds + 1e-12)
    assert z < 4.0, (ka.mean(), ja.mean(), z)


MAPS_SCENE = """<Scene>
  <BackgroundColor>6 6 10</BackgroundColor>
  <MaxRecursionDepth>2</MaxRecursionDepth>
  <ShadowRayEpsilon>1e-3</ShadowRayEpsilon>
  <Cameras><Camera id="1">
    <Position>0 1.2 4</Position><Gaze>0 -0.25 -1</Gaze><Up>0 1 0</Up>
    <NearPlane>-1 1 -0.75 0.75</NearPlane><NearDistance>1</NearDistance>
    <ImageResolution>320 240</ImageResolution>
    <ImageName>megamaps.png</ImageName>
  </Camera></Cameras>
  <Lights>
    <AmbientLight>25 25 25</AmbientLight>
    <PointLight id="1"><Position>2 4 2</Position>
      <Intensity>900 900 900</Intensity></PointLight>
  </Lights>
  <Materials>
    <Material id="1"><AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.7 0.5 0.4</DiffuseReflectance>
      <SpecularReflectance>0.3 0.3 0.3</SpecularReflectance>
      <PhongExponent>25</PhongExponent></Material>
    <Material id="2"><AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.2 0.4 0.8</DiffuseReflectance>
      <SpecularReflectance>0.5 0.5 0.5</SpecularReflectance>
      <PhongExponent>60</PhongExponent></Material>
  </Materials>
  <Textures>
    <Images>
      <Image id="1">{img1}</Image>
      <Image id="2">{img2}</Image>
    </Images>
    <TextureMap id="1" type="image">
      <DecalMode>replace_normal</DecalMode><ImageId>1</ImageId>
      <Interpolation>nearest</Interpolation>
    </TextureMap>
    <TextureMap id="2" type="image">
      <DecalMode>bump_normal</DecalMode><ImageId>2</ImageId>
      <Interpolation>nearest</Interpolation>
      <BumpFactor>2.5</BumpFactor>
    </TextureMap>
    <TextureMap id="3" type="image">
      <DecalMode>replace_all</DecalMode><ImageId>2</ImageId>
      <Interpolation>bilinear</Interpolation>
    </TextureMap>
  </Textures>
  <VertexData>
    -8 -1 4   8 -1 4   8 -1 -12   -8 -1 -12
    -3 -1 1   -1 -1 1   -1 1 1    -3 1 1
    1 -1 0.5   3 -1 0.5   3 1 0.5   1 1 0.5
  </VertexData>
  <TexCoordData>
    0 3   3 3   3 0   0 0
    0 1   1 1   1 0   0 0
    0 1   1 1   1 0   0 0
  </TexCoordData>
  <Objects>
    <Mesh id="1"><Material>1</Material>
      <Textures>2</Textures>
      <Faces>1 2 3  1 3 4</Faces></Mesh>
    <Mesh id="2"><Material>2</Material>
      <Textures>1</Textures>
      <Faces vertexOffset="4" textureOffset="4">1 2 3  1 3 4</Faces></Mesh>
    <Mesh id="3"><Material>2</Material>
      <Textures>3</Textures>
      <Faces vertexOffset="8" textureOffset="8">1 2 3  1 3 4</Faces></Mesh>
  </Objects>
</Scene>"""


def test_megakernel_normal_bump_replaceall(tmp_path):
    """Tangent-space normal maps, image height-field bump, and replace_all
    decals — deterministic."""
    img1 = tmp_path / "nm.png"
    img2 = tmp_path / "bump.png"
    _write_test_png(img1, 16, 16, 5)
    _write_test_png(img2, 33, 7, 6)
    cfg, pack = _load(tmp_path, MAPS_SCENE.format(img1=img1, img2=img2),
                      "megamaps.xml")
    assert pack.static.n_textures == 3
    _check_det("normal_bump_replaceall", pack, cfg, seed=13, n=2048,
               mean_tol=0.02, q=0.995, q_tol=1.0)


def test_megakernel_streamed_geometry():
    """A 2048-face terrain, which the kernel swept in HBM-streamed chunks
    behind AABB culls (identical to its resident sweep)."""
    from advanced_cpu_raytracing_tpu.scene.synth import terrain_scene

    cfg = terrain_scene(n=33, width=64, height=48)  # 2048 faces
    pack = pack_scene(cfg)
    px, py = _pixels(2, 1024, 64, 48)
    diff = np.abs(frozen("streamed_geometry")["kernel"]
                  - _wavefront(pack, cfg, px, py))
    assert np.mean(diff) < 0.01, np.mean(diff)


def test_megakernel_six_textures(tmp_path):
    """IMAGE_SCENE grown to 6 maps (3 image decals + perlin replace_kd +
    perlin bump + image blend on the mirror)."""
    img1 = tmp_path / "t1.png"
    img2 = tmp_path / "t2.png"
    _write_test_png(img1, 16, 16, 3)
    _write_test_png(img2, 33, 7, 4)
    xml = IMAGE_SCENE.format(img1=img1, img2=img2)
    xml = xml.replace(
        """    <TextureMap id="4" type="perlin">""",
        """    <TextureMap id="5" type="perlin">
      <DecalMode>bump_normal</DecalMode>
      <NoiseConversion>linear</NoiseConversion>
      <NoiseScale>2</NoiseScale>
      <BumpFactor>0.5</BumpFactor>
    </TextureMap>
    <TextureMap id="6" type="image">
      <DecalMode>blend_kd</DecalMode><ImageId>1</ImageId>
      <Interpolation>nearest</Interpolation>
    </TextureMap>
    <TextureMap id="4" type="perlin">""")
    xml = xml.replace(
        '<Mesh id="3"><Material>3</Material>\n      <Faces>9 10 11  9 11 12</Faces></Mesh>',
        '<Mesh id="3"><Material>3</Material><Textures>6</Textures>\n'
        '      <Faces>9 10 11  9 11 12</Faces></Mesh>')
    xml = xml.replace("<Textures>1</Textures>", "<Textures>1 5</Textures>")
    cfg, pack = _load(tmp_path, xml, "sixtex.xml")
    assert pack.static.n_textures == 6
    _check_det("six_textures", pack, cfg, seed=13, n=2048)


def _compare_big(tmp_path, name, img1_path, img2_path):
    """IMAGE_SCENE with textures past the kernel's on-chip texel budget
    (it sampled them through a windowed gather)."""
    cfg, pack = _load(tmp_path,
                      IMAGE_SCENE.format(img1=img1_path, img2=img2_path),
                      "bigimage.xml")
    _check_det(name, pack, cfg, seed=21, n=2048)


def test_megakernel_big_texture_nearest(tmp_path):
    img1 = tmp_path / "big1.png"
    img2 = tmp_path / "small2.png"
    _write_test_png(img1, 164, 127, 3)  # 20828 texels
    _write_test_png(img2, 33, 7, 4)
    _compare_big(tmp_path, "big_texture_nearest", img1, img2)


def test_megakernel_big_texture_bilinear(tmp_path):
    img1 = tmp_path / "small1.png"
    img2 = tmp_path / "big2.png"
    _write_test_png(img1, 16, 16, 3)
    _write_test_png(img2, 150, 110, 4)  # 16500 texels
    _compare_big(tmp_path, "big_texture_bilinear", img1, img2)


def test_megakernel_hdr_texture(tmp_path):
    """Float-texel (EXR) images (HDRImage.h:45-70 capability)."""
    from advanced_cpu_raytracing_tpu.scene.images import write_exr

    img1 = tmp_path / "hdr1.exr"
    img2 = tmp_path / "small2.png"
    rng = np.random.default_rng(9)
    write_exr(str(img1),
              rng.uniform(0.0, 400.0, (30, 40, 3)).astype(np.float32))
    _write_test_png(img2, 33, 7, 4)
    _compare_big(tmp_path, "hdr_texture", img1, img2)


def test_megakernel_big_normal_bump_replaceall(tmp_path):
    """Large textures through the normal-map, image-bump and replace_all
    decal paths."""
    img1 = tmp_path / "bignm.png"
    img2 = tmp_path / "bigbump.png"
    _write_test_png(img1, 160, 120, 5)
    _write_test_png(img2, 140, 123, 6)
    cfg, pack = _load(tmp_path, MAPS_SCENE.format(img1=img1, img2=img2),
                      "bigmaps.xml")
    _check_det("big_normal_bump_replaceall", pack, cfg, seed=13, n=2048,
               mean_tol=0.02, q=0.995, q_tol=1.0)


def test_megakernel_big_env(tmp_path):
    """A 200x100 lat-long env map; the deterministic env background
    (primary + mirror misses) must match exactly."""
    from advanced_cpu_raytracing_tpu.ops.traverse import closest_hit

    cfg, pack = _env_scene(tmp_path, mirror=True, w=200, h=100)
    cam = build_camera(cfg.cameras[0])
    n = 2048
    px, py = _pixels(0, n, 320, 240)
    o, d = cam_mod.generate_rays(cam, px, py, jnp.zeros((n, 2)), dof=False)
    img_j = _wavefront(pack, cfg, px, py,
                       RenderOptions(max_depth=cfg.max_recursion_depth))
    hit = np.asarray(closest_hit(pack, o, d, jnp.zeros(n)).valid)
    assert (~hit).sum() > 200
    np.testing.assert_allclose(frozen("big_env")["kernel"][~hit],
                               img_j[~hit], rtol=1e-5, atol=1e-5)


BG_SCENE = """<Scene>
  <BackgroundColor>9 9 9</BackgroundColor>
  <MaxRecursionDepth>2</MaxRecursionDepth>
  <Cameras><Camera id="1">
    <Position>0 0 3</Position><Gaze>0 0 -1</Gaze><Up>0 1 0</Up>
    <NearPlane>-1 1 -0.75 0.75</NearPlane><NearDistance>1</NearDistance>
    <ImageResolution>320 240</ImageResolution>
    <ImageName>bg.png</ImageName>
  </Camera></Cameras>
  <Lights>
    <AmbientLight>20 20 20</AmbientLight>
    <PointLight id="1"><Position>0 2 3</Position>
      <Intensity>300 300 300</Intensity></PointLight>
  </Lights>
  <Materials>
    <Material id="1"><AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.5 0.4 0.3</DiffuseReflectance>
      <SpecularReflectance>0.2 0.2 0.2</SpecularReflectance>
      <PhongExponent>12</PhongExponent></Material>
  </Materials>
  <Textures>
    <Images><Image id="1">{img}</Image></Images>
    <TextureMap id="1" type="image">
      <DecalMode>replace_background</DecalMode><ImageId>1</ImageId>
      <Interpolation>{interp}</Interpolation>
    </TextureMap>
  </Textures>
  <VertexData>
    -0.6 -0.6 0   0.6 -0.6 0   0.6 0.6 0   -0.6 0.6 0
  </VertexData>
  <Objects>
    <Mesh id="1"><Material>1</Material><Faces>1 2 3  1 3 4</Faces></Mesh>
  </Objects>
</Scene>"""


@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
def test_megakernel_bg_texture(tmp_path, interp):
    """The replace_background decal samples at pixel uv on primary miss
    (texture.h:49-52) — a centered quad leaves background all around."""
    img = tmp_path / "bg.png"
    _write_test_png(img, 37, 23, 8)
    cfg, pack = _load(tmp_path, BG_SCENE.format(img=img, interp=interp),
                      "bgscene.xml")
    assert pack.static.bg_tex >= 0
    _, l_jnp = _check_det(f"bg_texture_{interp}", pack, cfg, seed=2, n=2048)
    # the background is actually textured (misses vary, not flat 9s)
    assert np.std(l_jnp, axis=0).max() > 1.0


SPHERE_TEX_SCENE = """<Scene>
  <BackgroundColor>2 2 2</BackgroundColor>
  <MaxRecursionDepth>2</MaxRecursionDepth>
  <Cameras><Camera id="1">
    <Position>0 0 3</Position><Gaze>0 0 -1</Gaze><Up>0 1 0</Up>
    <NearPlane>-1 1 -0.75 0.75</NearPlane><NearDistance>1</NearDistance>
    <ImageResolution>320 240</ImageResolution>
    <ImageName>stex.png</ImageName>
  </Camera></Cameras>
  <Lights>
    <AmbientLight>20 20 20</AmbientLight>
    <PointLight id="1"><Position>2 3 3</Position>
      <Intensity>500 500 500</Intensity></PointLight>
  </Lights>
  <Materials>
    <Material id="1"><AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.5 0.4 0.3</DiffuseReflectance>
      <SpecularReflectance>0.3 0.3 0.3</SpecularReflectance>
      <PhongExponent>15</PhongExponent></Material>
  </Materials>
  <Textures>
    <Images><Image id="1">{img}</Image></Images>
    <TextureMap id="1" type="image">
      <DecalMode>{decal}</DecalMode><ImageId>1</ImageId>
      <Interpolation>{interp}</Interpolation>
    </TextureMap>
    <TextureMap id="2" type="perlin">
      <DecalMode>replace_ks</DecalMode>
      <NoiseScale>4</NoiseScale>
      <NoiseConversion>absval</NoiseConversion>
    </TextureMap>
  </Textures>
  <VertexData>
    0 0 0   -2 -1.2 -1   2 -1.2 -1   0 1.4 -1
  </VertexData>
  <Objects>
    <Mesh id="1"><Material>1</Material>
      <Faces>2 3 4</Faces></Mesh>
    <Sphere id="1"><Material>1</Material><Textures>{tex}</Textures>
      <Center>1</Center><Radius>0.8</Radius></Sphere>
  </Objects>
</Scene>"""


@pytest.mark.parametrize("decal,interp,tex", [
    ("replace_kd", "nearest", "1 2"),
    ("blend_kd", "bilinear", "1"),
    ("replace_all", "bilinear", "1"),
    ("bump_normal", "nearest", "1"),
])
def test_megakernel_sphere_textures(tmp_path, decal, interp, tex):
    """Sphere textures — spherical UV from the local hit point
    (sphere.cpp:138-167) and perlin replace_ks on the same sphere."""
    img = tmp_path / "stex.png"
    _write_test_png(img, 48, 31, 9)
    cfg, pack = _load(tmp_path, SPHERE_TEX_SCENE.format(
        img=img, decal=decal, interp=interp, tex=tex), "spherescene.xml")
    # the kernel's polynomial atan2/acos UV differed from libm by ~1e-7
    # rad; a nearest-texel flip at a cell boundary can move one lane a
    # full texel, so compare means + a generous tail quantile
    _, l_jnp = _check_det(f"sphere_textures_{decal}", pack, cfg, seed=4,
                          n=2048, mean_tol=0.05, q=0.99, q_tol=1.0)
    # the sphere is actually textured (its pixels vary)
    assert np.std(l_jnp, axis=0).max() > 1.0


def test_megakernel_transformed_normal_bump(tmp_path):
    """Normal/bump-mapped meshes with NON-identity transforms: object-space
    TBN (mesh.cpp:264-357)."""
    img1 = tmp_path / "nm.png"
    img2 = tmp_path / "bump.png"
    _write_test_png(img1, 16, 16, 5)
    _write_test_png(img2, 33, 7, 6)
    xml = MAPS_SCENE.format(img1=img1, img2=img2)
    # non-uniform scale + axis-aligned rotation on the bump floor and the
    # normal-mapped wall (the parser supports axis-aligned rotations only)
    xml = xml.replace(
        "<Objects>",
        """<Transformations>
    <Scaling id="1">1.4 0.8 1.1</Scaling>
    <Rotation id="1">25 0 1 0</Rotation>
  </Transformations>
  <Objects>""")
    xml = xml.replace(
        '<Mesh id="1"><Material>1</Material>',
        '<Mesh id="1"><Material>1</Material>'
        '<Transformations>s1</Transformations>')
    xml = xml.replace(
        '<Mesh id="2"><Material>2</Material>',
        '<Mesh id="2"><Material>2</Material>'
        '<Transformations>r1</Transformations>')
    cfg, pack = _load(tmp_path, xml, "tbnobj.xml")
    _check_det("transformed_normal_bump", pack, cfg, seed=14, n=2048,
               mean_tol=0.02, q=0.995, q_tol=1.0)


def test_megakernel_streamed_textured():
    """The textured 2048-face terrain (texture columns streamed with the
    geometry in the kernel)."""
    from advanced_cpu_raytracing_tpu.scene.synth import terrain_scene

    cfg = terrain_scene(n=33, width=64, height=48, textured=True)
    pack = pack_scene(cfg)
    assert pack.static.n_textures == 1
    px, py = _pixels(5, 1024, 64, 48)
    diff = np.abs(frozen("streamed_textured")["kernel"]
                  - _wavefront(pack, cfg, px, py))
    assert np.mean(diff) < 0.02, np.mean(diff)
    assert np.quantile(diff, 0.995) < 1.0, np.quantile(diff, 0.995)


def test_megakernel_sphere_perlin_bump(tmp_path):
    """PERLIN bump on spheres — local-frame gradient against the analytic
    tangent basis (sphere.cpp:116-137)."""
    img = tmp_path / "stex.png"
    _write_test_png(img, 16, 16, 9)
    xml = SPHERE_TEX_SCENE.format(img=img, decal="replace_kd",
                                  interp="nearest", tex="1 2")
    xml = xml.replace(
        "<DecalMode>replace_ks</DecalMode>",
        "<DecalMode>bump_normal</DecalMode>")
    cfg, pack = _load(tmp_path, xml, "sphperlinbump.xml")
    _check_det("sphere_perlin_bump", pack, cfg, seed=4, n=2048,
               mean_tol=0.05, q=0.99, q_tol=1.0)
