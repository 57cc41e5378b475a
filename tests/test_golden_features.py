"""Cross-validation of the ADVANCED features against the reference binary.

The reference defines PT, tonemapping, DoF, spot/directional lights and
textures in code but ships NO scene exercising them (SURVEY.md section 0.2) —
so these tests author scenes, render them through the freshly compiled
reference binary (tests/conftest.fresh_golden_custom) and through our
renderer, and compare:

  * deterministic scenes (1 spp, no MC features): near-exact match;
  * Monte-Carlo scenes (DoF lens sampling, area/mesh-light sampling, PT):
    the RNG streams differ by construction (mt19937 vs counter-based
    jax.random), so 8x8 block means are compared instead of pixels.
"""

import io

import numpy as np
import pytest

from tests.conftest import fresh_golden_custom

pytestmark = pytest.mark.golden


def _render_ours(scene_path, cam_index=0, seed=0):
    from advanced_cpu_raytracing_tpu.render.renderer import (
        ldr_from_radiance,
        render_camera,
    )
    from advanced_cpu_raytracing_tpu.scene.pack import pack_scene
    from advanced_cpu_raytracing_tpu.scene.xml_parser import load_scene

    cfg = load_scene(str(scene_path))
    pack = pack_scene(cfg)
    cam_cfg = cfg.cameras[cam_index]
    radiance = render_camera(pack, cfg, cam_cfg, seed=seed)
    if cam_cfg.tonemap is not None:
        from advanced_cpu_raytracing_tpu.post.tonemap import reinhard_tonemap

        tm = cam_cfg.tonemap
        ldr = reinhard_tonemap(radiance, key_value=tm.key_value,
                               burn_percent=tm.burn_percent,
                               saturation=tm.saturation, gamma=tm.gamma)
    else:
        ldr = ldr_from_radiance(radiance)
    return ldr, radiance


def _exact(ours, gold, mean_tol=2.0, frac_tol=0.02):
    diff = np.abs(ours.astype(int) - gold.astype(int))
    assert diff.mean() < mean_tol, f"mean {diff.mean():.3f}"
    assert (diff > 2).mean() < frac_tol, f"frac>2 {(diff > 2).mean():.4f}"


def _blocks(img, b=8):
    h, w = img.shape[:2]
    h2, w2 = h - h % b, w - w % b
    return img[:h2, :w2].reshape(h2 // b, b, w2 // b, b, 3).mean(axis=(1, 3))


def _mc(ours, gold, block_tol):
    d = np.abs(_blocks(ours.astype(np.float64))
               - _blocks(gold.astype(np.float64)))
    assert d.mean() < block_tol, f"block mean {d.mean():.3f}"


def _skip_if_none(gold):
    if gold is None:
        pytest.skip("reference binary unavailable")


CAM = """
  <Cameras><Camera id="1">
    <Position>{pos}</Position><Gaze>{gaze}</Gaze><Up>0 1 0</Up>
    <NearPlane>-1 1 -0.75 0.75</NearPlane><NearDistance>1</NearDistance>
    <ImageResolution>320 240</ImageResolution>
    <ImageName>{name}.png</ImageName>{extra}
  </Camera></Cameras>
"""


def test_spot_and_directional_lights():
    name = "feat_spotdir"
    xml = f"""<Scene>
  <BackgroundColor>8 8 16</BackgroundColor>
  <MaxRecursionDepth>2</MaxRecursionDepth>
  {CAM.format(pos="0 1 3", gaze="0 -0.2 -1", name=name, extra="")}
  <Lights>
    <AmbientLight>12 12 12</AmbientLight>
    <SpotLight id="1">
      <Position>1.5 4 -2</Position><Direction>-0.4 -1 -0.2</Direction>
      <Intensity>900 850 800</Intensity>
      <CoverageAngle>40</CoverageAngle><FalloffAngle>24</FalloffAngle>
    </SpotLight>
    <DirectionalLight id="1">
      <Direction>-0.3 -1 -0.5</Direction><Radiance>4 5 6</Radiance>
    </DirectionalLight>
  </Lights>
  <Materials>
    <Material id="1">
      <AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.7 0.65 0.6</DiffuseReflectance>
      <SpecularReflectance>0.3 0.3 0.3</SpecularReflectance>
      <PhongExponent>40</PhongExponent>
    </Material>
    <Material id="2">
      <AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.2 0.5 0.8</DiffuseReflectance>
      <SpecularReflectance>0.5 0.5 0.5</SpecularReflectance>
      <PhongExponent>120</PhongExponent>
    </Material>
  </Materials>
  <VertexData>
    -8 -1 4   8 -1 4   8 -1 -12   -8 -1 -12
    0 -0.3 -3
  </VertexData>
  <Objects>
    <Mesh id="1"><Material>1</Material>
      <Faces>1 2 3  1 3 4</Faces></Mesh>
    <Sphere id="1"><Material>2</Material>
      <Center>5</Center><Radius>0.7</Radius></Sphere>
  </Objects>
</Scene>"""
    scene_path, gold = fresh_golden_custom(name, xml)
    _skip_if_none(gold)
    ours, _ = _render_ours(scene_path)
    _exact(ours, gold["png"], mean_tol=2.0, frac_tol=0.02)


def test_depth_of_field():
    name = "feat_dof"
    extra = ("<NumSamples>36</NumSamples>"
             "<FocusDistance>3.5</FocusDistance>"
             "<ApertureSize>0.35</ApertureSize>")
    xml = f"""<Scene>
  <BackgroundColor>5 5 10</BackgroundColor>
  <MaxRecursionDepth>2</MaxRecursionDepth>
  {CAM.format(pos="0 0 2", gaze="0 0 -1", name=name, extra=extra)}
  <Lights>
    <AmbientLight>15 15 15</AmbientLight>
    <PointLight id="1"><Position>3 4 2</Position>
      <Intensity>900 900 900</Intensity></PointLight>
  </Lights>
  <Materials>
    <Material id="1"><AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.8 0.25 0.2</DiffuseReflectance>
      <SpecularReflectance>0.2 0.2 0.2</SpecularReflectance>
      <PhongExponent>30</PhongExponent></Material>
    <Material id="2"><AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.2 0.8 0.3</DiffuseReflectance>
      <SpecularReflectance>0.2 0.2 0.2</SpecularReflectance>
      <PhongExponent>30</PhongExponent></Material>
    <Material id="3"><AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.25 0.35 0.85</DiffuseReflectance>
      <SpecularReflectance>0.2 0.2 0.2</SpecularReflectance>
      <PhongExponent>30</PhongExponent></Material>
  </Materials>
  <VertexData>
    -1.1 0 -0.6   0 -0.1 -1.5   1.2 0.2 -3.5
  </VertexData>
  <Objects>
    <Sphere id="1"><Material>1</Material><Center>1</Center>
      <Radius>0.45</Radius></Sphere>
    <Sphere id="2"><Material>2</Material><Center>2</Center>
      <Radius>0.5</Radius></Sphere>
    <Sphere id="3"><Material>3</Material><Center>3</Center>
      <Radius>0.6</Radius></Sphere>
  </Objects>
</Scene>"""
    scene_path, gold = fresh_golden_custom(name, xml)
    _skip_if_none(gold)
    ours, _ = _render_ours(scene_path)
    # MC lens sampling: RNG streams differ; compare 8x8 block means
    _mc(ours, gold["png"], block_tol=6.0)


def test_tonemap_and_hdr_output():
    name = "feat_tonemap"
    extra = ("<Tonemap><TMO>Photographic</TMO>"
             "<TMOOptions>0.18 1</TMOOptions>"
             "<Saturation>1.0</Saturation><Gamma>2.2</Gamma></Tonemap>")
    xml = f"""<Scene>
  <BackgroundColor>2 2 4</BackgroundColor>
  <MaxRecursionDepth>3</MaxRecursionDepth>
  {CAM.format(pos="0 1 4", gaze="0 -0.15 -1", name=name, extra=extra)}
  <Lights>
    <AmbientLight>20 20 20</AmbientLight>
    <PointLight id="1"><Position>0 4 0</Position>
      <Intensity>4000 3800 3500</Intensity></PointLight>
  </Lights>
  <Materials>
    <Material id="1"><AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.7 0.7 0.7</DiffuseReflectance>
      <SpecularReflectance>0.4 0.4 0.4</SpecularReflectance>
      <PhongExponent>90</PhongExponent></Material>
    <Material id="2" type="mirror"><AmbientReflectance>0 0 0</AmbientReflectance>
      <DiffuseReflectance>0.1 0.1 0.1</DiffuseReflectance>
      <SpecularReflectance>0 0 0</SpecularReflectance>
      <MirrorReflectance>0.85 0.85 0.85</MirrorReflectance></Material>
  </Materials>
  <VertexData>
    -6 -1 4   6 -1 4   6 -1 -10   -6 -1 -10
    -0.9 -0.2 -2   1 0 -3
  </VertexData>
  <Objects>
    <Mesh id="1"><Material>1</Material><Faces>1 2 3  1 3 4</Faces></Mesh>
    <Sphere id="1"><Material>2</Material><Center>5</Center>
      <Radius>0.8</Radius></Sphere>
    <Sphere id="2"><Material>1</Material><Center>6</Center>
      <Radius>1.0</Radius></Sphere>
  </Objects>
</Scene>"""
    scene_path, gold = fresh_golden_custom(name, xml)
    _skip_if_none(gold)
    ours_ldr, ours_hdr = _render_ours(scene_path)
    _exact(ours_ldr, gold["png"], mean_tol=2.0, frac_tol=0.02)
    if "hdr" in gold:
        g = gold["hdr"]
        rel = np.abs(ours_hdr - g) / (np.abs(g) + 1.0)
        assert np.mean(rel) < 0.02


def _checker_png() -> bytes:
    from advanced_cpu_raytracing_tpu.scene.images import encode_png

    rng = np.random.default_rng(42)
    base = rng.integers(30, 225, (8, 8, 3), dtype=np.uint8)
    return encode_png(np.kron(base, np.ones((2, 2, 1), np.uint8)))  # 16x16


def test_image_textures_nearest_and_bilinear():
    name = "feat_teximg"
    xml = f"""<Scene>
  <BackgroundColor>4 4 8</BackgroundColor>
  <MaxRecursionDepth>2</MaxRecursionDepth>
  {CAM.format(pos="0 0.8 4.2", gaze="0 -0.18 -1", name=name, extra="")}
  <Lights>
    <AmbientLight>30 30 30</AmbientLight>
    <PointLight id="1"><Position>0 4 2</Position>
      <Intensity>1400 1400 1400</Intensity></PointLight>
  </Lights>
  <Materials>
    <Material id="1"><AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.6 0.6 0.6</DiffuseReflectance>
      <SpecularReflectance>0.1 0.1 0.1</SpecularReflectance>
      <PhongExponent>15</PhongExponent></Material>
  </Materials>
  <Textures>
    <Images>
      <Image id="1">tex.png</Image>
    </Images>
    <TextureMap id="1" type="image">
      <DecalMode>replace_kd</DecalMode><ImageId>1</ImageId>
      <Interpolation>nearest</Interpolation>
    </TextureMap>
    <TextureMap id="2" type="image">
      <DecalMode>blend_kd</DecalMode><ImageId>1</ImageId>
      <Interpolation>bilinear</Interpolation>
    </TextureMap>
  </Textures>
  <VertexData>
    -2.2 -1 -2   -0.2 -1 -2   -0.2 1 -2   -2.2 1 -2
    0.2 -1 -2   2.2 -1 -2   2.2 1 -2   0.2 1 -2
  </VertexData>
  <TexCoordData>
    0 1   1 1   1 0   0 0
    0 1   1 1   1 0   0 0
  </TexCoordData>
  <Objects>
    <Mesh id="1"><Material>1</Material><Textures>1</Textures>
      <Faces>1 2 3  1 3 4</Faces></Mesh>
    <Mesh id="2"><Material>1</Material><Textures>2</Textures>
      <Faces>5 6 7  5 7 8</Faces></Mesh>
  </Objects>
</Scene>"""
    scene_path, gold = fresh_golden_custom(
        name, xml, aux_files={"inputs/tex.png": _checker_png()})
    _skip_if_none(gold)
    ours, _ = _render_ours(scene_path)
    _exact(ours, gold["png"], mean_tol=2.0, frac_tol=0.02)


def test_perlin_texture():
    name = "feat_perlin"
    xml = f"""<Scene>
  <BackgroundColor>4 4 8</BackgroundColor>
  <MaxRecursionDepth>2</MaxRecursionDepth>
  {CAM.format(pos="0 1 4", gaze="0 -0.2 -1", name=name, extra="")}
  <Lights>
    <AmbientLight>25 25 25</AmbientLight>
    <PointLight id="1"><Position>2 4 2</Position>
      <Intensity>1200 1200 1200</Intensity></PointLight>
  </Lights>
  <Materials>
    <Material id="1"><AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.7 0.7 0.7</DiffuseReflectance>
      <SpecularReflectance>0.2 0.2 0.2</SpecularReflectance>
      <PhongExponent>25</PhongExponent></Material>
  </Materials>
  <Textures>
    <TextureMap id="1" type="perlin">
      <DecalMode>replace_kd</DecalMode>
      <NoiseConversion>absval</NoiseConversion>
      <NoiseScale>3</NoiseScale>
    </TextureMap>
    <TextureMap id="2" type="perlin">
      <DecalMode>replace_kd</DecalMode>
      <NoiseConversion>linear</NoiseConversion>
      <NoiseScale>1.5</NoiseScale>
    </TextureMap>
  </Textures>
  <VertexData>
    -8 -1 4   8 -1 4   8 -1 -12   -8 -1 -12
    0 0 -2.5
  </VertexData>
  <Objects>
    <Mesh id="1"><Material>1</Material><Textures>2</Textures>
      <Faces>1 2 3  1 3 4</Faces></Mesh>
    <Sphere id="1"><Material>1</Material><Textures>1</Textures>
      <Center>5</Center><Radius>1.0</Radius></Sphere>
  </Objects>
</Scene>"""
    scene_path, gold = fresh_golden_custom(name, xml)
    _skip_if_none(gold)
    ours, _ = _render_ours(scene_path)
    _exact(ours, gold["png"], mean_tol=2.0, frac_tol=0.02)


PT_BOX = """<Scene>
  <BackgroundColor>0 0 0</BackgroundColor>
  <MaxRecursionDepth>4</MaxRecursionDepth>
  <Cameras><Camera id="1">
    <Position>0 0 2.6</Position><Gaze>0 0 -1</Gaze><Up>0 1 0</Up>
    <NearPlane>-1 1 -1 1</NearPlane><NearDistance>1</NearDistance>
    <ImageResolution>128 128</ImageResolution>
    <ImageName>{name}.png</ImageName>
    <NumSamples>{spp}</NumSamples>
    <Renderer>PathTracing</Renderer>
    <RendererParams>{params}</RendererParams>
  </Camera></Cameras>
  <Lights><AmbientLight>0 0 0</AmbientLight></Lights>
  <Materials>
    <Material id="1"><AmbientReflectance>0 0 0</AmbientReflectance>
      <DiffuseReflectance>0.7 0.7 0.7</DiffuseReflectance>
      <SpecularReflectance>0 0 0</SpecularReflectance>
      <PhongExponent>1</PhongExponent></Material>
    <Material id="2"><AmbientReflectance>0 0 0</AmbientReflectance>
      <DiffuseReflectance>0.7 0.12 0.12</DiffuseReflectance>
      <SpecularReflectance>0 0 0</SpecularReflectance>
      <PhongExponent>1</PhongExponent></Material>
    <Material id="3"><AmbientReflectance>0 0 0</AmbientReflectance>
      <DiffuseReflectance>0.12 0.7 0.12</DiffuseReflectance>
      <SpecularReflectance>0 0 0</SpecularReflectance>
      <PhongExponent>1</PhongExponent></Material>
    <Material id="4"><AmbientReflectance>0 0 0</AmbientReflectance>
      <DiffuseReflectance>0 0 0</DiffuseReflectance>
      <SpecularReflectance>0 0 0</SpecularReflectance>
      <PhongExponent>1</PhongExponent></Material>
  </Materials>
  <VertexData>
    -1 -1 1    1 -1 1    1 -1 -1   -1 -1 -1
    -1  1 1    1  1 1    1  1 -1   -1  1 -1
    -0.35 0.999 0.45   0.35 0.999 0.45   0.35 0.999 -0.25   -0.35 0.999 -0.25
  </VertexData>
  <Objects>
    <Mesh id="1"><Material>1</Material>
      <Faces>1 2 3  1 3 4   5 7 6  5 8 7   4 3 7  4 7 8   1 5 6  1 6 2</Faces>
    </Mesh>
    <Mesh id="2"><Material>2</Material>
      <Faces>1 4 8  1 8 5</Faces></Mesh>
    <Mesh id="3"><Material>3</Material>
      <Faces>2 6 7  2 7 3</Faces></Mesh>
    <LightMesh id="4"><Material>4</Material>
      <Radiance>18 17 15</Radiance>
      <Faces>9 10 11  9 11 12</Faces></LightMesh>
  </Objects>
</Scene>"""


@pytest.mark.parametrize("tag,params", [
    ("nee_imp", "NextEventEstimation ImportanceSampling"),
    ("uniform", ""),
])
def test_path_tracing_vs_reference(tag, params):
    """PT cornell box with an emissive LightMesh ceiling panel: the two MC
    estimators (different RNG streams) must agree in 8x8 block means."""
    name = f"feat_pt_{tag}"
    xml = PT_BOX.format(name=name, spp=64, params=params)
    scene_path, gold = fresh_golden_custom(name, xml)
    _skip_if_none(gold)
    ours, _ = _render_ours(scene_path)
    _mc(ours, gold["png"], block_tol=8.0)
    # global energy agreement (estimator means), tighter than block noise
    assert abs(float(ours.mean()) - float(gold["png"].mean())) < 4.0


def test_path_tracing_russian_roulette_self_consistency():
    """RR cannot be cross-validated against the reference: its RR never
    terminates by design — Shade() updates ray.throughput only on the BRDF
    branch (raytracer.cpp:203), the survival max() reads .x twice and .y
    never (raytracer.cpp:141), so maxThroughput stays 1 and
    `probTest > 1` is always false (raytracer.cpp:142) — its RR renders end
    only when chain rays leak out of closed geometry through fp corner gaps.
    Ours implements the documented INTENT (survive w.p. max-throughput, then
    divide).  Check: RR at depth 4 + 8-bounce floor must agree with the
    no-RR estimator run to depth 12 within MC noise.

    Note the reference's GI estimator multiplies each bounce by Shade*2pi
    while KEEPING the cos factor under cosine-importance sampling
    (raytracer.cpp:161-167, 188) — per-bounce energy gain ~kd*(2/3)*2pi,
    which DIVERGES with depth whenever kd > ~0.24 (faithfully replicated;
    the cross-validated PT scenes above use depth 4 where truncation bounds
    it).  A divergent estimator has heavy-tailed MC noise, so the check is
    PAIRED on seeds and relative."""
    import dataclasses

    import jax

    from advanced_cpu_raytracing_tpu.render.integrator import (
        RenderOptions,
        trace_radiance,
    )
    from advanced_cpu_raytracing_tpu.render.camera import build_camera
    from advanced_cpu_raytracing_tpu.render.renderer import (
        options_for_camera,
    )
    from advanced_cpu_raytracing_tpu.scene.pack import pack_scene
    from advanced_cpu_raytracing_tpu.scene.xml_parser import load_scene

    name = "feat_pt_rr_self"
    xml = PT_BOX.format(name=name, spp=1,
                        params="NextEventEstimation ImportanceSampling")
    xml = (xml.replace("0.7 0.7 0.7", "0.35 0.35 0.35")
              .replace("0.7 0.12 0.12", "0.35 0.1 0.1")
              .replace("0.12 0.7 0.12", "0.1 0.35 0.1"))
    scene_path, _ = fresh_golden_custom(name, xml, aux_files={})
    cfg = load_scene(str(scene_path))
    pack = pack_scene(cfg)
    cam = build_camera(cfg.cameras[0])
    base = options_for_camera(cfg, cfg.cameras[0])

    rng = np.random.default_rng(3)
    n = 512
    import jax.numpy as jnp

    px = jnp.asarray(rng.uniform(0, 128, n).astype(np.float32))
    py = jnp.asarray(rng.uniform(0, 128, n).astype(np.float32))

    def estimate(opts, seeds):
        f = jax.jit(lambda k: trace_radiance(pack, cam, px, py, k, opts))
        acc = np.zeros((n, 3))
        for s in seeds:
            acc += np.asarray(f(jax.random.PRNGKey(s)))
        return acc / len(seeds)

    rr = estimate(dataclasses.replace(base, russian_roulette=True,
                                      max_depth=4), range(16))
    deep = estimate(dataclasses.replace(base, max_depth=12), range(16))
    # both estimate the same depth-12 bounce sum (the RR floor extends
    # depth 4 by 8 survival-weighted bounces)
    assert abs(rr.mean() - deep.mean()) / max(deep.mean(), 1.0) < 0.05



def test_environment_light_vs_reference():
    """HDR spherical environment light (SphericalDirectionalLight): the env
    EXR is authored with scene/images.py::write_exr and decoded by the
    reference's vendored tinyexr.  Background lookups are deterministic
    (direction -> lat-long texel); surface shading uses one rejection-sampled
    hemisphere direction per point (different RNG streams), so surface areas
    compare in block means."""
    import io as _io

    import numpy as np

    from advanced_cpu_raytracing_tpu.scene.images import write_exr

    # smooth gradient + a bright band so direction errors are visible
    h, w = 32, 64
    ys, xs = np.mgrid[0:h, 0:w]
    env = np.stack([
        1.0 + 3.0 * xs / w,
        0.5 + 2.0 * ys / h,
        2.0 + np.where((ys > 8) & (ys < 14), 6.0, 0.0),
    ], axis=-1).astype(np.float32)
    buf = _io.BytesIO()
    import tempfile

    with tempfile.NamedTemporaryFile(suffix=".exr", delete=False) as f:
        write_exr(f.name, env)
        exr_bytes = open(f.name, "rb").read()

    name = "feat_env"
    xml = f"""<Scene>
  <BackgroundColor>0 0 0</BackgroundColor>
  <MaxRecursionDepth>2</MaxRecursionDepth>
  {CAM.format(pos="0 1 4", gaze="0 -0.1 -1", name=name, extra="")}
  <Lights>
    <AmbientLight>5 5 5</AmbientLight>
    <SphericalDirectionalLight id="1">
      <ImageId>1</ImageId>
    </SphericalDirectionalLight>
  </Lights>
  <Materials>
    <Material id="1"><AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.6 0.6 0.6</DiffuseReflectance>
      <SpecularReflectance>0.2 0.2 0.2</SpecularReflectance>
      <PhongExponent>20</PhongExponent></Material>
  </Materials>
  <Textures>
    <Images><Image id="1">env.exr</Image></Images>
  </Textures>
  <VertexData>
    -6 -1 4   6 -1 4   6 -1 -8   -6 -1 -8
    0 0 -2
  </VertexData>
  <Objects>
    <Mesh id="1"><Material>1</Material><Faces>1 2 3  1 3 4</Faces></Mesh>
    <Sphere id="1"><Material>1</Material><Center>5</Center>
      <Radius>1.0</Radius></Sphere>
  </Objects>
</Scene>"""
    scene_path, gold = fresh_golden_custom(
        name, xml, aux_files={"inputs/env.exr": exr_bytes})
    _skip_if_none(gold)
    ours, _ = _render_ours(scene_path)
    # MC surface sampling: block means; background pixels are deterministic
    _mc(ours, gold["png"], block_tol=6.0)


def test_brdf_models_vs_reference():
    """All five pluggable BRDF models (src/brdf*.cpp) against the reference
    binary: five spheres in one deterministic 1-spp scene, each shaded by a
    different BRDF (incl. the normalized/kdfresnel variants)."""
    name = "feat_brdfs"
    xml = f"""<Scene>
  <BackgroundColor>6 6 10</BackgroundColor>
  <MaxRecursionDepth>2</MaxRecursionDepth>
  {CAM.format(pos="0 1.2 6", gaze="0 -0.15 -1", name=name, extra="")}
  <Lights>
    <AmbientLight>14 14 14</AmbientLight>
    <PointLight id="1"><Position>0 5 3</Position>
      <Intensity>1500 1450 1400</Intensity></PointLight>
  </Lights>
  <BRDFs>
    <OriginalPhong id="1"><Exponent>30</Exponent></OriginalPhong>
    <ModifiedPhong id="2" normalized="true"><Exponent>40</Exponent></ModifiedPhong>
    <OriginalBlinnPhong id="3"><Exponent>50</Exponent></OriginalBlinnPhong>
    <ModifiedBlinnPhong id="4" normalized="true"><Exponent>60</Exponent></ModifiedBlinnPhong>
    <TorranceSparrow id="5" kdfresnel="true"><Exponent>80</Exponent></TorranceSparrow>
  </BRDFs>
  <Materials>
    <Material id="1"><AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.55 0.55 0.55</DiffuseReflectance>
      <SpecularReflectance>0.15 0.15 0.15</SpecularReflectance>
      <PhongExponent>25</PhongExponent></Material>
    <Material id="2" BRDF="1"><AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.7 0.2 0.2</DiffuseReflectance>
      <SpecularReflectance>0.5 0.5 0.5</SpecularReflectance>
      <PhongExponent>25</PhongExponent></Material>
    <Material id="3" BRDF="2"><AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.2 0.7 0.2</DiffuseReflectance>
      <SpecularReflectance>0.5 0.5 0.5</SpecularReflectance>
      <PhongExponent>25</PhongExponent></Material>
    <Material id="4" BRDF="3"><AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.2 0.2 0.7</DiffuseReflectance>
      <SpecularReflectance>0.5 0.5 0.5</SpecularReflectance>
      <PhongExponent>25</PhongExponent></Material>
    <Material id="5" BRDF="4"><AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.6 0.6 0.2</DiffuseReflectance>
      <SpecularReflectance>0.5 0.5 0.5</SpecularReflectance>
      <PhongExponent>25</PhongExponent></Material>
    <Material id="6" BRDF="5"><AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.6 0.3 0.6</DiffuseReflectance>
      <SpecularReflectance>0.5 0.5 0.5</SpecularReflectance>
      <RefractionIndex>1.8</RefractionIndex>
      <PhongExponent>25</PhongExponent></Material>
  </Materials>
  <VertexData>
    -9 -1 6   9 -1 6   9 -1 -9   -9 -1 -9
    -4 -0.2 0   -2 -0.2 -0.7   0 -0.2 -1   2 -0.2 -0.7   4 -0.2 0
  </VertexData>
  <Objects>
    <Mesh id="1"><Material>1</Material><Faces>1 2 3  1 3 4</Faces></Mesh>
    <Sphere id="1"><Material>2</Material><Center>5</Center><Radius>0.8</Radius></Sphere>
    <Sphere id="2"><Material>3</Material><Center>6</Center><Radius>0.8</Radius></Sphere>
    <Sphere id="3"><Material>4</Material><Center>7</Center><Radius>0.8</Radius></Sphere>
    <Sphere id="4"><Material>5</Material><Center>8</Center><Radius>0.8</Radius></Sphere>
    <Sphere id="5"><Material>6</Material><Center>9</Center><Radius>0.8</Radius></Sphere>
  </Objects>
</Scene>"""
    scene_path, gold = fresh_golden_custom(name, xml)
    _skip_if_none(gold)
    ours, _ = _render_ours(scene_path)
    _exact(ours, gold["png"], mean_tol=2.0, frac_tol=0.02)


def test_normal_and_bump_maps_vs_reference():
    """replace_normal (TBN normal map) and bump_normal (image height-field
    bump) on quads, plus a Perlin bump sphere — deterministic 1 spp vs the
    reference binary (mesh.cpp:264-357, sphere.cpp:116-169)."""
    name = "feat_maps"
    xml = f"""<Scene>
  <BackgroundColor>6 6 10</BackgroundColor>
  <MaxRecursionDepth>2</MaxRecursionDepth>
  {CAM.format(pos="0 0.6 4.4", gaze="0 -0.1 -1", name=name, extra="")}
  <Lights>
    <AmbientLight>20 20 20</AmbientLight>
    <PointLight id="1"><Position>1.5 3 2.5</Position>
      <Intensity>900 900 900</Intensity></PointLight>
  </Lights>
  <Materials>
    <Material id="1"><AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.65 0.6 0.55</DiffuseReflectance>
      <SpecularReflectance>0.25 0.25 0.25</SpecularReflectance>
      <PhongExponent>35</PhongExponent></Material>
  </Materials>
  <Textures>
    <Images>
      <Image id="1">tex.png</Image>
    </Images>
    <TextureMap id="1" type="image">
      <DecalMode>replace_normal</DecalMode><ImageId>1</ImageId>
      <Interpolation>nearest</Interpolation>
    </TextureMap>
    <TextureMap id="2" type="image">
      <DecalMode>bump_normal</DecalMode><ImageId>1</ImageId>
      <Interpolation>nearest</Interpolation>
      <BumpFactor>2.5</BumpFactor>
    </TextureMap>
    <TextureMap id="3" type="perlin">
      <DecalMode>bump_normal</DecalMode>
      <NoiseConversion>absval</NoiseConversion>
      <NoiseScale>2.5</NoiseScale>
    </TextureMap>
  </Textures>
  <VertexData>
    -2.3 -1 -2   -0.3 -1 -2   -0.3 1 -2   -2.3 1 -2
    0.3 -1 -2   2.3 -1 -2   2.3 1 -2   0.3 1 -2
    0 -0.55 -0.4
  </VertexData>
  <TexCoordData>
    0 1   1 1   1 0   0 0
    0 1   1 1   1 0   0 0
  </TexCoordData>
  <Objects>
    <Mesh id="1"><Material>1</Material><Textures>1</Textures>
      <Faces>1 2 3  1 3 4</Faces></Mesh>
    <Mesh id="2"><Material>1</Material><Textures>2</Textures>
      <Faces>5 6 7  5 7 8</Faces></Mesh>
    <Sphere id="1"><Material>1</Material><Textures>3</Textures>
      <Center>9</Center><Radius>0.45</Radius></Sphere>
  </Objects>
</Scene>"""
    scene_path, gold = fresh_golden_custom(
        name, xml, aux_files={"inputs/tex.png": _checker_png()})
    _skip_if_none(gold)
    ours, _ = _render_ours(scene_path)
    _exact(ours, gold["png"], mean_tol=2.5, frac_tol=0.03)


def test_replace_all_and_background_textures_vs_reference():
    """replace_all short-circuits shading (raytracer.cpp:87-89);
    replace_background drives primary-miss color from screen-space UVs
    (raytracer.cpp:49-53).  replace_ks is intentionally NOT cross-validated:
    the reference samples the *diffuse* texture pointer for it
    (raytracer.cpp:516-531, null-deref without one) — divergence documented
    in ARCHITECTURE.md."""
    name = "feat_replall"
    xml = f"""<Scene>
  <BackgroundColor>6 6 10</BackgroundColor>
  <MaxRecursionDepth>2</MaxRecursionDepth>
  {CAM.format(pos="0 0.4 4", gaze="0 0 -1", name=name, extra="")}
  <Lights>
    <AmbientLight>20 20 20</AmbientLight>
    <PointLight id="1"><Position>2 4 2</Position>
      <Intensity>800 800 800</Intensity></PointLight>
  </Lights>
  <Materials>
    <Material id="1"><AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.6 0.6 0.6</DiffuseReflectance>
      <SpecularReflectance>0.1 0.1 0.1</SpecularReflectance>
      <PhongExponent>10</PhongExponent></Material>
  </Materials>
  <Textures>
    <Images>
      <Image id="1">tex.png</Image>
    </Images>
    <TextureMap id="1" type="image">
      <DecalMode>replace_all</DecalMode><ImageId>1</ImageId>
      <Interpolation>bilinear</Interpolation>
    </TextureMap>
    <TextureMap id="2" type="image">
      <DecalMode>replace_background</DecalMode><ImageId>1</ImageId>
      <Interpolation>nearest</Interpolation>
    </TextureMap>
  </Textures>
  <VertexData>
    -1 -1 -2   1 -1 -2   1 1 -2   -1 1 -2
  </VertexData>
  <TexCoordData>
    0 1   1 1   1 0   0 0
  </TexCoordData>
  <Objects>
    <Mesh id="1"><Material>1</Material><Textures>1</Textures>
      <Faces>1 2 3  1 3 4</Faces></Mesh>
  </Objects>
</Scene>"""
    scene_path, gold = fresh_golden_custom(
        name, xml, aux_files={"inputs/tex.png": _checker_png()})
    _skip_if_none(gold)
    ours, _ = _render_ours(scene_path)
    _exact(ours, gold["png"], mean_tol=2.0, frac_tol=0.02)


def test_mesh_perlin_bump_vs_reference():
    """Perlin textures on MESHES — replace_kd(absval), blend_kd, replace_ks
    and bump_normal plus a mirror — vs the reference binary.  Also covers
    the reference's uv-gate quirk (mesh.cpp:245: the whole normal/bump block
    needs TexCoordData, even for UV-free perlin bump), which the pack
    replicates by clearing the slots (scene/pack.py::tex_slots)."""
    import re

    from tests.test_megakernel import PERLIN_SCENE

    xml = PERLIN_SCENE.replace("megaperlin", "feat_meshperlin")
    # replace_ks is intentionally NOT cross-validated (the reference samples
    # the *diffuse* texture pointer for it — see
    # test_replace_all_and_background_textures_vs_reference); strip it here
    # so the oracle comparison stays pure.  The frozen-oracle test keeps it
    # (tests/test_megakernel.py::test_megakernel_perlin_textures).
    xml = xml.replace("<Textures>2 4</Textures>", "<Textures>2</Textures>")
    assert "<Textures>2 4" not in xml
    scene_path, gold = fresh_golden_custom("feat_meshperlin", xml)
    _skip_if_none(gold)
    ours, _ = _render_ours(scene_path)
    _exact(ours, gold["png"], mean_tol=2.0, frac_tol=0.02)

    # uv-less variant: the reference silently skips mesh bump; so do we
    nouv = re.sub(r"<TexCoordData>.*?</TexCoordData>", "", xml, flags=re.S)
    assert nouv != xml
    scene_path2, gold2 = fresh_golden_custom("feat_meshperlin_nouv", nouv)
    _skip_if_none(gold2)
    ours2, _ = _render_ours(scene_path2)
    _exact(ours2, gold2["png"], mean_tol=2.0, frac_tol=0.02)
