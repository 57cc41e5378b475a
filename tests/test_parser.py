import numpy as np
import pytest

from advanced_cpu_raytracing_tpu.scene.types import MaterialType
from advanced_cpu_raytracing_tpu.scene.xml_parser import load_scene
from tests.conftest import WHITTED_XML


def test_simple_scene(simple_scene):
    cfg = simple_scene
    assert cfg.shadow_ray_epsilon == 1e-3
    assert len(cfg.cameras) == 1
    cam = cfg.cameras[0]
    assert cam.width == 800 and cam.height == 800
    assert cam.image_name == "simple.png"
    assert not cam.is_look_at
    np.testing.assert_allclose(cam.near_plane, [-1, 1, -1, 1])
    assert len(cfg.point_lights) == 1
    np.testing.assert_allclose(cfg.point_lights[0].intensity, [1000] * 3)
    np.testing.assert_allclose(cfg.ambient_light, [25, 25, 25])
    # Mesh(2 faces) + Triangle lowered to a 1-face mesh
    assert len(cfg.meshes) == 2
    assert len(cfg.meshes[1].faces) == 1
    assert len(cfg.spheres) == 1
    np.testing.assert_allclose(cfg.spheres[0].center, [-0.875, 1, -2])
    assert cfg.spheres[0].radius == 0.3


def test_material_defaults(simple_scene):
    m = simple_scene.materials[0]
    assert m.type == MaterialType.DEFAULT
    assert m.phong_exponent == 1.0
    assert m.refractive_index == 1.0
    np.testing.assert_allclose(m.mirror, [0, 0, 0])


def test_conductor_materials():
    cfg = load_scene(str(WHITTED_XML))
    assert cfg.max_recursion_depth == 6
    cond = [m for m in cfg.materials if m.type == MaterialType.CONDUCTOR]
    assert len(cond) == 1
    assert cond[0].refractive_index == pytest.approx(0.37)
    assert cond[0].conductor_absorption_index == pytest.approx(2.82)
    np.testing.assert_allclose(cond[0].mirror, [0.9, 0.7, 0.4])
    diel = [m for m in cfg.materials if m.type == MaterialType.DIELECTRIC]
    assert len(diel) == 1 and diel[0].refractive_index == pytest.approx(1.5)


def test_material_carry_over(tmp_path):
    # The reference reuses its Material loop variable, so omitted
    # Diffuse/Ambient tags inherit from the previous material
    # (parser.cpp:1115, 1161-1199).
    xml = """<Scene><Cameras></Cameras><Materials>
      <Material id="1"><DiffuseReflectance>0.5 0.25 0.125</DiffuseReflectance>
        <AmbientReflectance>1 1 1</AmbientReflectance></Material>
      <Material id="2"><AmbientReflectance>0 0 0</AmbientReflectance></Material>
    </Materials></Scene>"""
    p = tmp_path / "carry.xml"
    p.write_text(xml)
    cfg = load_scene(str(p))
    np.testing.assert_allclose(cfg.materials[1].diffuse, [0.5, 0.25, 0.125])
    np.testing.assert_allclose(cfg.materials[1].ambient, [0, 0, 0])


def test_degamma(tmp_path):
    xml = """<Scene><Materials>
      <Material id="1" degamma="true">
        <DiffuseReflectance>0.5 0.5 0.5</DiffuseReflectance></Material>
    </Materials></Scene>"""
    p = tmp_path / "dg.xml"
    p.write_text(xml)
    cfg = load_scene(str(p))
    np.testing.assert_allclose(cfg.materials[0].diffuse, [0.5 ** 2.2] * 3,
                               rtol=1e-6)


def test_lookat_camera(tmp_path):
    xml = """<Scene><Cameras><Camera id="1" type="lookAt">
      <Position>0 0 10</Position><GazePoint>0 0 0</GazePoint>
      <Up>0 1 0</Up><FovY>45</FovY><NearDistance>1</NearDistance>
      <ImageResolution>640 480</ImageResolution>
      <ImageName>t.png</ImageName><NumSamples>16</NumSamples>
      <FocusDistance>5</FocusDistance><ApertureSize>0.5</ApertureSize>
    </Camera></Cameras></Scene>"""
    p = tmp_path / "cam.xml"
    p.write_text(xml)
    cfg = load_scene(str(p))
    cam = cfg.cameras[0]
    assert cam.is_look_at and cam.fov_y_deg == 45
    assert cam.num_samples == 16
    assert cam.aperture_size == 0.5 and cam.focus_distance == 5


def test_renderer_params(tmp_path):
    xml = """<Scene><Cameras><Camera id="1">
      <Position>0 0 0</Position><Gaze>0 0 -1</Gaze><Up>0 1 0</Up>
      <NearPlane>-1 1 -1 1</NearPlane><NearDistance>1</NearDistance>
      <ImageResolution>16 16</ImageResolution><ImageName>t.png</ImageName>
      <Renderer>PathTracing</Renderer>
      <RendererParams>NextEventEstimation RussianRoulette ImportanceSampling</RendererParams>
      <Tonemap><TMO>Photographic</TMO><TMOOptions>0.18 2</TMOOptions>
        <Saturation>1.1</Saturation><Gamma>2.4</Gamma></Tonemap>
    </Camera></Cameras></Scene>"""
    p = tmp_path / "pt.xml"
    p.write_text(xml)
    cam = load_scene(str(p)).cameras[0]
    rp = cam.renderer_params
    assert rp.path_tracing and rp.next_event_estimation
    assert rp.russian_roulette and rp.importance_sampling
    assert cam.tonemap.burn_percent == 2 and cam.tonemap.gamma == 2.4


def test_transformations_and_instances(tmp_path):
    xml = """<Scene>
      <Transformations>
        <Translation id="1">1 2 3</Translation>
        <Scaling id="1">2 2 2</Scaling>
        <Rotation id="1">90 0 1 0</Rotation>
      </Transformations>
      <Materials><Material id="1">
        <DiffuseReflectance>1 1 1</DiffuseReflectance></Material></Materials>
      <VertexData>0 0 0 1 0 0 0 1 0</VertexData>
      <Objects>
        <Mesh id="1"><Material>1</Material>
          <Transformations>s1 t1</Transformations>
          <Faces>1 2 3</Faces></Mesh>
        <MeshInstance id="7" baseMeshId="1" resetTransform="true">
          <Material>1</Material>
          <Transformations>r1</Transformations>
          <MotionBlur>0 0 4</MotionBlur>
        </MeshInstance>
      </Objects></Scene>"""
    p = tmp_path / "tr.xml"
    p.write_text(xml)
    cfg = load_scene(str(p))
    assert cfg.meshes[0].transform_ops[0][0] == "s"
    assert cfg.meshes[0].transform_ops[1][0] == "t"
    inst = cfg.instances[0]
    assert inst.reset_transform and inst.base_mesh_id == 1
    np.testing.assert_allclose(inst.motion_blur, [0, 0, 4])
