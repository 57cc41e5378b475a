"""Golden-image comparison against the reference renderer.

Preferred oracle: the reference's *current* source compiled and run fresh
(tests/conftest.fresh_golden) — the archived hw1_outputs PNGs were produced
by older homework iterations (cornellbox_recursive_alt2.png in particular
predates the current camera code and disagrees with the reference binary
itself by mean 114/255).  The archived PNG is the fallback when no compiler
is available.

Tolerances: the reference exhibits fp-order-sensitive shadow acne on sphere
silhouettes (visible as isolated black/lit pixel noise in its own outputs),
so bitwise equality is impossible against archived goldens; fresh goldens
typically match near-exactly.
"""

import dataclasses
import os

import numpy as np
import pytest

from tests.conftest import HW1_INPUTS, fresh_golden, golden_image

CASES = [
    # (scene, mean_tol, frac_gt2_tol)
    ("simple", 2.0, 0.02),
    ("two_spheres", 2.0, 0.03),
    ("spheres_mirror", 1.0, 0.01),
    ("cornellbox_recursive_conductors", 1.5, 0.03),
    ("spheres", 2.0, 0.03),
    ("cornellbox_recursive_alt2", 2.5, 0.05),  # dielectric recursion
    ("scienceTree", 2.5, 0.05),
    ("scienceTree_diamond", 3.5, 0.08),  # dielectric mesh, deep splits
]


def _render(name, spp=None, force_bvh=False):
    from advanced_cpu_raytracing_tpu.render.renderer import (
        ldr_from_radiance,
        render_camera,
    )
    from advanced_cpu_raytracing_tpu.scene.pack import pack_scene
    from advanced_cpu_raytracing_tpu.scene.xml_parser import load_scene

    cfg = load_scene(str(HW1_INPUTS / f"{name}.xml"))
    pack = pack_scene(cfg)
    if force_bvh:
        pack = dataclasses.replace(
            pack, static=dataclasses.replace(pack.static, use_bvh=True)
        )
    cam = cfg.cameras[0]
    img = render_camera(pack, cfg, cam, seed=0, spp=spp)
    return ldr_from_radiance(img)


@pytest.mark.golden
@pytest.mark.parametrize("name,mean_tol,frac_tol", CASES)
def test_golden(reference_inputs, name, mean_tol, frac_tol):
    if not os.environ.get("ACRT_FULL_GOLDENS"):
        pytest.skip("full-res golden renders cost ~1 min/scene of CPU compile "
                    "+ render; the small-res tier below checks every scene "
                    "against the same fresh oracle in seconds.  Set "
                    "ACRT_FULL_GOLDENS=1 to run these too")
    ours = _render(name)
    gold = fresh_golden(name)
    if gold is None:
        gold = golden_image(name)
    diff = np.abs(ours.astype(int) - gold.astype(int))
    assert diff.mean() < mean_tol, f"mean {diff.mean()}"
    assert (diff > 2).mean() < frac_tol, f"frac {(diff > 2).mean()}"


# ---------------------------------------------------------------------------
# Small-resolution tier: every scene re-authored at ~1/6 resolution and
# rendered through the freshly built reference binary, so the whole tier
# finishes in well under a minute on CPU while still exercising every scene
# (VERDICT r1 item 3).
# ---------------------------------------------------------------------------

# Measured small-res diffs vs the FRESH reference binary (CPU, 2026-08-18):
# six scenes are bit-exact (mean 0.0000, 0.000% pixels >2); conductors shows
# mean 0.298 / 0.32% and spheres 0.011 / 0.014% — both are the reference's
# own fp shadow acne on silhouettes.  Bounds = measured x2 headroom.
SMALL_CASES = [
    ("simple", 0.05, 0.002),
    ("two_spheres", 0.05, 0.002),
    ("spheres_mirror", 0.1, 0.005),
    ("cornellbox_recursive_conductors", 0.6, 0.008),
    ("spheres", 0.1, 0.003),
    ("cornellbox_recursive_alt2", 0.05, 0.002),
    ("scienceTree", 0.05, 0.002),
    ("scienceTree_diamond", 0.1, 0.005),
]


@pytest.mark.golden
@pytest.mark.parametrize("name,mean_tol,frac_tol", SMALL_CASES)
def test_golden_smallres(reference_inputs, name, mean_tol, frac_tol):
    import re

    from tests.conftest import fresh_golden_custom

    xml = (HW1_INPUTS / f"{name}.xml").read_text()
    # scienceTree_diamond's deterministic dielectric split tree costs ~6 min
    # of CPU wavefront time even at 1/6 scale — shrink it harder
    factor = 24 if name == "scienceTree_diamond" else 6

    def shrink(m):
        # heights must stay divisible by 8: the reference assigns height/8
        # rows per thread and SILENTLY DROPS the remainder rows
        # (main.cpp:38-39) — at 800/6 = 133 its bottom 5 rows are garbage
        w, h = int(m.group(1)), int(m.group(2))
        w, h = max(w // factor // 8 * 8, 16), max(h // factor // 8 * 8, 16)
        return f"<ImageResolution>{w} {h}</ImageResolution>"

    xml = re.sub(r"<ImageResolution>\s*(\d+)\s+(\d+)\s*</ImageResolution>",
                 shrink, xml)
    scene_path, gold = fresh_golden_custom(f"small_{name}", xml)
    if gold is None:
        pytest.skip("reference binary unavailable")

    from advanced_cpu_raytracing_tpu.render.renderer import render_camera
    from advanced_cpu_raytracing_tpu.scene.pack import pack_scene
    from advanced_cpu_raytracing_tpu.scene.xml_parser import load_scene

    cfg = load_scene(str(scene_path))
    pack = pack_scene(cfg)
    ours = render_camera(pack, cfg, cfg.cameras[0], seed=0, ldr=True)
    diff = np.abs(ours.astype(int) - gold["png"].astype(int))
    assert diff.mean() < mean_tol, f"mean {diff.mean()}"
    assert (diff > 2).mean() < frac_tol, f"frac {(diff > 2).mean()}"


@pytest.mark.golden
def test_golden_simple_bvh_path(reference_inputs):
    # same scene through the BVH traversal path must match the golden too
    ours = _render("simple", force_bvh=True)
    gold = golden_image("simple")
    diff = np.abs(ours.astype(int) - gold.astype(int))
    assert diff.mean() < 2.0
    assert (diff > 2).mean() < 0.02


@pytest.mark.golden
@pytest.mark.slow
def test_golden_ton_roosendaal_bvh():
    """Large PLY mesh (16k faces) through the BVH traversal path, against the
    author's archived render (deterministic 1-spp scene; the archived PNG for
    this scene matches the current reference code)."""
    from PIL import Image

    from advanced_cpu_raytracing_tpu.render.renderer import (
        ldr_from_radiance,
        render_camera,
    )
    from advanced_cpu_raytracing_tpu.scene.pack import pack_scene
    from advanced_cpu_raytracing_tpu.scene.xml_parser import load_scene
    from tests.conftest import HW1_INPUTS, HW1_OUTPUTS

    if not os.environ.get("ACRT_FULL_GOLDENS"):
        pytest.skip("78k-face full-res render through the CPU BVH path takes "
                    "minutes; set ACRT_FULL_GOLDENS=1")
    scene = HW1_INPUTS / "akif_uslu" / "ton_Roosendaal_smooth.xml"
    gold_path = HW1_OUTPUTS / "akif_uslu" / "ton_Roosendaal_smooth.png"
    if not scene.exists() or not gold_path.exists():
        pytest.skip("assets missing")
    cfg = load_scene(str(scene))
    pack = pack_scene(cfg)
    assert pack.static.use_bvh
    img = ldr_from_radiance(render_camera(pack, cfg, cfg.cameras[0], seed=0))
    gold = np.asarray(Image.open(gold_path).convert("RGB"))
    diff = np.abs(img.astype(int) - gold.astype(int))
    assert diff.mean() < 3.0, f"mean {diff.mean()}"
    assert (diff > 2).mean() < 0.05, f"frac {(diff > 2).mean()}"


# ---------------------------------------------------------------------------
# Contributor scenes (archive/hw1_inputs/akif_uslu/) with all assets present.
# Triage of the rest (PARITY.md): lobster.xml and other_dragon.xml reference
# PLY files absent from the repo; trex_smooth.xml is missing mesh_3.ply.
# Full-resolution (up to 1080x1920) through the CPU BVH path takes minutes,
# so these run small-res against the fresh reference binary by default and
# full-res against the archived PNGs under ACRT_FULL_GOLDENS=1.
# ---------------------------------------------------------------------------

# tower_smooth and windmill_smooth are NOT here: the reference binary hangs
# on them at ANY resolution (tower: >20 min at 135x240, 27% of host RAM;
# windmill: killed after minutes at 100x100) — our renderer handles both.
# trex/lobster/other_dragon miss PLY
# assets (see PARITY.md triage).
CONTRIB = ["berserker_smooth", "car_smooth_fixed", "low_poly_smooth"]


@pytest.mark.golden
@pytest.mark.parametrize("name", CONTRIB)
def test_golden_contrib_smallres(reference_inputs, name):
    import re

    from tests.conftest import fresh_golden_custom

    xml = (HW1_INPUTS / "akif_uslu" / f"{name}.xml").read_text()

    def shrink(m):
        w, h = int(m.group(1)), int(m.group(2))
        w, h = max(w // 8 // 8 * 8, 16), max(h // 8 // 8 * 8, 16)
        return f"<ImageResolution>{w} {h}</ImageResolution>"

    xml = re.sub(r"<ImageResolution>\s*(\d+)\s+(\d+)\s*</ImageResolution>",
                 shrink, xml)
    scene_path, gold = fresh_golden_custom(f"small_{name}", xml)
    if gold is None:
        pytest.skip("reference binary unavailable")

    from advanced_cpu_raytracing_tpu.render.renderer import render_camera
    from advanced_cpu_raytracing_tpu.scene.pack import pack_scene
    from advanced_cpu_raytracing_tpu.scene.xml_parser import load_scene

    cfg = load_scene(str(scene_path))
    pack = pack_scene(cfg)
    for cam_cfg in cfg.cameras:  # car has two cameras
        ours = render_camera(pack, cfg, cam_cfg, seed=0, ldr=True)
        gimg = gold["pngs"].get(cam_cfg.image_name, gold["png"])
        diff = np.abs(ours.astype(int) - gimg.astype(int))
        assert diff.mean() < 3.0, f"{cam_cfg.image_name} mean {diff.mean()}"
        assert (diff > 2).mean() < 0.06, \
            f"{cam_cfg.image_name} frac {(diff > 2).mean()}"
