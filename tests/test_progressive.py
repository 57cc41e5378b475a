"""Progressive rendering + checkpoint/resume tests."""

import numpy as np

from advanced_cpu_raytracing_tpu.render.progressive import ProgressiveRenderer


def _setup():
    from advanced_cpu_raytracing_tpu.scene.pack import pack_scene
    from advanced_cpu_raytracing_tpu.scene.xml_parser import load_scene
    from tests.conftest import SIMPLE_XML

    cfg = load_scene(str(SIMPLE_XML))
    # shrink the camera for speed
    cfg.cameras[0].width = 16
    cfg.cameras[0].height = 16
    return cfg, pack_scene(cfg)


def test_progressive_accumulates():
    cfg, pack = _setup()
    pr = ProgressiveRenderer(pack, cfg, cfg.cameras[0], tile_size=256)
    pr.step()
    img1 = pr.image.copy()
    pr.step()
    img2 = pr.image
    assert pr.samples_done == 2
    assert np.isfinite(img2).all()
    # first pass is deterministic center-sample; average stays close
    assert np.abs(img2 - img1).mean() < max(img1.mean(), 1.0)


def test_checkpoint_resume(tmp_path):
    cfg, pack = _setup()
    ck = str(tmp_path / "render.ckpt.npz")

    a = ProgressiveRenderer(pack, cfg, cfg.cameras[0], tile_size=256)
    a.step()
    a.step()
    a.save(ck)

    b = ProgressiveRenderer(pack, cfg, cfg.cameras[0], tile_size=256)
    assert b.load(ck)
    assert b.samples_done == 2
    np.testing.assert_allclose(b.image, a.image)

    # resuming continues the same RNG stream: b's next pass equals what a
    # would produce
    a.step()
    b.step()
    np.testing.assert_allclose(b.image, a.image)


def test_checkpoint_rejects_mismatch(tmp_path):
    cfg, pack = _setup()
    ck = str(tmp_path / "c.npz")
    a = ProgressiveRenderer(pack, cfg, cfg.cameras[0], tile_size=256)
    a.step()
    a.save(ck)
    cfg.cameras[0].width = 8
    b = ProgressiveRenderer(pack, cfg, cfg.cameras[0], tile_size=256)
    assert not b.load(ck)
