"""Stochastic single-path dielectric sampling vs the deterministic split.

The single-path estimator (RenderOptions.stochastic_dielectric) picks reflect
with probability r_refl, else refract, with the Fresnel weight cancelling the
selection probability — unbiased for the split integrator (reference
raytracer.cpp:313-410).  Verified in expectation over seeds, and structurally:
the stochastic mode's iteration bound is O(depth), not O(2^depth).
"""

import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from advanced_cpu_raytracing_tpu.render.camera import build_camera
from advanced_cpu_raytracing_tpu.render.integrator import (
    RenderOptions,
    trace_radiance,
)
from advanced_cpu_raytracing_tpu.scene.pack import pack_scene
from advanced_cpu_raytracing_tpu.scene.xml_parser import load_scene
from tests.conftest import WHITTED_XML


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    # the Whitted Cornell box (dielectric sphere, depth 6) without its area
    # light, so the deterministic split is a noise-free reference
    xml = re.sub(r"<AreaLight.*?</AreaLight>", "", WHITTED_XML.read_text(),
                 flags=re.S)
    path = tmp_path_factory.mktemp("scene") / "whitted_point.xml"
    path.write_text(xml)
    cfg = load_scene(str(path))
    assert not cfg.area_lights
    pack = pack_scene(cfg)
    cam = build_camera(cfg.cameras[0])
    rng = np.random.default_rng(11)
    n = 512
    px = jnp.asarray(rng.uniform(0, 800, n).astype(np.float32))
    py = jnp.asarray(rng.uniform(0, 800, n).astype(np.float32))
    return pack, cam, px, py


def test_iteration_bound_is_linear(setup):
    """Stochastic mode removes the dielectric branch from the stack budget."""
    split = RenderOptions(max_depth=8)
    single = RenderOptions(max_depth=8, stochastic_dielectric=True)
    assert split.auto_iters(branching=2) > 200
    assert single.auto_iters(branching=1) == 10


def test_unbiased_vs_split(setup):
    """Mean over seeds of the single-path estimator must match the
    deterministic split within Monte-Carlo error."""
    pack, cam, px, py = setup
    opts_split = RenderOptions(max_depth=6)
    opts_mc = RenderOptions(max_depth=6, stochastic_dielectric=True)

    f_split = jax.jit(
        lambda k: trace_radiance(pack, cam, px, py, k, opts_split))
    f_mc = jax.jit(lambda k: trace_radiance(pack, cam, px, py, k, opts_mc))

    ref = np.asarray(f_split(jax.random.PRNGKey(0)))
    # rare Fresnel branches (a few % reflectance onto bright highlights) need
    # enough seeds that no lane sees its rare branch zero times
    n_seeds = 128
    acc = np.zeros_like(ref)
    samples = []
    for s in range(n_seeds):
        img = np.asarray(f_mc(jax.random.PRNGKey(100 + s)))
        acc += img
        samples.append(img)
    mean = acc / n_seeds
    stderr = np.std(np.stack(samples), axis=0) / np.sqrt(n_seeds)

    diff = np.abs(mean - ref)
    # each lane's error should be explained by MC noise (4 sigma + epsilon);
    # aggregate bias must vanish
    assert np.mean(diff) < np.mean(stderr) * 1.0 + 0.05
    assert np.quantile(diff - 4.0 * stderr - 0.05, 0.999) <= 0.0
