import numpy as np
import jax.numpy as jnp
import pytest

from advanced_cpu_raytracing_tpu.ops.traverse import (
    KIND_SPHERE,
    KIND_TRI,
    closest_hit,
    occluded,
)
from advanced_cpu_raytracing_tpu.scene.pack import pack_scene
from advanced_cpu_raytracing_tpu.scene.xml_parser import load_scene
from tests.conftest import SIMPLE_XML, WHITTED_XML


@pytest.fixture(scope="module")
def pack():
    return pack_scene(load_scene(str(SIMPLE_XML)))


def test_primary_hits(pack):
    # center ray hits the quad at z=-2
    o = jnp.zeros((3, 3))
    d = jnp.asarray([
        [0.0, 0.0, -1.0],                 # quad center
        [-0.875 / 2.0, 0.5, -1.0],        # toward the sphere
        [0.0, 1.0, 0.0],                  # up: miss
    ])
    hit = closest_hit(pack, o, d)
    assert bool(hit.valid[0]) and int(hit.kind[0]) == int(KIND_TRI)
    np.testing.assert_allclose(float(hit.t[0]), 2.0, atol=1e-5)
    assert bool(hit.valid[1]) and int(hit.kind[1]) == int(KIND_SPHERE)
    assert not bool(hit.valid[2])


def test_closest_of_overlapping(pack):
    # ray through both the sphere (at z=-2, r=0.3 around y=1) region and
    # beyond: sphere must win over farther geometry when both on the path
    o = jnp.array([[-0.875, 1.0, 0.0]])
    d = jnp.array([[0.0, 0.0, -1.0]])
    hit = closest_hit(pack, o, d)
    assert int(hit.kind[0]) == int(KIND_SPHERE)
    np.testing.assert_allclose(float(hit.t[0]), 1.7, atol=1e-5)


def test_occlusion(pack):
    # from just in front of the quad toward the light at origin: clear
    o = jnp.array([[0.0, 0.0, -1.9]])
    d = jnp.array([[0.0, 0.0, 1.0]])
    assert not bool(occluded(pack, o, d, jnp.array([1.9]))[0])
    # from behind the quad toward the origin: blocked by the quad
    o2 = jnp.array([[0.1, 0.1, -3.0]])
    d2 = jnp.array([[0.0, 0.0, 1.0]])
    assert bool(occluded(pack, o2, d2, jnp.array([3.0]))[0])
    # blocker beyond the light does not cast shadow
    assert not bool(occluded(pack, o2, d2, jnp.array([0.5]))[0])


def test_bvh_matches_brute():
    # force-BVH pack vs brute pack must agree on hits
    import dataclasses

    cfg = load_scene(str(WHITTED_XML))
    p_brute = pack_scene(cfg)
    p_bvh = dataclasses.replace(
        p_brute, static=dataclasses.replace(p_brute.static, use_bvh=True)
    )
    rng = np.random.default_rng(0)
    n = 128
    o = jnp.asarray(rng.uniform(-5, 5, (n, 3)).astype(np.float32))
    d = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    hb = closest_hit(p_brute, o, d)
    hv = closest_hit(p_bvh, o, d)
    np.testing.assert_array_equal(np.asarray(hb.valid), np.asarray(hv.valid))
    m = np.asarray(hb.valid)
    np.testing.assert_allclose(np.asarray(hb.t)[m], np.asarray(hv.t)[m],
                               rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(hb.kind)[m], np.asarray(hv.kind)[m])
