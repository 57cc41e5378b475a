"""The dense brute-force hit test (ops/traverse.py) against a plain numpy
loop over triangles, its motion-blur offsets, and the gradient rule of the
differentiable hit (stop-gradient topology + winner recompute)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from advanced_cpu_raytracing_tpu.ops import traverse
from advanced_cpu_raytracing_tpu.ops.traverse import _brute_hits


def _random_case(n_rays=200, n_tris=37, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2, 2, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    v0 = rng.uniform(-4, 4, (n_tris, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-2, 2, (n_tris, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-2, 2, (n_tris, 3)).astype(np.float32)
    return o, d, v0, v1, v2


def _numpy_loop(o, d, v0, v1, v2, offset=None):
    """One triangle at a time in float64 (Cramer's rule,
    Mesh::IntersectFace, src/mesh.cpp:201-236); first minimum wins."""
    o, d = o.astype(np.float64), d.astype(np.float64)
    r = o.shape[0]
    t_best = np.full(r, np.inf)
    i_best = np.full(r, -1)
    b_best = np.zeros(r)
    g_best = np.zeros(r)
    for i in range(v0.shape[0]):
        oi = o if offset is None else o + offset[i]
        a, b, c = (x[i].astype(np.float64) for x in (v0, v1, v2))
        m = np.stack([np.broadcast_to(a - b, d.shape),
                      np.broadcast_to(a - c, d.shape), d], axis=-1)
        det = np.linalg.det(m)
        safe = np.where(det == 0, 1.0, det)
        rhs = a - oi
        sol = [np.linalg.det(np.where(np.arange(3)[None, None, :] == k,
                                      rhs[:, :, None], m)) / safe
               for k in range(3)]
        beta, gamma, t = sol
        ok = ((det != 0) & (beta >= 0) & (gamma >= 0) & (beta + gamma <= 1)
              & (t > 0) & (t < t_best))
        t_best = np.where(ok, t, t_best)
        i_best = np.where(ok, i, i_best)
        b_best = np.where(ok, beta, b_best)
        g_best = np.where(ok, gamma, g_best)
    return t_best, i_best, b_best, g_best


def _assert_same_hits(got, ref):
    tk, ik, bk, gk = map(np.asarray, got)
    tj, ij, bj, gj = ref
    np.testing.assert_array_equal(ik >= 0, ij >= 0)
    hit = ij >= 0
    assert np.all(np.isinf(tk[~hit]))
    # another winner only where two hits tie in t at f32 precision
    same = hit & (ik == ij)
    flip = hit & ~same
    assert np.all(np.abs(tk[flip] - tj[flip]) <= 1e-5 * tj[flip])
    np.testing.assert_allclose(tk[hit], tj[hit], rtol=1e-4)
    np.testing.assert_allclose(bk[same], bj[same], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(gk[same], gj[same], rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matches_numpy_loop(seed):
    case = _random_case(seed=seed)
    _assert_same_hits(_brute_hits(*map(jnp.asarray, case)),
                      _numpy_loop(*case))


def test_all_miss():
    o, d, v0, v1, v2 = _random_case(n_rays=64, n_tris=8, seed=3)
    # move every ray far away from every triangle
    t, idx, _, _ = _brute_hits(*map(jnp.asarray, (o + 1000.0, d, v0, v1,
                                                 v2)))
    assert np.all(np.asarray(idx) == -1)
    assert np.all(np.isinf(np.asarray(t)))


def test_odd_shapes():
    case = _random_case(n_rays=67, n_tris=13, seed=4)
    _assert_same_hits(_brute_hits(*map(jnp.asarray, case)),
                      _numpy_loop(*case))


def test_motion_offset():
    """Each item's ray origin shifts by its own offset (motion blur)."""
    o, d, v0, v1, v2 = _random_case(n_rays=90, n_tris=11, seed=6)
    rng = np.random.default_rng(7)
    motion = rng.normal(size=(11, 3)).astype(np.float32)
    time = rng.uniform(0, 1, 90).astype(np.float32)
    offset = motion[:, None, :] * time[None, :, None]
    _assert_same_hits(
        _brute_hits(*map(jnp.asarray, (o, d, v0, v1, v2, offset))),
        _numpy_loop(o, d, v0, v1, v2, offset))


def _whitted_pack():
    from advanced_cpu_raytracing_tpu.scene.pack import pack_scene
    from advanced_cpu_raytracing_tpu.scene.xml_parser import load_scene
    from tests.conftest import WHITTED_XML

    return pack_scene(load_scene(str(WHITTED_XML)))


def _scene_rays(n=128, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-4, 4, (n, 3)).astype(np.float32) + np.array(
        [0, 5, 0], np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def test_closest_hit_matches_numpy_loop():
    """closest_hit on a real brute-force scene: the winning entity and face
    follow the numpy loop over the pack's world-space work items."""
    pack = _whitted_pack()
    assert not pack.static.use_bvh and pack.static.n_spheres == 2
    pack = dataclasses.replace(pack, static=dataclasses.replace(
        pack.static, n_spheres=0))  # triangles only
    o, d = _scene_rays()
    hit = traverse.closest_hit(pack, jnp.asarray(o), jnp.asarray(d))
    t, idx, _, _ = _numpy_loop(o, d, *(np.asarray(x) for x in (
        pack.wi_v0, pack.wi_v1, pack.wi_v2)))
    valid = np.asarray(hit.valid)
    np.testing.assert_array_equal(valid, idx >= 0)
    assert valid.sum() > 64
    np.testing.assert_allclose(np.asarray(hit.t)[valid], t[valid], rtol=1e-4)
    np.testing.assert_array_equal(np.asarray(hit.face)[valid],
                                  np.asarray(pack.wi_face)[idx[valid]])
    np.testing.assert_array_equal(np.asarray(hit.index)[valid],
                                  np.asarray(pack.wi_ent)[idx[valid]])


def test_occluded_matches_bvh_strategy():
    """Occlusion through the shadow table equals the per-entity BVH walk
    (which masks emissive entities itself)."""
    pack = _whitted_pack()
    p_bvh = dataclasses.replace(pack, static=dataclasses.replace(
        pack.static, use_bvh=True))
    o, d = _scene_rays(256, seed=1)
    lim = jnp.asarray(np.random.default_rng(2).uniform(0.5, 12, 256)
                      .astype(np.float32))
    a = traverse.occluded(pack, jnp.asarray(o), jnp.asarray(d), lim)
    b = traverse.occluded(p_bvh, jnp.asarray(o), jnp.asarray(d), lim)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert 0 < int(np.asarray(a).sum()) < 256


@pytest.mark.parametrize("use_bvh", [False, True])
def test_differentiable_hit_values_match(use_bvh):
    """The differentiable hit (stop-gradient topology + winner recompute in
    object space) returns the same hits as the plain query."""
    pack = _whitted_pack()
    pack = dataclasses.replace(pack, static=dataclasses.replace(
        pack.static, use_bvh=use_bvh))
    o, d = map(jnp.asarray, _scene_rays(seed=3))
    h0 = traverse.closest_hit(pack, o, d)
    h1 = traverse.closest_hit(pack, o, d, differentiable=True)
    np.testing.assert_array_equal(np.asarray(h0.valid), np.asarray(h1.valid))
    np.testing.assert_array_equal(np.asarray(h0.face), np.asarray(h1.face))
    m = np.asarray(h0.valid)
    np.testing.assert_allclose(np.asarray(h1.t)[m], np.asarray(h0.t)[m],
                               rtol=1e-5, atol=1e-5)


def test_hit_t_gradient_matches_finite_difference():
    """d(sum of hit t)/d(ray origin) through the winner recompute equals
    central differences (rays away from silhouettes)."""
    pack = _whitted_pack()
    o, d = map(jnp.asarray, _scene_rays(64, seed=4))

    def total_t(o):
        h = traverse.closest_hit(pack, o, d, differentiable=True)
        return jnp.sum(jnp.where(h.valid & (h.kind == traverse.KIND_TRI),
                                 h.t, 0.0))

    g = np.asarray(jax.grad(total_t)(o))
    eps = 1e-3
    for c in range(3):
        step = jnp.zeros_like(o).at[:, c].set(eps)
        fd = (float(total_t(o + step)) - float(total_t(o - step))) / (2 * eps)
        np.testing.assert_allclose(g[:, c].sum(), fd, rtol=2e-2, atol=1e-3)
