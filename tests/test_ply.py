import io

import numpy as np
import pytest

from advanced_cpu_raytracing_tpu.scene.ply import load_ply_python


def _write_binary_ply(path, n=64):
    """A binary little-endian PLY heightfield: n x n vertices with float
    x y z and a float normal, 2 (n-1)^2 triangle faces as uchar/int lists —
    the layout of the reference's smooth-shaded PLY assets."""
    ys, xs = np.mgrid[0:n, 0:n].astype(np.float32)
    v = np.stack([xs, np.sin(xs * 0.3) * np.cos(ys * 0.2), ys], axis=-1)
    v = v.reshape(-1, 3).astype("<f4")
    nrm = np.tile(np.array([0, 1, 0], "<f4"), (n * n, 1))
    idx = np.arange(n * n).reshape(n, n)
    a, b = idx[:-1, :-1].ravel(), idx[1:, :-1].ravel()
    c, d = idx[1:, 1:].ravel(), idx[:-1, 1:].ravel()
    t = np.concatenate([np.stack([a, b, c], -1), np.stack([a, c, d], -1)])
    vert_rec = np.empty(n * n, dtype=[("p", "<f4", 3), ("n", "<f4", 3)])
    vert_rec["p"], vert_rec["n"] = v, nrm
    face_rec = np.empty(len(t), dtype=[("k", "u1"), ("i", "<i4", 3)])
    face_rec["k"], face_rec["i"] = 3, t
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n * n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property float nx\nproperty float ny\nproperty float nz\n"
        f"element face {len(t)}\n"
        "property list uchar int vertex_indices\nend_header\n")
    path.write_bytes(header.encode() + vert_rec.tobytes()
                     + face_rec.tobytes())
    return v, t


def _write_ascii_ply(path, quads=False):
    faces = "3 0 1 2\n" if not quads else "4 0 1 2 3\n"
    nv = 4
    path.write_text(
        "ply\nformat ascii 1.0\n"
        f"element vertex {nv}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "element face 1\n"
        "property list uchar int vertex_indices\n"
        "end_header\n"
        "0 0 0\n1 0 0\n1 1 0\n0 1 0\n" + faces
    )


def test_ascii_tri(tmp_path):
    p = tmp_path / "t.ply"
    _write_ascii_ply(p)
    v, t = load_ply_python(str(p))
    assert v.shape == (4, 3) and t.shape == (1, 3)
    np.testing.assert_allclose(v[2], [1, 1, 0])


def test_ascii_quad_split(tmp_path):
    # quad -> (v0,v1,v2) + (v2,v3,v0) (parser.cpp:1431-1437)
    p = tmp_path / "q.ply"
    _write_ascii_ply(p, quads=True)
    v, t = load_ply_python(str(p))
    assert t.shape == (2, 3)
    np.testing.assert_array_equal(t[0], [0, 1, 2])
    np.testing.assert_array_equal(t[1], [2, 3, 0])


def test_binary_reference_asset(tmp_path):
    p = tmp_path / "mesh_1.ply"
    v_ref, t_ref = _write_binary_ply(p)
    v, t = load_ply_python(str(p))
    assert v.shape == (4096, 3)
    assert t.shape == (7938, 3)
    assert t.min() >= 0 and t.max() < 4096
    np.testing.assert_array_equal(v, v_ref)
    np.testing.assert_array_equal(t, t_ref)


def test_native_matches_python(tmp_path):
    from advanced_cpu_raytracing_tpu.native.bindings import load_ply_native

    p = tmp_path / "mesh_1.ply"
    _write_binary_ply(p)
    res = load_ply_native(str(p))
    if res is None:
        pytest.skip("native library unavailable")
    vn, tn = res
    vp, tp = load_ply_python(str(p))
    np.testing.assert_array_equal(tn, tp)
    np.testing.assert_allclose(vn, vp)
