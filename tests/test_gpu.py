"""Card tier: compiled code on a CUDA GPU against the plain references.

Every test here needs a GPU and skips elsewhere; the decision is made in a
fixture, so every pytest worker collects the same tests.  Run alone on the
card (chip_smoke.py does this before it starts its own phases):

    python -m pytest tests/test_gpu.py -m gpu -q
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def gpu():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a CUDA GPU (JAX platform is {dev.platform!r})")
    return dev


@pytest.mark.parametrize("n_tri", [32, 2048])
def test_brute_hits_gpu_matches_cpu(gpu, n_tri):
    """The dense brute-force hit test compiled for the card vs the host
    CPU, at the brute-force cap and below."""
    from chip_smoke import check_hits, random_hit_case
    from advanced_cpu_raytracing_tpu.ops.traverse import _brute_hits

    case = random_hit_case(65536, n_tri, seed=n_tri)
    cpu = jax.devices("cpu")[0]
    got = jax.jit(_brute_hits)(*case)
    ref = jax.jit(_brute_hits)(*(jax.device_put(x, cpu) for x in case))
    check_hits(got, ref)


def test_wavefront_gpu_matches_cpu(gpu):
    """One jitted tile of the Whitted Cornell box on the card and on the
    host CPU: identical inputs and keys, so the u8 images agree up to
    silhouette branch flips under another fp order."""
    from chip_smoke import compare_u8, render_tile_on

    cpu = jax.devices("cpu")[0]
    img_gpu = render_tile_on(gpu, "scenes/cornell_whitted.xml", 1024)
    img_cpu = render_tile_on(cpu, "scenes/cornell_whitted.xml", 1024)
    compare_u8(img_gpu, img_cpu)


def test_fwd_bwd_gpu_matches_cpu(gpu):
    """Gradients of a pixel loss on the card vs the host CPU (identical
    inputs and key), to a relative L2 error of 1e-3."""
    from chip_smoke import REPO
    from advanced_cpu_raytracing_tpu.diff.params import (
        extract_params,
        inject_params,
    )
    from advanced_cpu_raytracing_tpu.render.camera import build_camera
    from advanced_cpu_raytracing_tpu.render.integrator import (
        RenderOptions,
        trace_radiance,
    )
    from advanced_cpu_raytracing_tpu.scene.pack import pack_scene
    from advanced_cpu_raytracing_tpu.scene.xml_parser import load_scene

    cfg = load_scene(str(REPO / "scenes" / "cornell_whitted.xml"))
    pack = pack_scene(cfg)
    cam = build_camera(cfg.cameras[0])
    opts = RenderOptions(max_depth=6, differentiable=True, max_iters=8,
                         stochastic_dielectric=True)
    ys, xs = divmod(jnp.arange(2048), 64)
    px = (xs * 12.5).astype(jnp.float32)
    py = (ys * 25.0).astype(jnp.float32)
    params = extract_params(pack, ("mat_diffuse", "pl_intensity", "verts"))

    def loss(params, pack, cam, px, py, key):
        img = trace_radiance(inject_params(pack, params), cam, px, py, key,
                             opts)
        return jnp.mean(img ** 2)

    step = jax.jit(jax.grad(loss))
    args = (params, pack, cam, px, py, jax.random.PRNGKey(1))
    g_gpu = step(*args)
    cpu = jax.devices("cpu")[0]
    g_cpu = step(*(jax.device_put(a, cpu) for a in args))
    for k in params:
        a, b = np.asarray(g_gpu[k]), np.asarray(g_cpu[k])
        assert np.linalg.norm(b) > 0, k
        assert np.linalg.norm(a - b) <= 1e-3 * np.linalg.norm(b), k
