"""Sharded rendering: pixels split across the device mesh, scene replicated.

Strategy (SURVEY.md section 2.3 / 7): data parallelism over pixels is the
reference's only axis (row blocks over 8 pthreads, main.cpp:38-39); here the
flattened pixel batch is sharded on the ``tiles`` mesh axis with
``jax.sharding`` annotations and jit — XLA partitions the whole integrator
SPMD and inserts any needed collectives (psum for scalar reductions and for
parameter gradients in the differentiable path), which run over NVLink on a
multi-GPU host.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from advanced_cpu_raytracing_tpu.parallel.mesh import (
    make_device_mesh,
    replicated,
    tile_sharding,
)
from advanced_cpu_raytracing_tpu.render.integrator import (
    RenderOptions,
    trace_radiance,
)


@partial(jax.jit, static_argnames=("opts",))
def _traced(pack, cam, px, py, key, opts):
    return trace_radiance(pack, cam, px, py, key, opts)


def render_camera_sharded(pack, cfg, cam_cfg, mesh=None, seed: int = 0,
                          spp: int | None = None) -> np.ndarray:
    """The PRODUCTION render — stratified multisampling + Gaussian
    reconstruction included — with pixels sharded across the device mesh.

    This is the same jitted tile function the single-device renderer uses
    (render/renderer.py::_render_tile); the only difference is the sharding
    annotations on the pixel batch (scene pack and camera replicated).  XLA
    partitions the whole integrator SPMD, so the result equals the
    single-device image up to fp reduction order.  The reference's analogue
    is its only parallel axis: row blocks over 8 pthreads (main.cpp:38-39).
    """
    import math

    from advanced_cpu_raytracing_tpu.render.renderer import (
        _render_tile,
        options_for_camera,
    )
    from advanced_cpu_raytracing_tpu.render.camera import build_camera

    if mesh is None:
        mesh = make_device_mesh()
    cam = build_camera(cam_cfg)
    opts = options_for_camera(cfg, cam_cfg)
    w, h = cam_cfg.width, cam_cfg.height
    spp = cam_cfg.num_samples if spp is None else spp
    n_cells = max(int(math.isqrt(max(spp, 1))), 1)

    total = w * h
    pad = (-total) % mesh.size
    ys, xs = np.divmod(np.arange(total, dtype=np.int64), w)
    px = np.pad(xs.astype(np.float32), (0, pad))
    py = np.pad(ys.astype(np.float32), (0, pad))

    shard = tile_sharding(mesh)
    repl = replicated(mesh)
    px = jax.device_put(jnp.asarray(px), shard)
    py = jax.device_put(jnp.asarray(py), shard)
    pack_r = jax.device_put(pack, repl)
    cam_r = jax.device_put(cam, repl)
    # fold_in(key, 0) mirrors the single-device driver's per-tile key for its
    # first (here: only) tile, so sharded and unsharded images use identical
    # sample jitter
    key = jax.device_put(
        jax.random.fold_in(jax.random.PRNGKey(seed), 0), repl)

    col = _render_tile(pack_r, cam_r, px, py, key, opts, n_cells)
    return np.asarray(col)[:total].reshape(h, w, 3)


def render_sharded(pack, cam, px, py, key, opts: RenderOptions, mesh=None):
    """Render a flat pixel batch sharded across devices.

    ``px``/``py`` length must divide by the mesh size (pad upstream).
    Returns the gathered (R,3) radiance.
    """
    if mesh is None:
        mesh = make_device_mesh()
    shard = tile_sharding(mesh)
    repl = replicated(mesh)
    px = jax.device_put(jnp.asarray(px), shard)
    py = jax.device_put(jnp.asarray(py), shard)
    pack = jax.device_put(pack, repl)
    cam = jax.device_put(cam, repl)
    key = jax.device_put(key, repl)
    out = _traced(pack, cam, px, py, key, opts)
    return np.asarray(out)


@partial(jax.jit, static_argnames=("opts", "param_inject"))
def _loss_and_grads(params, pack, cam, px, py, key, target, opts,
                    param_inject):
    def loss_fn(params):
        img = trace_radiance(param_inject(pack, params), cam, px, py, key,
                             opts)
        return jnp.mean((img - target) ** 2)

    return jax.value_and_grad(loss_fn)(params)


def loss_and_grads(pack, cam, px, py, key, opts: RenderOptions, target,
                   param_extract, param_inject, mesh=None):
    """Sharded differentiable render step: pixel-MSE loss against ``target``
    and gradients w.r.t. the extracted parameter pytree.

    Parameters are replicated, pixels sharded; XLA all-reduces the parameter
    gradients automatically (the gradient of a replicated array fed by
    sharded compute is a psum).  The step is compiled once per
    (opts, param_inject) and shape, so repeated calls reuse it.
    """
    if mesh is None:
        mesh = make_device_mesh()
    shard = tile_sharding(mesh)
    repl = replicated(mesh)

    params = param_extract(pack)
    px = jax.device_put(jnp.asarray(px), shard)
    py = jax.device_put(jnp.asarray(py), shard)
    target = jax.device_put(jnp.asarray(target), shard)
    pack = jax.device_put(pack, repl)
    cam = jax.device_put(cam, repl)
    params = jax.device_put(params, repl)
    key = jax.device_put(key, repl)
    return _loss_and_grads(params, pack, cam, px, py, key, target, opts,
                           param_inject)
