"""Image rendering driver: pixel tiling, stratified multisampling, Gaussian
reconstruction, per-camera orchestration.

Replaces the reference's thread scheduler (renderThreadMain,
src/main.cpp:26-130): instead of 8 pthreads owning row blocks, pixels are
flattened and processed in fixed-size device tiles; samples accumulate with
the 2D Gaussian filter (sigma = pixelWidth/6, src/gaussian.h:3-21;
weights on the jitter offsets, main.cpp:79-100).

Sampling note: the reference computes n = floor(sqrt(spp)) stratified cells
but then traces ``spp`` samples, reading uninitialized jitter for the excess
when spp is not a perfect square (main.cpp:44-76).  We trace exactly n^2
samples (identical for perfect squares, well-defined otherwise).
"""

from __future__ import annotations

import math
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from advanced_cpu_raytracing_tpu.render.camera import build_camera
from advanced_cpu_raytracing_tpu.render.integrator import (
    RenderOptions,
    trace_radiance,
)
from advanced_cpu_raytracing_tpu.scene.pack import ScenePack, pack_scene
from advanced_cpu_raytracing_tpu.scene.types import CameraCfg, SceneConfig

DEFAULT_TILE = 1 << 21  # upper bound; render_camera clamps by stack memory


def _auto_tile(total: int, opts: RenderOptions, pack: ScenePack,
               requested: int | None) -> int:
    """Pick the lane-tile size: as large as possible (host->device dispatch
    latency dominates small tiles) while keeping the per-lane ray stack
    within a fixed HBM budget."""
    if requested:
        return requested
    branches = 1 + (1 if opts.path_tracing else 0) + \
        (1 if pack.static.has_dielectric
         and not opts.stochastic_dielectric else 0)
    from advanced_cpu_raytracing_tpu.render.integrator import RR_DEPTH_FLOOR

    depth_total = opts.max_depth + (RR_DEPTH_FLOOR if opts.russian_roulette
                                    else 0)
    k = max(branches - 1, 1) * max(depth_total, 1) + 4
    bytes_per_lane = k * 64 + 256  # stack entries + working set
    budget = 4 << 30
    tile = min(DEFAULT_TILE, max(budget // bytes_per_lane, 1 << 14))
    return min(tile, max(total, 1))


def _gaussian_multisample(trace_fn, px, py, key, n_cells: int):
    """n_cells^2 stratified samples per pixel, Gaussian weighted (sigma = 1/6,
    src/gaussian.h; weights on the jitter offsets, main.cpp:79-100).

    The sample loop is a lax.scan so the integrator is traced exactly once
    regardless of spp (an unrolled loop would inline one integrator copy per
    sample and explode compile time).
    """
    if n_cells <= 1:
        return trace_fn(px, py, key)

    r = px.shape[0]
    sigma = 1.0 / 6.0
    inv_2s2 = 1.0 / (2.0 * sigma * sigma)
    c1 = 1.0 / (2.0 * jnp.pi * sigma * sigma)

    def sample(carry, s):
        acc, wacc = carry
        k_jit, k_trace = jax.random.split(jax.random.fold_in(key, s))
        row = s // n_cells
        col = s % n_cells
        psi = jax.random.uniform(k_jit, (r, 2))
        sx = (col + psi[:, 0]) / n_cells
        sy = (row + psi[:, 1]) / n_cells
        colr = trace_fn(px + sx, py + sy, k_trace)
        dx = sx - 0.5
        dy = sy - 0.5
        wgt = c1 * jnp.exp(-(dx * dx + dy * dy) * inv_2s2)
        return (acc + colr * wgt[:, None], wacc + wgt), None

    (acc, wacc), _ = jax.lax.scan(
        sample, (jnp.zeros((r, 3)), jnp.zeros(r)),
        jnp.arange(n_cells * n_cells),
    )
    return acc / wacc[:, None]


@partial(jax.jit, static_argnames=("opts", "n_cells"))
def _render_tile(pack: ScenePack, cam, px, py, key, opts: RenderOptions,
                 n_cells: int):
    """One device tile via the jnp wavefront integrator.  px/py are integer
    pixel coords as float arrays (R,)."""
    return _gaussian_multisample(
        lambda px2, py2, k: trace_radiance(pack, cam, px2, py2, k, opts),
        px, py, key, n_cells)


def options_for_camera(cfg: SceneConfig, cam_cfg: CameraCfg) -> RenderOptions:
    rp = cam_cfg.renderer_params
    return RenderOptions(
        path_tracing=rp.path_tracing,
        importance_sampling=rp.importance_sampling,
        next_event_estimation=rp.next_event_estimation,
        russian_roulette=rp.russian_roulette,
        max_depth=cfg.max_recursion_depth,
        # PT renders are Monte-Carlo anyway: sample one dielectric child per
        # hit (flat ray population) instead of splitting exponentially;
        # Whitted renders keep the reference's deterministic split
        stochastic_dielectric=rp.path_tracing,
    )


def render_camera(pack: ScenePack, cfg: SceneConfig, cam_cfg: CameraCfg,
                  seed: int = 0, tile_size: int | None = None,
                  spp: int | None = None, ldr: bool = False) -> np.ndarray:
    """Render one camera to an (H, W, 3) image.

    ``ldr=False`` (default) returns float32 radiance; ``ldr=True`` returns
    the clamped u8 image ((int)c clamp, src/helperMath.cpp:140-152).
    """
    cam = build_camera(cam_cfg)
    opts = options_for_camera(cfg, cam_cfg)
    w, h = cam_cfg.width, cam_cfg.height
    spp = cam_cfg.num_samples if spp is None else spp
    n_cells = max(int(math.isqrt(max(spp, 1))), 1)
    key = jax.random.PRNGKey(seed)

    tile_size = _auto_tile(w * h, opts, pack, tile_size)
    total = w * h
    ys, xs = np.divmod(np.arange(total, dtype=np.int64), w)
    px_all = xs.astype(np.float32)
    py_all = ys.astype(np.float32)

    out = np.zeros((total, 3), np.float32)
    n_tiles = (total + tile_size - 1) // tile_size
    for ti in range(n_tiles):
        lo = ti * tile_size
        hi = min(lo + tile_size, total)
        pad = tile_size - (hi - lo)
        px = np.pad(px_all[lo:hi], (0, pad))
        py = np.pad(py_all[lo:hi], (0, pad))
        k_tile = jax.random.fold_in(key, ti)
        col = _render_tile(pack, cam, jnp.asarray(px), jnp.asarray(py),
                           k_tile, opts, n_cells)
        out[lo:hi] = np.asarray(col)[: hi - lo]
    img = out.reshape(h, w, 3)
    return ldr_from_radiance(img) if ldr else img


def ldr_from_radiance(img: np.ndarray) -> np.ndarray:
    """Clamp path for non-tonemapped cameras: (int)c clamped to [0,255]
    (clamp(), src/helperMath.cpp:140-152; applied at main.cpp:121)."""
    return np.clip(np.nan_to_num(img).astype(np.int32), 0, 255).astype(np.uint8)


def render_scene(path_or_cfg, seed: int = 0, spp: int | None = None):
    """Render every camera of a scene; returns list of
    (camera_cfg, radiance_image) tuples."""
    if isinstance(path_or_cfg, SceneConfig):
        cfg = path_or_cfg
    else:
        from advanced_cpu_raytracing_tpu.scene.xml_parser import load_scene

        cfg = load_scene(path_or_cfg)
    pack = pack_scene(cfg)
    results = []
    for cam_cfg in cfg.cameras:
        img = render_camera(pack, cfg, cam_cfg, seed=seed, spp=spp)
        results.append((cam_cfg, img))
    return results
