"""Benchmark harness: times the renderer on the GPU and prints ONE JSON line.

Default mode: the in-repo Whitted Cornell box (scenes/cornell_whitted.xml,
800x800, depth 6) at 16 samples per pixel — stratified 4x4 jitter and the
Gaussian filter accumulated on device (src/main.cpp:44-105 semantics) —
with the clamped u8 image in host memory at the end of every frame, as the
reference's timed loop fills a host buffer (src/main.cpp:108-125).
"paths" = width x height x spp primary samples, each carrying its full
recursive tree.

``--bwd``: a 1920x1080 forward+backward frame of the differentiable path —
value_and_grad of a pixel loss w.r.t. material colours, light intensities
and vertex positions, in gradient tiles.  ``--bwd-scene`` picks the scene:
whitted (default), spotareaml, pt, ptrr, ptspec (scenes/*.xml).

Every result is the median of REPEATS timed frames with its quartiles;
compilation (the first frame) is reported separately as set-up time.  The
line names the device (platform, device_kind, count) and the card's name
and power limit.  Without a GPU the harness exits non-zero: a CPU timing is
not a device measurement.

    python bench.py
    python bench.py --bwd --bwd-scene pt
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SCENES = {
    "whitted": "scenes/cornell_whitted.xml",
    "spotareaml": "scenes/feat_spotareaml.xml",
    "pt": "scenes/feat_pt.xml",
    "ptrr": "scenes/feat_pt_rr.xml",
    "ptspec": "scenes/feat_pt_spec.xml",
}
REPEATS = 5


def gpu_name_and_power() -> str | None:
    """The cards as nvidia-smi reports them ("name, power limit" per line),
    or None without nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip()


def device_info() -> dict:
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def timed(fn, repeats: int = REPEATS) -> dict:
    """First call = compile + warm-up (set-up time); then ``repeats`` timed
    calls.  ``fn`` must block until its result is ready."""
    t0 = time.perf_counter()
    fn(0)
    setup = time.perf_counter() - t0
    times = []
    for i in range(repeats):
        t0 = time.perf_counter()
        fn(1 + i)
        times.append(time.perf_counter() - t0)
    q1, med, q3 = np.percentile(times, [25, 50, 75])
    return {"setup_s": setup, "median_s": float(med), "q1_s": float(q1),
            "q3_s": float(q3), "times_s": times}


def main_fwd() -> dict:
    from advanced_cpu_raytracing_tpu.render.renderer import render_camera
    from advanced_cpu_raytracing_tpu.scene.pack import pack_scene
    from advanced_cpu_raytracing_tpu.scene.xml_parser import load_scene

    cfg = load_scene(os.path.join(HERE, SCENES["whitted"]))
    pack = pack_scene(cfg)
    cam_cfg = cfg.cameras[0]
    spp = 16
    paths = cam_cfg.width * cam_cfg.height * spp

    def frame(seed):
        img = render_camera(pack, cfg, cam_cfg, seed=seed, spp=spp, ldr=True)
        assert img.shape == (cam_cfg.height, cam_cfg.width, 3)

    t = timed(frame)
    return {"metric": "cornell_whitted_800x800_16spp_paths_per_s",
            "unit": "Mpaths/s", "value": paths / t["median_s"] / 1e6,
            "q1": paths / t["q3_s"] / 1e6, "q3": paths / t["q1_s"] / 1e6,
            **t}


def make_bwd_step(name: str):
    """The 1080p fwd+bwd frame of scene ``name``: returns
    (step, pack, cam, params, px_all, py_all, n_tiles), where
    ``step(params, pack, cam, px, py, key) -> (loss, grads)`` is one jitted
    gradient tile.  The scene enters as arguments, not closure constants, so
    the same step also runs on another device's copies."""
    import jax
    import jax.numpy as jnp

    from advanced_cpu_raytracing_tpu.diff.params import (
        extract_params,
        inject_params,
    )
    from advanced_cpu_raytracing_tpu.render.camera import build_camera
    from advanced_cpu_raytracing_tpu.render.integrator import (
        RR_DEPTH_FLOOR,
        RenderOptions,
        trace_radiance,
    )
    from advanced_cpu_raytracing_tpu.render.renderer import options_for_camera
    from advanced_cpu_raytracing_tpu.scene.pack import pack_scene
    from advanced_cpu_raytracing_tpu.scene.xml_parser import load_scene

    cfg = load_scene(os.path.join(HERE, SCENES[name]))
    pack = pack_scene(cfg)
    cam_cfg = cfg.cameras[0]
    cam = build_camera(cam_cfg)
    cam_opts = options_for_camera(cfg, cam_cfg)
    rr = cam_opts.path_tracing and cam_opts.russian_roulette
    pt_spec = cam_opts.path_tracing and (
        pack.static.has_mirror or pack.static.has_conductor
        or pack.static.has_dielectric)
    # fixed-trip differentiable wavefront (reverse-mode AD cannot cross
    # lax.while_loop); depth+2 iterations cover the specular/GI chains (+ the
    # RR floor when roulette extends them)
    opts = RenderOptions(max_depth=cfg.max_recursion_depth,
                         differentiable=True,
                         max_iters=cfg.max_recursion_depth + 2
                         + (RR_DEPTH_FLOOR if rr else 0),
                         stochastic_dielectric=pack.static.has_dielectric,
                         stochastic_spec_gi=pt_spec,
                         path_tracing=cam_opts.path_tracing,
                         next_event_estimation=cam_opts.next_event_estimation,
                         importance_sampling=cam_opts.importance_sampling,
                         russian_roulette=cam_opts.russian_roulette)

    w, h = 1920, 1080
    n = w * h
    ys, xs = np.divmod(np.arange(n, dtype=np.int64), w)
    # map the 1080p sample grid onto the scene camera's pixel plane
    px_all = jnp.asarray(xs * (cam_cfg.width / w), jnp.float32)
    py_all = jnp.asarray(ys * (cam_cfg.height / h), jnp.float32)
    params = extract_params(pack, ("mat_diffuse", "pl_intensity", "verts"))

    def loss_fn(params, pack, cam, px, py, key):
        img = trace_radiance(inject_params(pack, params), cam, px, py, key,
                             opts)
        return jnp.sum(img ** 2) / float(n)

    # reverse-mode AD keeps every loop iteration's intermediates, so the
    # frame is rendered as gradient tiles whose grads sum (the loss is a sum
    # of per-tile sums)
    n_tiles = 8
    step = jax.jit(jax.value_and_grad(loss_fn))
    return step, pack, cam, params, px_all, py_all, n_tiles


def bwd_frame(step, pack, cam, params, px_all, py_all, n_tiles, seed):
    """One full fwd+bwd frame: the tiles' losses and gradients summed,
    blocked until ready."""
    import jax
    import jax.numpy as jnp

    tile = px_all.shape[0] // n_tiles
    total, grads = 0.0, None
    for t in range(n_tiles):
        sl = slice(t * tile, (t + 1) * tile)
        loss, g = step(params, pack, cam, px_all[sl], py_all[sl],
                       jax.random.PRNGKey(seed * n_tiles + t))
        total += loss
        grads = g if grads is None else jax.tree_util.tree_map(
            jnp.add, grads, g)
    jax.block_until_ready((total, grads))
    return total, grads


def main_bwd(name: str) -> dict:
    step, pack, cam, params, px_all, py_all, n_tiles = make_bwd_step(name)

    def frame(seed):
        total, _ = bwd_frame(step, pack, cam, params, px_all, py_all,
                             n_tiles, seed)
        assert np.isfinite(float(total))

    t = timed(frame, repeats=3)
    rays = px_all.shape[0]
    return {"metric": f"{name}_1080p_fwd_bwd_rays_per_s", "unit": "Mrays/s",
            "value": rays / t["median_s"] / 1e6,
            "q1": rays / t["q3_s"] / 1e6, "q3": rays / t["q1_s"] / 1e6, **t}


def main() -> int:
    sys.path.insert(0, HERE)
    from advanced_cpu_raytracing_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    dev = device_info()
    if dev["platform"] != "gpu":
        print(f"bench.py: no GPU (JAX platform {dev['platform']!r}); "
              "refusing to report a CPU timing", file=sys.stderr)
        return 1
    card = gpu_name_and_power() or "nvidia-smi unavailable"
    print(card)
    if "--bwd" in sys.argv:
        name = "whitted"
        if "--bwd-scene" in sys.argv:
            name = sys.argv[sys.argv.index("--bwd-scene") + 1]
        rec = main_bwd(name)
    else:
        rec = main_fwd()
    rec.update(device=dev, card=card)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
