#!/usr/bin/env python3
"""Smoke test of the renderer on one NVIDIA GPU, through the entry points a
user calls, at the sizes users render.

    python chip_smoke.py            # one GPU: card tests + phases 1-6
    python chip_smoke.py --multi    # four GPUs: the sharded paths only

Order: ``nvidia-smi`` names the card; the card tier (tests/test_gpu.py) runs
in a child pytest before this process imports JAX, so one process holds the
card at a time; then each phase runs here and prints its compile time (first
call), steady time (second call, ended by block_until_ready or a host copy),
the process's peak device memory so far, and its check against the plain
reference:

  1. path-traced frame through the CLI (scenes/feat_pt.xml: 800x800, 16 spp,
     NEE + importance sampling, depth 4);
  2. Whitted frame (scenes/cornell_whitted.xml: 800x800, depth 6) through
     render_camera, and a 4096-pixel tile on the GPU vs the host CPU;
  3. 524,288-face textured terrain at 640x480 through the BVH path, same
     CPU comparison;
  4. the dense brute-force hit test at its cap: 640k rays x 32 and x 2048
     triangles on the GPU vs the CPU, and a 2048-face Whitted frame with
     the same CPU comparison as phase 2;
  5. 1920x1080 fwd+bwd of scenes/feat_spotareaml.xml in gradient tiles, and
     the gradients of a 4096-pixel subset on the GPU vs the CPU;
  6. 5 Adam steps of diff.optimize.optimize at 256x256.

``--multi`` runs only the sharded paths over four GPUs against one:
render_camera_sharded, loss_and_grads and reinhard_tonemap_sharded.

The last line of standard output is one JSON object,
``{"ok": ..., "device": {"platform", "kind", "count"}}``.  Without a GPU, or
outside a checkout of this repository, the script prints no result and
exits non-zero.  Any failing phase makes the exit code non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
WHITTED = REPO / "scenes" / "cornell_whitted.xml"
SUBSET = 4096


# ---------------------------------------------------------------------------
# comparisons shared with tests/test_gpu.py
# ---------------------------------------------------------------------------

def random_hit_case(n_rays: int, n_tris: int, seed: int = 0):
    """Random rays and triangles in one box, most rays hitting something."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    o = rng.uniform(-2, 2, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    v0 = rng.uniform(-4, 4, (n_tris, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-2, 2, (n_tris, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-2, 2, (n_tris, 3)).astype(np.float32)
    return tuple(jnp.asarray(x) for x in (o, d, v0, v1, v2))


def check_hits(got, ref) -> str:
    """Hit records (t, idx, beta, gamma) from two devices: the same rays
    hit; the winning index agrees except on an fp tie (the two t within
    1e-6 t); where the same triangle won, t, beta and gamma agree to 1e-5
    relative or 1e-5 absolute on all but 1e-4 of the rays, and to 1e-3 on
    every ray.  Another FMA contraction order changes the last bits, and an
    ill-conditioned hit (a grazing ray, a sliver triangle) amplifies them:
    between an H100 and the CPU, 1 ray in 65,536 differed by 1.4e-5."""
    tk, ik, bk, gk = (np.asarray(x) for x in got)
    tj, ij, bj, gj = (np.asarray(x) for x in ref)
    if not np.array_equal(ik >= 0, ij >= 0):
        raise AssertionError(
            f"hit masks differ on {(np.not_equal(ik >= 0, ij >= 0)).sum()} "
            "rays")
    hit = ij >= 0
    same = hit & (ik == ij)
    diff_idx = hit & ~same
    # a different winner is accepted only on a tie in t
    tie = np.zeros_like(hit)
    tie[hit] = np.abs(tk[hit] - tj[hit]) <= 1e-6 * np.abs(tj[hit])
    if not np.all(tie[diff_idx]):
        raise AssertionError(
            f"{int((diff_idx & ~tie).sum())} rays chose another triangle "
            "without a tie in t")
    for name, a, b in (("t", tk, tj), ("beta", bk, bj), ("gamma", gk, gj)):
        a, b = a[same], b[same]
        off = ~np.isclose(a, b, rtol=1e-5, atol=1e-5)
        if off.mean() > 1e-4:
            raise AssertionError(f"{name}: {int(off.sum())} of {a.size} rays "
                                 "differ by more than 1e-5")
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3, err_msg=name)
    rel = np.abs(tk[same] - tj[same]) / tj[same]
    return (f"{int(hit.sum())} hits, {int(diff_idx.sum())} tie flips, "
            f"max |dt|/t {float(rel.max(initial=0.0)):.2e}")


def compare_u8(a, b) -> str:
    """u8 images: mean |diff| <= 0.5 LSB and at most 0.5% of pixels off by
    more than 2 — room for silhouette branch flips under another fp
    order."""
    d = np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))
    mean, frac = float(d.mean()), float((d.max(axis=-1) > 2).mean())
    if mean > 0.5 or frac > 0.005:
        raise AssertionError(f"u8 mean |d| {mean:.4f}, frac>2 {frac:.4%}")
    return f"u8 mean |d| {mean:.4f} LSB, frac>2 {frac:.4%}"


def _subset(w: int, h: int, n: int | None = None, seed: int = 0):
    rng = np.random.default_rng(seed)
    idx = rng.choice(w * h, size=n or SUBSET, replace=False)
    ys, xs = np.divmod(idx, w)
    return xs.astype(np.float32), ys.astype(np.float32)


def _tile_on(device, pack, cfg, cam_cfg, px, py, seed=0):
    """The renderer's jitted tile function on ``device``: identical inputs
    and key on every device, so the images differ only by fp order."""
    import jax

    from advanced_cpu_raytracing_tpu.render.camera import build_camera
    from advanced_cpu_raytracing_tpu.render.renderer import (
        _render_tile,
        ldr_from_radiance,
        options_for_camera,
    )

    put = lambda x: jax.device_put(x, device)  # noqa: E731
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 0)
    col = _render_tile(put(pack), put(build_camera(cam_cfg)), put(px),
                       put(py), put(key), options_for_camera(cfg, cam_cfg),
                       1)
    return ldr_from_radiance(np.asarray(col))


def render_tile_on(device, scene: str, n: int):
    """A random n-pixel tile of an XML scene (relative to the repo) on one
    device, as clamped u8."""
    from advanced_cpu_raytracing_tpu.scene.pack import pack_scene
    from advanced_cpu_raytracing_tpu.scene.xml_parser import load_scene

    cfg = load_scene(str(REPO / scene))
    cam_cfg = cfg.cameras[0]
    px, py = _subset(cam_cfg.width, cam_cfg.height, n)
    return _tile_on(device, pack_scene(cfg), cfg, cam_cfg, px, py)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def _peak() -> int:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", -1))


def _twice(fn):
    """(first-call seconds, second-call seconds, second result)."""
    t0 = time.perf_counter()
    fn()
    t1 = time.perf_counter()
    out = fn()
    t2 = time.perf_counter()
    return t1 - t0, t2 - t1, out


def _report(name, compile_s, steady_s, check):
    print(f"[{name}] compile {compile_s:.3f} s, steady {steady_s:.3f} s, "
          f"peak_bytes_in_use {_peak()}, {check}", flush=True)


def phase_cli_pt():
    from advanced_cpu_raytracing_tpu.cli.render import main as cli_main
    from advanced_cpu_raytracing_tpu.render.renderer import render_camera
    from advanced_cpu_raytracing_tpu.scene.images import load_image
    from advanced_cpu_raytracing_tpu.scene.pack import pack_scene
    from advanced_cpu_raytracing_tpu.scene.xml_parser import load_scene

    scene = REPO / "scenes" / "feat_pt.xml"
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        rc = cli_main([str(scene), "--out-dir", out])
        t_cli = time.perf_counter() - t0
        assert rc == 0, rc
        png, _ = load_image(os.path.join(out, "pt.png"))
    cfg = load_scene(str(scene))
    cam_cfg = cfg.cameras[0]
    assert (cam_cfg.width, cam_cfg.height, cam_cfg.num_samples) == (
        800, 800, 16)
    pack = pack_scene(cfg)
    t0 = time.perf_counter()
    img = render_camera(pack, cfg, cam_cfg, seed=1)
    t_steady = time.perf_counter() - t0
    assert png.shape == (800, 800, 3) and png.mean() > 1.0, png.mean()
    assert np.all(np.isfinite(img)), "non-finite radiance"
    _report("1 cli pt 800x800 16spp", t_cli, t_steady,
            f"png written, mean {png.mean():.2f}, radiance finite, "
            f"{800 * 800 * 16 / t_steady / 1e6:.3f} Mpaths/s steady")


def _frame_and_cpu_subset(name, cfg, pack, seed=0):
    import jax

    from advanced_cpu_raytracing_tpu.render.renderer import render_camera

    cam_cfg = cfg.cameras[0]
    c, s, img = _twice(lambda: render_camera(pack, cfg, cam_cfg, seed=seed,
                                             ldr=True))
    assert img.shape == (cam_cfg.height, cam_cfg.width, 3)
    px, py = _subset(cam_cfg.width, cam_cfg.height)
    gpu = _tile_on(jax.devices()[0], pack, cfg, cam_cfg, px, py, seed)
    cpu = _tile_on(jax.devices("cpu")[0], pack, cfg, cam_cfg, px, py, seed)
    paths = cam_cfg.width * cam_cfg.height
    _report(name, c, s, f"{paths / s / 1e6:.3f} Mpaths/s steady; "
            f"GPU vs CPU {SUBSET} px: {compare_u8(gpu, cpu)}")


def phase_whitted():
    from advanced_cpu_raytracing_tpu.scene.pack import pack_scene
    from advanced_cpu_raytracing_tpu.scene.xml_parser import load_scene

    cfg = load_scene(str(WHITTED))
    _frame_and_cpu_subset("2 whitted 800x800 depth 6", cfg, pack_scene(cfg))


def phase_terrain():
    from advanced_cpu_raytracing_tpu.scene.pack import pack_scene
    from advanced_cpu_raytracing_tpu.scene.synth import terrain_scene

    cfg = terrain_scene(n=513, textured=True)
    pack = pack_scene(cfg)
    assert pack.static.n_faces == 524288 and pack.static.use_bvh
    _frame_and_cpu_subset("3 terrain 524288 faces 640x480 bvh", cfg, pack)


def _median_s(fn, reps: int = 10) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def phase_brute_cap():
    """The dense brute-force hit test at its cap: alone at 640k rays (GPU
    vs CPU on the first 65536), then a 2048-face Whitted frame end to end
    with the CPU subset comparison."""
    import jax

    from advanced_cpu_raytracing_tpu.ops.traverse import _brute_hits
    from advanced_cpu_raytracing_tpu.scene.pack import pack_scene
    from advanced_cpu_raytracing_tpu.scene.synth import terrain_scene

    n_rays, n_cpu = 640_000, 65_536
    cpu = jax.devices("cpu")[0]
    hits = jax.jit(_brute_hits)
    for n_tri in (32, 2048):
        case = random_hit_case(n_rays, n_tri, seed=n_tri)
        c, _, got = _twice(lambda: jax.block_until_ready(hits(*case)))
        s = _median_s(lambda: jax.block_until_ready(hits(*case)))
        ref = hits(*(jax.device_put(x[:n_cpu] if i < 2 else x, cpu)
                     for i, x in enumerate(case)))
        _report(f"4 brute hit test R={n_rays} W={n_tri}", c, s,
                f"median of 10 {s * 1e3:.3f} ms; GPU vs CPU on {n_cpu} "
                "rays: " + check_hits([x[:n_cpu] for x in got], ref))

    cfg = terrain_scene(n=33, width=800, height=800)
    pack = pack_scene(cfg)
    assert pack.static.n_faces == 2048 and not pack.static.use_bvh
    _frame_and_cpu_subset("4 whitted frame W=2048 800x800 brute", cfg, pack)


def phase_fwd_bwd():
    import jax

    import bench

    step, pack, cam, params, px_all, py_all, n_tiles = bench.make_bwd_step(
        "spotareaml")
    c, s, (loss, grads) = _twice(lambda: bench.bwd_frame(
        step, pack, cam, params, px_all, py_all, n_tiles, 0))
    assert np.isfinite(float(loss))
    assert all(np.all(np.isfinite(np.asarray(g)))
               for g in jax.tree_util.tree_leaves(grads))
    # one 4096-pixel subset through the same jitted step on each device
    idx = np.random.default_rng(0).choice(px_all.shape[0], SUBSET,
                                          replace=False)
    px_s, py_s = np.asarray(px_all)[idx], np.asarray(py_all)[idx]
    key = jax.random.PRNGKey(3)
    errs = []
    outs = []
    for dev in (jax.devices()[0], jax.devices("cpu")[0]):
        put = lambda x: jax.device_put(x, dev)  # noqa: E731
        outs.append(step(put(params), put(pack), put(cam), put(px_s),
                         put(py_s), put(key))[1])
    for k in params:
        a, b = np.asarray(outs[0][k]), np.asarray(outs[1][k])
        if a.size == 0:
            continue
        err = float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
        errs.append(f"{k} {err:.2e}")
        if err > 1e-3:
            raise AssertionError(f"grad {k}: relative L2 error {err:.3e}")
    rays = px_all.shape[0]
    _report("5 fwd+bwd 1920x1080 spotareaml", c, s,
            f"{rays / s / 1e6:.3f} Mrays/s steady; GPU vs CPU grads over "
            f"{SUBSET} px, rel L2: " + ", ".join(errs))


def phase_inverse():
    import dataclasses

    import jax
    import jax.numpy as jnp

    from advanced_cpu_raytracing_tpu.diff.optimize import optimize
    from advanced_cpu_raytracing_tpu.render.camera import build_camera
    from advanced_cpu_raytracing_tpu.render.integrator import (
        RenderOptions,
        trace_radiance,
    )
    from advanced_cpu_raytracing_tpu.scene.pack import pack_scene
    from advanced_cpu_raytracing_tpu.scene.xml_parser import load_scene

    cfg = load_scene(str(WHITTED))
    pack = pack_scene(cfg)
    cam_cfg = cfg.cameras[0]
    cam = build_camera(cam_cfg)
    depth = cfg.max_recursion_depth
    opts = RenderOptions(max_depth=depth, differentiable=True,
                         max_iters=depth + 2, stochastic_dielectric=True)
    res = 256
    ys, xs = np.divmod(np.arange(res * res), res)
    px = jnp.asarray((xs + 0.5) * cam_cfg.width / res, jnp.float32)
    py = jnp.asarray((ys + 0.5) * cam_cfg.height / res, jnp.float32)
    target = trace_radiance(pack, cam, px, py, jax.random.PRNGKey(0), opts)
    wrong = dataclasses.replace(pack, mat_diffuse=pack.mat_diffuse * 0.5)
    # optimize() jits its step afresh on every call: the first call pays the
    # compile, the second finds it in the persistent compilation cache
    c, s, (_, hist) = _twice(lambda: optimize(
        wrong, cam, px, py, opts, target, ("mat_diffuse",), steps=5,
        lr=0.05))
    assert all(np.isfinite(hist)), hist
    assert hist[-1] < hist[0], hist
    _report("6 inverse 256x256 5 Adam steps", c, s,
            "loss " + " -> ".join(f"{v:.4g}" for v in hist)
            + f"; {5 / s:.3f} steps/s steady")


PHASES = {"1": phase_cli_pt, "2": phase_whitted, "3": phase_terrain,
          "4": phase_brute_cap, "5": phase_fwd_bwd, "6": phase_inverse}


def phase_multi():
    """Four GPUs against one: the sharded Whitted frame at 1 spp, one
    sharded gradient tile, the sharded tonemap."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    import bench
    from advanced_cpu_raytracing_tpu.diff.params import (
        extract_params,
        inject_params,
    )
    from advanced_cpu_raytracing_tpu.parallel.mesh import make_device_mesh
    from advanced_cpu_raytracing_tpu.parallel.shard_render import (
        loss_and_grads,
        render_camera_sharded,
    )
    from advanced_cpu_raytracing_tpu.post.tonemap import (
        reinhard_tonemap,
        reinhard_tonemap_sharded,
    )
    from advanced_cpu_raytracing_tpu.render.integrator import (
        RenderOptions,
        trace_radiance,
    )
    from advanced_cpu_raytracing_tpu.render.renderer import (
        ldr_from_radiance,
        render_camera,
    )
    from advanced_cpu_raytracing_tpu.scene.pack import pack_scene
    from advanced_cpu_raytracing_tpu.scene.xml_parser import load_scene

    n_dev = len(jax.devices())
    assert n_dev == 4, f"--multi needs 4 GPUs, found {n_dev}"
    mesh = make_device_mesh(4)

    cfg = load_scene(str(WHITTED))
    pack = pack_scene(cfg)
    cam_cfg = dataclasses.replace(cfg.cameras[0], num_samples=1)
    c, s, img_sh = _twice(lambda: render_camera_sharded(
        pack, cfg, cam_cfg, mesh=mesh, seed=0, spp=1))
    c1, s1, img_1 = _twice(lambda: render_camera(pack, cfg, cam_cfg, seed=0,
                                                 spp=1))
    _report("7a sharded whitted 800x800 1spp, 4 GPUs", c, s,
            f"1 GPU: compile {c1:.3f} s steady {s1:.3f} s; 4 vs 1: "
            + compare_u8(ldr_from_radiance(img_sh), ldr_from_radiance(img_1)))

    # one gradient tile of the 1080p spot/area/mesh-light frame: every
    # n_tiles-th pixel, so the tile spans the whole frame
    step, bpack, bcam, _, px_all, py_all, n_tiles = bench.make_bwd_step(
        "spotareaml")
    px = np.asarray(px_all[::n_tiles])
    py = np.asarray(py_all[::n_tiles])
    tile = px.shape[0]
    target = np.zeros((tile, 3), np.float32)
    key = jax.random.PRNGKey(5)
    fields = ("mat_diffuse", "pl_intensity", "verts")
    bcfg = load_scene(str(REPO / bench.SCENES["spotareaml"]))
    depth = bcfg.max_recursion_depth
    opts = RenderOptions(max_depth=depth, differentiable=True,
                         max_iters=depth + 2)
    extract = lambda p: extract_params(p, fields)  # noqa: E731
    c, s, (loss_sh, g_sh) = _twice(lambda: jax.block_until_ready(
        loss_and_grads(bpack, bcam, px, py, key, opts, target, extract,
                       inject_params, mesh=mesh)))

    def loss_single(p):
        img = trace_radiance(inject_params(bpack, p), bcam, jnp.asarray(px),
                             jnp.asarray(py), key, opts)
        return jnp.mean((img - jnp.asarray(target)) ** 2)

    single = jax.jit(jax.value_and_grad(loss_single))
    c1, s1, (loss_1, g_1) = _twice(lambda: jax.block_until_ready(
        single(extract(bpack))))
    np.testing.assert_allclose(float(loss_sh), float(loss_1), rtol=1e-5)
    errs = []
    for k in fields:
        a, b = np.asarray(g_sh[k]), np.asarray(g_1[k])
        if a.size == 0:
            continue
        err = float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
        errs.append(f"{k} {err:.2e} (|g| {np.linalg.norm(b):.3e})")
        if not np.linalg.norm(b) > 0:
            raise AssertionError(f"sharded grad {k}: zero gradient")
        if err > 1e-4:
            raise AssertionError(f"sharded grad {k}: rel L2 {err:.3e}")
    _report(f"7b loss_and_grads {tile} px, 4 GPUs", c, s,
            f"1 GPU: compile {c1:.3f} s steady {s1:.3f} s; loss "
            f"{float(loss_sh):.6g} vs {float(loss_1):.6g}; grads rel L2 "
            + ", ".join(errs))

    c, s, ldr_sh = _twice(lambda: reinhard_tonemap_sharded(img_1, mesh))
    ldr_1 = reinhard_tonemap(img_1)
    d = np.abs(ldr_sh.astype(int) - ldr_1.astype(int))
    if d.max() > 1 or d.mean() > 0.02:
        raise AssertionError(f"tonemap mean {d.mean():.4f} max {d.max()}")
    _report("7c sharded tonemap 800x800, 4 GPUs", c, s,
            f"4 vs 1: mean |d| {d.mean():.4f} LSB, max {d.max()}")


def run_gpu_tests() -> bool:
    """The card tier in a child pytest, before this process touches JAX."""
    cmd = [sys.executable, "-m", "pytest", "tests/test_gpu.py", "-m", "gpu",
           "-q", "-p", "no:cacheprovider", "-rs"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=900)
    tail = proc.stdout.strip().splitlines()[-1] if proc.stdout else ""
    print(f"[0 card tests] {time.perf_counter() - t0:.1f} s: {tail}",
          flush=True)
    ok = proc.returncode == 0 and "passed" in tail and "skipped" not in tail
    if not ok:
        print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n",
              file=sys.stderr)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="four GPUs: the sharded paths only")
    args = ap.parse_args(argv)

    if not (REPO / "advanced_cpu_raytracing_tpu").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from bench import gpu_name_and_power

    card = gpu_name_and_power()
    if card is None:
        print("chip_smoke.py: nvidia-smi finds no GPU", file=sys.stderr)
        return 2
    print(card, flush=True)
    print("JAX_COMPILATION_CACHE_DIR="
          + os.environ.get("JAX_COMPILATION_CACHE_DIR", "(unset)"), flush=True)
    # the CPU backend stays available beside CUDA for the reference renders
    os.environ["JAX_PLATFORMS"] = "cuda,cpu"

    failed = []
    if not args.multi and not run_gpu_tests():
        failed.append("0")

    import jax

    from advanced_cpu_raytracing_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    try:
        devs = jax.devices()
    except RuntimeError as e:
        print(f"chip_smoke.py: JAX finds no GPU ({e})", file=sys.stderr)
        return 2
    if devs[0].platform != "gpu":
        print(f"chip_smoke.py: JAX platform is {devs[0].platform!r}, not gpu",
              file=sys.stderr)
        return 2
    enable_compile_cache()

    phases = {"7": phase_multi} if args.multi else PHASES
    for key, fn in phases.items():
        try:
            fn()
        except Exception:  # a failed phase is reported; the rest still run
            traceback.print_exc()
            print(f"[{key}] FAILED", flush=True)
            failed.append(key)

    dev = devs[0]
    print(card, flush=True)
    print(json.dumps({"ok": not failed,
                      "device": {"platform": dev.platform,
                                 "kind": dev.device_kind,
                                 "count": len(devs)},
                      **({"failed": failed} if failed else {})}))
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
