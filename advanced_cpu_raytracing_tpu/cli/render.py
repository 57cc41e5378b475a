"""CLI entry point: ``python -m advanced_cpu_raytracing_tpu.cli.render scene.xml``.

Matches the reference driver (src/main.cpp:132-202): renders every camera in
the scene; tonemapped cameras emit both ``<name>.hdr`` (raw radiance) and
``<name w/o ext>.png``; others emit the clamped LDR png; prints total
wall-clock at the end.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="JAX ray tracer")
    parser.add_argument("scene", help="XML scene file")
    parser.add_argument("--out-dir", default=".", help="output directory")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--spp", type=int, default=None,
                        help="override per-camera NumSamples")
    parser.add_argument("--tile", type=int, default=None, help="tile size")
    parser.add_argument("--shard", action="store_true",
                        help="shard pixels across all visible devices "
                             "(jax.sharding mesh; scene replicated)")
    args = parser.parse_args(argv)

    from advanced_cpu_raytracing_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    from advanced_cpu_raytracing_tpu.post.tonemap import reinhard_tonemap
    from advanced_cpu_raytracing_tpu.post.writers import write_hdr, write_png
    from advanced_cpu_raytracing_tpu.render.renderer import (
        ldr_from_radiance,
        render_camera,
    )
    from advanced_cpu_raytracing_tpu.scene.pack import pack_scene
    from advanced_cpu_raytracing_tpu.scene.xml_parser import load_scene

    if not os.path.exists(args.scene):
        print(f"error: scene file not found: {args.scene}", file=sys.stderr)
        return 1
    os.makedirs(args.out_dir, exist_ok=True)
    cfg = load_scene(args.scene)
    start = time.perf_counter()
    pack = pack_scene(cfg)

    for cam_cfg in cfg.cameras:
        print(f"Resolution: {cam_cfg.width}x{cam_cfg.height}, "
              f"samples: {cam_cfg.num_samples}")
        if cam_cfg.renderer_params.path_tracing:
            print(f"Path tracing is enabled for: {cam_cfg.image_name}")
        if args.shard:
            from advanced_cpu_raytracing_tpu.parallel.shard_render import (
                render_camera_sharded,
            )

            img = render_camera_sharded(pack, cfg, cam_cfg, seed=args.seed,
                                        spp=args.spp)
        else:
            kwargs = {}
            if args.tile:
                kwargs["tile_size"] = args.tile
            img = render_camera(pack, cfg, cam_cfg, seed=args.seed,
                                spp=args.spp, **kwargs)
        base = os.path.join(args.out_dir, cam_cfg.image_name)
        stem = base[: base.rfind(".")] if "." in os.path.basename(base) else base
        if cam_cfg.tonemap is not None:
            tm = cam_cfg.tonemap
            ldr = reinhard_tonemap(img, key_value=tm.key_value,
                                   burn_percent=tm.burn_percent,
                                   saturation=tm.saturation, gamma=tm.gamma)
            write_hdr(base if base.endswith(".hdr") else stem + ".hdr",
                      np.nan_to_num(img))
            write_png(stem + ".png", ldr)
        else:
            write_png(stem + ".png", ldr_from_radiance(img))
        print(f"wrote {stem}.png")

    elapsed = time.perf_counter() - start
    print(f"Rendering took: {elapsed}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
