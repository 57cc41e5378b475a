"""Worker for tests/test_multihost.py: one PROCESS of a 2-process
jax.distributed render.

Each process owns 4 virtual CPU devices; the global mesh spans all 8 across
both processes, so the pixel batch is sharded over a process boundary and the
loss reduction becomes a cross-process psum — the real multi-host wiring
(`jax.distributed.initialize` over TCP) rather than the single-process
virtual-mesh simulation used elsewhere.

Usage: python tests/multihost_worker.py <coordinator_port> <process_id> <out>
"""

import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=4"
).strip()

import jax

jax.config.update("jax_platforms", "cpu")


def main() -> int:
    port, pid, out_path = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=2,
        process_id=pid,
    )
    assert jax.process_count() == 2
    assert len(jax.devices()) == 8  # global
    assert len(jax.local_devices()) == 4

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from advanced_cpu_raytracing_tpu.render.camera import build_camera
    from advanced_cpu_raytracing_tpu.render.integrator import (
        RenderOptions,
        trace_radiance,
    )
    from advanced_cpu_raytracing_tpu.scene.pack import pack_scene
    from advanced_cpu_raytracing_tpu.scene.xml_parser import load_scene

    cfg = load_scene(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "data", "simple.xml"))
    pack = pack_scene(cfg)
    cam = build_camera(cfg.cameras[0])
    opts = RenderOptions(max_depth=cfg.max_recursion_depth)

    mesh = Mesh(np.asarray(jax.devices()), ("tiles",))
    shard = NamedSharding(mesh, P("tiles"))
    repl = NamedSharding(mesh, P())

    n = 1024  # 128 rays per device, identical on every process
    rng = np.random.default_rng(0)
    px_h = rng.uniform(0, 799, n).astype(np.float32)
    py_h = rng.uniform(0, 799, n).astype(np.float32)

    def from_host(arr):
        return jax.make_array_from_callback(
            arr.shape, shard, lambda idx: arr[idx])

    px = from_host(px_h)
    py = from_host(py_h)
    pack_r = jax.device_put(pack, repl)
    cam_r = jax.device_put(cam, repl)
    key = jax.device_put(jax.random.PRNGKey(0), repl)

    @jax.jit
    def render_sum(pack, cam, px, py, key):
        img = trace_radiance(pack, cam, px, py, key, opts)
        return jnp.sum(img)  # cross-process psum

    total = float(render_sum(pack_r, cam_r, px, py, key))
    assert np.isfinite(total) and total > 0.0
    with open(out_path, "w") as f:
        f.write(f"{total:.6f}\n")
    jax.distributed.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
