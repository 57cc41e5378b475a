"""advanced_cpu_raytracing_tpu — a differentiable ray tracer in JAX.

A from-scratch re-design of the capabilities of the reference CPU ray tracer
(dorukb/Advanced-CPU-Raytracing, "DorkTracer"): Whitted-style recursive ray
tracing and Monte-Carlo path tracing over triangle meshes (BVH-accelerated,
instanced, motion-blurred) and spheres, with the full material/BRDF zoo, six
light types, image/Perlin texturing with normal & bump mapping, depth of field,
stratified multisampling with Gaussian reconstruction, and Reinhard tonemapping.

Architecture (a wavefront design, not a port):
  - ``scene``    host-side ingest: XML/PLY/image loading -> flat device arrays
  - ``accel``    BVH build (host / native C++) flattened to SoA node arrays
  - ``ops``      batched intersection / shading / texture kernels (jnp)
  - ``render``   wavefront integrator: per-lane ray stacks in lax.while_loop
  - ``parallel`` device-mesh sharding (XLA-inserted collectives)
  - ``post``     sample accumulation, Reinhard TMO, PNG/HDR/PPM writers
  - ``diff``     differentiable-rendering parameter pytrees and optimizers
  - ``cli``      ``python -m advanced_cpu_raytracing_tpu.cli.render scene.xml``

Reference parity citations use ``src/<file>:<lines>`` paths relative to the
reference repo.
"""

__version__ = "0.1.0"

from advanced_cpu_raytracing_tpu.scene.xml_parser import load_scene  # noqa: F401

__all__ = ["load_scene", "__version__"]
