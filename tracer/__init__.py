"""tracer — a differentiable path tracer in JAX, run on an NVIDIA GPU.

A brand-new JAX/XLA implementation of the capabilities of the
reference CUDA path tracer (zloyaloha/ray-tracing-practice), redesigned
as array programs:

- arrays-of-structs -> structs-of-arrays pytrees,
- per-thread branches -> masked vector lanes,
- the CUDA megakernel -> a jitted wavefront integrator that XLA compiles,
- and (beyond the reference) a fully differentiable scene: pixel losses
  backpropagate to sphere centers/radii, material albedo/fuzz/IOR/
  absorption/emission, and camera parameters.

Layer map (mirrors SURVEY.md section 1 of the reference):
  core/      L0 math + L1 RNG
  geometry/  L2 intersection
  bvh/       L3 acceleration structure (host build + device traversal)
  materials/ L4 scatter/emit + texturing
  scene/     L5 scene pytree, builders, config
  render/    L6 camera + integrator
  io/        L7 image savers + texture loading
  cli.py     L8 driver
  dist/      mesh + sharding (new capability; reference is single-GPU)
  opt/       inverse-rendering fit loop + chunked L2 gradients
  utils/     profiling + debug guards
"""

__version__ = "0.1.0"
