"""tpurt — a Monte-Carlo path-tracing framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
TheSovietPancakes/ripoff-raytracer (a C++17 + OpenCL multi-GPU tile
path tracer). Everything device-side is pure-functional SPMD: the scene
is an immutable struct-of-arrays pytree in device memory, a render is a
jitted function ``(scene, camera, config, frame) -> image`` and
multi-device distribution is ``shard_map`` over a device mesh instead of host
threads + mutexes (reference: src/image.hpp:280-350).

Layer map (mirrors SURVEY.md §1 of the reference):
  core/      vec math, bit-exact PRNG, camera rays      (ref: src/math.hpp, Trace.cl:80-257,596-621)
  scene/     OBJ loader, materials, instances, cornell  (ref: src/readobj.hpp, image.hpp:401-449)
  accel/     SAH BVH build + flat threaded layout       (ref: src/readobj.hpp:96-267)
  render/    integrator (brute force + BVH), tonemap    (ref: src/Trace.cl)
  parallel/  device-mesh tile/sample sharding           (ref: src/image.hpp:280-350)
  io/        BMP writer, tile-grain checkpoints         (ref: src/math.hpp:117-164)
  utils/     progress/ETA, metrics, profiling           (ref: src/image.hpp:306-344)
"""

__version__ = "0.1.0"

from tpurt.config import RenderConfig  # noqa: F401
