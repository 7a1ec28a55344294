"""mafrixraytracing_tpu — a differentiable wavefront path-tracing framework.

Built from scratch in JAX/XLA/Pallas with the capability set of the F# CPU
renderer NAIVEddd/MafrixRaytracing (see SURVEY.md): XML scene descriptions,
OBJ/MTL loading, sphere/triangle/rect geometry, BVH acceleration, pinhole and
thin-lens cameras, Lambert/metal/dielectric materials, area/point lights, a
path integrator with next-event estimation, jittered pixel sampling,
progressive film accumulation, and ACES tone mapping — re-designed for
wavefront execution on an accelerator:

- Scenes compile to flat SoA arrays (a `ScenePytree`), not object graphs
  (replaces the interface zoo of `EngineCore/Core/Interfaces/*`).
- The integrator is a wavefront `lax.scan` over a fixed-size path-state SoA
  (replaces the recursive `PathIntegrator.TraceRay`,
  reference `Core/Integrator/Integrators.fs:96-141`).
- RNG is counter-based `jax.random` keys folded per (pixel, sample, bounce)
  (replaces ad-hoc `System.Random`, deterministic and replayable).
- Hot intersection paths run as Pallas (Triton) kernels over ray blocks; the
  closest-hit backward pass recomputes only the selected primitive, so
  forward+backward costs ~forward.
- Multi-device scaling is `jax.sharding.Mesh` + `shard_map` with XLA
  collectives (`psum`) for framebuffer merge and gradient all-reduce.
"""

__version__ = "0.1.0"

from mafrixraytracing_tpu.scene.compiler import ScenePytree, compile_scene
from mafrixraytracing_tpu.camera.camera import Camera
from mafrixraytracing_tpu.integrator.path import PathTracerConfig, render_image

__all__ = [
    "ScenePytree",
    "compile_scene",
    "Camera",
    "PathTracerConfig",
    "render_image",
]
