"""Batched pytree types for rays, hits, and path state.

Wavefront replacement for the reference's per-ray objects: `Ray`
(`EngineCore/Core/Ray.fs:5-10`) and `HitRecord`
(`EngineCore/Core/Interfaces/HitRecord.fs:5-15`) become structure-of-arrays
pytrees over a ray-batch axis, so one `Rays` holds an entire wavefront.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from mafrixraytracing_tpu.core import struct
from jax import Array


class Rays(struct.PyTreeNode):
    """A batch of rays. origin/direction: (..., 3); direction is unit length
    (the reference asserts this in `Core/Ray.fs:9`; we maintain it by
    construction at every producer)."""

    origin: Array
    direction: Array

    def at(self, t: Array) -> Array:
        """Point at parameter t (reference `Ray.PointAtParameter`,
        `Core/Ray.fs:8`)."""
        return self.origin + t[..., None] * self.direction

    @property
    def batch_shape(self):
        return self.origin.shape[:-1]


class Hit(struct.PyTreeNode):
    """Closest-hit record for a batch of rays (SoA form of the reference's
    `HitRecord`, `Core/Interfaces/HitRecord.fs:5-15`). `prim_idx` indexes the
    flat primitive arrays; `material` indexes the material table — the array
    analog of the reference's `MaterialManager` int index
    (`Core/Interfaces/IMaterial.fs:20-35`).
    """

    valid: Array      # (...,) bool — did the ray hit anything
    t: Array          # (...,) f32 — hit distance
    point: Array      # (..., 3) — hit position
    normal: Array     # (..., 3) — geometric unit normal (toward ray origin side flag below)
    front_face: Array # (...,) bool — True if the ray hit the front side
    material: Array   # (...,) i32 — material table index
    prim_idx: Array   # (...,) i32 — flat primitive index (tri: [0,T), sphere: T + s)
    uv: Array         # (..., 2) — barycentric / surface uv

    @classmethod
    def none(cls, batch_shape, t_max=jnp.inf):
        z3 = jnp.zeros(batch_shape + (3,), jnp.float32)
        return cls(
            valid=jnp.zeros(batch_shape, bool),
            t=jnp.full(batch_shape, t_max, jnp.float32),
            point=z3,
            normal=z3.at[..., 2].set(1.0),
            front_face=jnp.ones(batch_shape, bool),
            material=jnp.zeros(batch_shape, jnp.int32),
            prim_idx=jnp.full(batch_shape, -1, jnp.int32),
            uv=jnp.zeros(batch_shape + (2,), jnp.float32),
        )


class Shading(struct.PyTreeNode):
    """Per-hit material attributes, pre-joined per primitive (one packed row
    gather in `geometry.intersect.hit_attributes_packed`) so the shading
    stage reads no material tables. `albedo` is already modulated by the
    material's texture at the hit uv."""

    albedo: Array     # (..., 3) base color x texture
    emission: Array   # (..., 3) emitted radiance
    fuzz: Array       # (...,) metal roughness
    ior: Array        # (...,) dielectric index
    mtype: Array      # (...,) i32 material type (bsdf.LAMBERT/...)
    two_sided: Array  # (...,) bool — emitter radiates from both faces


from typing import NamedTuple  # noqa: E402

from mafrixraytracing_tpu.core.v3 import V3  # noqa: E402


class HitS(NamedTuple):
    """SoA closest-hit record: `Hit` with every vector as a V3 of flat (B,)
    columns and uv split into scalars (see core.v3 for the layout
    rationale). Used by the hot integrator path."""

    valid: "jnp.ndarray"
    t: "jnp.ndarray"
    point: V3
    normal: V3
    front_face: "jnp.ndarray"
    material: "jnp.ndarray"
    prim_idx: "jnp.ndarray"
    u: "jnp.ndarray"
    v: "jnp.ndarray"


class ShadingS(NamedTuple):
    """SoA form of `Shading` (albedo/emission as V3 columns).

    `light_pdf_sa` is the solid-angle pdf with which the sphere-light NEE
    cone sampler (`lights.nee_sphere_soa`) would have generated the ray that
    produced this hit — nonzero only for sphere primitives, 0 when the ray
    origin was inside the sphere (NEE cannot sample it). Used by the
    integrator's MIS weight for BSDF-sampled emissive-sphere hits; triangle
    lights derive their pdf from the area CDF instead."""

    albedo: V3
    emission: V3
    fuzz: "jnp.ndarray"
    ior: "jnp.ndarray"
    mtype: "jnp.ndarray"
    two_sided: "jnp.ndarray"
    light_pdf_sa: "jnp.ndarray"


class PathState(struct.PyTreeNode):
    """Wavefront path state carried through the bounce `lax.scan` — the array
    analog of the reference's recursion locals in `PathIntegrator.TraceRay`
    (`Core/Integrator/Integrators.fs:107-138`)."""

    rays: Rays            # current ray per path
    throughput: Array     # (..., 3) — product of f*cos/pdf so far
    radiance: Array       # (..., 3) — accumulated L
    alive: Array          # (...,) bool — path still tracing
    key: Array            # jax PRNG key array, one key per path
    prev_bsdf_pdf: Array  # (...,) f32 — pdf of the previous BSDF sample (for MIS)
    prev_specular: Array  # (...,) bool — previous bounce was a delta lobe


def ray_batch_shape(state: PathState):
    return state.throughput.shape[:-1]
