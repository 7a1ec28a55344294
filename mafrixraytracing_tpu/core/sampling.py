"""Sampling warps and pixel samplers.

Replaces the reference's sampler zoo (`Core/Interfaces/ISampler.fs:13-58`,
`Core/Samples/JitteredSampler.fs`, hemisphere helpers in
`Core/Materials/Brdfs/Lambertian.fs:10-53`, rejection sampling in
`Core/Materials/Material.fs:9-14`) with branch-free analytic warps of uniform
[0,1)^2 samples — branch-free (no rejection loops) and differentiable.
Also fixes the reference's diagonal-jitter bug
(`Core/Samples/JitteredSampler.fs:16` uses the same random value for both
axes); our stratified jitter uses independent axes.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import Array

from mafrixraytracing_tpu.core.math import local_to_world

TWO_PI = 2.0 * jnp.pi


def uniform_hemisphere(u: Array, n: Array) -> Array:
    """Uniform direction on the hemisphere around unit normal `n`.
    u: (..., 2) uniforms. pdf = 1/(2*pi). Analytic replacement for the
    reference's rejection sampler `GetRandomInUnitSphere`
    (`Core/Materials/Material.fs:9-14`)."""
    z = u[..., 0]
    r = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    phi = TWO_PI * u[..., 1]
    local = jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)
    return local_to_world(local, n)


def cosine_hemisphere(u: Array, n: Array):
    """Cosine-weighted hemisphere sample around `n`. Returns (dir, pdf),
    pdf = cos(theta)/pi (reference's intended `CosHemisphereSample`,
    `Core/Materials/Brdfs/Lambertian.fs:17-28`)."""
    r = jnp.sqrt(jnp.clip(u[..., 0], 0.0, 1.0))
    phi = TWO_PI * u[..., 1]
    x = r * jnp.cos(phi)
    y = r * jnp.sin(phi)
    z = jnp.sqrt(jnp.maximum(1.0 - u[..., 0], 0.0))
    local = jnp.stack([x, y, z], axis=-1)
    pdf = jnp.maximum(z, 1e-8) / jnp.pi
    return local_to_world(local, n), pdf


def uniform_sphere(u: Array) -> Array:
    """Uniform direction on the full sphere; pdf = 1/(4*pi)."""
    z = 1.0 - 2.0 * u[..., 0]
    r = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    phi = TWO_PI * u[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def uniform_disk(u: Array) -> Array:
    """Concentric-free polar warp to the unit disk -> (..., 2). Used by the
    thin-lens camera (reference sample `RandomInUnitDisk`,
    `RenderTest/Sample/RayTracing.fs:327-333`, was rejection-based)."""
    r = jnp.sqrt(jnp.clip(u[..., 0], 0.0, 1.0))
    phi = TWO_PI * u[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi)], axis=-1)


def uniform_triangle(u: Array) -> Array:
    """sqrt-warp uniform barycentrics on a triangle -> (..., 2) = (b1, b2)
    with b0 = 1-b1-b2 (same warp the reference uses,
    `Core/Shape/Trangle.fs:157-169`)."""
    su = jnp.sqrt(jnp.clip(u[..., 0], 0.0, 1.0))
    b1 = 1.0 - su
    b2 = u[..., 1] * su
    return jnp.stack([b1, b2], axis=-1)


def fuzz_sphere(u: Array) -> Array:
    """Uniform point *inside* the unit ball via radius cube-root warp — the
    metal `fuzz` perturbation (reference `Core/Materials/Material.fs:60-64`
    used hemisphere rejection)."""
    d = uniform_sphere(u[..., :2])
    r = jnp.cbrt(jnp.clip(u[..., 2], 1e-12, 1.0))
    return d * r[..., None]


def stratified_jitter(key: Array, n_samples: int) -> Array:
    """(n_samples, 2) stratified samples on [0,1)^2 using an n x n-ish grid
    with independent per-axis jitter (fixes the diagonal-sample bug of
    `JitteredSampler.fs:16`). When n_samples is not a perfect square, falls
    back to 1D stratification along x with uniform y."""
    import math

    side = int(math.isqrt(n_samples))
    u = jax.random.uniform(key, (n_samples, 2))
    if side * side == n_samples:
        ix = jnp.arange(n_samples) % side
        iy = jnp.arange(n_samples) // side
        grid = jnp.stack([ix, iy], axis=-1).astype(jnp.float32)
        return (grid + u) / side
    strata = (jnp.arange(n_samples, dtype=jnp.float32) + u[:, 0]) / n_samples
    return jnp.stack([strata, u[:, 1]], axis=-1)


# ---------------------------------------------------------------------------
# SoA (flat-component) variants — the hot integrator path carries vectors as
# V3 of (B,) columns (see core.v3 for why), so these mirror the warps above
# without ever forming a (B, 3) array.
# ---------------------------------------------------------------------------

from mafrixraytracing_tpu.core.v3 import V3  # noqa: E402


def _onb_soa(n: V3):
    """Branch-free ONB around unit normal (Frisvad/Duff), SoA form of
    `core.math.orthonormal_basis`."""
    sign = jnp.where(n.z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n.z)
    b = n.x * n.y * a
    t = V3(1.0 + sign * n.x * n.x * a, sign * b, -sign * n.x)
    bt = V3(b, sign + n.y * n.y * a, -n.y)
    return t, bt


def _local_to_world_soa(lx, ly, lz, n: V3) -> V3:
    t, b = _onb_soa(n)
    return t * lx + b * ly + n * lz


def uniform_hemisphere_soa(u: Array, n: V3) -> V3:
    z = u[..., 0]
    r = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    phi = TWO_PI * u[..., 1]
    return _local_to_world_soa(r * jnp.cos(phi), r * jnp.sin(phi), z, n)


def cosine_hemisphere_soa(u: Array, n: V3):
    r = jnp.sqrt(jnp.clip(u[..., 0], 0.0, 1.0))
    phi = TWO_PI * u[..., 1]
    z = jnp.sqrt(jnp.maximum(1.0 - u[..., 0], 0.0))
    pdf = jnp.maximum(z, 1e-8) / jnp.pi
    return _local_to_world_soa(r * jnp.cos(phi), r * jnp.sin(phi), z, n), pdf


def fuzz_sphere_soa(u: Array) -> V3:
    """Uniform point inside the unit ball, SoA."""
    z = 1.0 - 2.0 * u[..., 0]
    rr = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    phi = TWO_PI * u[..., 1]
    r = jnp.cbrt(jnp.clip(u[..., 2], 1e-12, 1.0))
    return V3(r * rr * jnp.cos(phi), r * rr * jnp.sin(phi), r * z)
