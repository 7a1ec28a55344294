"""Vector math core.

Batched replacement for the reference's scalar `Point`/`Vector`/`Color`
types (reference `EngineCore/Core/Point.fs:5-68`, `Core/Color.fs:4-20`):
everything here operates on batched `(..., 3)` float arrays so it vectorizes
across rays instead of running one scalar op per component.
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import Array

EPS = 1e-8


def dot(a: Array, b: Array) -> Array:
    """Batched dot product over the last axis, keepdims-free -> (...,)."""
    return jnp.sum(a * b, axis=-1)


def dot3(a: Array, b: Array) -> Array:
    """Batched dot product, keeping the last axis -> (..., 1)."""
    return jnp.sum(a * b, axis=-1, keepdims=True)


def cross(a: Array, b: Array) -> Array:
    return jnp.cross(a, b)


def safe_sqrt(x: Array) -> Array:
    """sqrt(max(x, 0)) with a finite gradient at/below zero.

    Plain `sqrt(max(x, 0))` has d/dx = inf at x == 0; under AD, masked-out
    lanes then produce `inf * 0 = NaN` cotangents that poison whole-batch
    gradients (the "double where" trap). This computes sqrt on a guarded
    operand so the untaken branch never sees a non-finite value."""
    pos = x > 0.0
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, x, 1.0)), 0.0)


def safe_div(num: Array, den: Array, eps: float = 1e-10) -> Array:
    """num/den that returns 0 (with zero gradient, not NaN) where |den|<=eps."""
    ok = jnp.abs(den) > eps
    return jnp.where(ok, num / jnp.where(ok, den, 1.0), 0.0)


def length(v: Array) -> Array:
    return safe_sqrt(dot(v, v))


def normalize(v: Array) -> Array:
    """Zero-safe normalize (reference `Core/Point.fs:52-56` returns the input
    vector unchanged when its length is ~0; we do the same via a guard)."""
    n2 = dot3(v, v)
    scale = jnp.where(n2 > EPS * EPS, 1.0 / jnp.sqrt(jnp.maximum(n2, EPS * EPS)), 1.0)
    return v * scale


def lerp(a: Array, b: Array, t: Array) -> Array:
    return a + (b - a) * t


def reflect(v: Array, n: Array) -> Array:
    """Mirror reflection of direction `v` about normal `n`
    (reference `Core/Materials/Material.fs:16`)."""
    return v - 2.0 * dot3(v, n) * n


def refract(v: Array, n: Array, eta: Array):
    """Refract unit direction `v` through normal `n` with relative IOR `eta`
    (= n_i/n_t). Returns `(ok, refracted)`; `ok` is False on total internal
    reflection (reference `Core/Materials/Material.fs:18-24`)."""
    cos_i = -dot3(v, n)
    sin2_t = eta[..., None] ** 2 * jnp.maximum(1.0 - cos_i**2, 0.0)
    ok = sin2_t[..., 0] < 1.0
    cos_t = safe_sqrt(1.0 - sin2_t)
    refracted = eta[..., None] * v + (eta[..., None] * cos_i - cos_t) * n
    return ok, refracted


def fresnel_dielectric(cos_i: Array, eta_i: Array, eta_t: Array) -> Array:
    """Exact unpolarized dielectric Fresnel reflectance (average of r_par and
    r_perp); total internal reflection -> 1
    (reference `Core/Materials/Material.fs:74-96`)."""
    cos_i = jnp.clip(cos_i, 0.0, 1.0)
    sin_t = (eta_i / eta_t) * safe_sqrt(1.0 - cos_i**2)
    tir = sin_t >= 1.0
    cos_t = safe_sqrt(1.0 - sin_t**2)
    r_par = (eta_t * cos_i - eta_i * cos_t) / jnp.maximum(eta_t * cos_i + eta_i * cos_t, EPS)
    r_perp = (eta_i * cos_i - eta_t * cos_t) / jnp.maximum(eta_i * cos_i + eta_t * cos_t, EPS)
    fr = 0.5 * (r_par**2 + r_perp**2)
    return jnp.where(tir, 1.0, fr)


def schlick_fresnel(cos_i: Array, ior: Array) -> Array:
    """Schlick approximation (reference sample `RenderTest/Sample/RayTracing.fs`
    `Schlick`)."""
    r0 = ((1.0 - ior) / (1.0 + ior)) ** 2
    return r0 + (1.0 - r0) * (1.0 - jnp.clip(cos_i, 0.0, 1.0)) ** 5


def orthonormal_basis(n: Array):
    """Build a right-handed orthonormal basis (t, b, n) around unit normal
    `n`, branch-free (Frisvad/Duff-style; replaces reference
    `Core/Materials/ONB.fs:6-26` which branches on |n.x|>0.9).

    Returns (tangent, bitangent) with n = cross(tangent, bitangent).
    """
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = jnp.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = jnp.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], axis=-1)
    bt = jnp.stack([b, sign + ny * ny * a, -ny], axis=-1)
    return t, bt


def local_to_world(local_dir: Array, n: Array) -> Array:
    """Map a direction in the local (t, b, n) frame of normal `n` to world
    space (reference `ONB.Local`, `Core/Materials/ONB.fs:22-25`)."""
    t, b = orthonormal_basis(n)
    return (
        local_dir[..., 0:1] * t
        + local_dir[..., 1:2] * b
        + local_dir[..., 2:3] * n
    )


def luminance(rgb: Array) -> Array:
    return (
        0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]
    )
