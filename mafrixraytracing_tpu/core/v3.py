"""Structure-of-arrays 3-vectors: the wavefront vector representation.

The hot integrator path carries every vector as a `V3` of three flat `(B,)`
components instead of one `(B, 3)` array: each component is a dense,
contiguous array, so every elementwise fusion reads and writes whole
columns with no strided minor dimension, and no stack/unstack pair sits
between fusions for XLA to materialize. `(B, 3)` arrays appear only at API
boundaries (scene tables, images, tests).

This is the wavefront analog of the reference keeping scalar `Point`
fields (`Core/Point.fs:5-68`) — components stay separate, batched over
rays instead of over coordinates.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import Array


class V3(NamedTuple):
    x: Array
    y: Array
    z: Array

    # --- conversions ---
    @staticmethod
    def of(a: Array) -> "V3":
        """(..., 3) array -> V3 of (...,) components."""
        return V3(a[..., 0], a[..., 1], a[..., 2])

    @staticmethod
    def fill(v, shape=()) -> "V3":
        """Broadcast a length-3 constant to component arrays."""
        return V3(
            jnp.broadcast_to(jnp.asarray(v[0], jnp.float32), shape),
            jnp.broadcast_to(jnp.asarray(v[1], jnp.float32), shape),
            jnp.broadcast_to(jnp.asarray(v[2], jnp.float32), shape),
        )

    def arr(self) -> Array:
        """V3 -> (..., 3) array (boundary use only)."""
        return jnp.stack([self.x, self.y, self.z], axis=-1)

    # --- arithmetic (component-wise; scalars broadcast) ---
    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return self * (1.0 / o)

    def max_component(self) -> Array:
        return jnp.maximum(self.x, jnp.maximum(self.y, self.z))

    def sum(self) -> Array:
        return self.x + self.y + self.z


def dot(a: V3, b: V3) -> Array:
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: V3, b: V3) -> V3:
    return V3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def norm2(a: V3) -> Array:
    return dot(a, a)


def normalize(v: V3, eps: float = 1e-12) -> V3:
    """Zero-safe normalize (reference `Core/Point.fs:52-56` returns the
    input unchanged at ~0 length; same guard)."""
    n2 = norm2(v)
    scale = jnp.where(n2 > eps, jax.lax.rsqrt(jnp.maximum(n2, eps)), 1.0)
    return v * scale


def where(mask: Array, a: V3, b: V3) -> V3:
    return V3(
        jnp.where(mask, a.x, b.x),
        jnp.where(mask, a.y, b.y),
        jnp.where(mask, a.z, b.z),
    )


def reflect(d: V3, n: V3) -> V3:
    """Mirror reflection of propagation direction `d` about normal `n`
    (reference `Material.fs:16-17`)."""
    return d - n * (2.0 * dot(d, n))


def refract(d: V3, n: V3, eta: Array):
    """Snell refraction; d points into the surface, n against it.
    Returns (ok, refracted) — ok False on total internal reflection
    (reference `Material.fs:19-24`). cos_t uses the guarded-sqrt pattern:
    plain sqrt(max(x, 0)) has an infinite gradient at the TIR boundary,
    which turns into NaN through the selecting `where` (0 * inf) and
    poisons whole-batch gradients."""
    cos_i = jnp.clip(-dot(d, n), -1.0, 1.0)
    sin2_t = eta * eta * jnp.maximum(1.0 - cos_i * cos_i, 0.0)
    ok = sin2_t < 1.0
    x = 1.0 - sin2_t
    pos = x > 0.0
    cos_t = jnp.where(pos, jnp.sqrt(jnp.where(pos, x, 1.0)), 0.0)
    out = d * eta + n * (eta * cos_i - cos_t)
    return ok, out
