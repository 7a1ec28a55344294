"""4x4 homogeneous transforms.

Parity with the reference's `Matrix4x4` factories and point/vector transforms
(`EngineCore/Core/Transformation.fs:8-132`): row-major 4x4, displacement /
rotation about X/Y/Z in degrees / scale, with inverses, and transform of
points (with w-divide) vs. vectors (no translation). All functions accept and
return jnp arrays and are batched over leading axes and differentiable, so
instancing transforms can be optimized by gradient descent.
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import Array
from jax.lax import Precision

# float32 products at full precision: a GPU would otherwise run them in TF32
HIGHEST = Precision.HIGHEST


def identity() -> Array:
    return jnp.eye(4, dtype=jnp.float32)


def translation(offset) -> Array:
    """Displacement matrix (reference `Transformation.fs` MakeDisplacementMatrix)."""
    o = jnp.asarray(offset, jnp.float32)
    m = jnp.eye(4, dtype=jnp.float32)
    return m.at[:3, 3].set(o)


def scale(factors) -> Array:
    f = jnp.asarray(factors, jnp.float32)
    f = jnp.broadcast_to(f, (3,))
    return jnp.diag(jnp.concatenate([f, jnp.ones((1,), jnp.float32)]))


def _deg2rad(deg) -> Array:
    return jnp.asarray(deg, jnp.float32) * (jnp.pi / 180.0)


def rotation_x(deg) -> Array:
    a = _deg2rad(deg)
    c, s = jnp.cos(a), jnp.sin(a)
    return jnp.array(
        [[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]], jnp.float32
    )


def rotation_y(deg) -> Array:
    a = _deg2rad(deg)
    c, s = jnp.cos(a), jnp.sin(a)
    return jnp.array(
        [[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]], jnp.float32
    )


def rotation_z(deg) -> Array:
    a = _deg2rad(deg)
    c, s = jnp.cos(a), jnp.sin(a)
    return jnp.array(
        [[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], jnp.float32
    )


def compose(*mats: Array) -> Array:
    """Left-to-right application order: compose(A, B) applies A first."""
    out = jnp.eye(4, dtype=jnp.float32)
    for m in mats:
        out = jnp.matmul(m, out, precision=HIGHEST)
    return out


def inverse(m: Array) -> Array:
    return jnp.linalg.inv(m)


def apply_point(m: Array, p: Array) -> Array:
    """Transform points (..., 3) with w-divide
    (reference `Transformation.fs:48-57`)."""
    ph = jnp.concatenate([p, jnp.ones(p.shape[:-1] + (1,), p.dtype)], axis=-1)
    out = jnp.einsum("ij,...j->...i", m, ph, precision=HIGHEST)
    w = jnp.where(jnp.abs(out[..., 3:4]) > 1e-12, out[..., 3:4], 1.0)
    return out[..., :3] / w


def apply_vector(m: Array, v: Array) -> Array:
    """Transform directions (..., 3); translation ignored
    (reference `Transformation.fs:59-63`)."""
    return jnp.einsum("ij,...j->...i", m[:3, :3], v, precision=HIGHEST)


def apply_normal(m: Array, n: Array) -> Array:
    """Transform normals by the inverse-transpose so they stay perpendicular
    under non-uniform scale (the reference lacks this; needed for correct
    instancing)."""
    inv_t = jnp.linalg.inv(m[:3, :3]).T
    return jnp.einsum("ij,...j->...i", inv_t, n, precision=HIGHEST)
