"""Cameras: pinhole and thin-lens, as differentiable pytrees.

Parity targets:
- `PinholeCamera` (reference `EngineCore/Core/Camera.fs:113-142`): view plane
  0.5 units ahead, `hori = tan(0.5*fov*pi/360)` (the reference's quarter-angle
  convention — nominal fov 120 behaves like a 60-degree horizontal field),
  `vert = hori/aspect`, rays from `topleft + u*right + v*down`.
- `CameraCoordinate` basis (reference `Core/Camera.fs:88-111`):
  right = forward x up, up' = right x forward.
- Thin-lens (reference sample `RayTraceCamera`,
  `RenderTest/Sample/RayTracing.fs:335-364`): aperture disk + focus distance.

The whole camera is a pytree of f32 arrays, so camera parameters
(position, orientation, fov) receive gradients in inverse rendering.
"""
from __future__ import annotations

import jax.numpy as jnp
from mafrixraytracing_tpu.core import struct
from jax import Array

from mafrixraytracing_tpu.core.math import cross, normalize
from mafrixraytracing_tpu.core.sampling import uniform_disk
from mafrixraytracing_tpu.core.types import Rays


class Camera(struct.PyTreeNode):
    position: Array      # (3,)
    topleft: Array       # (3,) top-left corner of the view plane
    right_vec: Array     # (3,) full-width vector along +u
    down_vec: Array      # (3,) full-height vector along +v
    # thin-lens extras (lens_radius == 0 -> pure pinhole)
    lens_right: Array    # (3,) unit right for lens offsets
    lens_up: Array       # (3,) unit up for lens offsets
    lens_radius: Array   # () f32
    focus_scale: Array   # () f32 — focus_dist / plane_dist

    @classmethod
    def pinhole(
        cls,
        position,
        direction,
        fov: float,
        aspect: float,
        up=(0.0, 1.0, 0.0),
        fov_convention: str = "mafrix",
    ) -> "Camera":
        """Build the reference-compatible pinhole camera.

        fov_convention:
          - "mafrix": half-extent = tan(0.5*fov*pi/360) with plane at 0.5
            (reference `Core/Camera.fs:122-133`).
          - "standard": `fov` is the true horizontal field of view in degrees.
        """
        pos = jnp.asarray(position, jnp.float32)
        fwd = normalize(jnp.asarray(direction, jnp.float32))
        upv = normalize(jnp.asarray(up, jnp.float32))
        right = normalize(cross(fwd, upv))
        true_up = cross(right, fwd)

        fov = jnp.asarray(fov, jnp.float32)
        if fov_convention == "mafrix":
            plane_dist = 0.5
            hori = jnp.tan(0.5 * fov * jnp.pi / 360.0)
        elif fov_convention == "standard":
            plane_dist = 1.0
            hori = 2.0 * jnp.tan(0.5 * fov * jnp.pi / 180.0)
        else:
            raise ValueError(f"unknown fov_convention {fov_convention!r}")
        vert = hori / jnp.asarray(aspect, jnp.float32)

        right_vec = right * hori
        up_vec = true_up * vert
        topleft = pos + plane_dist * fwd - 0.5 * right_vec + 0.5 * up_vec
        return cls(
            position=pos,
            topleft=topleft,
            right_vec=right_vec,
            down_vec=-up_vec,
            lens_right=right,
            lens_up=true_up,
            lens_radius=jnp.float32(0.0),
            focus_scale=jnp.float32(1.0),
        )

    @classmethod
    def thin_lens(
        cls,
        position,
        look_at,
        fov: float,
        aspect: float,
        aperture: float,
        focus_dist: float | None = None,
        up=(0.0, 1.0, 0.0),
    ) -> "Camera":
        """Thin-lens camera with defocus blur (reference `RayTraceCamera`,
        `RenderTest/Sample/RayTracing.fs:335-364`). `fov` is the true
        horizontal FOV in degrees; focus defaults to the look-at distance."""
        pos = jnp.asarray(position, jnp.float32)
        tgt = jnp.asarray(look_at, jnp.float32)
        d = tgt - pos
        dist = jnp.sqrt(jnp.sum(d * d))
        cam = cls.pinhole(pos, d, fov, aspect, up=up, fov_convention="standard")
        focus = jnp.float32(focus_dist) if focus_dist is not None else dist
        return cam.replace(
            lens_radius=jnp.float32(aperture) / 2.0,
            focus_scale=focus,  # plane_dist == 1.0 for "standard"
        )

    def get_rays(self, u: Array, v: Array, lens_uv: Array | None = None) -> Rays:
        """Map film coordinates u, v in [0,1] (v=0 is the top row, matching
        reference `PinholeCamera.GetRay`, `Core/Camera.fs:134-139`) to world
        rays. `lens_uv` (optional, (..., 2) uniforms) enables defocus blur."""
        target = (
            self.topleft
            + u[..., None] * self.right_vec
            + v[..., None] * self.down_vec
        )
        origin = jnp.broadcast_to(self.position, target.shape)
        if lens_uv is not None:
            disk = uniform_disk(lens_uv) * self.lens_radius
            offset = disk[..., 0:1] * self.lens_right + disk[..., 1:2] * self.lens_up
            # Focus: scale the in-plane target out to the focal plane so rays
            # through different lens points converge there.
            target = self.position + (target - self.position) * self.focus_scale
            origin = origin + offset
        direction = normalize(target - origin)
        return Rays(origin=origin, direction=direction)
