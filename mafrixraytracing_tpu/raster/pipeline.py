"""Fixed-function rasterizer pipeline (the reference's legacy second engine).

Parity with `EngineCore/Core/Pipeline.fs:69-103` (`PipelineDraw`):
local→world (`Pipeline.fs:10-12`) → backface removal by face-normal·view
(`Pipeline.fs:14-21`) → per-face light color (`Pipeline.fs:77-80`) →
world→camera→perspective→screen (`Pipeline.fs:23-38`) → barycentric
triangle fill with z/uv/normal interpolation (`Pipeline.fs:40-65`) →
per-pixel texture sample + `Sample_Li` lighting → z-buffered write
(`Core/RenderTarget.fs:15-20`).

Wavefront redesign: no scanlines (`DrawModelCar.fs:11-89`'s top/bottom
split is serial per-row work) — coverage is dense edge-function evaluation
of pixel tiles against triangle chunks, scanned with a running z-buffer, so
the whole frame is a fixed-shape `lax.scan` the XLA fuser handles. Like the
reference, attribute interpolation is affine screen-space barycentric (its
`DrawTrangle` interpolates z/uv/normal without perspective correction);
`perspective_correct=True` upgrades it.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from mafrixraytracing_tpu.core.math import normalize


# ---------------------------------------------------------------------------
# Camera matrices (reference `Core/Camera.fs:43-86` GetUVNTransMatrix /
# GetPerspectiveMatrix / GetOrthogriphicMatrix)
# ---------------------------------------------------------------------------


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> jnp.ndarray:
    """World -> camera (UVN) matrix; camera looks down -z."""
    eye = jnp.asarray(eye, jnp.float32)
    f = normalize(jnp.asarray(target, jnp.float32) - eye)
    r = normalize(jnp.cross(f, jnp.asarray(up, jnp.float32)))
    u = jnp.cross(r, f)
    rot = jnp.stack([r, u, -f], axis=0)
    m = jnp.eye(4, dtype=jnp.float32)
    m = m.at[:3, :3].set(rot)
    m = m.at[:3, 3].set(-jnp.matmul(rot, eye, precision=lax.Precision.HIGHEST))
    return m


def perspective(fov_deg, aspect, near=0.1, far=100.0) -> jnp.ndarray:
    """Perspective projection (vertical fov, degrees) -> clip space."""
    f = 1.0 / jnp.tan(jnp.deg2rad(jnp.asarray(fov_deg, jnp.float32)) / 2.0)
    return jnp.array(
        [
            [f / aspect, 0, 0, 0],
            [0, f, 0, 0],
            [0, 0, (far + near) / (near - far), 2 * far * near / (near - far)],
            [0, 0, -1, 0],
        ],
        jnp.float32,
    )


def orthographic(half_w, half_h, near=0.1, far=100.0) -> jnp.ndarray:
    return jnp.array(
        [
            [1.0 / half_w, 0, 0, 0],
            [0, 1.0 / half_h, 0, 0],
            [0, 0, -2.0 / (far - near), -(far + near) / (far - near)],
            [0, 0, 0, 1],
        ],
        jnp.float32,
    )


@dataclass(frozen=True)
class RasterLight:
    """Rasterizer lights (reference DU `Light`, `Core/Lights/Light.fs:66-80`:
    Ambient_Light / Direction_Light / Point_Light)."""

    type: str                       # "ambient" | "directional" | "point"
    color: tuple = (1.0, 1.0, 1.0)
    direction: tuple = (0.0, -1.0, 0.0)   # directional
    position: tuple = (0.0, 5.0, 0.0)     # point


def _shade(lights, points, normals, base_color):
    """Per-pixel Lambert shading (reference `Light.Sample_Li`,
    `Core/Lights/Light.fs:104-117`)."""
    total = jnp.zeros_like(base_color)
    for l in lights:
        c = jnp.asarray(l.color, jnp.float32)
        if l.type == "ambient":
            total = total + c
        elif l.type == "directional":
            d = normalize(jnp.asarray(l.direction, jnp.float32))
            lam = jnp.maximum(-jnp.sum(normals * d, axis=-1), 0.0)
            total = total + lam[..., None] * c
        elif l.type == "point":
            p = jnp.asarray(l.position, jnp.float32)
            to_l = p - points
            d2 = jnp.maximum(jnp.sum(to_l * to_l, axis=-1), 1e-6)
            wl = to_l / jnp.sqrt(d2)[..., None]
            lam = jnp.maximum(jnp.sum(normals * wl, axis=-1), 0.0)
            total = total + (lam / d2)[..., None] * c
        else:
            raise ValueError(l.type)
    return base_color * total


@partial(
    jax.jit,
    static_argnames=("width", "height", "lights", "chunk", "perspective_correct",
                     "cull_backfaces"),
)
def rasterize(
    vertices,        # (V, 3) world/object-space positions
    faces,           # (F, 3) i32
    normals,         # (V, 3) per-vertex normals (world space)
    uvs,             # (V, 2)
    model,           # (4, 4) local -> world
    view,            # (4, 4) world -> camera
    proj,            # (4, 4) camera -> clip
    texture,         # (TH, TW, 3) or None-like ones
    width: int,
    height: int,
    lights: tuple = (RasterLight("ambient", (0.15, 0.15, 0.15)),
                     RasterLight("directional", (0.9, 0.9, 0.9), (0, -1, -1))),
    chunk: int = 64,
    perspective_correct: bool = False,
    cull_backfaces: bool = True,
    background=(0.0, 0.0, 0.0),
):
    """Render one frame. Returns (height, width, 3) f32 colors in [0, ~]."""
    V = vertices.shape[0]
    F = faces.shape[0]

    # --- vertex stage: local -> world -> clip -> NDC -> screen ---
    # float32 products pinned to full precision: a GPU would otherwise run
    # them in TF32 and move vertices by ~1e-3 relative, i.e. pixel edges
    mm = partial(jnp.matmul, precision=lax.Precision.HIGHEST)
    vh = jnp.concatenate([vertices, jnp.ones((V, 1), jnp.float32)], axis=1)
    world = mm(vh, model.T)
    clip = mm(mm(world, view.T), proj.T)
    w = jnp.where(jnp.abs(clip[:, 3:4]) > 1e-8, clip[:, 3:4], 1e-8)
    ndc = clip[:, :3] / w
    sx = (ndc[:, 0] * 0.5 + 0.5) * width
    sy = (0.5 - ndc[:, 1] * 0.5) * height  # y down, row 0 = top
    sz = ndc[:, 2]
    inv_w = 1.0 / w[:, 0]

    nrm_w = mm(normals, jnp.linalg.inv(model[:3, :3]).T)  # normal matrix
    world3 = world[:, :3]

    # pad faces to a chunk multiple with degenerate (index 0) tris
    Fp = ((F + chunk - 1) // chunk) * chunk
    fpad = jnp.zeros((Fp, 3), jnp.int32)
    fpad = fpad.at[:F].set(faces.astype(jnp.int32))
    valid_face = jnp.arange(Fp) < F

    px = jnp.arange(width, dtype=jnp.float32) + 0.5
    py = jnp.arange(height, dtype=jnp.float32) + 0.5
    PX = jnp.tile(px[None, :], (height, 1)).reshape(-1)  # (P,)
    PY = jnp.repeat(py, width)

    def face_corners(arr, f):
        return arr[f[:, 0]], arr[f[:, 1]], arr[f[:, 2]]

    n_chunks = Fp // chunk
    f_chunks = fpad.reshape(n_chunks, chunk, 3)
    v_chunks = valid_face.reshape(n_chunks, chunk)

    def rasterize_chunk(carry, xs):
        """One triangle chunk vs. all pixels: edge-function coverage, z test,
        keep the per-pixel winner (reference `DrawTrangle` barycentric fill,
        `Core/Pipeline.fs:40-65`, as a dense masked update)."""
        zbuf, tri_best, b_u, b_v, base = carry
        f, vmask = xs
        x0, x1, x2 = face_corners(sx, f)
        y0, y1, y2 = face_corners(sy, f)
        z0, z1, z2 = face_corners(sz, f)
        area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
        if cull_backfaces:
            front = area < 0.0
        else:
            front = jnp.abs(area) > 1e-12
        inv_area = jnp.where(jnp.abs(area) > 1e-8, 1.0 / area, 0.0)
        dx = PX[:, None]
        dy = PY[:, None]
        w0 = ((x1 - dx) * (y2 - dy) - (x2 - dx) * (y1 - dy)) * inv_area[None]
        w1 = ((x2 - dx) * (y0 - dy) - (x0 - dx) * (y2 - dy)) * inv_area[None]
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        z = w0 * z0[None] + w1 * z1[None] + w2 * z2[None]
        ok = inside & front[None] & vmask[None] & (z > -1) & (z < 1) & (z < zbuf[:, None])
        z = jnp.where(ok, z, jnp.inf)
        arg = jnp.argmin(z, axis=1)
        take = lambda a: jnp.take_along_axis(a, arg[:, None], axis=1)[:, 0]
        znew = take(z)
        better = jnp.isfinite(znew) & (znew < zbuf)
        gid = base + arg.astype(jnp.int32)
        return (
            jnp.where(better, znew, zbuf),
            jnp.where(better, gid, tri_best),
            jnp.where(better, take(w0), b_u),
            jnp.where(better, take(w1), b_v),
            base + chunk,
        ), None

    P = width * height
    init = (
        jnp.full((P,), jnp.inf, jnp.float32),
        jnp.full((P,), -1, jnp.int32),
        jnp.zeros((P,), jnp.float32),
        jnp.zeros((P,), jnp.float32),
        jnp.int32(0),
    )
    (zbuf, tri_best, b0, b1, _), _ = lax.scan(
        rasterize_chunk, init, (f_chunks, v_chunks)
    )

    # --- attribute stage: gather the winning triangle per pixel ---
    hit = tri_best >= 0
    ti = jnp.clip(tri_best, 0, Fp - 1)
    f = fpad[ti]
    b2 = 1.0 - b0 - b1

    if perspective_correct:
        iw0, iw1, iw2 = inv_w[f[:, 0]], inv_w[f[:, 1]], inv_w[f[:, 2]]
        denom = jnp.maximum(b0 * iw0 + b1 * iw1 + b2 * iw2, 1e-12)
        c0, c1, c2 = b0 * iw0 / denom, b1 * iw1 / denom, b2 * iw2 / denom
    else:
        c0, c1, c2 = b0, b1, b2  # affine, like the reference's DrawTrangle

    def interp(attr):
        a0, a1, a2 = attr[f[:, 0]], attr[f[:, 1]], attr[f[:, 2]]
        return c0[:, None] * a0 + c1[:, None] * a1 + c2[:, None] * a2

    pts = interp(world3)
    nrm = normalize(interp(nrm_w))
    uv = interp(uvs)

    # nearest texture sample (reference `Texture2D`, `Core/Texture.fs:11-28`)
    TH, TW = texture.shape[0], texture.shape[1]
    tx = jnp.clip((uv[:, 0] % 1.0) * (TW - 1), 0, TW - 1).astype(jnp.int32)
    ty = jnp.clip(((1.0 - uv[:, 1]) % 1.0) * (TH - 1), 0, TH - 1).astype(jnp.int32)
    base_color = texture[ty, tx]

    color = _shade(lights, pts, nrm, base_color)
    bg = jnp.asarray(background, jnp.float32)
    out = jnp.where(hit[:, None], color, bg)
    return out.reshape(height, width, 3)
