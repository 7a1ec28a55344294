"""Rasterizer demo: the spot cow with its texture through the
fixed-function pipeline — the reference's `DrawCarWithTexture` sample
(`RenderTest/Sample/DrawWithTexture.fs:14-43`: spot OBJ + texture +
turntable rotation through `PipelineDraw`), its dead display loop replaced
by PNG frames (north star: window -> array output).

Usage:
    python examples/rasterize_spot.py [out.png] [--size WxH] [--angle DEG]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp
import numpy as np

from mafrixraytracing_tpu.film.image import write_png
from mafrixraytracing_tpu.io.obj import load_obj
from mafrixraytracing_tpu.raster import pipeline as R
from mafrixraytracing_tpu.scene import assets


def main():
    from mafrixraytracing_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    out = sys.argv[1] if len(sys.argv) > 1 and not sys.argv[1].startswith("--") \
        else "/tmp/spot_raster.png"
    size = "512x512"
    angle = 150.0
    for i, a in enumerate(sys.argv):
        if a == "--size" and i + 1 < len(sys.argv):
            size = sys.argv[i + 1]
        if a == "--angle" and i + 1 < len(sys.argv):
            angle = float(sys.argv[i + 1])
    W, H = (int(x) for x in size.split("x"))

    model = load_obj(assets.SPOT_OBJ)
    mesh = model.mesh()
    v = np.asarray(mesh.vertices, np.float32)
    faces = np.asarray(mesh.faces, np.int32)

    # per-vertex normals: area-weighted accumulation of face normals
    fv = v[faces]
    fn = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
    normals = np.zeros_like(v)
    for k in range(3):
        np.add.at(normals, faces[:, k], fn)
    normals /= np.maximum(np.linalg.norm(normals, axis=1, keepdims=True), 1e-12)

    # OBJ uvs are per-corner; the rasterizer wants per-vertex — re-index the
    # mesh so each (vertex, uv) pair is unique (spot's uvs are vertex-aligned
    # enough that first-wins is visually fine, like the reference's loader)
    uvs = np.zeros((v.shape[0], 2), np.float32)
    if mesh.uvs is not None and mesh.face_uvs is not None:
        src = np.asarray(mesh.uvs, np.float32)
        fu = np.asarray(mesh.face_uvs, np.int64)
        for c in range(3):
            uvs[faces[:, c]] = src[fu[:, c]]

    tex = assets.load_texture(
        os.path.join(assets.REFERENCE_ASSETS, "spot", "spot_texture.png")
    )
    texture = jnp.asarray(tex if tex is not None else np.ones((2, 2, 3), np.float32))

    th = np.deg2rad(angle)
    rot = np.array(
        [[np.cos(th), 0, np.sin(th), 0], [0, 1, 0, 0],
         [-np.sin(th), 0, np.cos(th), 0], [0, 0, 0, 1]], np.float32,
    )
    view = R.look_at((0.0, 0.3, 2.2), (0.0, 0.0, 0.0))
    proj = R.perspective(40.0, W / H, near=0.2, far=20.0)

    img = R.rasterize(
        jnp.asarray(v), jnp.asarray(faces), jnp.asarray(normals),
        jnp.asarray(uvs), jnp.asarray(rot), view, proj, texture, W, H,
        lights=(R.RasterLight("ambient", (0.35, 0.35, 0.35)),
                R.RasterLight("directional", (0.9, 0.9, 0.9), (-0.3, -1.0, -0.6))),
        perspective_correct=True,
        background=(0.08, 0.09, 0.12),
    )
    rgb = np.clip(np.asarray(img), 0.0, 1.0)
    write_png(out, (rgb * 255.99).astype(np.uint8))
    print(f"wrote {out} ({W}x{H}, angle {angle})")


if __name__ == "__main__":
    main()
