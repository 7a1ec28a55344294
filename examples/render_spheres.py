"""Render the three-sphere RTIOW-style hero shot (lambert / metal /
dielectric) — the array-program analog of the reference's disabled
`DoRayTrace` sample (`RenderTest/Sample/RayTracing.fs:417-474`), whose
render loop was dead code after the OpenCVSharp removal. Ours runs.

Usage: python examples/render_spheres.py [out.png] [--spp N] [--size WxH]
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
import numpy as np

from mafrixraytracing_tpu.film.film import FilmState
from mafrixraytracing_tpu.film.image import write_png
from mafrixraytracing_tpu.integrator.path import (
    PathTracerConfig,
    render_sample_batch,
)
from mafrixraytracing_tpu.scene.builtin import sphere_triad
from mafrixraytracing_tpu.scene.compiler import compile_scene


def main():
    from mafrixraytracing_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default="spheres.png")
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--size", default="400x200")
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--dump-every", type=int, default=16)
    args = ap.parse_args()
    W, H = (int(x) for x in args.size.split("x"))

    cs = compile_scene(sphere_triad(width=W, height=H))
    # sky background like the sample's gradient miss shader, flat here
    scene = cs.scene.replace(background=np.array([0.5, 0.7, 1.0], np.float32))
    config = PathTracerConfig(max_depth=args.depth)
    key = jax.random.key(0)

    step = jax.jit(
        lambda s, c, i: render_sample_batch(s, c, W, H, i, key, config)
    )
    film = FilmState.create(H, W)
    t0 = time.time()
    for s in range(args.spp):
        frame = step(scene, cs.camera, s).reshape(H, W, 3)
        film = film.add_frame(frame)
        if (s + 1) % args.dump_every == 0 or s + 1 == args.spp:
            write_png(args.out, np.asarray(film.to_bytes()))
            rate = W * H * (s + 1) / (time.time() - t0)
            print(f"spp {s+1}/{args.spp}  {rate/1e6:.2f} Mpaths/s  -> {args.out}")


if __name__ == "__main__":
    main()
