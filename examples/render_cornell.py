"""Render the Cornell-box flagship scene to PNG — the array-program analog of
the reference's `DoRayTrace4` demo (`RenderTest/Sample/RayTracing4.fs:7-80`),
with progressive accumulation and periodic dumps instead of an ImGui window.

Usage: python examples/render_cornell.py [out.png] [--spp N] [--size WxH]
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
from mafrixraytracing_tpu.scene.builtin import cornell_box
from mafrixraytracing_tpu.scene.compiler import compile_scene


def main():
    from mafrixraytracing_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default="cornell.png")
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--size", default="300x300")
    ap.add_argument("--dump-every", type=int, default=16)
    ap.add_argument("--preview-port", type=int, default=None,
                    help="serve a live auto-refreshing preview at "
                         "http://127.0.0.1:PORT/ while rendering (the "
                         "array-output analog of the reference's ImGui "
                         "window, Core/Film.fs:38-92)")
    args = ap.parse_args()
    W, H = (int(x) for x in args.size.split("x"))

    cs = compile_scene(cornell_box(width=W, height=H))
    config = PathTracerConfig()
    key = jax.random.key(0)

    step = jax.jit(
        lambda s, c, i: render_sample_batch(s, c, W, H, i, key, config)
    )
    film = FilmState.create(H, W)
    preview = None
    if args.preview_port is not None:
        from mafrixraytracing_tpu.film.preview import LivePreview

        preview = LivePreview(args.out, http_port=args.preview_port)
        print(f"live preview: http://127.0.0.1:{preview.port}/")
    t0 = time.time()
    for s in range(args.spp):
        frame = step(cs.scene, cs.camera, s).reshape(H, W, 3)
        film = film.add_frame(frame)
        if preview is not None:
            preview.update(np.asarray(film.to_bytes()))
        if (s + 1) % args.dump_every == 0 or s + 1 == args.spp:
            if preview is None:
                write_png(args.out, np.asarray(film.to_bytes()))
            rate = W * H * (s + 1) / (time.time() - t0)
            print(f"spp {s+1}/{args.spp}  {rate/1e6:.2f} Mpaths/s  -> {args.out}")


if __name__ == "__main__":
    main()
