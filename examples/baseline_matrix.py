"""Render the BASELINE.md forward-correctness config matrix end-to-end and
record artifacts (PNG + JSON log) under artifacts/ at the repository root.

    python examples/baseline_matrix.py [--quick]

Configs (BASELINE.md): Cornell 256^2 @ 16 spp, Cube 512^2 @ 64 spp,
Renault12TL 1024^2 @ 256 spp (the Renault entry takes minutes; --quick
drops it). Prints per-scene wall seconds + mean radiance and writes
artifacts/RESULTS.json.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

from mafrixraytracing_tpu.film.image import write_png
from mafrixraytracing_tpu.film.tonemap import to_bytes, tonemap
from mafrixraytracing_tpu.integrator.path import PathTracerConfig, render_image
from mafrixraytracing_tpu.scene import assets
from mafrixraytracing_tpu.scene.builtin import cornell_box
from mafrixraytracing_tpu.scene.compiler import compile_scene
from mafrixraytracing_tpu.utils.cache import REPO_ROOT, enable_compile_cache

ART = os.path.join(REPO_ROOT, "artifacts")


def run(name, cs, w, h, spp, depth=5, passes=1):
    """Render w x h at `spp` total samples; `passes > 1` accumulates the
    frame progressively over several device launches (the Film design —
    also bounds the memory of each launch for the 1024^2 @ 256 spp Renault
    config)."""
    cfg = PathTracerConfig(max_depth=depth)
    per = spp // passes
    t0 = time.perf_counter()
    acc = None
    for p in range(passes):
        img = render_image(cs.scene, cs.camera, w, h, per,
                           jax.random.key(1 + p), cfg)
        img = np.asarray(jax.block_until_ready(img))
        acc = img if acc is None else acc + img
    img = acc / passes
    dt = time.perf_counter() - t0
    path = os.path.join(ART, f"{name}_{w}x{h}_spp{spp}.png")
    write_png(path, np.asarray(to_bytes(tonemap(img))))
    rec = {"scene": name, "width": w, "height": h, "spp": spp, "depth": depth,
           "seconds": dt, "mean_radiance": float(img.mean()),
           "finite": bool(np.isfinite(img).all()), "png": os.path.basename(path)}
    print(json.dumps(rec))
    return rec


def main():
    enable_compile_cache()
    quick = "--quick" in sys.argv
    os.makedirs(ART, exist_ok=True)
    results = []
    results.append(run("cornell", compile_scene(cornell_box()), 256, 256, 16))
    if assets.have_reference_assets():
        results.append(run("cube", compile_scene(assets.cube_scene(512, 512)),
                           512, 512, 64))
        if not quick:
            results.append(
                run("renault", compile_scene(assets.renault_scene(1024, 1024)),
                    1024, 1024, 256, passes=16)
            )
    with open(os.path.join(ART, "RESULTS.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {len(results)} artifacts -> {ART}")


if __name__ == "__main__":
    main()
