"""Scaling-efficiency harness: render + train-step throughput at 1/2/4/8
devices (BASELINE.md: >= 85% efficiency 1 -> 4 hosts).

On a one-chip environment run it on the virtual CPU mesh:
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python bench_scaling.py

IMPORTANT: virtual host-platform devices TIMESHARE the same physical CPU
cores (and XLA already uses all cores intra-op at 1 device), so wall-clock
"efficiency" on the virtual mesh reflects core sharing, NOT interconnect
scaling — results carry "virtual_mesh": true and must not be read against
the 85% target. What the virtual run does validate: the sharded program
compiles, collectives execute, and per-device-count outputs are
bit-identical (tests/test_sharding.py). On real multi-chip/multi-host
hardware the same harness reports true interconnect scaling.
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from mafrixraytracing_tpu.integrator.path import PathTracerConfig  # noqa: E402
from mafrixraytracing_tpu.opt import inverse  # noqa: E402
from mafrixraytracing_tpu.parallel.mesh import make_mesh  # noqa: E402
from mafrixraytracing_tpu.parallel.render import render_image_sharded  # noqa: E402
from mafrixraytracing_tpu.scene.builtin import cornell_box  # noqa: E402
from mafrixraytracing_tpu.scene.compiler import compile_scene  # noqa: E402


def main():
    W = int(os.environ.get("SCALE_WIDTH", 64))
    H = int(os.environ.get("SCALE_HEIGHT", 64))
    SPP = int(os.environ.get("SCALE_SPP", 4))
    DEPTH = int(os.environ.get("SCALE_DEPTH", 3))
    cfg = PathTracerConfig(max_depth=DEPTH, rr_enable=False,
                           backend=os.environ.get("SCALE_BACKEND", "auto"))
    cs = compile_scene(cornell_box(width=W, height=H))
    scene, camera = cs.scene, cs.camera
    counts = [n for n in (1, 2, 4, 8) if n <= len(jax.devices())]
    virtual = jax.default_backend() == "cpu"
    results = {}
    for n in counts:
        mesh = make_mesh(n)
        fn = lambda key: render_image_sharded(scene, camera, mesh, W, H, SPP, key, cfg)
        img = jax.block_until_ready(fn(jax.random.key(0)))  # compile
        iters = 3
        t0 = time.perf_counter()
        for i in range(iters):
            img = fn(jax.random.key(i + 1))
        jax.block_until_ready(img)
        dt = (time.perf_counter() - t0) / iters
        rays = W * H * SPP * DEPTH  # upper-bound accounting, constant across n
        results[n] = rays / dt
        print(json.dumps({
            "metric": "scaling_render_rays_per_s", "devices": n,
            "value": rays / dt, "seconds_per_frame": dt,
            "virtual_mesh": virtual,
        }), flush=True)

    base = results[counts[0]]
    for n in counts[1:]:
        eff = results[n] / (base * n)
        print(json.dumps({
            "metric": "scaling_efficiency", "devices": n,
            "value": eff, "vs_target": eff / 0.85,
            "virtual_mesh": virtual,
            **({"note": "virtual devices timeshare one host's cores; "
                        "not an interconnect-scaling measurement"}
               if virtual else {}),
        }), flush=True)

    # one train step (grad + psum all-reduce) at max device count
    mesh = make_mesh(counts[-1])
    target = jax.block_until_ready(
        render_image_sharded(scene, camera, mesh, W, H, SPP, jax.random.key(9), cfg))
    opt = optax.adam(1e-2)
    params = inverse.extract_params(scene, ("mat_albedo",))
    step = inverse.make_train_step(mesh, opt, W, H, SPP, cfg)
    st = opt.init(params)
    out = step(params, st, scene, camera, target, jax.random.key(1))
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for i in range(3):
        out = step(params, st, scene, camera, target, jax.random.key(i + 2))
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / 3
    print(json.dumps({
        "metric": "train_step_seconds", "devices": counts[-1], "value": dt,
    }), flush=True)


if __name__ == "__main__":
    main()
