"""Benchmark: rays/s per device, forward+backward, on one scene.

Prints ONE JSON line: {"metric", "value", "unit", "device", "detail"}.

Ray accounting: a "ray" is one traced query — closest-hit or shadow — as is
standard for path-tracer throughput. Query counts are measured (not bounded)
by an instrumented forward pass at 1 spp, then scaled by spp; the timed run
does forward + backward (gradient w.r.t. material albedo, light radiance,
and vertex positions).

Env knobs: BENCH_WIDTH/HEIGHT (default 256), BENCH_SPP (default 64),
BENCH_DEPTH (default 5), BENCH_SCENE (spot|cube|renault|cornell|
spot_standin|renault_standin). The reference meshes load only when their
assets are present; without them the spot and renault rows use their
box-field stand-ins (`scene.builtin.box_field`) and the JSON says so.
"""
from __future__ import annotations

import json
import os
import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from mafrixraytracing_tpu.core import rng  # noqa: E402
from mafrixraytracing_tpu.integrator import path as P  # noqa: E402
from mafrixraytracing_tpu.scene.compiler import compile_scene  # noqa: E402

def build_scene(width, height, name=None):
    """Compile the BENCH_SCENE scene; returns (compiled scene, name of the
    scene that was actually built)."""
    name = name or os.environ.get("BENCH_SCENE", "spot")
    from mafrixraytracing_tpu.scene import assets, builtin

    if name in ("spot", "cube", "renault") and assets.have_reference_assets():
        builder = {
            "spot": assets.spot_scene,
            "cube": assets.cube_scene,
            "renault": assets.renault_scene,
        }[name]
        return compile_scene(builder(width, height)), name
    if name in ("spot", "spot_standin"):
        return compile_scene(builtin.box_field(builtin.SPOT_TRIS, width,
                                               height)), "spot_standin"
    if name in ("renault", "renault_standin"):
        return compile_scene(builtin.box_field(builtin.RENAULT_TRIS, width,
                                               height)), "renault_standin"
    if name != "cornell":
        raise ValueError(f"unknown BENCH_SCENE {name!r}")
    return compile_scene(builtin.cornell_box(width=width,
                                             height=height)), "cornell"


def count_queries_per_sample(scene, camera, width, height, config,
                             profile=False):
    """Instrumented 1-spp pass: measured closest-hit + shadow queries
    (optionally plus the per-bounce live-fraction profile)."""
    px, py = P.make_pixel_uv(width, height)
    B = px.shape[0]
    keys = rng.pixel_keys(jax.random.key(123), B)
    u = (px + 0.5) / width
    v = (py + 0.5) / height
    rays = camera.get_rays(u, v)

    @jax.jit
    def stats(scene, rays):
        return P.trace_stats(scene, rays, keys, config,
                             return_profile=profile)

    out = stats(scene, rays)
    if profile:
        q, prof = out
        return float(q), [float(p) for p in prof]
    return float(out)


def calibrated_config(scene, camera, width, height, depth):
    """Build the bench config: measure the per-bounce survival profile and
    size the compaction buckets with 25% headroom (+2% floor) so the
    unbiased population-control kill stays a rare safety valve. The query
    numerator is then re-measured WITH the final schedule (trace_stats
    mirrors the kills), keeping the rays/s accounting honest.
    BENCH_COMPACT=0 disables compaction."""
    wavefront = int(os.environ.get("BENCH_WAVEFRONT", str(1 << 19)))
    base = P.PathTracerConfig(max_depth=depth, wavefront=wavefront)
    _, prof = count_queries_per_sample(
        scene, camera, width, height, base, profile=True
    )
    if os.environ.get("BENCH_COMPACT", "1") != "1" or depth < 2:
        return base, prof
    headroom = float(os.environ.get("BENCH_HEADROOM", "1.12"))
    sched = [1.0] + [
        min(1.0, p * headroom + 0.01) for p in prof[1:]
    ]
    import dataclasses

    return dataclasses.replace(base, compact=tuple(sched)), prof


def make_grad_fn(scene, camera, width, height, spp, config):
    """jit(grad of the mean image w.r.t. (mat_albedo, light_radiance,
    tri_v0)) — the forward + backward unit of work the bench times. Called
    as grad_fn(albedo, radiance, tri_v0, key)."""

    def loss_fn(albedo, radiance, tri_v0, key):
        s = scene.replace(
            mat_albedo=albedo, light_radiance=radiance, tri_v0=tri_v0
        )
        img = P.render_image(s, camera, width, height, spp, key, config)
        return jnp.mean(img)

    return jax.jit(jax.grad(loss_fn, argnums=(0, 1, 2)))


def time_grad(grad_fn, scene, n_iters):
    """Mean seconds per forward+backward after one warm-up call."""
    args = (scene.mat_albedo, scene.light_radiance, scene.tri_v0)
    jax.block_until_ready(grad_fn(*args, jax.random.key(0)))
    t0 = time.perf_counter()
    for i in range(n_iters):
        g = grad_fn(*args, jax.random.key(i + 1))
    jax.block_until_ready(g)
    return (time.perf_counter() - t0) / n_iters, g


def main():
    from mafrixraytracing_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    width = int(os.environ.get("BENCH_WIDTH", 256))
    height = int(os.environ.get("BENCH_HEIGHT", 256))
    spp = int(os.environ.get("BENCH_SPP", 64))
    depth = int(os.environ.get("BENCH_DEPTH", 5))

    cs, scene_name = build_scene(width, height)
    scene, camera = cs.scene, cs.camera
    config, survival = calibrated_config(scene, camera, width, height, depth)

    queries_per_spp = count_queries_per_sample(
        scene, camera, width, height, config
    )
    total_rays = queries_per_spp * spp

    grad_fn = make_grad_fn(scene, camera, width, height, spp, config)
    dt, _ = time_grad(grad_fn, scene, int(os.environ.get("BENCH_ITERS", 3)))

    rays_per_s = total_rays / dt
    dev = jax.devices()[0]
    print(
        json.dumps(
            {
                "metric": "rays_per_s_fwd_bwd",
                "value": rays_per_s,
                "unit": "rays/s",
                "device": {"platform": dev.platform,
                           "kind": dev.device_kind,
                           "count": len(jax.devices())},
                "detail": {
                    "scene": scene_name,
                    "width": width,
                    "height": height,
                    "spp": spp,
                    "depth": depth,
                    "queries_per_spp": queries_per_spp,
                    "seconds_per_iter": dt,
                    "backend": jax.default_backend(),
                    "compact": list(config.compact),
                    "survival": [round(s, 4) for s in survival],
                },
            }
        )
    )


if __name__ == "__main__":
    main()
