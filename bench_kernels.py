"""Time the cluster-walk search kernels against the plain jnp scan.

    python bench_kernels.py [--rays N]

On the spot- and Renault-sized box-field stand-ins
(`scene.builtin.box_field`), with chip_smoke.py's 2^19-ray wavefront
(camera rays + cosine bounce rays from the first hits), times
  - closest-hit: `ops.intersect_pallas.find_closest` (cull + kernel +
    mega/sphere merge) against `geometry.intersect.find_closest`;
  - any-hit: `ops.intersect_pallas.occluded` against
    `geometry.intersect.occluded`, with per-ray t_max at 0.5-1.5x the
    closest hit;
  - the cull alone (`ops.intersect_pallas._prep`).
Each number is the median of several calls after a warm-up, on the host
clock around `block_until_ready`. Prints one JSON line per measurement and
refuses to run without a GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402
from mafrixraytracing_tpu.core.v3 import V3  # noqa: E402
from mafrixraytracing_tpu.geometry import intersect as isect  # noqa: E402
from mafrixraytracing_tpu.ops import intersect_pallas as ip  # noqa: E402
from mafrixraytracing_tpu.scene import builtin  # noqa: E402
from mafrixraytracing_tpu.scene.compiler import compile_scene  # noqa: E402

T_MIN = chip_smoke.T_MIN


def time_call(fn, *args, reps: int = 7) -> float:
    """Median seconds per call after one warm-up (compile) call."""
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def _cull_only(scene, rays, t_max):
    """The cull (and mega prepass) of a closest-hit query, no walk."""
    o, d = V3.of(rays.origin), V3.of(rays.direction)
    return ip._prep(scene, o, d, T_MIN, 1e8)[3]


def search_fns():
    """Fresh jitted (kernel closest, scan closest, kernel any, scan any,
    cull) callables — fresh so module constants are re-read at trace."""
    return {
        "closest_kernel": jax.jit(
            lambda s, r, tm: ip.find_closest(s, r, T_MIN, 1e8)),
        "closest_scan": jax.jit(
            lambda s, r, tm: isect.find_closest(s, r, T_MIN, 1e8)),
        "anyhit_kernel": jax.jit(
            lambda s, r, tm: ip.occluded(s, r, T_MIN, tm)),
        "anyhit_scan": jax.jit(
            lambda s, r, tm: isect.occluded(s, r, T_MIN, tm)),
        "cull": jax.jit(_cull_only),
    }


def stand_in_inputs(n_tris: int, n_rays: int):
    cs = compile_scene(builtin.box_field(n_tris, 512, 512))
    rays = chip_smoke.search_rays(cs.scene, cs.camera, n_rays)
    t, idx = isect.find_closest(cs.scene, rays, T_MIN, 1e8)
    u = jax.random.uniform(jax.random.key(7), t.shape, minval=0.5,
                           maxval=1.5)
    t_max = jnp.where(idx >= 0, t * u, 1e8).astype(jnp.float32)
    return cs.scene, rays, t_max


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rays", type=int, default=1 << 19)
    args = ap.parse_args(argv)
    if jax.default_backend() != "gpu":
        print("bench_kernels: no GPU", file=sys.stderr)
        return 2
    from mafrixraytracing_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices()), "card": chip_smoke.card_line()}
    for n_tris, tag in ((builtin.SPOT_TRIS, "spot_standin"),
                        (builtin.RENAULT_TRIS, "renault_standin")):
        scene, rays, t_max = stand_in_inputs(n_tris, args.rays)
        for name, fn in search_fns().items():
            sec = time_call(fn, scene, rays, t_max)
            print(json.dumps({"scene": tag, "rays": args.rays,
                              "measure": name, "seconds": sec,
                              "block": ip.BLOCK, "device": device}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
