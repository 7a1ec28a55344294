"""Intersection backend dispatch: Pallas cluster-walk kernels vs. jnp.

The jnp path (`geometry.intersect`) is always correct and differentiable;
the Pallas path accelerates the closest-hit *search* on the GPU and reuses
the same differentiable attribute recompute for gradients.

- `backend="auto"`: the kernels on `gpu` when the scene fits them, jnp
  everywhere else (on `cpu` the kernels would only run interpreted).
- `backend="pallas"`: the kernels, compiled on `gpu` and interpreted on
  `cpu`; a scene they cannot take raises instead of falling back.
- `backend="jnp"`: the dense reference scan.

Search results are tagged with `checkpoint_name` ('isect_t', 'isect_idx',
'occluded'): under `jax.checkpoint(policy=save_only_these_names(...))`
(see `integrator.path`) the backward pass reuses the saved search results
instead of re-running the kernels — rematerialization then only re-executes
the cheap shading math, not the O(rays x clusters) traversal.
"""
from __future__ import annotations

import jax
from jax.ad_checkpoint import checkpoint_name

from mafrixraytracing_tpu.core.types import Rays
from mafrixraytracing_tpu.geometry import intersect as isect

ISECT_NAMES = ("isect_t", "isect_idx", "occluded")


def _use_pallas(scene, backend: str) -> bool:
    if backend == "jnp":
        return False
    from mafrixraytracing_tpu.ops import intersect_pallas

    ok = intersect_pallas.supports(scene)
    if backend == "pallas":
        if not ok:
            raise ValueError(
                "backend='pallas' needs a clustered scene (triangle count a "
                "multiple of 128 with one AABB per 128 triangles); compile "
                "it with scene.compiler.compile_scene"
            )
        return True
    if backend != "auto":
        raise ValueError(f"unknown intersection backend {backend!r}")
    return ok and jax.default_backend() == "gpu"


def intersect_scene(scene, rays: Rays, t_min, t_max, chunk=1024, backend="auto"):
    if _use_pallas(scene, backend):
        from mafrixraytracing_tpu.ops import intersect_pallas

        t, idx = intersect_pallas.find_closest(scene, rays, t_min, t_max)
    else:
        t, idx = isect.find_closest(scene, rays, t_min, t_max, chunk=chunk)
    t = checkpoint_name(t, "isect_t")
    idx = checkpoint_name(idx, "isect_idx")
    return isect.hit_attributes(scene, rays, idx, t)


def intersect_shade(scene, rays: Rays, t_min, t_max, chunk=1024, backend="auto"):
    """Closest-hit query returning (Hit, Shading) via the packed one-gather
    attribute fetch (`geometry.intersect.hit_attributes_packed`) — the fast
    path used by the integrators."""
    if _use_pallas(scene, backend):
        from mafrixraytracing_tpu.ops import intersect_pallas

        t, idx = intersect_pallas.find_closest(scene, rays, t_min, t_max)
    else:
        t, idx = isect.find_closest(scene, rays, t_min, t_max, chunk=chunk)
    t = checkpoint_name(t, "isect_t")
    idx = checkpoint_name(idx, "isect_idx")
    return isect.hit_attributes_packed(scene, rays, idx, t)


def occluded(scene, rays: Rays, t_min, t_max, chunk=1024, backend="auto"):
    if _use_pallas(scene, backend):
        from mafrixraytracing_tpu.ops import intersect_pallas

        occ = intersect_pallas.occluded(scene, rays, t_min, t_max)
    else:
        occ = isect.occluded(scene, rays, t_min, t_max, chunk=chunk)
    return checkpoint_name(occ, "occluded")


def intersect_shade_soa(scene, o, d, t_min, t_max, chunk=1024, backend="auto",
                        times=None, packed=None):
    """SoA closest-hit query -> (HitS, ShadingS); o, d are V3 of (B,)
    columns (the hot integrator path — see core.v3). `times` (B,) enables
    sphere motion blur."""
    if _use_pallas(scene, backend):
        from mafrixraytracing_tpu.ops import intersect_pallas

        t, idx = intersect_pallas.find_closest_soa(scene, o, d, t_min, t_max,
                                                   times=times)
    else:
        t, idx = isect.find_closest(
            scene, Rays(origin=o.arr(), direction=d.arr()), t_min, t_max,
            chunk=chunk, times=times,
        )
    t = checkpoint_name(t, "isect_t")
    idx = checkpoint_name(idx, "isect_idx")
    return isect.hit_attributes_soa(scene, o, d, idx, t, times=times,
                                    packed=packed)


def occluded_soa(scene, o, d, t_min, t_max, chunk=1024, backend="auto",
                 times=None):
    """SoA any-hit query; o, d are V3 columns."""
    if _use_pallas(scene, backend):
        from mafrixraytracing_tpu.ops import intersect_pallas

        occ = intersect_pallas.occluded_soa(scene, o, d, t_min, t_max,
                                            times=times)
    else:
        occ = isect.occluded(
            scene, Rays(origin=o.arr(), direction=d.arr()), t_min, t_max,
            chunk=chunk, times=times,
        )
    return checkpoint_name(occ, "occluded")
