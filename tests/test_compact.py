"""Wavefront compaction (round 5): correctness of the packed bounce loop.

Key invariant: when the per-bounce buckets are large enough that no
population-control kill triggers, compaction is a pure permutation of the
wavefront — per-lane radiance must match the uncompacted scan to 1 ULP
(sorts move values, never combine them; the only permitted deviation is
XLA fusing/FMA-contracting the same math differently at the smaller
wavefront shapes). When buckets force kills, the live/K reweighting keeps
the estimator unbiased — checked as converged-mean agreement.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np

from mafrixraytracing_tpu.core import rng
from mafrixraytracing_tpu.core.types import Rays
from mafrixraytracing_tpu.integrator.path import (
    PathTracerConfig,
    compact_buckets,
    render_image,
    trace_radiance,
    trace_stats,
)
from mafrixraytracing_tpu.scene import spec as S
from mafrixraytracing_tpu.scene.builtin import cornell_box
from mafrixraytracing_tpu.scene.compiler import compile_scene


def _floor_scene():
    floor = S.make_rect_mesh((-10, 0, 10), (10, 0, 10), (10, 0, -10), (-10, 0, -10))
    light = S.make_rect_mesh((-0.4, 2, -0.4), (0.4, 2, -0.4), (0.4, 2, 0.4), (-0.4, 2, 0.4))
    spec = S.SceneSpec(
        materials=[S.MaterialSpec(albedo=(0.6, 0.6, 0.6))],
        shapes=[S.ShapeSpec(floor, 0)],
        area_lights=[S.AreaLightSpec(light, radiance=(10.0,) * 3, visible=False)],
    )
    return compile_scene(spec).scene


def _down_rays(n):
    o = jnp.tile(jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32), (n, 1))
    d = jnp.tile(jnp.array([[0.0, -1.0, 0.0]]), (n, 1))
    return Rays(origin=o, direction=d)


def test_buckets_static_schedule():
    cfg = PathTracerConfig(max_depth=4, compact=(1.0, 0.5, 0.5, 0.25))
    from mafrixraytracing_tpu.ops.intersect_pallas import BLOCK

    def up(n):
        return -(-n // BLOCK) * BLOCK

    assert compact_buckets(cfg, 1 << 19) == [524288, 262144, 262144, 131072]
    # batches below one intersector block round without the alignment
    assert BLOCK > 4 and compact_buckets(cfg, 4) == [4, 2, 2, 1]
    # rounded up to the intersector block, non-increasing
    assert compact_buckets(cfg, 3000) == [3000, up(1500), up(1500), up(750)]
    assert compact_buckets(cfg, 3000)[1] % BLOCK == 0


def test_compaction_bit_exact_when_no_kills():
    """Open floor scene: almost no rays survive bounce 1, so generous late
    buckets never overflow -> compaction must reproduce the uncompacted
    radiance per lane (to reassociation ULPs)."""
    scene = _floor_scene()
    n = 256
    rays = _down_rays(n)
    keys = rng.pixel_keys(jax.random.key(0), n)
    base = PathTracerConfig(backend="jnp", max_depth=4, rr_enable=False)
    cfg = replace(base, compact=(1.0, 1.0, 0.5, 0.5))
    r0 = trace_radiance(scene, rays, keys, base)
    r1 = trace_radiance(scene, rays, keys, cfg)
    np.testing.assert_allclose(np.asarray(r0), np.asarray(r1),
                               rtol=1e-6, atol=1e-7)


def test_compaction_bit_exact_full_image_pallas_interpret():
    """Same invariant through render_image (spp grouping, remat, tiling) on
    the Pallas interpret backend."""
    cs = compile_scene(cornell_box(width=16, height=16))
    base = PathTracerConfig(backend="pallas", max_depth=3, rr_enable=False)
    cfg = replace(base, compact=(1.0, 1.0, 1.0))  # no shrink: wiring no-op
    img0 = render_image(cs.scene, cs.camera, 16, 16, 4, jax.random.key(2), base)
    img1 = render_image(cs.scene, cs.camera, 16, 16, 4, jax.random.key(2), cfg)
    np.testing.assert_array_equal(np.asarray(img0), np.asarray(img1))
    # floor scene again, real shrink, via render_image on jnp
    scene = _floor_scene()
    from mafrixraytracing_tpu.camera.camera import Camera

    cam = Camera.pinhole((0.0, 3.0, 4.0), (0.0, -0.5, -1.0), 90.0, 1.0)
    b = PathTracerConfig(backend="jnp", max_depth=4, rr_enable=False)
    c = replace(b, compact=(1.0, 1.0, 0.5, 0.25))
    i0 = render_image(scene, cam, 16, 16, 4, jax.random.key(3), b)
    i1 = render_image(scene, cam, 16, 16, 4, jax.random.key(3), c)
    np.testing.assert_allclose(np.asarray(i0), np.asarray(i1),
                               rtol=1e-6, atol=1e-7)


def test_compaction_kills_unbiased_mean():
    """Cornell box (closed: ~every ray survives bounce 1) with a bucket at
    50%: half the live rays are rouletted with live/K compensation. The
    converged image mean must agree with the uncompacted estimator."""
    cs = compile_scene(cornell_box(width=12, height=12))
    base = PathTracerConfig(backend="jnp", max_depth=3, rr_enable=False)
    cfg = replace(base, compact=(1.0, 0.5, 0.5))
    m0 = float(jnp.mean(
        render_image(cs.scene, cs.camera, 12, 12, 192, jax.random.key(5), base)
    ))
    m1 = float(jnp.mean(
        render_image(cs.scene, cs.camera, 12, 12, 192, jax.random.key(5), cfg)
    ))
    assert abs(m1 - m0) / m0 < 0.04, (m0, m1)


def test_compaction_gradient_matches_fd():
    """AD flows through the pack sort / slices / fragment concat: linear
    light-radiance gradient must still match central differences tightly."""
    scene = _floor_scene()
    n = 128
    rays = _down_rays(n)
    keys = rng.pixel_keys(jax.random.key(1), n)
    cfg = PathTracerConfig(backend="jnp", max_depth=3, rr_enable=False,
                           compact=(1.0, 1.0, 0.5))

    def f(lr):
        return jnp.mean(trace_radiance(
            scene.replace(light_radiance=lr), rays, keys, cfg))

    g = jax.grad(f)(scene.light_radiance)
    eps = 1e-2
    d = jnp.zeros_like(scene.light_radiance).at[(0, 0)].set(1.0)
    fd = (float(f(scene.light_radiance + eps * d))
          - float(f(scene.light_radiance - eps * d))) / (2 * eps)
    np.testing.assert_allclose(float((g * d).sum()), fd, rtol=1e-3, atol=1e-6)


def test_trace_stats_mirrors_compaction():
    """The bench numerator must track the compacted run: fewer or equal
    queries with aggressive buckets, identical with loose ones."""
    cs = compile_scene(cornell_box(width=8, height=8))
    from mafrixraytracing_tpu.integrator.path import make_pixel_uv

    px, py = make_pixel_uv(8, 8)
    u, v = (px + 0.5) / 8, (py + 0.5) / 8
    rays = cs.camera.get_rays(u, v)
    keys = rng.pixel_keys(jax.random.key(9), 64)
    base = PathTracerConfig(backend="jnp", max_depth=4, rr_enable=False)
    loose = replace(base, compact=(1.0, 1.0, 1.0, 1.0))
    tight = replace(base, compact=(1.0, 0.5, 0.25, 0.25))
    q0 = float(trace_stats(cs.scene, rays, keys, base))
    ql = float(trace_stats(cs.scene, rays, keys, loose))
    qt = float(trace_stats(cs.scene, rays, keys, tight))
    assert ql == q0
    assert qt < q0
