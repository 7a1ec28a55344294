import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mafrixraytracing_tpu.integrator.path import (
    PathTracerConfig,
    render_image,
    trace_radiance,
)
from mafrixraytracing_tpu.core import rng
from mafrixraytracing_tpu.core.types import Rays
from mafrixraytracing_tpu.scene import spec as S
from mafrixraytracing_tpu.scene.builtin import cornell_box, furnace
from mafrixraytracing_tpu.scene.compiler import compile_scene

CFG = PathTracerConfig(backend="jnp")


def _trace(scene, origins, dirs, n, seed=0, config=CFG):
    o = jnp.tile(jnp.asarray(origins, jnp.float32), (n, 1))
    d = jnp.tile(jnp.asarray(dirs, jnp.float32), (n, 1))
    keys = rng.pixel_keys(jax.random.key(seed), n)
    return trace_radiance(scene, Rays(origin=o, direction=d), keys, config)


def test_furnace_single_bounce_equals_albedo():
    """Lambert sphere (albedo a) in a unit-radiance environment: every
    camera ray bounces once then escapes (convex), so each sample returns
    exactly a * background — zero variance."""
    a = 0.7
    cs = compile_scene(furnace(albedo=a))
    scene = cs.scene.replace(background=jnp.ones(3))
    rad = _trace(scene, [0.0, 0.0, 3.0], [0.0, 0.0, -1.0], 256)
    np.testing.assert_allclose(np.asarray(rad), a, atol=1e-3)


def test_miss_gives_background():
    cs = compile_scene(furnace())
    scene = cs.scene.replace(background=jnp.array([0.2, 0.4, 0.6]))
    rad = _trace(scene, [0.0, 0.0, 3.0], [0.0, 1.0, 0.0], 8)
    np.testing.assert_allclose(np.asarray(rad), [[0.2, 0.4, 0.6]] * 8, atol=1e-6)


def test_nee_matches_analytic_small_light():
    """Lambert floor lit by a small overhead area light ~ point source:
    L ~= albedo/pi * Le * A * cos_s * cos_l / d^2. MC estimate must agree
    within a few percent."""
    albedo, Le, s, h = 0.6, 40.0, 0.05, 2.0
    floor = S.make_rect_mesh((-10, 0, 10), (10, 0, 10), (10, 0, -10), (-10, 0, -10))
    light = S.make_rect_mesh((-s, h, -s), (s, h, -s), (s, h, s), (-s, h, s))
    spec = S.SceneSpec(
        materials=[S.MaterialSpec(albedo=(albedo,) * 3)],
        shapes=[S.ShapeSpec(floor, 0)],
        area_lights=[S.AreaLightSpec(light, radiance=(Le,) * 3, visible=False)],
    )
    scene = compile_scene(spec).scene
    # camera ray straight down at the origin; light directly overhead
    rad = _trace(scene, [0.0, 1.0, 0.0], [0.0, -1.0, 0.0], 4096)
    got = float(jnp.mean(rad))
    area = (2 * s) ** 2
    want = albedo / np.pi * Le * area / h**2  # cos_s = cos_l = 1
    np.testing.assert_allclose(got, want, rtol=0.05)


def test_emissive_light_visible_to_camera():
    cs = compile_scene(cornell_box(light_visible=True))
    # ray from below straight up into the light (one-sided, faces down)
    rad = _trace(cs.scene, [0.0, 1.0, 0.0], [0.0, 1.0, 0.0], 4)
    np.testing.assert_allclose(np.asarray(rad), 10.0, rtol=1e-5)


def test_emissive_one_sided():
    cs = compile_scene(cornell_box(light_visible=True))
    # from above the light looking down: back face -> no emission, but the
    # ray continues to nothing (light blocks floor? no - it hits the light
    # geometry, which doesn't scatter) -> radiance contribution only from NEE
    rad = _trace(cs.scene, [0.0, 1.99, 0.0], [0.0, -1.0, 0.0], 4)
    assert float(jnp.max(rad)) < 10.0


def test_cornell_render_statistics():
    cs = compile_scene(cornell_box(width=48, height=48))
    img = render_image(
        cs.scene, cs.camera, 48, 48, 8, jax.random.key(7), CFG
    )
    img = np.asarray(img)
    assert img.shape == (48, 48, 3)
    assert np.all(np.isfinite(img))
    assert img.max() > 0.5  # light visible somewhere
    # left third reddish vs right third greenish (red left wall @ material 2)
    left = img[:, :8].mean(axis=(0, 1))
    right = img[:, -8:].mean(axis=(0, 1))
    assert left[0] > left[1], f"left wall should be red-dominant: {left}"
    assert right[1] > right[0], f"right wall should be green-dominant: {right}"
    # ceiling (top rows, away from light) is lit indirectly -> nonzero
    assert img[:6].mean() > 0.0


def test_mafrix_estimator_direct_term_scale():
    """Parity estimator: for a single direct bounce the reference weights
    NEE by `albedo*2*cos_wi` and folds Area^2/d^2 into the light term
    (`Material.fs:33-36` + `Light.fs:48-59` + `Integrators.fs:130-136`), so
    the expected mafrix/physical ratio on a flat lambert floor under a small
    light is 2*pi*E[cos_wi]*Area = pi*Area. Verify to MC tolerance."""
    albedo, Le, s, h = 0.6, 40.0, 0.05, 2.0
    floor = S.make_rect_mesh((-10, 0, 10), (10, 0, 10), (10, 0, -10), (-10, 0, -10))
    light = S.make_rect_mesh((-s, h, -s), (s, h, -s), (s, h, s), (-s, h, s))
    spec = S.SceneSpec(
        materials=[S.MaterialSpec(albedo=(albedo,) * 3)],
        shapes=[S.ShapeSpec(floor, 0)],
        area_lights=[S.AreaLightSpec(light, radiance=(Le,) * 3, visible=False)],
    )
    scene = compile_scene(spec).scene
    cfg_m = PathTracerConfig(backend="jnp", estimator="mafrix", max_depth=1)
    cfg_p = PathTracerConfig(backend="jnp", max_depth=1, rr_enable=False)
    rad_m = _trace(scene, [0.0, 1.0, 0.0], [0.0, -1.0, 0.0], 8192, config=cfg_m)
    rad_p = _trace(scene, [0.0, 1.0, 0.0], [0.0, -1.0, 0.0], 8192, config=cfg_p)
    area = (2 * s) ** 2
    ratio = float(jnp.mean(rad_m)) / float(jnp.mean(rad_p))
    np.testing.assert_allclose(ratio, np.pi * area, rtol=0.1)


def test_nee_only_vs_mis_converge_to_same_image():
    """NEE+MIS and NEE-only (lights invisible) are both unbiased for the
    diffuse Cornell scene; their converged means must agree."""
    cs = compile_scene(cornell_box(width=16, height=16, light_visible=False))
    cfg_a = PathTracerConfig(backend="jnp", mis=True)
    cfg_b = PathTracerConfig(backend="jnp", mis=False)
    img_a = render_image(cs.scene, cs.camera, 16, 16, 96, jax.random.key(1), cfg_a)
    img_b = render_image(cs.scene, cs.camera, 16, 16, 96, jax.random.key(2), cfg_b)
    # agree to MC noise at 96 spp over a 16x16 mean
    np.testing.assert_allclose(
        float(img_a.mean()), float(img_b.mean()), rtol=0.05
    )


def test_deterministic_given_key():
    cs = compile_scene(cornell_box(width=16, height=16))
    img1 = render_image(cs.scene, cs.camera, 16, 16, 2, jax.random.key(5), CFG)
    img2 = render_image(cs.scene, cs.camera, 16, 16, 2, jax.random.key(5), CFG)
    np.testing.assert_array_equal(np.asarray(img1), np.asarray(img2))


def test_dielectric_eta2_weight_directions():
    """The refracted branch must carry the reference's (et^2/ei^2) radiance
    compression (`Core/Materials/Material.fs:103-118`): entering glass
    (air -> ior) scales by ior^2, exiting by 1/ior^2; reflected samples stay
    at weight 1."""
    from mafrixraytracing_tpu.core.types import Hit
    from mafrixraytracing_tpu.materials.bsdf import sample_bsdf

    ior = 1.5
    spec = S.SceneSpec(
        materials=[S.MaterialSpec(type="dielectric", albedo=(1, 1, 1), ior=ior)],
        spheres=[S.SphereSpec(center=(0, 0, 0), radius=1.0, material=0)],
    )
    scene = compile_scene(spec).scene
    B = 4096
    n = jnp.tile(jnp.array([[0.0, 0.0, 1.0]]), (B, 1))

    def weights(front):
        hit = Hit(
            valid=jnp.ones(B, bool),
            t=jnp.ones(B),
            point=jnp.zeros((B, 3)),
            normal=n,
            front_face=jnp.full(B, front),
            material=jnp.zeros(B, jnp.int32),
            prim_idx=jnp.zeros(B, jnp.int32),
            uv=jnp.zeros((B, 2)),
        )
        wo = n  # normal incidence: fr ~ 0.04, TIR impossible
        keys = rng.pixel_keys(jax.random.key(5), B)
        bs = sample_bsdf(scene, hit, wo, keys)
        refracted = np.asarray(jnp.sum(bs.wi * n, axis=1)) < 0.0
        w = np.asarray(bs.weight)[:, 0]
        return w[refracted], w[~refracted]

    w_in_refr, w_in_refl = weights(front=True)
    assert w_in_refr.size > B // 2  # most samples refract at fr ~ 4%
    np.testing.assert_allclose(w_in_refr, ior**2, rtol=1e-5)
    np.testing.assert_allclose(w_in_refl, 1.0, rtol=1e-5)
    w_out_refr, _ = weights(front=False)
    np.testing.assert_allclose(w_out_refr, 1.0 / ior**2, rtol=1e-5)


def test_glass_sphere_furnace_flat():
    """Solid glass sphere in a unit furnace: every path enters and exits the
    sphere (possibly with internal reflections), so the eta^2 factors must
    cancel exactly and each pixel equals the background — a strong oracle
    that the transmission scaling is applied symmetrically."""
    spec = S.SceneSpec(
        camera=S.CameraSpec(position=(0.0, 0.0, 3.0), direction=(0.0, 0.0, -1.0),
                            fov=40.0, fov_convention="standard"),
        materials=[S.MaterialSpec(type="dielectric", albedo=(1, 1, 1), ior=1.5)],
        spheres=[S.SphereSpec(center=(0, 0, 0), radius=1.0, material=0)],
    )
    cs = compile_scene(spec)
    scene = cs.scene.replace(background=jnp.ones(3))
    cfg = PathTracerConfig(max_depth=24, rr_enable=False, backend="jnp")
    rad = _trace(scene, [0.0, 0.0, 3.0], [0.0, 0.0, -1.0], 512, config=cfg)
    np.testing.assert_allclose(np.asarray(rad).mean(), 1.0, atol=0.02)


def test_nee_visible_light_oblique():
    """Round-4 regression: with VISIBLE light geometry and oblique shadow
    rays, the NEE visibility interval must be measured from the offset
    shadow origin — measuring from hit.point places the light's own surface
    at dist - eps/cos(theta) < dist - eps, self-occluding ~every oblique
    shadow ray. Oracle: NEE-only and BSDF-only estimators target the same
    direct-light integral."""
    floor = S.make_rect_mesh((-4, 0, 4), (4, 0, 4), (4, 0, -4), (-4, 0, -4))
    light = S.make_rect_mesh((-1, 3, -1), (1, 3, -1), (1, 3, 1), (-1, 3, 1))
    cs = compile_scene(S.SceneSpec(
        materials=[S.MaterialSpec(albedo=(0.7,) * 3)],
        shapes=[S.ShapeSpec(floor, 0)],
        area_lights=[S.AreaLightSpec(light, radiance=(10.0,) * 3, visible=True)],
    ))
    scene = cs.scene
    # oblique: hit at (0.5, 0, 0.5), light centered overhead at origin
    def run(nee, mis, n, seed):
        cfg = PathTracerConfig(max_depth=2, rr_enable=False, backend="jnp",
                               nee=nee, mis=mis)
        return float(jnp.mean(_trace(scene, [0.5, 1.0, 0.5], [0.0, -1.0, 0.0],
                                     n, seed=seed, config=cfg)))

    bsdf_only = np.mean([run(False, False, 1 << 14, s) for s in range(4)])
    nee_only = np.mean([run(True, False, 1 << 13, s + 8) for s in range(4)])
    mis_both = np.mean([run(True, True, 1 << 13, s + 16) for s in range(4)])
    np.testing.assert_allclose(nee_only, bsdf_only, rtol=0.04)
    np.testing.assert_allclose(mis_both, bsdf_only, rtol=0.04)


def test_nee_light_row_fetch_equals_gathers():
    """The NEE light fetch (one row of `packed_light_table`) equals the
    per-field gathers of the light table, bit for bit — no matrix product
    sits in the fetch to round light geometry or radiance."""
    from mafrixraytracing_tpu.lights.lights import packed_light_table

    cs = compile_scene(cornell_box())
    s = cs.scene
    s = s.replace(light_radiance=s.light_radiance * 1.2345678)
    L = s.light_v0.shape[0]
    li = jnp.asarray(np.random.default_rng(0).integers(0, L, 257), jnp.int32)
    row = np.asarray(packed_light_table(s)[li])
    for lo, field in ((0, s.light_v0), (3, s.light_e1), (6, s.light_e2),
                      (9, s.light_normal), (12, s.light_radiance)):
        np.testing.assert_array_equal(row[:, lo:lo + 3],
                                      np.asarray(field)[np.asarray(li)])
    flags = (np.asarray(s.light_two_sided, np.float32)
             + 2.0 * np.asarray(s.light_mask, np.float32))
    np.testing.assert_array_equal(row[:, 15], flags[np.asarray(li)])
