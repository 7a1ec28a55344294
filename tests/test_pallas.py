"""Pallas kernel correctness vs the jnp reference intersector (interpret
mode on the CPU; the same kernels compile through Triton on the GPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mafrixraytracing_tpu.core.types import Rays
from mafrixraytracing_tpu.geometry import intersect as isect
from mafrixraytracing_tpu.ops import intersect_pallas as ip

T_MIN = 1e-3  # epsilon used by both backends in these comparisons
from mafrixraytracing_tpu.scene.builtin import cornell_box, sphere_triad
from mafrixraytracing_tpu.scene.compiler import compile_scene


def _random_rays(n, origin, spread=1.0, seed=0):
    key = jax.random.key(seed)
    d = jax.random.normal(key, (n, 3))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    o = jnp.tile(jnp.asarray([origin], jnp.float32), (n, 1))
    return Rays(origin=o, direction=d)


@pytest.mark.parametrize("n", [128, 256])
def test_matches_jnp_on_cornell(n):
    cs = compile_scene(cornell_box())
    rays = _random_rays(n, (0.0, 1.0, 1.5))
    t_j, i_j = isect.find_closest(cs.scene, rays, T_MIN, 1e8)
    t_p, i_p = ip.find_closest(cs.scene, rays, T_MIN, 1e8, interpret=True)
    hit_j = i_j >= 0
    hit_p = i_p >= 0
    np.testing.assert_array_equal(np.asarray(hit_j), np.asarray(hit_p))
    np.testing.assert_allclose(
        np.where(hit_j, np.asarray(t_j), 0.0),
        np.where(hit_p, np.asarray(t_p), 0.0),
        rtol=1e-4,
        atol=1e-5,
    )
    # indices may differ only for exactly-tied t (shared edges); verify the
    # chosen triangles produce the same hit distance instead of equality
    np.testing.assert_array_equal(np.asarray(i_j), np.asarray(i_p))


def test_nonaligned_batch():
    cs = compile_scene(cornell_box())
    rays = _random_rays(100, (0.2, 0.8, 0.0), seed=3)
    t_j, i_j = isect.find_closest(cs.scene, rays, T_MIN, 1e8)
    t_p, i_p = ip.find_closest(cs.scene, rays, T_MIN, 1e8, interpret=True)
    np.testing.assert_array_equal(np.asarray(i_j), np.asarray(i_p))


def test_sphere_merge():
    cs = compile_scene(sphere_triad())
    rays = _random_rays(128, (0.0, 0.7, 2.0), seed=5)
    t_j, i_j = isect.find_closest(cs.scene, rays, T_MIN, 1e8)
    t_p, i_p = ip.find_closest(cs.scene, rays, T_MIN, 1e8, interpret=True)
    np.testing.assert_array_equal(np.asarray(i_j), np.asarray(i_p))
    hit = np.asarray(i_j) >= 0
    np.testing.assert_allclose(
        np.asarray(t_j)[hit], np.asarray(t_p)[hit], rtol=1e-4
    )


def test_occlusion_with_per_ray_tmax():
    cs = compile_scene(cornell_box())
    n = 128
    # x=0.75, y=1.0 clears both boxes (tall box reaches x<=0.03, short box
    # tops out at y=0.6): first hit is the back wall at distance 1
    rays = Rays(
        origin=jnp.tile(jnp.array([[0.75, 1.0, 0.0]]), (n, 1)),
        direction=jnp.tile(jnp.array([[0.0, 0.0, -1.0]]), (n, 1)),
    )
    t_max_far = jnp.full((n,), 5.0)
    t_max_near = jnp.full((n,), 0.5)
    assert bool(
        jnp.all(ip.occluded(cs.scene, rays, 1e-3, t_max_far, interpret=True))
    )
    assert not bool(
        jnp.any(ip.occluded(cs.scene, rays, 1e-3, t_max_near, interpret=True))
    )


@pytest.mark.skipif(
    not __import__("mafrixraytracing_tpu.scene.assets",
                   fromlist=["x"]).have_reference_assets(),
    reason="reference assets absent",
)
def test_matches_jnp_on_spot():
    from mafrixraytracing_tpu.scene.assets import spot_scene

    cs = compile_scene(spot_scene(64, 64))
    rays = _random_rays(256, (0.0, 0.3, 2.0), seed=7)
    t_j, i_j = isect.find_closest(cs.scene, rays, T_MIN, 1e8)
    t_p, i_p = ip.find_closest(cs.scene, rays, T_MIN, 1e8, interpret=True)
    agree = np.mean(np.asarray(i_j) == np.asarray(i_p))
    assert agree == 1.0, f"index agreement {agree}"


def _flat_quad_over_mega_ground():
    """Regression scene: a small flat quad at y=0 that
    lands in a regular cluster (zero-thickness AABB -> conservative entry ==
    exit for vertical rays) over a huge ground quad at y=-5 that becomes a
    mega triangle. A strict early-exit comparison skips the flat cluster
    entirely and falls through to the ground."""
    from mafrixraytracing_tpu.scene import spec as S

    quad = S.make_rect_mesh(
        (-0.5, 0.0, -0.5), (0.5, 0.0, -0.5), (0.5, 0.0, 0.5), (-0.5, 0.0, 0.5)
    )
    ground = S.make_rect_mesh(
        (-10.0, -5.0, -10.0), (10.0, -5.0, -10.0),
        (10.0, -5.0, 10.0), (-10.0, -5.0, 10.0),
    )
    spec = S.SceneSpec(
        shapes=[S.ShapeSpec(mesh=quad, material=0),
                S.ShapeSpec(mesh=ground, material=0)]
    )
    cs = compile_scene(spec)
    # the premise of the repro: ground is mega, quad is clustered
    assert int(cs.scene.num_mega) >= 2
    return cs


def test_flat_clustered_rect_axis_aligned_tile():
    cs = _flat_quad_over_mega_ground()
    n = 1024
    key = jax.random.key(11)
    xz = jax.random.uniform(key, (n, 2), minval=-0.45, maxval=0.45)
    o = jnp.stack([xz[:, 0], jnp.full((n,), 2.0), xz[:, 1]], axis=1)
    d = jnp.tile(jnp.array([[0.0, -1.0, 0.0]]), (n, 1))
    rays = Rays(origin=o, direction=d)
    t_j, i_j = isect.find_closest(cs.scene, rays, T_MIN, 1e8)
    t_p, i_p = ip.find_closest(cs.scene, rays, T_MIN, 1e8, interpret=True)
    np.testing.assert_array_equal(np.asarray(i_j), np.asarray(i_p))
    np.testing.assert_allclose(np.asarray(t_j), np.asarray(t_p), rtol=1e-5)
    # every ray must hit the quad at t = 2, not the ground at t = 7
    np.testing.assert_allclose(np.asarray(t_p), 2.0, atol=1e-4)


def test_flat_clustered_rect_oblique_tile():
    cs = _flat_quad_over_mega_ground()
    n = 1024
    d1 = jnp.array([0.3, -1.0, 0.2])
    d1 = d1 / jnp.linalg.norm(d1)
    key = jax.random.key(12)
    xz = jax.random.uniform(key, (n, 2), minval=-0.3, maxval=0.3)
    # place origins so the rays pass through the quad at y=0
    t_to_plane = 2.0 / (-float(d1[1]))
    ox = xz[:, 0] - float(d1[0]) * t_to_plane
    oz = xz[:, 1] - float(d1[2]) * t_to_plane
    o = jnp.stack([ox, jnp.full((n,), 2.0), oz], axis=1)
    rays = Rays(origin=o, direction=jnp.tile(d1[None], (n, 1)))
    t_j, i_j = isect.find_closest(cs.scene, rays, T_MIN, 1e8)
    t_p, i_p = ip.find_closest(cs.scene, rays, T_MIN, 1e8, interpret=True)
    np.testing.assert_array_equal(np.asarray(i_j), np.asarray(i_p))
    hit = np.asarray(i_j) >= 0
    np.testing.assert_allclose(
        np.asarray(t_j)[hit], np.asarray(t_p)[hit], rtol=1e-5
    )
    # all rays were aimed through the quad: none may fall through to ground
    assert hit.all() and (np.asarray(i_p) < 2).all()


def test_supercluster_path_matches_jnp(monkeypatch):
    """Two-level (supercluster) walk forced on small scenes: identical
    results to the jnp reference on cornell, the flat-quad repro, and
    random oblique batches; any-hit agrees as well."""
    monkeypatch.setattr(ip, "SUPER_MIN_C", 0)
    for cs, origin, seed in [
        (compile_scene(cornell_box()), (0.0, 1.0, 1.5), 0),
        (_flat_quad_over_mega_ground(), (0.0, 2.0, 0.0), 2),
        (compile_scene(sphere_triad()), (0.0, 0.7, 2.0), 5),
    ]:
        rays = _random_rays(512, origin, seed=seed)
        t_j, i_j = isect.find_closest(cs.scene, rays, T_MIN, 1e8)
        t_p, i_p = ip.find_closest(cs.scene, rays, T_MIN, 1e8,
                                   interpret=True)
        np.testing.assert_array_equal(np.asarray(i_j), np.asarray(i_p))
        hit = np.asarray(i_j) >= 0
        np.testing.assert_allclose(np.asarray(t_j)[hit], np.asarray(t_p)[hit],
                                   rtol=1e-4)
        # any-hit with per-ray t_max just below / above the closest hit
        tj = np.asarray(t_j)
        t_far = jnp.asarray(np.where(hit, tj * 1.01, 1e8), jnp.float32)
        occ = ip.occluded(cs.scene, rays, T_MIN, t_far,
                          interpret=True)
        np.testing.assert_array_equal(np.asarray(occ), hit | (~hit & np.asarray(
            ip.occluded(cs.scene, rays, T_MIN,
                        jnp.full(hit.shape, 1e8, jnp.float32),
                        interpret=True))))


def test_supercluster_straight_down_flat(monkeypatch):
    """Supercluster path on the flat-cluster regression tile (axis-aligned
    rays, zero-thickness child AABB): the inclusive refinement comparison
    must keep the quad."""
    monkeypatch.setattr(ip, "SUPER_MIN_C", 0)
    cs = _flat_quad_over_mega_ground()
    n = 1024
    key = jax.random.key(11)
    xz = jax.random.uniform(key, (n, 2), minval=-0.45, maxval=0.45)
    o = jnp.stack([xz[:, 0], jnp.full((n,), 2.0), xz[:, 1]], axis=1)
    d = jnp.tile(jnp.array([[0.0, -1.0, 0.0]]), (n, 1))
    rays = Rays(origin=o, direction=d)
    t_j, i_j = isect.find_closest(cs.scene, rays, T_MIN, 1e8)
    t_p, i_p = ip.find_closest(cs.scene, rays, T_MIN, 1e8,
                               interpret=True)
    np.testing.assert_array_equal(np.asarray(i_j), np.asarray(i_p))
    np.testing.assert_allclose(np.asarray(t_p), 2.0, atol=1e-4)


def test_t_min_honored_by_both_backends():
    """`config.t_min` must reach the Pallas kernels (it is baked into each
    kernel specialization, not replaced by a constant). Rays starting ON a surface see it again at
    t ~= 2.0 through the box: with t_min below 2 both backends report that
    hit; with t_min above it both must skip to farther geometry — and the
    two backends must agree at BOTH settings."""
    cs = compile_scene(cornell_box())
    # straight down the box from the ceiling area toward the floor at y=0
    o = jnp.tile(jnp.asarray([[0.3, 1.9, -0.4]], jnp.float32), (128, 1))
    d = jnp.tile(jnp.asarray([[0.0, -1.0, 0.0]], jnp.float32), (128, 1))
    rays = Rays(origin=o, direction=d)
    for t_min in (1e-3, 1.95):
        t_j, i_j = isect.find_closest(cs.scene, rays, t_min, 1e8)
        t_p, i_p = ip.find_closest(cs.scene, rays, t_min, 1e8, interpret=True)
        np.testing.assert_array_equal(np.asarray(i_j), np.asarray(i_p))
        np.testing.assert_allclose(np.asarray(t_j), np.asarray(t_p),
                                   rtol=1e-5, atol=1e-6)
        assert float(t_j[0]) > t_min
    # the two t_min settings must actually select different geometry
    t_lo, _ = ip.find_closest(cs.scene, rays, 1e-3, 1e8, interpret=True)
    t_hi, _ = ip.find_closest(cs.scene, rays, 1.95, 1e8, interpret=True)
    assert float(t_hi[0]) > float(t_lo[0]) + 0.01, (t_lo[0], t_hi[0])


def test_auto_backend_is_jnp_on_cpu():
    """`auto` picks the kernels only on a GPU; here (CPU) it is the jnp
    scan, while an explicit `pallas` runs the kernels interpreted."""
    from mafrixraytracing_tpu.ops import dispatch

    cs = compile_scene(cornell_box())
    assert ip.supports(cs.scene)
    assert not dispatch._use_pallas(cs.scene, "auto")
    assert dispatch._use_pallas(cs.scene, "pallas")
    assert not dispatch._use_pallas(cs.scene, "jnp")
    with pytest.raises(ValueError, match="unknown intersection backend"):
        dispatch._use_pallas(cs.scene, "cuda")


def test_pallas_backend_raises_on_unsupported_scene():
    """An explicit `pallas` request on a scene the kernels cannot take (no
    one-AABB-per-128-triangles cluster table) raises instead of silently
    running the jnp scan."""
    from mafrixraytracing_tpu.ops import dispatch

    cs = compile_scene(cornell_box())
    bad = cs.scene.replace(cluster_min=cs.scene.cluster_min[:0],
                           cluster_max=cs.scene.cluster_max[:0])
    assert not ip.supports(bad)
    assert not dispatch._use_pallas(bad, "auto")
    rays = _random_rays(32, (0.0, 1.0, 1.5))
    with pytest.raises(ValueError, match="clustered scene"):
        dispatch.intersect_scene(bad, rays, T_MIN, 1e8, backend="pallas")


@pytest.mark.parametrize("platform,expect", [("cpu", True), ("gpu", False),
                                             ("metal", None)])
def test_interpret_mode_follows_platform(monkeypatch, platform, expect):
    """Interpret mode exactly on the CPU, Triton on the GPU, and no route on
    any other platform."""
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    if expect is None:
        with pytest.raises(RuntimeError, match="not on 'metal'"):
            ip.resolve_interpret(None)
    else:
        assert ip.resolve_interpret(None) is expect
    assert ip.resolve_interpret(True) is True


def _box_field_rays(cs, n, seed):
    """n/2 camera rays plus n/2 random-direction rays from their first
    hits (bounce-like, incoherent)."""
    side = int(round((n // 2) ** 0.5))
    from mafrixraytracing_tpu.integrator.path import make_pixel_uv

    px, py = make_pixel_uv(side, side)
    cam = cs.camera.get_rays((px + 0.5) / side, (py + 0.5) / side)
    t, idx = isect.find_closest(cs.scene, cam, T_MIN, 1e8)
    hit = isect.hit_attributes(cs.scene, cam, idx, t)
    d = jax.random.normal(jax.random.key(seed), (side * side, 3))
    d = d / jnp.linalg.norm(d, axis=1, keepdims=True)
    d = jnp.where((jnp.sum(d * hit.normal, axis=1) < 0)[:, None], -d, d)
    ok = hit.valid[:, None]
    o = jnp.where(ok, hit.point + hit.normal * T_MIN, cam.origin)
    d = jnp.where(ok, d, cam.direction)
    return Rays(origin=jnp.concatenate([cam.origin, o]),
                direction=jnp.concatenate([cam.direction, d]))


@pytest.mark.parametrize("two_level", [False, True])
def test_box_field_standin_matches_jnp(monkeypatch, two_level):
    """A 2,400-triangle box field (the stand-in family used for the
    benchmark scenes, 19 live clusters): the interpret-mode kernels give the
    jnp reference's closest-hit indices and distances and its any-hit
    answers, on camera and bounce rays, through the flat and the two-level
    walk."""
    from mafrixraytracing_tpu.scene.builtin import box_field

    if two_level:
        monkeypatch.setattr(ip, "SUPER_MIN_C", 0)
    cs = compile_scene(box_field(2400, 32, 32, seed=1))
    rays = _box_field_rays(cs, 2048, seed=2)
    t_j, i_j = isect.find_closest(cs.scene, rays, T_MIN, 1e8)
    t_p, i_p = ip.find_closest(cs.scene, rays, T_MIN, 1e8, interpret=True)
    np.testing.assert_array_equal(np.asarray(i_j), np.asarray(i_p))
    hit = np.asarray(i_j) >= 0
    assert 0.2 < hit.mean() < 1.0
    np.testing.assert_allclose(np.asarray(t_p)[hit], np.asarray(t_j)[hit],
                               rtol=1e-5)
    t_max = jnp.where(hit, t_j * jnp.linspace(0.5, 1.5, hit.size), 1e8)
    occ_j = isect.occluded(cs.scene, rays, T_MIN, t_max)
    occ_p = ip.occluded(cs.scene, rays, T_MIN, t_max, interpret=True)
    np.testing.assert_array_equal(np.asarray(occ_j), np.asarray(occ_p))
    assert 0.1 < float(jnp.mean(occ_p)) < 0.9
