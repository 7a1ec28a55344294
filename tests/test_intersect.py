import jax
import jax.numpy as jnp
import numpy as np

from mafrixraytracing_tpu.core.types import Rays
from mafrixraytracing_tpu.geometry import intersect as isect
from mafrixraytracing_tpu.scene import spec as S
from mafrixraytracing_tpu.scene.builtin import cornell_box
from mafrixraytracing_tpu.scene.compiler import compile_scene


def _single_tri_scene(v0, v1, v2):
    mesh = S.Mesh(
        vertices=np.asarray([v0, v1, v2], np.float32),
        faces=np.asarray([[0, 1, 2]], np.int32),
    )
    spec = S.SceneSpec(materials=[S.MaterialSpec()], shapes=[S.ShapeSpec(mesh, 0)])
    return compile_scene(spec).scene


def test_triangle_hit_and_miss():
    scene = _single_tri_scene((-1, -1, -2), (1, -1, -2), (0, 1, -2))
    rays = Rays(
        origin=jnp.array([[0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [5.0, 5.0, 0.0]]),
        direction=jnp.array([[0.0, 0.0, -1.0], [0.0, 0.0, 1.0], [0.0, 0.0, -1.0]]),
    )
    hit = isect.intersect_scene(scene, rays)
    assert bool(hit.valid[0])
    np.testing.assert_allclose(hit.t[0], 2.0, atol=1e-5)
    assert not bool(hit.valid[1])  # pointing away
    assert not bool(hit.valid[2])  # off to the side


def test_triangle_double_sided():
    """The reference's Moller-Trumbore takes |det| (Trangle.fs:130) so
    triangles are hittable from both sides; ours must match."""
    scene = _single_tri_scene((-1, -1, -2), (1, -1, -2), (0, 1, -2))
    rays = Rays(
        origin=jnp.array([[0.0, 0.0, -4.0]]),
        direction=jnp.array([[0.0, 0.0, 1.0]]),
    )
    hit = isect.intersect_scene(scene, rays)
    assert bool(hit.valid[0])
    np.testing.assert_allclose(hit.t[0], 2.0, atol=1e-5)
    # shading normal flipped toward the ray origin side
    assert float(hit.normal[0, 2]) < 0 or float(hit.normal[0, 2]) > 0
    assert float(jnp.dot(hit.normal[0], rays.direction[0])) < 0


def test_closest_of_two():
    mesh = S.Mesh(
        vertices=np.asarray(
            [
                [-1, -1, -2], [1, -1, -2], [0, 1, -2],
                [-1, -1, -1], [1, -1, -1], [0, 1, -1],
            ],
            np.float32,
        ),
        faces=np.asarray([[0, 1, 2], [3, 4, 5]], np.int32),
    )
    spec = S.SceneSpec(materials=[S.MaterialSpec()], shapes=[S.ShapeSpec(mesh, 0)])
    scene = compile_scene(spec).scene
    rays = Rays(origin=jnp.array([[0.0, 0.0, 2.0]]), direction=jnp.array([[0.0, 0.0, -1.0]]))
    hit = isect.intersect_scene(scene, rays)
    np.testing.assert_allclose(hit.t[0], 3.0, atol=1e-5)  # z=-1 plane first
    assert int(hit.prim_idx[0]) == 1


def test_sphere_hit_normal_frontface():
    spec = S.SceneSpec(
        materials=[S.MaterialSpec()],
        spheres=[S.SphereSpec((0.0, 0.0, -3.0), 1.0, 0)],
    )
    scene = compile_scene(spec).scene
    rays = Rays(origin=jnp.array([[0.0, 0.0, 0.0]]), direction=jnp.array([[0.0, 0.0, -1.0]]))
    hit = isect.intersect_scene(scene, rays)
    assert bool(hit.valid[0])
    np.testing.assert_allclose(hit.t[0], 2.0, atol=1e-5)
    np.testing.assert_allclose(hit.normal[0], [0, 0, 1], atol=1e-5)
    assert bool(hit.front_face[0])
    # from inside: second root, flipped normal
    rays_in = Rays(
        origin=jnp.array([[0.0, 0.0, -3.0]]), direction=jnp.array([[0.0, 0.0, -1.0]])
    )
    hit_in = isect.intersect_scene(scene, rays_in)
    np.testing.assert_allclose(hit_in.t[0], 1.0, atol=1e-5)
    assert not bool(hit_in.front_face[0])
    assert float(jnp.dot(hit_in.normal[0], rays_in.direction[0])) < 0


def test_occlusion_epsilon_protocol():
    scene = _single_tri_scene((-5, -5, -2), (5, -5, -2), (0, 5, -2))
    rays = Rays(origin=jnp.array([[0.0, 0.0, 0.0]]), direction=jnp.array([[0.0, 0.0, -1.0]]))
    # blocked within range
    assert bool(isect.occluded(scene, rays, 1e-3, jnp.array([5.0]))[0])
    # t_max short of the blocker -> clear
    assert not bool(isect.occluded(scene, rays, 1e-3, jnp.array([1.5]))[0])


def test_cornell_compiles_and_center_ray_hits_back_wall():
    cs = compile_scene(cornell_box())
    rays = Rays(origin=jnp.array([[0.0, 1.0, 3.0]]), direction=jnp.array([[0.0, 0.0, -1.0]]))
    hit = isect.intersect_scene(cs.scene, rays)
    assert bool(hit.valid[0])
    # back wall at z=-1, camera at z=3 -> t=4 unless a box is in the way
    assert 2.0 < float(hit.t[0]) <= 4.0 + 1e-4


def test_chunked_scan_matches_small_chunk():
    cs = compile_scene(cornell_box())
    key = jax.random.key(3)
    o = jnp.zeros((32, 3)) + jnp.array([0.0, 1.0, 2.5])
    d = jax.random.normal(key, (32, 3))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    rays = Rays(origin=o, direction=d)
    h1 = isect.intersect_scene(cs.scene, rays, chunk=1024)
    h2 = isect.intersect_scene(cs.scene, rays, chunk=16)
    np.testing.assert_allclose(h1.t, h2.t, atol=1e-5)
    np.testing.assert_array_equal(h1.prim_idx, h2.prim_idx)


def test_vertex_gradients_flow_through_hit():
    """d(t)/d(vertex z) for a ray hitting a z-plane triangle must be 1 on
    the hit triangle and 0 elsewhere (detached-selection reparameterized
    estimator)."""
    scene = _single_tri_scene((-1, -1, -2), (1, -1, -2), (0, 1, -2))
    rays = Rays(origin=jnp.array([[0.0, -0.2, 0.0]]), direction=jnp.array([[0.0, 0.0, -1.0]]))

    def t_of_scene(tri_v0):
        s = scene.replace(tri_v0=tri_v0)
        hit = isect.intersect_scene(s, rays)
        return hit.t[0]

    g = jax.grad(t_of_scene)(scene.tri_v0)
    # tri_v0 holds corner 0; e1/e2 are relative, so moving v0's z by +dz
    # moves the whole plane toward the origin: dt/dz = -1 on row 0 only
    np.testing.assert_allclose(float(g[0, 2]), -1.0, atol=1e-4)
    assert float(jnp.sum(jnp.abs(g[1:]))) < 1e-4


def test_fetch_cols_gradient_matches_plain_gather():
    """`fetch_cols` (one row gather, 36 column views) differentiates like
    the plain per-column gather `table[idx, k]`, including repeated
    indices whose cotangents must add up."""
    table = jax.random.normal(jax.random.key(0), (40, isect.PACKED_COLS))
    idx = jnp.asarray(np.random.default_rng(1).integers(0, 40, 300),
                      jnp.int32)
    w = jax.random.normal(jax.random.key(2), (isect.PACKED_COLS, 300))

    def via_fetch(t):
        cols = isect.fetch_cols(t, idx)
        return sum(jnp.sum(jnp.sin(c) * w[k]) for k, c in enumerate(cols))

    def via_gather(t):
        return sum(jnp.sum(jnp.sin(t[idx, k]) * w[k])
                   for k in range(isect.PACKED_COLS))

    np.testing.assert_allclose(float(via_fetch(table)),
                               float(via_gather(table)), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(jax.grad(via_fetch)(table)),
                               np.asarray(jax.grad(via_gather)(table)),
                               rtol=1e-5, atol=1e-6)
