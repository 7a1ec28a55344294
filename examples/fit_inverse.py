"""Inverse-rendering demo: recover scene parameters from target renders by
gradient descent through the path tracer (BASELINE.md north-star capability;
the reference is forward-only).

Runs three fits on the device mesh (all visible devices):
  1. material:  spot's albedo, perturbed to green, recovered;
  2. geometry:  a floor displaced 0.25 upward, pulled back by pixel
                gradients;
  3. mesh vertices: the spot scene's SHARED vertex buffer
                (scene.mesh_vertices, BASELINE.md "recover vertices"):
                the ground plane is displaced 0.25 upward and pulled back
                on the default backend (the kernels on a GPU) — apply_params
                refreshes the cluster AABBs every step so moved geometry
                stays visible to the culling pass.

Estimator-class limitation, documented deliberately: vertex gradients are
reparameterized with DETACHED visibility, so silhouette/shadow-edge terms
carry no gradient. An FD study (round 4) shows the analytic gradient
matches FD as eps -> 0 (the continuous model), while at optimization-
scale steps the true loss change of a rigid cow translation is dominated
by silhouette terms the estimator cannot see — so translation-like body
displacements are NOT recoverable without edge-sampling gradients (future
work); falloff/shading-observable displacements (the ground, the floor
demo, albedo, radiance) are. `inverse.fit(smooth_geometry=N)` provides a
Laplacian gradient preconditioner for noisy per-vertex fits.

Usage:
    python examples/fit_inverse.py [out_prefix]
CPU (no accelerator needed):
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/fit_inverse.py
Writes <prefix>_{albedo,geo}_{target,start,fitted}.png and prints the loss
curve + parameter errors.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from mafrixraytracing_tpu.film.image import write_png
from mafrixraytracing_tpu.film.tonemap import to_bytes, tonemap
from mafrixraytracing_tpu.integrator.path import PathTracerConfig
from mafrixraytracing_tpu.opt import inverse
from mafrixraytracing_tpu.parallel.mesh import make_mesh
from mafrixraytracing_tpu.parallel.render import render_image_sharded
from mafrixraytracing_tpu.scene import assets
from mafrixraytracing_tpu.scene import spec as S
from mafrixraytracing_tpu.scene.compiler import compile_scene


def save(prefix, name, img):
    path = f"{prefix}_{name}.png"
    write_png(path, np.asarray(to_bytes(tonemap(img))))
    print(f"  wrote {path}")


def fit_albedo(prefix, mesh, cfg, W=48, H=48):
    print("[1/2] material recovery: spot albedo")
    cs = compile_scene(assets.spot_scene(W, H))
    scene, camera = cs.scene, cs.camera
    render = lambda s, spp, seed: render_image_sharded(
        s, camera, mesh, W, H, spp, jax.random.key(seed), cfg)
    target = jax.block_until_ready(render(scene, 16, 7))
    save(prefix, "albedo_target", target)

    true0 = np.asarray(scene.mat_albedo)[0]
    pert = np.asarray(scene.mat_albedo).copy()
    pert[0] = (0.2, 0.8, 0.2)
    bad = scene.replace(mat_albedo=jnp.asarray(pert))
    save(prefix, "albedo_start", render(bad, 16, 8))

    fitted, losses = inverse.fit(
        bad, camera, target, ("mat_albedo",), mesh,
        steps=40, lr=5e-2, spp=8, key=jax.random.key(11), config=cfg,
        log_every=10,
    )
    save(prefix, "albedo_fitted", render(fitted, 16, 9))
    f0 = np.asarray(fitted.mat_albedo)[0]
    print(f"  loss: {losses[0]:.4f} -> {losses[-1]:.4f}")
    print(f"  albedo: true {true0.round(3)}  start {pert[0].round(3)}  "
          f"fitted {f0.round(3)}")


def fit_geometry(prefix, mesh, cfg, W=32, H=32):
    print("[2/2] geometry recovery: displaced floor")
    floor = S.make_rect_mesh((-2, 0, 2), (2, 0, 2), (2, 0, -2), (-2, 0, -2))
    light = S.make_rect_mesh((-0.6, 2.0, -0.6), (0.6, 2.0, -0.6),
                             (0.6, 2.0, 0.6), (-0.6, 2.0, 0.6))
    spec = S.SceneSpec(
        camera=S.CameraSpec(position=(0.0, 1.2, 3.0), direction=(0.0, -0.3, -1.0),
                            fov=60.0, fov_convention="standard"),
        materials=[S.MaterialSpec(albedo=(0.7, 0.7, 0.7))],
        shapes=[S.ShapeSpec(floor, 0)],
        area_lights=[S.AreaLightSpec(light, radiance=(12.0,) * 3, visible=False)],
        film=S.FilmSpec(width=W, height=H),
    )
    cs = compile_scene(spec)
    scene, camera = cs.scene, cs.camera
    render = lambda s, spp, seed: render_image_sharded(
        s, camera, mesh, W, H, spp, jax.random.key(seed), cfg)
    target = jax.block_until_ready(render(scene, 32, 7))
    save(prefix, "geo_target", target)

    true_v0 = np.asarray(scene.tri_v0)
    mask = np.asarray(scene.tri_mask)
    pert_v0 = true_v0 + np.where(
        mask[:, None], np.array([[0.0, 0.25, 0.0]], np.float32), 0.0
    ).astype(np.float32)
    bad = scene.replace(tri_v0=jnp.asarray(pert_v0))
    save(prefix, "geo_start", render(bad, 32, 8))

    fitted, losses = inverse.fit(
        bad, camera, target, ("tri_v0",), mesh,
        steps=60, lr=3e-2, spp=8, key=jax.random.key(11), config=cfg,
        log_every=15,
    )
    save(prefix, "geo_fitted", render(fitted, 32, 9))
    d_b = np.linalg.norm(pert_v0 - true_v0, axis=1)[mask].mean()
    d_a = np.linalg.norm(np.asarray(fitted.tri_v0) - true_v0, axis=1)[mask].mean()
    print(f"  loss: {losses[0]:.4f} -> {losses[-1]:.4f}")
    print(f"  mean vertex error: {d_b:.4f} -> {d_a:.4f}")


def fit_spot_vertices(prefix, mesh, cfg, W=48, H=48):
    print("[3/3] vertex recovery: spot scene mesh_vertices (shared buffer)")
    cs = compile_scene(assets.spot_scene(W, H))
    scene, camera = cs.scene, cs.camera
    render = lambda s, spp, seed: render_image_sharded(
        s, camera, mesh, W, H, spp, jax.random.key(seed), cfg)
    target = jax.block_until_ready(render(scene, 32, 7))
    save(prefix, "verts_target", target)

    true_mv = np.asarray(scene.mesh_vertices)
    # displace the GROUND's shared vertices: height-under-light is the
    # falloff-observable direction (see the module docstring for why a
    # rigid cow translation is silhouette-dominated and out of reach for
    # detached-visibility gradients)
    faces = np.asarray(scene.tri_face_vi)[np.asarray(scene.tri_mask)]
    used = np.unique(faces)
    ground_rows = used[np.isin(used, np.nonzero(
        np.abs(true_mv[:, 1] - true_mv[used, 1].min()) < 1e-5)[0])]
    sel = np.zeros(true_mv.shape[0], bool)
    sel[ground_rows] = True
    pert = true_mv + np.where(sel[:, None], [[0.0, 0.25, 0.0]], 0.0).astype(
        np.float32
    )
    bad = inverse.apply_params(scene, {"mesh_vertices": jnp.asarray(pert)})
    save(prefix, "verts_start", render(bad, 32, 8))

    ck = "/tmp/fit_spot_verts_ck.npz"
    if os.path.exists(ck):
        os.remove(ck)  # fresh demo run (same path would RESUME a prior fit)
    fitted, losses = inverse.fit(
        bad, camera, target, ("mesh_vertices",), mesh,
        steps=80, lr=8e-3, spp=8, key=jax.random.key(13), config=cfg,
        log_every=20, checkpoint_path=ck,
    )
    save(prefix, "verts_fitted", render(fitted, 32, 9))
    d_b = np.abs(pert[:, 1] - true_mv[:, 1])[sel].mean()
    d_a = np.abs(
        np.asarray(fitted.mesh_vertices)[:, 1] - true_mv[:, 1]
    )[sel].mean()
    print(f"  loss: {losses[0]:.4f} -> {losses[-1]:.4f}")
    print(f"  ground height error: {d_b:.4f} -> {d_a:.4f}")


def main():
    from mafrixraytracing_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    prefix = sys.argv[1] if len(sys.argv) > 1 else "/tmp/fit"
    cfg = PathTracerConfig(max_depth=2, rr_enable=False)
    mesh = make_mesh()
    print(f"devices: {len(jax.devices())} ({jax.default_backend()})")
    fit_albedo(prefix, mesh, cfg)
    fit_geometry(prefix, mesh, cfg)
    fit_spot_vertices(prefix, mesh, cfg)


if __name__ == "__main__":
    main()
