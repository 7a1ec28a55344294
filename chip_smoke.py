"""Smoke test of the path tracer's main path on a GPU.

    python chip_smoke.py            # phases 1-4 on one card
    python chip_smoke.py --multi    # phase 5 only: 4 cards against 1

Phases (each checked against the repository's plain jnp reference):
  1. search parity: the cluster-walk kernels (closest-hit and any-hit)
     against `geometry.intersect.find_closest` / `occluded` on a 2^19-ray
     wavefront (camera rays + cosine bounce rays from the first hits), on
     the spot- and Renault-sized box-field stand-ins;
  2. forward render: the Cornell box with backend="auto" (the kernels)
     against backend="jnp" under the same key, then the Renault-sized
     stand-in at 1024^2 (forward only, timed);
  3. forward + backward: bench.py's loss and calibrated compaction
     schedule on the spot-sized stand-in, gradients against jnp, rays/s;
  4. three `opt.inverse.make_train_step` steps on a one-card mesh;
  5. (--multi) `render_image_sharded` and one `make_train_step` with
     overlap_microbatches=2 on a 4-card mesh against a 1-card mesh.

It runs in one process and never falls back to the CPU: without a GPU it
exits with status 2 before printing anything. Any failed check raises.
The last line of standard output is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

`--rehearse` runs phases 1-4 at tiny sizes on the CPU with the kernels in
interpret mode (a check of the script itself; it prints no result line).

All comparisons are float32 elementwise math (plane tests, shading, sums);
no matrix product on this path runs in TF32.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from mafrixraytracing_tpu.core.types import Rays  # noqa: E402
from mafrixraytracing_tpu.integrator import path as P  # noqa: E402
from mafrixraytracing_tpu.scene import builtin  # noqa: E402
from mafrixraytracing_tpu.scene.compiler import compile_scene  # noqa: E402

T_MIN = 1e-3
FULL = dict(rays=1 << 19, cornell=256, big=1024, grad=256, grad_spp=64,
            cmp_spp=16, spp=16, train=128, multi=256, timed=True)
TINY = dict(rays=1 << 11, cornell=16, big=32, grad=16, grad_spp=4,
            cmp_spp=2, spp=2, train=16, multi=16, timed=False)


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def secs(sz, seconds: float) -> str:
    """A time for the log; a CPU rehearsal reports none."""
    return f"{seconds:.4f} s" if sz["timed"] else "(not timed: rehearsal)"


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------------------
# Phase 1: search parity
# ---------------------------------------------------------------------------


def search_rays(scene, camera, n: int, seed: int = 0) -> Rays:
    """n rays: n/2 camera rays over a square pixel grid, then one
    cosine-weighted bounce ray from each first hit (misses repeat their
    camera ray)."""
    from mafrixraytracing_tpu.core.sampling import cosine_hemisphere
    from mafrixraytracing_tpu.geometry import intersect as isect

    side = int(round((n // 2) ** 0.5))
    assert 2 * side * side == n, n

    @jax.jit
    def make(scene, camera, key):
        px, py = P.make_pixel_uv(side, side)
        cam = camera.get_rays((px + 0.5) / side, (py + 0.5) / side)
        t, idx = isect.find_closest(scene, cam, T_MIN, 1e8)
        hit = isect.hit_attributes(scene, cam, idx, t)
        d, _ = cosine_hemisphere(jax.random.uniform(key, (side * side, 2)),
                                 hit.normal)
        ok = hit.valid[:, None]
        o = jnp.where(ok, hit.point + hit.normal * T_MIN, cam.origin)
        d = jnp.where(ok, d, cam.direction)
        return Rays(origin=jnp.concatenate([cam.origin, o]),
                    direction=jnp.concatenate([cam.direction, d]))

    return make(scene, camera, jax.random.key(seed))


def _mt_t(scene, rays, idx):
    """Reference Moller-Trumbore distance of triangle `idx` per ray."""
    from mafrixraytracing_tpu.geometry.intersect import tri_hit_terms

    i = np.clip(idx, 0, scene.tri_v0.shape[0] - 1)
    t, _, _, _ = tri_hit_terms(rays.origin, rays.direction,
                               scene.tri_v0[i], scene.tri_e1[i],
                               scene.tri_e2[i])
    return np.asarray(t)


def check_search(name, scene, rays, kernel_backend):
    """Closest-hit and any-hit: kernel against the jnp reference."""
    from mafrixraytracing_tpu.geometry import intersect as isect
    from mafrixraytracing_tpu.ops import intersect_pallas as ip

    interpret = kernel_backend == "pallas"
    ref_closest = jax.jit(lambda s, r: isect.find_closest(s, r, T_MIN, 1e8))
    ker_closest = jax.jit(lambda s, r: ip.find_closest(
        s, r, T_MIN, 1e8, interpret=interpret))
    t_r, i_r = map(np.asarray, ref_closest(scene, rays))
    t_k, i_k = map(np.asarray, ker_closest(scene, rays))
    hit_r, hit_k = i_r >= 0, i_k >= 0
    n_hitmiss = int(np.sum(hit_r != hit_k))
    assert n_hitmiss == 0, f"{name}: {n_hitmiss} rays hit in one search only"
    diff = np.nonzero(i_r != i_k)[0]
    if diff.size:
        # exact-t ties (shared edges): the kernel's triangle must give the
        # reference's distance under the reference's own arithmetic
        sub = Rays(origin=rays.origin[diff], direction=rays.direction[diff])
        t_alt = _mt_t(scene, sub, i_k[diff])
        np.testing.assert_allclose(t_alt, t_r[diff], rtol=1e-5,
                                   err_msg=f"{name}: non-tie index mismatch")
    np.testing.assert_allclose(t_k[hit_r], t_r[hit_r], rtol=1e-5,
                               err_msg=f"{name}: closest-hit t")

    # any-hit with per-ray t_max around the closest hit: below it (not
    # occluded unless something else is nearer), above it (occluded)
    u = np.asarray(jax.random.uniform(jax.random.key(7), t_r.shape,
                                      minval=0.5, maxval=1.5))
    t_max = jnp.asarray(np.where(hit_r, t_r * u, 1e8), jnp.float32)
    ref_any = jax.jit(lambda s, r, tm: isect.occluded(s, r, T_MIN, tm))
    ker_any = jax.jit(lambda s, r, tm: ip.occluded(
        s, r, T_MIN, tm, interpret=interpret))
    o_r = np.asarray(ref_any(scene, rays, t_max))
    o_k = np.asarray(ker_any(scene, rays, t_max))
    n_occ = int(np.sum(o_r != o_k))
    assert n_occ == 0, f"{name}: any-hit differs on {n_occ} rays"
    log(f"phase 1 {name}: {rays.origin.shape[0]} rays, "
        f"{int(hit_r.sum())} hits, {diff.size} tied-index rays, "
        f"{int(o_r.sum())} occluded; any-hit equal")


def phase1(sz, kernel_backend):
    for n_tris, tag in ((builtin.SPOT_TRIS, "spot stand-in"),
                        (builtin.RENAULT_TRIS, "renault stand-in")):
        cs = compile_scene(builtin.box_field(n_tris, 512, 512))
        rays = search_rays(cs.scene, cs.camera, sz["rays"])
        check_search(f"{tag} ({n_tris} tris)", cs.scene, rays,
                     kernel_backend)


# ---------------------------------------------------------------------------
# Phase 2: forward render
# ---------------------------------------------------------------------------


def phase2(sz, kernel_backend):
    from mafrixraytracing_tpu.ops import dispatch

    W = sz["cornell"]
    cs = compile_scene(builtin.cornell_box(width=W, height=W))
    if kernel_backend == "auto":
        assert dispatch._use_pallas(cs.scene, "auto"), "auto did not pick the kernel"
    key = jax.random.key(1)
    cfg_k = P.PathTracerConfig(max_depth=5, backend=kernel_backend)
    cfg_j = P.PathTracerConfig(max_depth=5, backend="jnp")
    img_k = np.asarray(P.render_image(cs.scene, cs.camera, W, W, sz["spp"],
                                      key, cfg_k))
    img_j = np.asarray(P.render_image(cs.scene, cs.camera, W, W, sz["spp"],
                                      key, cfg_j))
    assert np.isfinite(img_k).all() and np.isfinite(img_j).all()
    agree = float(np.mean(np.all(np.abs(img_k - img_j) <= 1e-5, axis=-1)))
    mean_rel = abs(img_k.mean() - img_j.mean()) / img_j.mean()
    log(f"phase 2 cornell {W}^2 {sz['spp']} spp: {agree:.6f} of pixels "
        f"within 1e-5, mean rel diff {mean_rel:.3e}")
    assert agree >= 0.999, agree
    # a path that a grazing-edge tie sends to another triangle diverges
    # from there on, so the means get a looser bound than the pixels
    assert mean_rel <= 1e-3, mean_rel

    Wb = sz["big"]
    cs = compile_scene(builtin.box_field(builtin.RENAULT_TRIS, Wb, Wb))
    render = jax.jit(P.render_image,
                     static_argnames=("width", "height", "spp", "config"))
    args = (cs.scene, cs.camera, Wb, Wb, sz["spp"], key, cfg_k)
    t0 = time.perf_counter()
    img = np.asarray(render(*args))
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    img = np.asarray(render(*args))
    dt = time.perf_counter() - t0
    assert img.shape == (Wb, Wb, 3) and np.isfinite(img).all()
    assert img.max() > 0.0
    log(f"phase 2 renault stand-in {Wb}^2 {sz['spp']} spp depth 5: "
        f"{secs(sz, dt)} per frame (first call incl. compile "
        f"{secs(sz, t_first)})")


# ---------------------------------------------------------------------------
# Phase 3: forward + backward
# ---------------------------------------------------------------------------


def phase3(sz, kernel_backend):
    import dataclasses

    import bench

    W = sz["grad"]
    cs = compile_scene(builtin.box_field(builtin.SPOT_TRIS, W, W))
    scene, camera = cs.scene, cs.camera
    config, _ = bench.calibrated_config(scene, camera, W, W, 5)
    config = dataclasses.replace(config, backend=kernel_backend)
    args = (scene.mat_albedo, scene.light_radiance, scene.tri_v0)
    names = ("mat_albedo", "light_radiance", "tri_v0")

    # kernels against jnp at cmp_spp: end-to-end time, and the gradients of
    # the last timed call (same key for both backends)
    # (both with 2^17-ray wavefronts: the jnp scan's fwd+bwd program at the
    # default 2^19 needs ~69 GB of device memory)
    spp_c = sz["cmp_spp"]
    cmp_cfg = dataclasses.replace(config, wavefront=1 << 17)
    dt_k, g_k = bench.time_grad(
        bench.make_grad_fn(scene, camera, W, W, spp_c, cmp_cfg), scene, 3)
    dt_j, g_j = bench.time_grad(
        bench.make_grad_fn(scene, camera, W, W, spp_c,
                           dataclasses.replace(cmp_cfg, backend="jnp")),
        scene, 3)
    log(f"phase 3 fwd+bwd {W}^2 {spp_c} spp: kernels {secs(sz, dt_k)}/iter, "
        f"jnp {secs(sz, dt_j)}/iter")
    for name, a, b, tol in zip(names, g_k, g_j, (1e-3, 1e-3, 1e-2)):
        assert np.isfinite(np.asarray(a)).all(), name
        err = rel_l2(a, b)
        log(f"phase 3 grad {name}: rel L2 kernel vs jnp {err:.3e} "
            f"(limit {tol:g})")
        # tri_v0 entries each depend on few paths, hence the looser bound
        assert err <= tol, (name, err)

    spp = sz["grad_spp"]
    queries = bench.count_queries_per_sample(scene, camera, W, W, config)
    grad_fn = bench.make_grad_fn(scene, camera, W, W, spp, config)
    dt, g = bench.time_grad(grad_fn, scene, 3)
    for name, a in zip(names, g):
        assert np.isfinite(np.asarray(a)).all(), name
    rate = f"{queries * spp / dt:.6e} rays/s" if sz["timed"] else ""
    log(f"phase 3 spot stand-in {W}^2 {spp} spp fwd+bwd: {secs(sz, dt)}/iter"
        f" {rate} ({queries:.0f} queries/spp, "
        f"compact={list(config.compact)})")


# ---------------------------------------------------------------------------
# Phase 4: train steps
# ---------------------------------------------------------------------------


def _fit_setup(W, spp, kernel_backend):
    import optax

    from mafrixraytracing_tpu.opt import inverse

    cs = compile_scene(builtin.box_field(builtin.SPOT_TRIS, W, W))
    config = P.PathTracerConfig(max_depth=3, rr_enable=False,
                                backend=kernel_backend)
    target = P.render_image(cs.scene, cs.camera, W, W, 4 * spp,
                            jax.random.key(3), config)
    bad = cs.scene.mat_albedo.at[0].set(jnp.asarray([0.2, 0.9, 0.2]))
    scene = cs.scene.replace(mat_albedo=bad)
    params = inverse.extract_params(scene, ["mat_albedo"])
    return cs, scene, config, target, params, optax, inverse


def phase4(sz, kernel_backend):
    from mafrixraytracing_tpu.parallel.mesh import make_mesh

    W, spp = sz["train"], 8
    cs, scene, config, target, params, optax, inverse = _fit_setup(
        W, spp, kernel_backend)
    opt = optax.adam(0.05)
    step = inverse.make_train_step(make_mesh(1), opt, W, W, spp, config)
    state = opt.init(params)
    losses = []
    for _ in range(3):
        # one key for all steps: the loss is then a fixed function of the
        # parameters and must fall step by step
        params, state, loss, gnorm = step(params, state, scene, cs.camera,
                                          target, jax.random.key(10))
        losses.append(float(loss))
        assert np.isfinite(float(gnorm)), gnorm
    log(f"phase 4 train steps (1-card mesh): losses {losses}")
    assert np.isfinite(losses).all(), losses
    assert losses[0] > losses[1] > losses[2], losses


# ---------------------------------------------------------------------------
# Phase 5 (--multi): 4 cards against 1
# ---------------------------------------------------------------------------


def _capture_grads():
    """An optax transformation whose state is the last gradient it saw
    (updates are zero), so a train step hands back its exact gradient."""
    import optax

    return optax.GradientTransformation(
        init=lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        update=lambda g, s, p=None: (
            jax.tree_util.tree_map(jnp.zeros_like, g), g),
    )


def phase5(sz, kernel_backend, n=4):
    from mafrixraytracing_tpu.parallel.mesh import make_mesh
    from mafrixraytracing_tpu.parallel.render import render_image_sharded

    assert len(jax.devices()) >= n, f"--multi needs {n} devices"
    W, spp = sz["multi"], sz["spp"]
    cs = compile_scene(builtin.cornell_box(width=W, height=W))
    config = P.PathTracerConfig(max_depth=5, backend=kernel_backend)
    key = jax.random.key(4)
    imgs = [np.asarray(render_image_sharded(cs.scene, cs.camera,
                                            make_mesh(m), W, W, spp, key,
                                            config)) for m in (n, 1)]
    assert np.isfinite(imgs[0]).all()
    max_diff = float(np.max(np.abs(imgs[0] - imgs[1])))
    log(f"phase 5 render_image_sharded {W}^2 {spp} spp: {n} cards vs 1, "
        f"max abs diff {max_diff:.3e}, bit-identical "
        f"{bool(np.array_equal(imgs[0], imgs[1]))}")
    assert np.array_equal(imgs[0], imgs[1]), max_diff

    Wt, spp_t = sz["train"], 8
    cs, scene, config, target, params, _, inverse = _fit_setup(
        Wt, spp_t, kernel_backend)
    out = []
    for m in (n, 1):
        opt = _capture_grads()
        step = inverse.make_train_step(make_mesh(m), opt, Wt, Wt, spp_t,
                                       config, overlap_microbatches=2)
        _, grads, loss, _ = step(params, opt.init(params), scene, cs.camera,
                                 target, jax.random.key(10))
        out.append((float(loss), grads))
    loss_rel = abs(out[0][0] - out[1][0]) / abs(out[1][0])
    g_rel = rel_l2(out[0][1]["mat_albedo"], out[1][1]["mat_albedo"])
    log(f"phase 5 train step (overlap_microbatches=2): {n} cards vs 1, "
        f"loss rel diff {loss_rel:.3e}, grad rel L2 {g_rel:.3e}")
    # the 4-card step sums per-card partial gradients in another order
    assert loss_rel <= 1e-5 and g_rel <= 1e-5, (loss_rel, g_rel)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-card sharded render + train step")
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes on the CPU, kernels interpreted")
    args = ap.parse_args(argv)

    if args.rehearse:
        sz, kernel_backend = TINY, "pallas"
    else:
        if jax.default_backend() != "gpu":
            print(f"chip_smoke: no GPU (JAX backend is "
                  f"{jax.default_backend()!r})", file=sys.stderr)
            return 2
        sz, kernel_backend = FULL, "auto"
    from mafrixraytracing_tpu.utils.cache import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    if not args.rehearse:
        log(f"card: {card_line()}")
    log(f"jax {jax.__version__}, devices: {jax.devices()}")

    t_all = time.perf_counter()
    if args.multi:
        phase5(sz, kernel_backend)
    else:
        for p, phase in enumerate((phase1, phase2, phase3, phase4), 1):
            t0 = time.perf_counter()
            phase(sz, kernel_backend)
            log(f"phase {p} done in {secs(sz, time.perf_counter() - t0)}")
    log(f"all phases done in {secs(sz, time.perf_counter() - t_all)}")
    if args.rehearse:
        return 0
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
