"""Inverse rendering: fit scene parameters to target images by gradient
descent through the differentiable renderer.

This subsystem has no analog in the reference (it is forward-only); it is the
north-star capability: pixel gradients flow to material albedo/emission,
light radiance, and vertex positions (BASELINE.md targets). The training
step is shard_map-parallel over the ray axis: every device renders its pixel
shard of the loss, gradients for the replicated scene parameters are
`psum`-reduced across the mesh, and each device applies the identical optimizer
update — the renderer's equivalent of data-parallel training.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import optax
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from mafrixraytracing_tpu.integrator.path import PathTracerConfig
from mafrixraytracing_tpu.parallel.mesh import RAY_AXIS
from mafrixraytracing_tpu.parallel.render import _render_flat_pixels


# Scene leaves that move geometry: optimizing any of these invalidates the
# cluster AABBs the Pallas cull relies on, so `apply_params` must rebuild
# them (a stale cull silently *loses hits* once vertices leave their
# original cluster boxes).
GEOMETRY_PARAMS = ("tri_v0", "tri_e1", "tri_e2", "mesh_vertices")


def apply_params(scene, params: dict):
    """Overlay a dict of optimizable leaves onto the scene pytree. Keys are
    ScenePytree field names (e.g. 'mat_albedo', 'light_radiance', 'tri_v0',
    'mesh_vertices'). Optimizing `mesh_vertices` (the shared vertex buffer)
    re-derives the per-face tri_v0/e1/e2 caches by gather inside jit, so a
    vertex's gradient accumulates from every face that references it.
    Geometry updates refresh the cluster AABBs on-device so the Pallas
    culling path stays conservative."""
    from mafrixraytracing_tpu.accel.clusters import refresh_clusters

    updates = dict(params)
    if "mat_albedo" in updates:
        updates["mat_albedo"] = jnp.clip(updates["mat_albedo"], 0.0, 1.0)
    if "mesh_vertices" in updates:
        mv = updates["mesh_vertices"]
        f = scene.tri_face_vi
        p0 = mv[f[:, 0]]
        updates["tri_v0"] = p0
        updates["tri_e1"] = mv[f[:, 1]] - p0
        updates["tri_e2"] = mv[f[:, 2]] - p0
    scene = scene.replace(**updates)
    if any(k in updates for k in GEOMETRY_PARAMS):
        scene = refresh_clusters(scene)
    return scene


def extract_params(scene, names) -> dict:
    return {n: getattr(scene, n) for n in names}


def smooth_vertex_grads(scene, g, iters: int = 8, alpha: float = 0.7):
    """Laplacian-smooth a mesh-vertex gradient over the face adjacency (a
    light version of the "Large Steps in Inverse Rendering" preconditioner).
    Per-vertex Monte-Carlo gradients at practical sample counts are noise-
    dominated; adam then normalizes that noise into a constant-size random
    walk that ROUGHENS the mesh while the loss drifts sideways. Diffusing
    the gradient over the 1-ring (iters Jacobi steps of
    g <- (1-alpha) g + alpha * neighbor-mean(g)) keeps the coherent,
    low-frequency component — which is exactly the part the shading signal
    can actually constrain — and averages the per-vertex noise away."""
    f = scene.tri_face_vi
    w = scene.tri_mask.astype(jnp.float32)[:, None]
    V = g.shape[0]
    deg = (
        jnp.zeros((V, 1))
        .at[f[:, 0]].add(2.0 * w)
        .at[f[:, 1]].add(2.0 * w)
        .at[f[:, 2]].add(2.0 * w)
    )

    def nb_sum(x):
        ga, gb, gc = x[f[:, 0]], x[f[:, 1]], x[f[:, 2]]
        return (
            jnp.zeros_like(x)
            .at[f[:, 0]].add((gb + gc) * w)
            .at[f[:, 1]].add((ga + gc) * w)
            .at[f[:, 2]].add((ga + gb) * w)
        )

    for _ in range(iters):
        avg = nb_sum(g) / jnp.maximum(deg, 1.0)
        g = (1.0 - alpha) * g + alpha * avg
    return g


def image_loss(img, target):
    """Relative-L2 loss (standard for HDR renders: divides out brightness so
    bright pixels don't dominate). Normalized by the *target* (a constant):
    normalizing by the noisy rendered image both amplifies Monte-Carlo noise
    in dark pixels and correlates the weight with the estimator, which in
    practice makes the fit diverge."""
    d = img - target
    return jnp.mean(d * d / (target * target + 1e-2))


def make_train_step(
    mesh: Mesh,
    optimizer: optax.GradientTransformation,
    width: int,
    height: int,
    spp: int,
    config: PathTracerConfig = PathTracerConfig(),
    smooth_geometry: int = 0,
    overlap_microbatches: int = 1,
):
    """Build a jitted, mesh-parallel train step:
        (params, opt_state, scene, camera, target, key)
            -> (params, opt_state, loss, grad_norm)
    `target` is the (H, W, 3) linear-radiance target image; `grad_norm` is
    the global L2 norm of the psum-reduced gradient (the in-run training
    scalar next to the loss).

    `overlap_microbatches=M > 1` splits the spp budget into M gradient
    microbatches and issues the gradient all-reduce (`pmean`) per
    microbatch, UNROLLED in one XLA program: microbatch m's all-reduce has
    no data dependence on microbatch m+1's forward/backward, so XLA's
    latency-hiding scheduler overlaps the collective with the remaining
    backward compute instead of serializing one big pmean after the whole
    backward pass (the payoff is largest for `mesh_vertices` fits, whose
    (V, 3) gradient makes the all-reduce payload large). Estimator note:
    the loss becomes the mean of M relative-L2 losses of sub-images (spp/M
    samples each) rather than one loss of the full-spp image — same target,
    slightly higher-variance gradient; the M sub-sample sets partition the
    original sample indices, so no RNG stream is reused."""

    n_dev = mesh.shape[RAY_AXIS]
    B = width * height
    B_pad = ((B + n_dev - 1) // n_dev) * n_dev
    M = overlap_microbatches
    assert M >= 1 and spp % M == 0, (
        f"overlap_microbatches={M} must divide spp={spp}")

    def loss_fn(params, scene, camera, ids, target_flat, key,
                spp_chunk=spp, sample_offset=0):
        s = apply_params(scene, params)
        img = _render_flat_pixels(s, camera, ids, width, height, spp_chunk,
                                  key, config, sample_offset=sample_offset)
        return image_loss(img, target_flat)

    def shard_step(params, opt_state, scene, camera, ids, target_flat, key):
        if M > 1:
            sub = spp // M
            loss = None
            grads = None
            for m in range(M):  # unrolled: collectives overlap later chunks
                l_m, g_m = jax.value_and_grad(loss_fn)(
                    params, scene, camera, ids, target_flat, key,
                    spp_chunk=sub, sample_offset=m * sub,
                )
                # per-microbatch all-reduce, issued as soon as this
                # chunk's backward finishes
                g_m = lax.pmean(g_m, RAY_AXIS)
                l_m = lax.pmean(l_m, RAY_AXIS)
                loss = l_m if loss is None else loss + l_m
                grads = g_m if grads is None else jax.tree_util.tree_map(
                    jnp.add, grads, g_m)
            inv = 1.0 / M
            loss = loss * inv
            grads = jax.tree_util.tree_map(lambda g: g * inv, grads)
        else:
            loss, grads = jax.value_and_grad(loss_fn)(
                params, scene, camera, ids, target_flat, key
            )
            # data-parallel gradient all-reduce over the ray axis
            grads = lax.pmean(grads, RAY_AXIS)
            loss = lax.pmean(loss, RAY_AXIS)
        if smooth_geometry and "mesh_vertices" in grads:
            grads = dict(grads)
            grads["mesh_vertices"] = smooth_vertex_grads(
                scene, grads["mesh_vertices"], iters=smooth_geometry
            )
        gnorm = optax.global_norm(grads)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss, gnorm

    sharded = shard_map(
        shard_step,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(RAY_AXIS), P(RAY_AXIS), P()),
        out_specs=(P(), P(), P(), P()),
        check_vma=False,
    )

    @jax.jit
    def train_step(params, opt_state, scene, camera, target, key):
        ids = jnp.arange(B_pad, dtype=jnp.int32) % B
        tflat = target.reshape(B, 3)
        tflat = jnp.concatenate([tflat, tflat[: B_pad - B]], axis=0)
        return sharded(params, opt_state, scene, camera, ids, tflat, key)

    return train_step


def fit(
    scene,
    camera,
    target,
    param_names,
    mesh: Mesh,
    steps: int = 100,
    lr: float = 5e-2,
    spp: int = 4,
    key=None,
    config: PathTracerConfig = PathTracerConfig(),
    callback=None,
    log_every: int = 0,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 25,
    smooth_geometry: int = 0,
    overlap_microbatches: int = 1,
):
    """Optimize `param_names` of `scene` so its render matches `target`.
    Returns (fitted_scene, losses).

    Observability + recovery for long fits (reference has neither —
    SURVEY §5 aux subsystems):
    - `log_every=N` prints an in-run scalar line every N steps: step,
      loss, global gradient norm, steps/s, and rays/s (pixels * spp *
      ~2 queries/bounce estimate).
    - `smooth_geometry=N` Laplacian-smooths the `mesh_vertices` gradient
      with N Jacobi iterations before the optimizer (see
      `smooth_vertex_grads`) — essential for stable vertex fits at
      practical sample counts.
    - `checkpoint_path` enables fail-fast + restart: the fit state
      (params, optimizer state, step index, RNG key) is saved every
      `checkpoint_every` steps and on completion; calling `fit` again
      with the same path RESUMES from the last checkpoint and reproduces
      the uninterrupted run bit-exactly (counter-based key schedule).
    """
    import time as _time

    from mafrixraytracing_tpu.utils import checkpoint as ckpt

    if key is None:
        key = jax.random.key(0)
    h, w = target.shape[:2]
    params = extract_params(scene, param_names)
    optimizer = optax.adam(lr)
    opt_state = optimizer.init(params)
    step_fn = make_train_step(mesh, optimizer, w, h, spp, config,
                              smooth_geometry=smooth_geometry,
                              overlap_microbatches=overlap_microbatches)

    start = 0
    if checkpoint_path is not None:
        resumed = ckpt.load_fit_state(checkpoint_path, params, opt_state)
        if resumed is not None:
            params, opt_state, start, key = resumed

    losses = []
    t_prev = _time.perf_counter()
    for i in range(start, steps):
        key, sub = jax.random.split(key)
        params, opt_state, loss, gnorm = step_fn(
            params, opt_state, scene, camera, target, sub
        )
        losses.append(float(loss))
        if log_every and ((i - start) % log_every == 0 or i == steps - 1):
            jax.block_until_ready(loss)
            now = _time.perf_counter()
            dt = max(now - t_prev, 1e-9) / max(log_every, 1)
            t_prev = now
            rays = w * h * spp * 2 * config.max_depth / dt
            print(
                f"[fit] step {i:4d}  loss {float(loss):.5f}  "
                f"|grad| {float(gnorm):.4g}  {1.0 / dt:6.2f} steps/s  "
                f"~{rays / 1e6:.2f}M rays/s"
            )
        if checkpoint_path is not None and (
            (i + 1) % checkpoint_every == 0 or i + 1 == steps
        ):
            ckpt.save_fit_state(checkpoint_path, params, opt_state, i + 1, key)
        if callback is not None:
            callback(i, float(loss), params)
    return apply_params(scene, params), losses
