"""Batched ray/primitive intersection (jnp reference path).

Batched replacement for the reference's per-ray recursive hit tests:
- Moller-Trumbore triangles, double-sided via |det| (reference
  `Core/Shape/Trangle.fs:120-145` takes `abs divisor` the same way).
- Stable-quadratic spheres (reference `Core/Shape/Sphere.fs:21-43`).

Design for differentiability + speed: the *search* for the closest hit is
wrapped in `stop_gradient` (closest-hit selection is piecewise constant), and
hit attributes (t, point, normal, uv) are then *recomputed differentiably*
for only the selected primitive via gather. The backward pass therefore costs
O(rays), not O(rays x prims) — gradients w.r.t. vertex positions flow through
the hit triangle's recompute, which is the standard reparameterized
closest-hit estimator (visibility discontinuities are not differentiated).

The closest-hit search runs as a `lax.scan` over primitive chunks so peak
memory is O(rays x chunk) regardless of scene size. The Pallas cluster-walk
kernels in `mafrixraytracing_tpu.ops` replace this search on the GPU and
share the same differentiable recompute for backward.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import Array, lax
from jax.ad_checkpoint import checkpoint_name

from mafrixraytracing_tpu.core.math import cross, dot, normalize, safe_sqrt
from mafrixraytracing_tpu.core.types import Hit, Rays

BIG = jnp.float32(1e30)
DET_EPS = 1e-10


def _chunk(arr: Array, n_chunks: int) -> Array:
    return arr.reshape((n_chunks, arr.shape[0] // n_chunks) + arr.shape[1:])


def _pick_chunks(total: int, target_chunk: int) -> int:
    """Number of equal chunks covering `total` (total is a padded
    power-of-two multiple of 128, so any power-of-two chunk divides it)."""
    chunk = min(total, target_chunk)
    while total % chunk:
        chunk //= 2
    return total // chunk


def tri_hit_terms(o, d, v0, e1, e2):
    """Moller-Trumbore core. Broadcasts rays (B, 1, 3) against tris
    (1, C, 3) — or any compatible shapes. Returns (t, u, v, det)."""
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    ok = jnp.abs(det) > DET_EPS
    inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
    tvec = o - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    return t, u, v, det


def sphere_hit_t(o, d, center, radius, t_min, t_max):
    """Stable-quadratic sphere intersection; assumes |d| == 1 (a == 1), the
    same simplification the reference makes (`Sphere.fs:23-24`). Returns the
    nearest t in range, else BIG."""
    oc = o - center
    b = dot(oc, d)
    c = dot(oc, oc) - radius * radius
    disc = b * b - c
    ok = disc > 0.0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t0 = -b - sq
    t1 = -b + sq
    t0_ok = ok & (t0 > t_min) & (t0 < t_max)
    t1_ok = ok & (t1 > t_min) & (t1 < t_max)
    t = jnp.where(t0_ok, t0, jnp.where(t1_ok, t1, BIG))
    return t


def _closest_tri(scene, o, d, t_min, t_max, chunk=1024):
    """Scan over triangle chunks, keeping the running (t, index) minimum.
    Shapes: o, d are (B, 3). Returns t (B,), idx (B,) with idx == -1 on miss."""
    T = scene.tri_v0.shape[0]
    n_chunks = _pick_chunks(T, chunk)
    cs = T // n_chunks
    xs = (
        _chunk(scene.tri_v0, n_chunks),
        _chunk(scene.tri_e1, n_chunks),
        _chunk(scene.tri_e2, n_chunks),
        _chunk(scene.tri_mask, n_chunks),
        _chunk(jnp.arange(T, dtype=jnp.int32), n_chunks),
    )
    B = o.shape[0]

    def body(carry, x):
        best_t, best_i = carry
        v0, e1, e2, mask, ids = x
        t, u, v, det = tri_hit_terms(
            o[:, None, :], d[:, None, :], v0[None], e1[None], e2[None]
        )
        valid = (
            mask[None]
            & (jnp.abs(det) > DET_EPS)
            & (u >= 0.0)
            & (v >= 0.0)
            & (u + v <= 1.0)
            & (t > t_min[:, None])
            & (t < t_max[:, None])
        )
        t = jnp.where(valid, t, BIG)
        # min + index-select reduces: the smallest index wins among equal t
        cand_t = jnp.min(t, axis=1)
        cand_i = jnp.min(
            jnp.where(t <= cand_t[:, None], ids[None], jnp.int32(2**31 - 1)),
            axis=1,
        )
        better = cand_t < best_t
        return (
            jnp.where(better, cand_t, best_t),
            jnp.where(better, cand_i, best_i),
        ), None

    init = (jnp.full((B,), BIG), jnp.full((B,), -1, jnp.int32))
    (best_t, best_i), _ = lax.scan(body, init, xs)
    return best_t, best_i


def _closest_sphere(scene, o, d, t_min, t_max, times=None):
    """All spheres at once (sphere counts are small). `times` (B,) shifts
    centers by t * velocity (MovingSphere)."""
    center = scene.sph_center[None]
    if times is not None:
        center = center + scene.sph_velocity[None] * times[:, None, None]
    t = sphere_hit_t(
        o[:, None, :],
        d[:, None, :],
        center,
        scene.sph_radius[None],
        t_min[:, None],
        t_max[:, None],
    )
    t = jnp.where(scene.sph_mask[None], t, BIG)
    best = jnp.min(t, axis=1)
    Sp = t.shape[1]
    ids = jnp.arange(Sp, dtype=jnp.int32)
    arg = jnp.min(
        jnp.where(t <= best[:, None], ids[None], jnp.int32(Sp)), axis=1
    )
    return best, jnp.minimum(arg, Sp - 1)


def _closest_sphere_soa(scene, o, d, t_min, t_max, times=None):
    """SoA `_closest_sphere`: o, d are V3 columns, temps are (B, Sp).
    `times` (B,) shifts each sphere center by t * velocity (the reference's
    `MovingSphere`, `RenderTest/Sample/RayTracing.fs:210-253`)."""
    cx = scene.sph_center[None, :, 0]
    cy = scene.sph_center[None, :, 1]
    cz = scene.sph_center[None, :, 2]
    if times is not None:
        tb = times[:, None]
        cx = cx + scene.sph_velocity[None, :, 0] * tb
        cy = cy + scene.sph_velocity[None, :, 1] * tb
        cz = cz + scene.sph_velocity[None, :, 2] * tb
    r = scene.sph_radius[None, :]
    ox, oy, oz = o.x[:, None], o.y[:, None], o.z[:, None]
    dx, dy, dz = d.x[:, None], d.y[:, None], d.z[:, None]
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    b = ocx * dx + ocy * dy + ocz * dz
    c = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    disc = b * b - c
    ok = disc > 0.0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t0 = -b - sq
    t1 = -b + sq
    t0_ok = ok & (t0 > t_min[:, None]) & (t0 < t_max[:, None])
    t1_ok = ok & (t1 > t_min[:, None]) & (t1 < t_max[:, None])
    t = jnp.where(t0_ok, t0, jnp.where(t1_ok, t1, BIG))
    t = jnp.where(scene.sph_mask[None], t, BIG)
    best = jnp.min(t, axis=1)
    Sp = t.shape[1]
    ids = jnp.arange(Sp, dtype=jnp.int32)
    arg = jnp.min(jnp.where(t <= best[:, None], ids[None], jnp.int32(Sp)), axis=1)
    return best, jnp.minimum(arg, Sp - 1)


def find_closest(scene, rays: Rays, t_min, t_max, chunk=1024, times=None):
    """Non-differentiable closest-hit search. Returns (t, prim_idx) where
    prim_idx encodes triangles as [0, T) and spheres as T + s; -1 on miss.
    `times` (B,) enables sphere motion blur."""
    o = lax.stop_gradient(rays.origin)
    d = lax.stop_gradient(rays.direction)
    if times is not None:
        times = lax.stop_gradient(times)
    scene_sg = jax.tree_util.tree_map(lax.stop_gradient, scene)
    B = o.shape[0]
    t_min = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (B,))
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (B,))

    tt, ti = _closest_tri(scene_sg, o, d, t_min, t_max, chunk)
    if getattr(scene, "num_live_spheres", 1) > 0:
        st, si = _closest_sphere(scene_sg, o, d, t_min, t_max, times=times)
        T = scene.tri_v0.shape[0]
        use_sphere = st < tt
        tt = jnp.where(use_sphere, st, tt)
        ti = jnp.where(use_sphere, T + si, ti)
    idx = jnp.where(tt < BIG, ti, -1)
    return tt, idx


def hit_attributes(scene, rays: Rays, prim_idx: Array, t_hint: Array) -> Hit:
    """Differentiable recompute of hit attributes for the selected primitive.
    Gathers one primitive per ray and re-derives t/point/normal/uv with
    gradients flowing to ray and scene parameters. `t_hint` breaks the
    two-root ambiguity for spheres."""
    T = scene.tri_v0.shape[0]
    valid = prim_idx >= 0
    is_tri = valid & (prim_idx < T)
    is_sph = valid & (prim_idx >= T)
    tri_i = jnp.clip(prim_idx, 0, T - 1)
    sph_i = jnp.clip(prim_idx - T, 0, scene.sph_center.shape[0] - 1)

    o, d = rays.origin, rays.direction

    # --- triangle attributes ---
    v0 = scene.tri_v0[tri_i]
    e1 = scene.tri_e1[tri_i]
    e2 = scene.tri_e2[tri_i]
    t_tri, u, v, det = tri_hit_terms(o, d, v0, e1, e2)
    gn = normalize(cross(e1, e2))
    w = 1.0 - u - v
    sn = normalize(
        w[..., None] * scene.tri_n0[tri_i]
        + u[..., None] * scene.tri_n1[tri_i]
        + v[..., None] * scene.tri_n2[tri_i]
    )
    # Guard the shading normal against degenerate/missing normals.
    sn = jnp.where(dot(sn, sn)[..., None] > 0.5, sn, gn)
    uv_tri = (
        w[..., None] * scene.tri_uv0[tri_i]
        + u[..., None] * scene.tri_uv1[tri_i]
        + v[..., None] * scene.tri_uv2[tri_i]
    )
    tri_mat = scene.tri_mat[tri_i]

    # --- sphere attributes ---
    c = scene.sph_center[sph_i]
    r = scene.sph_radius[sph_i]
    oc = o - c
    b = dot(oc, d)
    disc = b * b - (dot(oc, oc) - r * r)
    sq = safe_sqrt(disc)  # NaN-safe backward on non-sphere/missed lanes
    t0, t1 = -b - sq, -b + sq
    # pick the root closest to the (detached) search result
    th = lax.stop_gradient(t_hint)
    t_sph = jnp.where(jnp.abs(t0 - th) < jnp.abs(t1 - th), t0, t1)
    p_sph = o + t_sph[..., None] * d
    n_sph = (p_sph - c) / jnp.maximum(r, 1e-8)[..., None]
    sph_mat = scene.sph_mat[sph_i]
    # uv: spherical coordinates (for textures; reference sample
    # `RayTracing.fs` textures spheres the same way). Guards: arccos has an
    # infinite gradient at +-1 and arctan2 is NaN-grad at (0,0); clamp away
    # from both so masked non-sphere lanes cannot poison the backward pass.
    nx = n_sph[..., 0]
    nz = n_sph[..., 2]
    deg = (nx * nx + nz * nz) < 1e-12
    phi = jnp.arctan2(nz, jnp.where(deg, 1.0, nx))
    theta = jnp.arccos(jnp.clip(n_sph[..., 1], -1.0 + 1e-6, 1.0 - 1e-6))
    uv_sph = jnp.stack(
        [0.5 + phi / (2.0 * jnp.pi), theta / jnp.pi], axis=-1
    )

    # --- merge ---
    # Missed rays get t = 0 (point = origin): every consumer masks by
    # `valid`, and keeping the padding finite prevents inf/NaN from leaking
    # into the backward pass through `where` (inf * 0 = NaN under AD).
    t = jnp.where(is_tri, t_tri, jnp.where(is_sph, t_sph, 0.0))
    point = rays.at(t)
    geo_n = jnp.where(is_tri[..., None], gn, n_sph)
    shade_n = jnp.where(is_tri[..., None], sn, n_sph)
    front = dot(geo_n, d) < 0.0
    # orient shading normal against the incident ray (double-sided shading,
    # matching the reference's double-sided triangles `Trangle.fs:130`)
    flip = jnp.where(front, 1.0, -1.0)[..., None]
    shade_n = shade_n * flip

    return Hit(
        valid=valid,
        t=t,
        point=point,
        normal=shade_n,
        front_face=front,
        material=jnp.where(is_tri, tri_mat, sph_mat).astype(jnp.int32),
        prim_idx=prim_idx,
        uv=jnp.where(is_tri[..., None], uv_tri, uv_sph),
    )


# ---------------------------------------------------------------------------
# Packed attribute fetch: ONE row gather instead of ~15 narrow ones
# ---------------------------------------------------------------------------
#
# All per-primitive attributes — geometry AND the joined material row — are
# therefore packed into one (T+Sp, 36) f32 matrix built on the fly inside
# jit (T-sized ops, trivially cheap; gradients flow through the pack/unpack
# to tri_v0 / mat_albedo / ... automatically).
#
# Column layout (tri rows | sphere rows):
#   0:3   v0            | center
#   3:6   e1            | radius (col 3), 0, 0
#   6:9   e2            | velocity (cols 6:9, for MovingSphere time shift)
#   9:12  n0, 12:15 n1, 15:18 n2 (shading normals) | 0
#   18:20 uv0, 20:22 uv1, 22:24 uv2                | 0
#   24:27 albedo   27:30 emission   30 fuzz   31 ior
#   32 material type   33 texture page   34 emitter two-sided   35 material id

PACKED_COLS = 36


def packed_attr_table(scene) -> Array:
    """(T + Sp, 36) joined attribute matrix (see layout above)."""
    T = scene.tri_v0.shape[0]
    L = scene.light_v0.shape[0]
    m = scene.tri_mat
    lid = scene.tri_light
    two = jnp.where(
        lid >= 0, scene.light_two_sided[jnp.clip(lid, 0, L - 1)], False
    )
    f = lambda x: x.astype(jnp.float32)
    tri_rows = jnp.concatenate(
        [
            scene.tri_v0, scene.tri_e1, scene.tri_e2,
            scene.tri_n0, scene.tri_n1, scene.tri_n2,
            scene.tri_uv0, scene.tri_uv1, scene.tri_uv2,
            scene.mat_albedo[m], scene.mat_emission[m],
            scene.mat_fuzz[m, None], scene.mat_ior[m, None],
            f(scene.mat_type[m, None]), f(scene.mat_tex[m, None]),
            f(two[:, None]), f(m[:, None]),
        ],
        axis=1,
    )
    Sp = scene.sph_center.shape[0]
    ms = scene.sph_mat
    sph_rows = jnp.concatenate(
        [
            scene.sph_center, scene.sph_radius[:, None],
            jnp.zeros((Sp, 2), jnp.float32),
            scene.sph_velocity,
            jnp.zeros((Sp, 15), jnp.float32),
            scene.mat_albedo[ms], scene.mat_emission[ms],
            scene.mat_fuzz[ms, None], scene.mat_ior[ms, None],
            f(scene.mat_type[ms, None]), f(scene.mat_tex[ms, None]),
            jnp.zeros((Sp, 1), jnp.float32), f(ms[:, None]),
        ],
        axis=1,
    )
    return jnp.concatenate([tri_rows, sph_rows], axis=0)


def hit_attributes_packed(scene, rays: Rays, prim_idx: Array, t_hint: Array,
                          packed=None, times=None):
    """Differentiable attribute + shading recompute via ONE packed row
    gather. Same math/contract as `hit_attributes`, plus a `Shading` record
    (material columns joined per primitive, albedo already modulated by its
    texture) so the shading stage performs no further table gathers."""
    from mafrixraytracing_tpu.core.types import Shading
    from mafrixraytracing_tpu.materials.texture import sample_atlas

    T = scene.tri_v0.shape[0]
    P = T + scene.sph_center.shape[0]
    valid = prim_idx >= 0
    is_tri = valid & (prim_idx < T)
    is_sph = valid & (prim_idx >= T)
    if packed is None:
        packed = packed_attr_table(scene)
    row = packed[jnp.clip(prim_idx, 0, P - 1)]  # (B, 36)

    o, d = rays.origin, rays.direction

    # --- triangle attributes ---
    v0, e1, e2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
    t_tri, u, v, det = tri_hit_terms(o, d, v0, e1, e2)
    gn = normalize(cross(e1, e2))
    w = 1.0 - u - v
    sn = normalize(
        w[..., None] * row[:, 9:12]
        + u[..., None] * row[:, 12:15]
        + v[..., None] * row[:, 15:18]
    )
    sn = jnp.where(dot(sn, sn)[..., None] > 0.5, sn, gn)
    uv_tri = (
        w[..., None] * row[:, 18:20]
        + u[..., None] * row[:, 20:22]
        + v[..., None] * row[:, 22:24]
    )

    # --- sphere attributes (sphere rows: center 0:3, radius col 3,
    # velocity 6:9 — time-shifted for MovingSphere, like hit_attributes_soa)
    c = row[:, 0:3]
    if times is not None:
        c = c + row[:, 6:9] * times[:, None]
    r = row[:, 3]
    oc = o - c
    b = dot(oc, d)
    disc = b * b - (dot(oc, oc) - r * r)
    sq = safe_sqrt(disc)
    t0, t1 = -b - sq, -b + sq
    th = lax.stop_gradient(t_hint)
    t_sph = jnp.where(jnp.abs(t0 - th) < jnp.abs(t1 - th), t0, t1)
    p_sph = o + t_sph[..., None] * d
    n_sph = (p_sph - c) / jnp.maximum(r, 1e-8)[..., None]
    nx = n_sph[..., 0]
    nz = n_sph[..., 2]
    deg = (nx * nx + nz * nz) < 1e-12
    phi = jnp.arctan2(nz, jnp.where(deg, 1.0, nx))
    theta = jnp.arccos(jnp.clip(n_sph[..., 1], -1.0 + 1e-6, 1.0 - 1e-6))
    uv_sph = jnp.stack([0.5 + phi / (2.0 * jnp.pi), theta / jnp.pi], axis=-1)

    # --- merge (same conventions as hit_attributes) ---
    t = jnp.where(is_tri, t_tri, jnp.where(is_sph, t_sph, 0.0))
    point = rays.at(t)
    geo_n = jnp.where(is_tri[..., None], gn, n_sph)
    shade_n = jnp.where(is_tri[..., None], sn, n_sph)
    front = dot(geo_n, d) < 0.0
    flip = jnp.where(front, 1.0, -1.0)[..., None]
    shade_n = shade_n * flip
    uv = jnp.where(is_tri[..., None], uv_tri, uv_sph)

    mat_id = row[:, 35].astype(jnp.int32)
    hit = Hit(
        valid=valid,
        t=t,
        point=point,
        normal=shade_n,
        front_face=front,
        material=mat_id,
        prim_idx=prim_idx,
        uv=uv,
    )
    tex_id = row[:, 33].astype(jnp.int32)
    # nearest sampling = reference Texture2D parity AND one gather instead
    # of four; the sampled value is checkpoint-named so the backward pass
    # reuses it instead of re-gathering under remat
    tex_rgb = checkpoint_name(
        sample_atlas(scene.tex_atlas, tex_id, uv, mode="nearest"), "tex_rgb"
    )
    sh = Shading(
        albedo=row[:, 24:27] * tex_rgb,
        emission=row[:, 27:30],
        fuzz=row[:, 30],
        ior=row[:, 31],
        mtype=row[:, 32].astype(jnp.int32),
        two_sided=row[:, 34] > 0.5,
    )
    return hit, sh


def fetch_cols(table, idx):
    """Gather rows `table[idx]` and return them as a tuple of flat (B,)
    columns: one row gather, its column slices behind an
    `optimization_barrier` (on an H100 the barrier form ran the
    forward+backward of the fetch ~27% faster than free slices, the forward
    alone equally fast — PERF.md). Differentiable w.r.t. `table` by plain
    autodiff."""
    rows = table[idx]
    return lax.optimization_barrier(
        tuple(rows[:, k] for k in range(table.shape[1])))


def hit_attributes_soa(scene, o, d, prim_idx: Array, t_hint: Array,
                       times=None, packed=None):
    """SoA form of `hit_attributes_packed`: o, d are `V3` ray columns;
    returns (HitS, ShadingS) built from flat (B,) components only — no
    (B, 3) arrays are ever materialized (see core.v3)."""
    from mafrixraytracing_tpu.core import v3
    from mafrixraytracing_tpu.core.types import HitS, ShadingS
    from mafrixraytracing_tpu.core.v3 import V3
    from mafrixraytracing_tpu.materials.texture import sample_atlas

    T = scene.tri_v0.shape[0]
    P = T + scene.sph_center.shape[0]
    valid = prim_idx >= 0
    is_tri = valid & (prim_idx < T)
    is_sph = valid & (prim_idx >= T)
    if packed is None:
        packed = packed_attr_table(scene)
    cols = fetch_cols(packed, jnp.clip(prim_idx, 0, P - 1))
    # checkpoint-named so a remat policy may SAVE the fetched columns and
    # skip the gather in the rematted recompute (integrator.path
    # opts in via PathTracerConfig.save_attrs; ~75 MB/bounce/spp-step)
    cols = tuple(checkpoint_name(c, f"attr{k}") for k, c in enumerate(cols))
    col = lambda k: cols[k]
    vec = lambda k: V3(cols[k], cols[k + 1], cols[k + 2])

    # --- triangle attributes (Moller-Trumbore on SoA columns) ---
    v0, e1, e2 = vec(0), vec(3), vec(6)
    pv = v3.cross(d, e2)
    det = v3.dot(e1, pv)
    ok = jnp.abs(det) > DET_EPS
    inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
    tv = o - v0
    u = v3.dot(tv, pv) * inv_det
    qv = v3.cross(tv, e1)
    v = v3.dot(d, qv) * inv_det
    t_tri = v3.dot(e2, qv) * inv_det
    gn = v3.normalize(v3.cross(e1, e2))
    w = 1.0 - u - v
    sn = v3.normalize(vec(9) * w + vec(12) * u + vec(15) * v)
    sn = v3.where(v3.dot(sn, sn) > 0.5, sn, gn)
    uu_tri = w * col(18) + u * col(20) + v * col(22)
    vv_tri = w * col(19) + u * col(21) + v * col(23)

    # --- sphere attributes (center in cols 0:3, radius col 3, velocity in
    # cols 6:9) — the center is time-shifted by velocity * time so moving
    # spheres (reference `MovingSphere`, `RayTracing.fs:210-253`) shade with
    # on-surface hit points/normals, consistent with the time-shifted
    # search. Statically skipped for sphere-free scenes (the quadratic +
    # arctan/arccos are dead weight per lane per bounce there).
    has_sph = scene.num_live_spheres > 0
    if has_sph:
        c = vec(0)
        if times is not None:
            c = c + vec(6) * times
        r = col(3)
        oc = o - c
        b = v3.dot(oc, d)
        disc = b * b - (v3.dot(oc, oc) - r * r)
        sq = safe_sqrt(disc)
        t0, t1 = -b - sq, -b + sq
        th = lax.stop_gradient(t_hint)
        t_sph = jnp.where(jnp.abs(t0 - th) < jnp.abs(t1 - th), t0, t1)
        inv_r = 1.0 / jnp.maximum(r, 1e-8)
        n_sph = (o + d * t_sph - c) * inv_r
        deg = (n_sph.x * n_sph.x + n_sph.z * n_sph.z) < 1e-12
        phi = jnp.arctan2(n_sph.z, jnp.where(deg, 1.0, n_sph.x))
        theta = jnp.arccos(jnp.clip(n_sph.y, -1.0 + 1e-6, 1.0 - 1e-6))
        uu_sph = 0.5 + phi / (2.0 * jnp.pi)
        vv_sph = theta / jnp.pi

        # --- merge ---
        t = jnp.where(is_tri, t_tri, jnp.where(is_sph, t_sph, 0.0))
        point = o + d * t
        geo_n = v3.where(is_tri, gn, n_sph)
        shade_n = v3.where(is_tri, sn, n_sph)
        front = v3.dot(geo_n, d) < 0.0
        shade_n = shade_n * jnp.where(front, 1.0, -1.0)
        uu = jnp.where(is_tri, uu_tri, uu_sph)
        vv = jnp.where(is_tri, vv_tri, vv_sph)
    else:
        t = jnp.where(is_tri, t_tri, 0.0)
        point = o + d * t
        front = v3.dot(gn, d) < 0.0
        shade_n = sn * jnp.where(front, 1.0, -1.0)
        uu, vv = uu_tri, vv_tri

    hit = HitS(
        valid=valid,
        t=t,
        point=point,
        normal=shade_n,
        front_face=front,
        material=col(35).astype(jnp.int32),
        prim_idx=prim_idx,
        u=uu,
        v=vv,
    )
    albedo = vec(24)
    if scene.has_textures:
        tex_id = col(33).astype(jnp.int32)
        # saved per flat component, like every other saved residual (see
        # core.v3)
        tex_rgb = V3.of(
            sample_atlas(scene.tex_atlas, tex_id,
                         jnp.stack([uu, vv], axis=-1), mode="nearest")
        )
        tex_rgb = V3(
            checkpoint_name(tex_rgb.x, "tex_r"),
            checkpoint_name(tex_rgb.y, "tex_g"),
            checkpoint_name(tex_rgb.z, "tex_b"),
        )
        albedo = albedo * tex_rgb
    # Solid-angle pdf of the sphere-light cone sampler for this very ray
    # (origin o toward sphere (c, r)): pdf = 1 / (2 pi (1 - cos_max)),
    # cos_max = sqrt(1 - r^2/|c-o|^2). Matches `lights.nee_sphere_soa`'s
    # sampler exactly (required for unbiased MIS); 0 when o is inside the
    # sphere (the cone sampler cannot generate interior hits, so the BSDF
    # side takes full weight) and for triangle rows.
    # detached: a sampling pdf used only inside MIS weights (differentiating
    # it is not part of the reparameterized estimator, and on triangle rows
    # the r/c columns hold unrelated data whose sqrt-at-zero backward would
    # emit NaN cotangents). Statically skipped when the scene has no sphere
    # lights (the table shape is compile-time known).
    if has_sph and scene.slight_center.shape[0] > 0:
        oc_l = jax.tree_util.tree_map(lax.stop_gradient, o - c)
        dc2 = v3.dot(oc_l, oc_l)
        r_sg = lax.stop_gradient(r)
        sin2_max = r_sg * r_sg / jnp.maximum(dc2, 1e-12)
        cos_max = jnp.sqrt(jnp.clip(1.0 - sin2_max, 0.0, 1.0))
        cone_solid = 2.0 * jnp.pi * jnp.maximum(1.0 - cos_max, 1e-12)
        light_pdf_sa = jnp.where(
            is_sph & (sin2_max < 1.0), 1.0 / cone_solid, 0.0
        )
    else:
        light_pdf_sa = jnp.zeros_like(t)

    sh = ShadingS(
        albedo=albedo,
        emission=vec(27),
        fuzz=col(30),
        ior=col(31),
        mtype=col(32).astype(jnp.int32),
        two_sided=col(34) > 0.5,
        light_pdf_sa=light_pdf_sa,
    )
    return hit, sh


def intersect_scene(scene, rays: Rays, t_min=1e-4, t_max=1e8, chunk=1024) -> Hit:
    """Closest-hit query: detached search + differentiable attribute
    recompute (see module docstring). The jnp reference path; `ops` swaps in
    Pallas for the search."""
    t, idx = find_closest(scene, rays, t_min, t_max, chunk)
    return hit_attributes(scene, rays, idx, t)


def occluded(scene, rays: Rays, t_min, t_max, chunk=1024, times=None) -> Array:
    """Boolean any-hit query for shadow rays (reference shadow test
    `Core/Integrator/Integrators.fs:44`: `bvh.Hit(p, dir, 1e-6, dist-1e-6)`).
    Visibility is detached (not differentiated) by construction."""
    t, idx = find_closest(scene, rays, t_min, t_max, chunk, times=times)
    return idx >= 0
