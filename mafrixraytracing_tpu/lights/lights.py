"""Light sampling and next-event estimation.

Replaces `INewLight` / `NewAreaLight` / `NewPointLight`
(`Core/Lights/Light.fs:9-64`) and `SingleDirectLightIntegrator`
(`Core/Integrator/Integrators.fs:20-54`) with batched, differentiable array
ops over the scene's light table:

- Area lights are triangle sets; a point is drawn by area-weighted CDF
  inversion over the table, then sqrt-warp barycentrics on the chosen
  triangle (the reference warps the same way, `Core/Shape/Trangle.fs:157-169`,
  but picks the rect's two triangles *uniformly* — a bug for uneven splits,
  `Core/Shape/Rect.fs:33-38`; the CDF fixes that and generalizes to N lights,
  which the reference only sketched in `RandomDirectLightIntegrator`).
- Shadow rays are detached any-hit queries (visibility is not
  differentiated), with the reference's epsilon protocol
  (`bvh.Hit(p, dir, 1e-6, dist - 1e-6)`, `Integrators.fs:44`).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from mafrixraytracing_tpu.core import struct
from jax import Array

from mafrixraytracing_tpu.core import rng
from mafrixraytracing_tpu.core.math import dot, normalize
from mafrixraytracing_tpu.core.sampling import uniform_triangle
from mafrixraytracing_tpu.core.types import Rays
from mafrixraytracing_tpu.materials.bsdf import eval_bsdf

SHADOW_EPS = 1e-3


class LightSample(struct.PyTreeNode):
    point: Array      # (..., 3) sampled point on a light
    normal: Array     # (..., 3) light-surface normal at the point
    radiance: Array   # (..., 3) emitted radiance toward the shading point
    pdf_area: Array   # (...,) area-measure pdf of the sample
    two_sided: Array  # (...,) bool — emitter radiates from both faces
    valid: Array      # (...,) bool — scene has any area light


def sample_area_lights(scene, key: Array, batch_shape) -> LightSample:
    """Draw one point on the scene's area lights per batch element."""
    u_pick = rng.uniforms(key, 10)
    u_bary = rng.uniforms(key, 11, (2,))
    # CDF inversion over light triangles (L is small; searchsorted is fine)
    li = jnp.searchsorted(scene.light_cdf, u_pick, side="right")
    li = jnp.clip(li, 0, scene.light_v0.shape[0] - 1).astype(jnp.int32)
    b = uniform_triangle(u_bary)
    v0 = scene.light_v0[li]
    p = v0 + b[..., 0:1] * scene.light_e1[li] + b[..., 1:2] * scene.light_e2[li]
    pdf_area = jnp.where(
        scene.light_total_area > 0.0, 1.0 / jnp.maximum(scene.light_total_area, 1e-12), 0.0
    )
    pdf_area = jnp.broadcast_to(pdf_area, batch_shape)
    any_light = jnp.any(scene.light_mask)
    return LightSample(
        point=p,
        normal=scene.light_normal[li],
        radiance=scene.light_radiance[li],
        pdf_area=pdf_area,
        two_sided=scene.light_two_sided[li],
        valid=jnp.broadcast_to(any_light, batch_shape) & scene.light_mask[li],
    )


def light_pdf_area(scene) -> Array:
    """Area pdf of the CDF sampler — uniform over total emitter area, so it
    is the same scalar for every emitter (used to convert an emissive BSDF
    hit into the light sampler's pdf for MIS)."""
    return jnp.where(
        scene.light_total_area > 0.0,
        1.0 / jnp.maximum(scene.light_total_area, 1e-12),
        0.0,
    )


def nee_area(scene, hit, wo, key, occluded_fn, mis: bool = True, sh=None):
    """Next-event estimation against area lights. Returns the direct-light
    radiance estimate (..., 3), zero where shadowed/invalid.

    Physical estimator: f * cos_s * Le * cos_l / (d^2 * pdf_A), with the
    power-2 MIS heuristic against the BSDF pdf when `mis` (the reference
    comments "MIS" at `Integrators.fs:134` but never weights; see
    `integrator.path` for its parity mode).
    """
    ls = sample_area_lights(scene, key, hit.t.shape)
    to_l = ls.point - hit.point
    d2 = jnp.maximum(dot(to_l, to_l), 1e-12)
    dist = jnp.sqrt(d2)
    wl = to_l / dist[..., None]

    cos_s = dot(hit.normal, wl)
    cos_l = dot(ls.normal, -wl)
    # one-sided lights only illuminate points on their front side
    facing = jnp.where(ls.two_sided, cos_l != 0.0, cos_l > 0.0)
    cos_l_eff = jnp.abs(cos_l)

    f, pdf_b = eval_bsdf(scene, hit, wo, wl, sh=sh)
    candidate = (
        ls.valid
        & hit.valid
        & (cos_s > 0.0)
        & facing
        & (ls.pdf_area > 0.0)
        & jnp.any(f > 0.0, axis=-1)
    )

    # visibility measured from the OFFSET origin (see nee_area_soa: the
    # hit.point distance self-occludes against visible light geometry)
    origin = hit.point + hit.normal * SHADOW_EPS
    to_p = ls.point - origin
    d2o = jnp.maximum(dot(to_p, to_p), 1e-12)
    disto = jnp.sqrt(d2o)
    shadow_rays = Rays(origin=origin, direction=to_p / disto[..., None])
    # non-candidate lanes get t_max = 0 so the intersector's cull skips them
    blocked = occluded_fn(
        shadow_rays, SHADOW_EPS, jnp.where(candidate, disto - SHADOW_EPS, 0.0)
    )
    vis = candidate & ~blocked

    geom = cos_l_eff / d2
    contrib = f * (cos_s * geom / jnp.maximum(ls.pdf_area, 1e-12))[..., None] * ls.radiance

    if mis:
        pdf_l_sa = ls.pdf_area * d2 / jnp.maximum(cos_l_eff, 1e-8)
        w = pdf_l_sa**2 / jnp.maximum(pdf_l_sa**2 + pdf_b**2, 1e-20)
        contrib = contrib * w[..., None]

    return jnp.where(vis[..., None], contrib, 0.0)


def nee_point(scene, hit, wo, occluded_fn, sh=None):
    """Direct lighting from point lights (reference `NewPointLight`,
    `Core/Lights/Light.fs:9-29`: radiance intensity/d^2; its `Sample_Li` was
    stubbed to zeros — here point lights actually work). Sums over the
    (small, padded) point-light table; delta lights take no MIS."""
    P = scene.plight_pos.shape[0]
    if P == 0:
        return jnp.zeros(hit.point.shape, jnp.float32)

    B = hit.point.shape[0]
    # (P, B) shadow geometry, flattened into ONE batched occlusion query —
    # P separate queries would each pay a full intersector pass
    to_l = scene.plight_pos[:, None, :] - hit.point[None]          # (P, B, 3)
    d2 = jnp.maximum(dot(to_l, to_l), 1e-12)
    dist = jnp.sqrt(d2)
    wl = to_l / dist[..., None]
    cos_s = dot(hit.normal[None], wl)
    if sh is not None:
        sh = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x[None], (P,) + x.shape), sh
        )
    f, _ = eval_bsdf(scene, hit, wo[None] * jnp.ones((P, 1, 1)), wl, sh=sh)
    candidate = (
        scene.plight_mask[:, None]
        & hit.valid[None]
        & (cos_s > 0.0)
        & jnp.any(f > 0.0, axis=-1)
    )
    origin = hit.point[None] + hit.normal[None] * SHADOW_EPS
    shadow_rays = Rays(
        origin=jnp.broadcast_to(origin, (P, B, 3)).reshape(P * B, 3),
        direction=wl.reshape(P * B, 3),
    )
    t_far = jnp.where(candidate, dist - SHADOW_EPS, 0.0).reshape(P * B)
    blocked = occluded_fn(shadow_rays, SHADOW_EPS, t_far).reshape(P, B)
    vis = candidate & ~blocked
    contrib = f * (cos_s / d2)[..., None] * scene.plight_intensity[:, None, :]
    return jnp.sum(jnp.where(vis[..., None], contrib, 0.0), axis=0)


# ---------------------------------------------------------------------------
# SoA variants — flat-component vectors (core.v3) for the hot path
# ---------------------------------------------------------------------------

from mafrixraytracing_tpu.core import v3  # noqa: E402
from mafrixraytracing_tpu.core.v3 import V3  # noqa: E402
from mafrixraytracing_tpu.materials.bsdf import eval_bsdf_soa  # noqa: E402


def packed_light_table(scene):
    """(L, 16) joined light-row matrix so the per-ray light fetch is ONE row
    gather instead of five narrow ones:
    0:3 v0 | 3:6 e1 | 6:9 e2 | 9:12 normal | 12:15 radiance |
    15 flags (1 = two_sided, 2 = live)."""
    flags = (
        scene.light_two_sided.astype(jnp.float32)
        + 2.0 * scene.light_mask.astype(jnp.float32)
    )
    return jnp.concatenate(
        [
            scene.light_v0, scene.light_e1, scene.light_e2,
            scene.light_normal, scene.light_radiance, flags[:, None],
        ],
        axis=1,
    )


def nee_area_soa(scene, hit, key, occluded_fn, mis: bool, sh, wo=None):
    """SoA `nee_area`: same estimator on flat components; light row fetched
    with one packed gather."""
    from mafrixraytracing_tpu.core import rng
    from mafrixraytracing_tpu.core.sampling import uniform_triangle

    u_pick = rng.uniforms(key, 10)
    u_bary = rng.uniforms(key, 11, (2,))
    L = scene.light_v0.shape[0]
    li = jnp.searchsorted(scene.light_cdf, u_pick, side="right")
    li = jnp.clip(li, 0, L - 1).astype(jnp.int32)
    row = packed_light_table(scene)[li]  # (B, 16): one row gather
    vec = lambda k: V3(row[:, k], row[:, k + 1], row[:, k + 2])
    b = uniform_triangle(u_bary)
    p = vec(0) + vec(3) * b[..., 0] + vec(6) * b[..., 1]
    ln = vec(9)
    radiance = vec(12)
    two_sided = jnp.mod(row[:, 15], 2.0) > 0.5
    row_live = row[:, 15] >= 2.0
    pdf_area = jnp.where(
        scene.light_total_area > 0.0,
        1.0 / jnp.maximum(scene.light_total_area, 1e-12), 0.0,
    )
    ls_valid = jnp.any(scene.light_mask) & row_live

    to_l = p - hit.point
    d2 = jnp.maximum(v3.dot(to_l, to_l), 1e-12)
    inv_d = jax.lax.rsqrt(d2)
    dist = d2 * inv_d
    wl = to_l * inv_d
    cos_s = v3.dot(hit.normal, wl)
    cos_l = -v3.dot(ln, wl)
    facing = jnp.where(two_sided, cos_l != 0.0, cos_l > 0.0)
    cos_l_eff = jnp.abs(cos_l)

    f, pdf_b = eval_bsdf_soa(sh, hit, wl, wo=wo)
    candidate = (
        ls_valid & hit.valid & (cos_s > 0.0) & facing & (pdf_area > 0.0)
        & ((f.x > 0.0) | (f.y > 0.0) | (f.z > 0.0))
    )
    # Visibility: the ray is cast from the OFFSET origin, so its distance
    # to the sampled light point must also be measured from the offset
    # origin. Using the hit.point distance here self-occludes against the
    # target light's own (visible) geometry: the light plane sits at
    # dist - eps/cos(theta) < dist - eps for every non-normal direction
    # (round-4 finding — NEE was ~dead for visible lights at oblique
    # angles; tests/test_integrator.py::test_nee_visible_light_oblique).
    origin = hit.point + hit.normal * SHADOW_EPS
    to_p = p - origin
    d2o = jnp.maximum(v3.dot(to_p, to_p), 1e-12)
    inv_do = jax.lax.rsqrt(d2o)
    blocked = occluded_fn(
        origin, to_p * inv_do, SHADOW_EPS,
        jnp.where(candidate, d2o * inv_do - SHADOW_EPS, 0.0),
    )
    vis = candidate & ~blocked
    scale = cos_s * (cos_l_eff / d2) / jnp.maximum(pdf_area, 1e-12)
    if mis:
        pdf_l_sa = pdf_area * d2 / jnp.maximum(cos_l_eff, 1e-8)
        scale = scale * pdf_l_sa**2 / jnp.maximum(pdf_l_sa**2 + pdf_b**2, 1e-20)
    scale = jnp.where(vis, scale, 0.0)
    return f * radiance * scale


def nee_point_soa(scene, hit, occluded_fn, sh, wo=None) -> V3:
    """SoA `nee_point`: static loop over the (small) point-light table with
    one batched occlusion query."""
    P = scene.plight_pos.shape[0]
    zero = V3.fill((0.0, 0.0, 0.0), hit.t.shape)
    if P == 0:
        return zero
    B = hit.t.shape[0]
    total = zero
    origin = hit.point + hit.normal * SHADOW_EPS
    # per-light flat geometry; occlusion flattened into one query
    geoms = []
    for i in range(P):
        lp = V3(scene.plight_pos[i, 0], scene.plight_pos[i, 1], scene.plight_pos[i, 2])
        to_l = V3(lp.x - hit.point.x, lp.y - hit.point.y, lp.z - hit.point.z)
        d2 = jnp.maximum(v3.dot(to_l, to_l), 1e-12)
        inv_d = jax.lax.rsqrt(d2)
        wl = to_l * inv_d
        dist = d2 * inv_d
        cos_s = v3.dot(hit.normal, wl)
        f, _ = eval_bsdf_soa(sh, hit, wl, wo=wo)
        candidate = (
            scene.plight_mask[i] & hit.valid & (cos_s > 0.0)
            & ((f.x > 0.0) | (f.y > 0.0) | (f.z > 0.0))
        )
        geoms.append((wl, dist, d2, cos_s, f, candidate))
    so = V3(*(jnp.tile(c, P) for c in origin))
    sd = V3(*(jnp.concatenate([g[0][k] for g in geoms]) for k in range(3)))
    t_far = jnp.concatenate(
        [jnp.where(g[5], g[1] - SHADOW_EPS, 0.0) for g in geoms]
    )
    blocked = occluded_fn(so, sd, SHADOW_EPS, t_far).reshape(P, B)
    for i, (wl, dist, d2, cos_s, f, candidate) in enumerate(geoms):
        vis = candidate & ~blocked[i]
        inten = scene.plight_intensity[i]
        s = jnp.where(vis, cos_s / d2, 0.0)
        total = total + f * V3(inten[0] * s, inten[1] * s, inten[2] * s)
    return total


def nee_sphere_soa(scene, hit, key, occluded_fn, sh, mis: bool = True,
                   wo=None, times=None) -> V3:
    """Direct lighting from emissive-material spheres (the reference's DEAD
    `CircleAreaLightObject`, revived): per sphere-light row, one direction
    sampled uniformly inside the *visible cone* (PBRT-style cap sampling:
    cos_t uniform in [cos_max, 1], pdf_sa = 1/(2 pi (1 - cos_max)) with
    cos_max = sqrt(1 - r^2/d_c^2)) — never wastes samples on the back side —
    then the solid-angle estimator f * Le * cos_s / pdf_sa, power-2
    MIS-weighted against the BSDF pdf for the same direction. The matching
    BSDF-side weight uses `ShadingS.light_pdf_sa` (see `_trace_physical`).
    Shading points *inside* a sphere light are not sampled (the emission is
    picked up by the BSDF side at full weight). Static loop over the (small)
    table, shadow rays flattened into one batched occlusion query.

    `times` (B,) — with motion blur, a moving emissive sphere is sampled at
    its time-shifted center (center + velocity * time), matching both the
    time-shifted intersection search and the BSDF-side MIS pdf that
    `hit_attributes_soa` computes from the shifted center; drawing from the
    static center would light from the wrong position and break MIS
    consistency (round-4 ADVICE item 1)."""
    from mafrixraytracing_tpu.core import rng
    from mafrixraytracing_tpu.core.sampling import _local_to_world_soa

    SL = scene.slight_center.shape[0]
    zero = V3.fill((0.0, 0.0, 0.0), hit.t.shape)
    if SL == 0:
        return zero
    B = hit.t.shape[0]
    origin = hit.point + hit.normal * SHADOW_EPS
    total = zero
    geoms = []
    for i in range(SL):
        u = rng.uniforms(rng.split_dim(key, 40 + i), 0, (2,))
        c = jax.lax.stop_gradient(scene.slight_center[i])
        cx, cy, cz = c[0], c[1], c[2]  # scalars, or (B,) when time-shifted
        if times is not None:
            vel = jax.lax.stop_gradient(scene.slight_velocity[i])
            cx = cx + vel[0] * times
            cy = cy + vel[1] * times
            cz = cz + vel[2] * times
        r = jax.lax.stop_gradient(scene.slight_radius[i])
        # the sampled cone geometry (direction, distance, pdf) is detached:
        # it parameterizes the sampler, not the integrand — gradients flow
        # through f, cos_s (shading normal) and Le; sqrt(1 - sin2) at
        # sin2 == 1 (shading point on/inside the light) would otherwise emit
        # NaN cotangents
        hp = jax.tree_util.tree_map(jax.lax.stop_gradient, hit.point)
        to_c = V3(cx - hp.x, cy - hp.y, cz - hp.z)
        dc2 = jnp.maximum(v3.dot(to_c, to_c), 1e-12)
        inv_dc = jax.lax.rsqrt(dc2)
        w_axis = to_c * inv_dc
        sin2_max = jnp.clip(r * r / dc2, 0.0, 1.0)
        cos_max = jnp.sqrt(1.0 - sin2_max)
        # uniform in the cap: cos_t ~ U[cos_max, 1]
        cos_t = 1.0 - u[..., 0] * (1.0 - cos_max)
        sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
        phi = 2.0 * jnp.pi * u[..., 1]
        wl = _local_to_world_soa(
            sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), cos_t, w_axis
        )
        # nearest sphere intersection along wl FROM THE OFFSET SHADOW ORIGIN
        # (visibility rays start at hit.point + n*eps; measuring the
        # distance from hit.point instead would place the light's own
        # surface inside the shadow interval and self-occlude — see
        # nee_area_soa). Near-tangent lanes where the offset ray
        # geometrically MISSES the sphere are rejected outright: crediting
        # them full Le with a fallback distance slightly biased light
        # silhouettes (round-4 ADVICE item 2).
        oc = origin - V3(
            jnp.broadcast_to(cx, origin.x.shape),
            jnp.broadcast_to(cy, origin.x.shape),
            jnp.broadcast_to(cz, origin.x.shape),
        )
        bq = v3.dot(oc, wl)
        cq = v3.dot(oc, oc) - r * r
        disc_o = bq * bq - cq
        tno = -bq - jnp.sqrt(jnp.maximum(disc_o, 0.0))
        hits_light = (disc_o > 0.0) & (tno > 0.0)
        dist = jnp.where(hits_light, tno, 0.0)
        pdf_sa = 1.0 / jnp.maximum(2.0 * jnp.pi * (1.0 - cos_max), 1e-12)
        cos_s = v3.dot(hit.normal, wl)
        f, pdf_b = eval_bsdf_soa(sh, hit, wl, wo=wo)
        inside = r * r >= dc2
        candidate = (
            scene.slight_mask[i] & hit.valid & (cos_s > 0.0) & ~inside
            & hits_light
            & ((f.x > 0.0) | (f.y > 0.0) | (f.z > 0.0))
        )
        if mis:
            w_mis = pdf_sa**2 / jnp.maximum(pdf_sa**2 + pdf_b**2, 1e-20)
        else:
            w_mis = jnp.ones_like(pdf_sa)
        geoms.append((wl, dist, cos_s, f, candidate, pdf_sa, w_mis, i))
    so = V3(*(jnp.tile(cc, SL) for cc in origin))
    sd = V3(*(jnp.concatenate([g[0][k] for g in geoms]) for k in range(3)))
    t_far = jnp.concatenate(
        [jnp.where(g[4], g[1] - SHADOW_EPS, 0.0) for g in geoms]
    )
    blocked = occluded_fn(so, sd, SHADOW_EPS, t_far).reshape(SL, B)
    for (wl, dist, cos_s, f, candidate, pdf_sa, w_mis, i) in geoms:
        vis = candidate & ~blocked[i]
        Le = scene.slight_radiance[i]
        s_ = jnp.where(vis, cos_s * w_mis / pdf_sa, 0.0)
        total = total + f * V3(Le[0] * s_, Le[1] * s_, Le[2] * s_)
    return total
