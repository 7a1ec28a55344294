"""Whitted-style deterministic ray tracer.

Parity target: the reference's (commented-out) Whitted tracer
(`Core/Tracer/Whitted.fs`, DEAD — SURVEY §2.8): depth-limited recursion,
local shading at the first diffuse hit, and the RTIOW sky-gradient miss
shader its dead tracers share (`Core/Tracer/PathTracer.fs:48-67`).

Wavefront redesign — a *deterministic* wavefront loop (`lax.scan` over
depth), no Monte Carlo anywhere:

- miss        -> throughput * sky gradient, retire.
- emissive    -> throughput * Le, retire.
- lambert     -> local illumination: deterministic shadow rays to every
                 area-light row's centroid (the classic Whitted local term;
                 radiance uses the reference's `NewAreaLight.L` fold
                 `I * |cos_l| * Area / d^2`, `Core/Lights/Light.fs:48-59`)
                 plus every point light (`Light.fs:9-29`); retire.
- metal       -> perfect-mirror continuation (fuzz ignored: Whitted has no
                 glossy cone without sampling), throughput *= albedo.
- dielectric  -> deterministic refract branch weighted (1 - Fresnel), or
                 total-internal-reflection mirror branch. (A wavefront
                 cannot fork into the classic reflect+refract ray *tree*;
                 following the transmission branch is the standard
                 single-path Whitted reduction.)

Unlike `integrator.direct` (a config alias of the stochastic path tracer),
no RNG key is ever consumed: two renders of the same scene are bit-equal.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
from jax import Array, lax

from mafrixraytracing_tpu.core.math import dot, fresnel_dielectric, normalize, reflect, refract
from mafrixraytracing_tpu.core.types import Rays
from mafrixraytracing_tpu.integrator.path import RAY_EPS, make_pixel_uv
from mafrixraytracing_tpu.lights import lights as L
from mafrixraytracing_tpu.materials.bsdf import (
    DIELECTRIC,
    EMISSIVE,
    GLOSSY,
    LAMBERT,
    METAL,
)

INV_PI = 1.0 / jnp.pi


def sky_gradient(directions: Array) -> Array:
    """The RTIOW vertical blue-white lerp used by the reference's miss
    shaders (`RenderTest/Sample/RayTracing.fs:376-381`)."""
    t = 0.5 * (directions[..., 1] + 1.0)
    white = jnp.array([1.0, 1.0, 1.0])
    blue = jnp.array([0.5, 0.7, 1.0])
    return (1.0 - t)[..., None] * white + t[..., None] * blue


@dataclass(frozen=True)
class WhittedConfig:
    max_depth: int = 5          # delta-recursion depth
    t_min: float = RAY_EPS
    sky: bool = True            # sky-gradient miss shader (else scene.background)
    backend: str = "auto"
    chunk: int = 1024


def _direct_deterministic(scene, hit, occluded_fn):
    """Local illumination at a diffuse hit: one deterministic shadow ray to
    each area-light row's centroid + each point light. Returns (B, 3)."""
    B = hit.t.shape[0]
    total = jnp.zeros((B, 3), jnp.float32)
    Lrows = scene.light_v0.shape[0]
    for i in range(Lrows):
        centroid = scene.light_v0[i] + (scene.light_e1[i] + scene.light_e2[i]) / 3.0
        to_l = centroid[None, :] - hit.point
        d2 = jnp.maximum(dot(to_l, to_l), 1e-12)
        dist = jnp.sqrt(d2)
        wl = to_l / dist[:, None]
        cos_s = dot(hit.normal, wl)
        cos_l = dot(scene.light_normal[i][None, :], -wl)
        facing = jnp.where(scene.light_two_sided[i], jnp.abs(cos_l), cos_l)
        # visibility measured from the OFFSET origin: using the hit.point
        # distance would self-occlude against visible light geometry
        # (lights.nee_area_soa has the full analysis)
        so = hit.point + hit.normal * L.SHADOW_EPS
        to_o = centroid[None, :] - so
        disto = jnp.sqrt(jnp.maximum(dot(to_o, to_o), 1e-12))
        shadow = Rays(origin=so, direction=to_o / disto[:, None])
        blocked = occluded_fn(shadow, L.SHADOW_EPS, disto - L.SHADOW_EPS)
        # reference `NewAreaLight.L` fold: I * |cos_l| * Area / d^2
        rad = scene.light_radiance[i][None, :] * (
            facing * scene.light_area[i] / d2
        )[:, None]
        ok = (
            scene.light_mask[i]
            & ~blocked
            & (cos_s > 0.0)
            & (facing > 0.0)
        )
        total = total + jnp.where(ok[:, None], rad * cos_s[:, None], 0.0)
    return total


def trace_whitted(
    scene, rays: Rays, keys=None, config: WhittedConfig = WhittedConfig()
) -> Array:
    """Deterministic radiance for a ray batch. `keys` accepted (ignored) for
    signature parity with `trace_radiance`."""
    from mafrixraytracing_tpu.ops import dispatch

    B = rays.origin.shape[0]

    def occluded_fn(shadow_rays, t_min, t_max):
        return dispatch.occluded(scene, shadow_rays, t_min, t_max,
                                 chunk=config.chunk, backend=config.backend)

    def bounce_step(carry, _):
        rays, throughput, radiance, alive = carry
        t_max = jnp.where(alive, 1e8, 0.0)
        hit, sh = dispatch.intersect_shade(scene, rays, config.t_min, t_max,
                                           chunk=config.chunk, backend=config.backend)
        miss = alive & ~hit.valid
        bg = sky_gradient(rays.direction) if config.sky else scene.background[None, :]
        radiance = radiance + jnp.where(miss[:, None], throughput * bg, 0.0)

        mtype = sh.mtype
        albedo = sh.albedo
        live = alive & hit.valid

        # emissive: add and retire
        is_em = live & (mtype == EMISSIVE)
        radiance = radiance + jnp.where(
            is_em[:, None], throughput * sh.emission, 0.0
        )

        # lambert: local illumination, retire. Area-light irradiance is
        # weighted by the lambert BRDF here; nee_point folds the BRDF itself
        # (its `eval_bsdf` call).
        # glossy shades like lambert under Whitted (the classic tracer has
        # no distributed glossy reflection; reference Whitted is DEAD anyway)
        is_lam = live & ((mtype == LAMBERT) | (mtype == GLOSSY))
        direct = _direct_deterministic(scene, hit, occluded_fn)
        point_part = L.nee_point(scene, hit, -rays.direction, occluded_fn, sh=sh)
        radiance = radiance + jnp.where(
            is_lam[:, None],
            throughput * (albedo * INV_PI * direct + point_part),
            0.0,
        )

        # metal: perfect mirror
        d = rays.direction
        n = hit.normal
        wi_mirror = reflect(d, n)

        # dielectric: deterministic transmission branch (TIR -> mirror)
        cos_i = jnp.clip(-dot(d, n), 0.0, 1.0)
        eta_i = jnp.where(hit.front_face, 1.0, sh.ior)
        eta_t = jnp.where(hit.front_face, sh.ior, 1.0)
        fr = fresnel_dielectric(cos_i, eta_i, eta_t)
        ref_ok, refr = refract(d, n, eta_i / eta_t)
        refr = normalize(refr)
        wi_die = jnp.where(ref_ok[:, None], refr, wi_mirror)
        w_die = jnp.where(ref_ok, 1.0 - fr, 1.0)

        is_met = live & (mtype == METAL)
        is_die = live & (mtype == DIELECTRIC)
        wi = jnp.where(is_die[:, None], wi_die, wi_mirror)
        weight = jnp.where(
            is_met[:, None], albedo, jnp.where(is_die[:, None], w_die[:, None], 0.0)
        )

        alive = is_met | is_die
        throughput = jnp.where(alive[:, None], throughput * weight, throughput)
        offset_n = jnp.where(dot(n, wi)[:, None] >= 0.0, 1.0, -1.0) * n
        rays = Rays(origin=hit.point + offset_n * RAY_EPS, direction=wi)
        return (rays, throughput, radiance, alive), None

    init = (
        rays,
        jnp.ones((B, 3), jnp.float32),
        jnp.zeros((B, 3), jnp.float32),
        jnp.ones((B,), bool),
    )
    (_, _, radiance, _), _ = lax.scan(
        bounce_step, init, None, length=config.max_depth
    )
    return radiance


@partial(jax.jit, static_argnames=("width", "height", "config"))
def render_whitted(scene, camera, width: int, height: int,
                   config: WhittedConfig = WhittedConfig()) -> Array:
    """Full-frame deterministic Whitted render (pixel centers, 1 ray/pixel —
    no jitter: nothing in the pipeline is stochastic)."""
    px, py = make_pixel_uv(width, height)
    u = (px + 0.5) / width
    v = (py + 0.5) / height
    rays = camera.get_rays(u, v)
    rad = trace_whitted(scene, rays, config=config)
    return rad.reshape(height, width, 3)
