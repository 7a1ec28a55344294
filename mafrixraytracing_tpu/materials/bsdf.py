"""Table-driven BSDFs: lambert / metal / dielectric / emissive.

Replaces the reference's `IMaterial`/`IBxdf` class zoo
(`Core/Materials/Material.fs:29-125`) with a material *table* (see
`ScenePytree.mat_*`) indexed per hit — the SIMD analog of
`MaterialManager[hit.materialIndex]` (`Core/Integrator/Integrators.fs:118`).
All material branches are evaluated arithmetically and blended with
`jnp.where` on the type id: no divergent control flow across a
wavefront, and the whole shader stays differentiable.

Conventions: `wo` points *away* from the surface (toward the previous
vertex); `n` is the shading normal oriented against the incident ray;
`sample` returns `weight = f * cos / pdf` directly (for every lobe here this
collapses to `albedo`-like terms, which is also exactly the fold the
reference does in `LambertianBrdf.SampleF`, `Material.fs:33-36`).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from mafrixraytracing_tpu.core import struct
from jax import Array

from mafrixraytracing_tpu.core import rng
from mafrixraytracing_tpu.core.math import (
    dot,
    fresnel_dielectric,
    normalize,
    reflect,
    refract,
)
from mafrixraytracing_tpu.core.sampling import (
    cosine_hemisphere,
    fuzz_sphere,
    uniform_hemisphere,
)

LAMBERT, METAL, DIELECTRIC, EMISSIVE, GLOSSY = 0, 1, 2, 3, 4
INV_PI = 1.0 / jnp.pi
TWO_PI = 2.0 * jnp.pi


def surface_albedo(scene, hit):
    """Base color at a hit: material albedo modulated by its texture (the
    reference's `Lambertian(Texture)` sample material,
    `RenderTest/Sample/RayTracing.fs:277-291`, and per-pixel texture sample
    in the rasterizer, `Core/Pipeline.fs:86-103`)."""
    from mafrixraytracing_tpu.materials.texture import sample_atlas

    m = hit.material
    albedo = scene.mat_albedo[m]
    tex = scene.mat_tex[m]
    return albedo * sample_atlas(scene.tex_atlas, tex, hit.uv)


def make_shading(scene, hit):
    """Gather-based `Shading` construction — the compatibility path for
    callers without the packed row fetch (see
    `geometry.intersect.hit_attributes_packed` for the one-gather path the
    integrators use)."""
    from mafrixraytracing_tpu.core.types import Shading

    m = hit.material
    T = scene.tri_v0.shape[0]
    lid = scene.tri_light[jnp.clip(hit.prim_idx, 0, T - 1)]
    lid = jnp.where((hit.prim_idx >= 0) & (hit.prim_idx < T), lid, -1)
    two = jnp.where(
        lid >= 0,
        scene.light_two_sided[jnp.clip(lid, 0, scene.light_v0.shape[0] - 1)],
        False,
    )
    return Shading(
        albedo=surface_albedo(scene, hit),
        emission=scene.mat_emission[m],
        fuzz=scene.mat_fuzz[m],
        ior=scene.mat_ior[m],
        mtype=scene.mat_type[m],
        two_sided=two,
    )


class BsdfSample(struct.PyTreeNode):
    wi: Array        # (..., 3) sampled direction (unit)
    weight: Array    # (..., 3) f * cos / pdf
    pdf: Array       # (...,) solid-angle pdf (1.0 for delta lobes)
    specular: Array  # (...,) bool — delta lobe (skip MIS/NEE eval)
    valid: Array     # (...,) bool — sample usable


def sample_bsdf(scene, hit, wo: Array, key: Array, uniform_lambert: bool = False,
                sh=None) -> BsdfSample:
    """Sample a scattering direction for every ray in the batch.

    `uniform_lambert=True` reproduces the reference's uniform-hemisphere
    lambert sampling (`Material.fs:33-36`: pdf folded weight
    `albedo/pi * cos * 2pi`); default is cosine-weighted (same estimator
    expectation, lower variance). Pass a pre-joined `sh: Shading` to skip
    the material-table gathers.
    """
    if sh is None:
        sh = make_shading(scene, hit)
    mtype = sh.mtype
    albedo = sh.albedo
    fuzz = sh.fuzz
    ior = sh.ior
    n = hit.normal
    d = -wo  # incident propagation direction

    u_l = rng.uniforms(key, 0, (2,))
    u_f = rng.uniforms(key, 1, (3,))
    u_c = rng.uniforms(key, 2)

    # --- lambert ---
    if uniform_lambert:
        wi_lam = uniform_hemisphere(u_l, n)
        cos_lam = jnp.maximum(dot(wi_lam, n), 0.0)
        pdf_lam = jnp.full_like(cos_lam, 1.0 / (2.0 * jnp.pi))
        w_lam = albedo * (2.0 * cos_lam)[..., None]  # (a/pi)*cos/(1/2pi)
    else:
        wi_lam, pdf_lam = cosine_hemisphere(u_l, n)
        cos_lam = jnp.maximum(dot(wi_lam, n), 0.0)
        w_lam = albedo  # (a/pi)*cos/(cos/pi)

    # --- metal (mirror + fuzz perturbation, reference `Material.fs:58-72`) ---
    refl = reflect(d, n)
    wi_met = normalize(refl + fuzz[..., None] * fuzz_sphere(u_f))
    met_ok = dot(wi_met, n) > 0.0
    w_met = albedo

    # --- dielectric (Fresnel reflect/refract, reference `Material.fs:74-125`) ---
    cos_i = jnp.clip(-dot(d, n), 0.0, 1.0)
    eta_i = jnp.where(hit.front_face, 1.0, ior)
    eta_t = jnp.where(hit.front_face, ior, 1.0)
    fr = fresnel_dielectric(cos_i, eta_i, eta_t)
    ref_ok, refr = refract(d, n, eta_i / eta_t)
    refr = normalize(refr)
    choose_reflect = (u_c < fr) | ~ref_ok
    wi_die = jnp.where(choose_reflect[..., None], reflect(d, n), refr)
    # RR between lobes cancels the Fresnel weight; the refracted branch
    # additionally carries the (eta_t/eta_i)^2 radiance-compression factor —
    # the reference's `(et^2/ei^2)(1-F)T/|cos|` transmission weight
    # (`Core/Materials/Material.fs:103-118`) with (1-F)/pdf and cos/|cos|
    # cancelled. Factors invert on exit, so closed glass paths are unbiased.
    eta_scale = jnp.where(choose_reflect, 1.0, (eta_t / eta_i) ** 2)
    w_die = albedo * eta_scale[..., None]

    # --- glossy: normalized Phong lobe around the mirror direction (the
    # reference's DEAD GlossySpecular, `Brdfs/GlossySpecular.fs:5-15`,
    # f = ks (r.wo)^e col — energy-normalized here: f = a (e+2)/(2pi) cos^e).
    # The exponent rides the fuzz column (type-overloaded; scene compiler).
    exp_g = jnp.maximum(fuzz, 1.0)
    from mafrixraytracing_tpu.core.math import local_to_world

    cos_a = jnp.clip(u_l[..., 0], 1e-6, 1.0) ** (1.0 / (exp_g + 1.0))
    sin_a = jnp.sqrt(jnp.maximum(1.0 - cos_a * cos_a, 0.0))
    phi_g = TWO_PI * u_l[..., 1]
    local_g = jnp.stack(
        [sin_a * jnp.cos(phi_g), sin_a * jnp.sin(phi_g), cos_a], axis=-1
    )
    wi_glo = local_to_world(local_g, refl)
    cos_glo = dot(wi_glo, n)
    pdf_glo = (exp_g + 1.0) / TWO_PI * cos_a**exp_g
    # weight = f cos / pdf = a (e+2)/(e+1) cos_i
    w_glo = albedo * ((exp_g + 2.0) / (exp_g + 1.0) * jnp.maximum(cos_glo, 0.0))[
        ..., None
    ]

    is_lam = mtype == LAMBERT
    is_met = mtype == METAL
    is_die = mtype == DIELECTRIC
    is_glo = mtype == GLOSSY

    wi = jnp.where(
        is_lam[..., None], wi_lam,
        jnp.where(is_met[..., None], wi_met,
                  jnp.where(is_glo[..., None], wi_glo, wi_die)),
    )
    weight = jnp.where(
        is_lam[..., None], w_lam,
        jnp.where(is_met[..., None], w_met,
                  jnp.where(is_glo[..., None], w_glo, w_die)),
    )
    pdf = jnp.where(is_lam, pdf_lam, jnp.where(is_glo, pdf_glo, 1.0))
    specular = is_met | is_die
    valid = jnp.where(
        is_lam, cos_lam > 0.0,
        jnp.where(is_met, met_ok,
                  jnp.where(is_glo, cos_glo > 0.0, is_die)),
    )
    return BsdfSample(wi=wi, weight=weight, pdf=pdf, specular=specular, valid=valid)


def eval_bsdf(scene, hit, wo: Array, wi: Array, sh=None):
    """Evaluate (f, pdf) for a given direction — used by NEE/MIS. Delta lobes
    (metal/dielectric) return zero: they cannot be hit by light sampling.
    The glossy Phong lobe evaluates f = a (e+2)/(2pi) (r.wi)^e with matching
    sampling pdf (e+1)/(2pi) (r.wi)^e."""
    if sh is None:
        sh = make_shading(scene, hit)
    mtype = sh.mtype
    albedo = sh.albedo
    n = hit.normal
    cos_wi = dot(wi, n)
    same_side = cos_wi > 0.0
    is_lam = mtype == LAMBERT
    is_glo = mtype == GLOSSY
    exp_g = jnp.maximum(sh.fuzz, 1.0)
    r = reflect(-wo, n)
    cos_a = jnp.maximum(dot(r, wi), 0.0)
    glo_ok = is_glo & same_side & (cos_a > 0.0)
    f_glo = albedo * ((exp_g + 2.0) / TWO_PI * cos_a**exp_g)[..., None]
    f = jnp.where(
        (is_lam & same_side)[..., None], albedo * INV_PI,
        jnp.where(glo_ok[..., None], f_glo, 0.0),
    )
    pdf = jnp.where(
        is_lam & same_side, jnp.maximum(cos_wi, 0.0) * INV_PI,
        jnp.where(glo_ok, (exp_g + 1.0) / TWO_PI * cos_a**exp_g, 0.0),
    )
    return f, pdf


def emitted(scene, hit, sh=None):
    """Emitted radiance at a hit (reference `IMaterial.Emit`,
    `Core/Interfaces/IMaterial.fs:18` — always black there; here emissive
    materials actually emit, making lights visible to camera/BSDF rays).
    One-sided by default: only the front face emits, matching the facing
    check in `NewAreaLight.L` (`Core/Lights/Light.fs:48-56`)."""
    if sh is None:
        sh = make_shading(scene, hit)
    emits = hit.front_face | sh.two_sided
    return jnp.where((hit.valid & emits)[..., None], sh.emission, 0.0)


# ---------------------------------------------------------------------------
# SoA variants — flat-component vectors (core.v3) for the hot path
# ---------------------------------------------------------------------------

from typing import NamedTuple  # noqa: E402

from mafrixraytracing_tpu.core import v3  # noqa: E402
from mafrixraytracing_tpu.core.sampling import (  # noqa: E402
    cosine_hemisphere_soa,
    fuzz_sphere_soa,
    uniform_hemisphere_soa,
)
from mafrixraytracing_tpu.core.math import fresnel_dielectric  # noqa: E402
from mafrixraytracing_tpu.core.v3 import V3  # noqa: E402


class BsdfSampleS(NamedTuple):
    wi: V3          # sampled direction (unit), SoA
    weight: V3      # f * cos / pdf, SoA
    pdf: "jnp.ndarray"
    specular: "jnp.ndarray"
    valid: "jnp.ndarray"


def sample_bsdf_soa(sh, hit, wo: V3, key, uniform_lambert: bool = False,
                    glossy: bool = True, metal: bool = True,
                    dielectric: bool = True) -> BsdfSampleS:
    """SoA `sample_bsdf`: identical math on flat components (no (B,3)
    arrays; see core.v3 for why). The `glossy`/`metal`/`dielectric` flags
    statically skip whole lobes the scene cannot contain — pass the
    `scene.has_*` capability flags; with all of them False this collapses
    to the pure-lambert shader (the spot bench case)."""
    from mafrixraytracing_tpu.core import rng

    n = hit.normal
    d = -wo
    u_l = rng.uniforms(key, 0, (2,))

    # --- lambert (the base lobe every scene has) ---
    if uniform_lambert:
        wi_lam = uniform_hemisphere_soa(u_l, n)
        cos_lam = jnp.maximum(v3.dot(wi_lam, n), 0.0)
        pdf_lam = jnp.full_like(cos_lam, 1.0 / (2.0 * jnp.pi))
        w_lam = sh.albedo * (2.0 * cos_lam)
    else:
        wi_lam, pdf_lam = cosine_hemisphere_soa(u_l, n)
        cos_lam = jnp.maximum(v3.dot(wi_lam, n), 0.0)
        w_lam = sh.albedo

    wi, weight, pdf = wi_lam, w_lam, pdf_lam
    valid = cos_lam > 0.0
    specular = jnp.zeros_like(valid)
    if metal or glossy:
        refl = v3.reflect(d, n)

    # --- metal (mirror + fuzz, reference `Material.fs:58-72`) ---
    if metal:
        u_f = rng.uniforms(key, 1, (3,))
        is_met = sh.mtype == METAL
        wi_met = v3.normalize(refl + fuzz_sphere_soa(u_f) * sh.fuzz)
        met_ok = v3.dot(wi_met, n) > 0.0
        wi = v3.where(is_met, wi_met, wi)
        weight = v3.where(is_met, sh.albedo, weight)
        pdf = jnp.where(is_met, 1.0, pdf)
        valid = jnp.where(is_met, met_ok, valid)
        specular = specular | is_met

    # --- dielectric (Fresnel RR reflect/refract) ---
    if dielectric:
        u_c = rng.uniforms(key, 2)
        is_die = sh.mtype == DIELECTRIC
        cos_i = jnp.clip(-v3.dot(d, n), 0.0, 1.0)
        eta_i = jnp.where(hit.front_face, 1.0, sh.ior)
        eta_t = jnp.where(hit.front_face, sh.ior, 1.0)
        fr = fresnel_dielectric(cos_i, eta_i, eta_t)
        ref_ok, refr = v3.refract(d, n, eta_i / eta_t)
        refr = v3.normalize(refr)
        choose_reflect = (u_c < fr) | ~ref_ok
        wi_die = v3.where(choose_reflect, v3.reflect(d, n), refr)
        # refracted branch carries (eta_t/eta_i)^2 — the reference's
        # `(et^2/ei^2)(1-F)T/|cos|` transmission weight
        # (`Material.fs:103-118`) with the RR'd (1-F) and the delta cos
        # fold cancelled (see sample_bsdf)
        eta_scale = jnp.where(choose_reflect, 1.0, (eta_t / eta_i) ** 2)
        wi = v3.where(is_die, wi_die, wi)
        weight = v3.where(is_die, sh.albedo * eta_scale, weight)
        pdf = jnp.where(is_die, 1.0, pdf)
        valid = jnp.where(is_die, True, valid)
        specular = specular | is_die

    # --- glossy Phong lobe (see sample_bsdf) ---
    if glossy:
        from mafrixraytracing_tpu.core.sampling import _local_to_world_soa

        is_glo = sh.mtype == GLOSSY
        exp_g = jnp.maximum(sh.fuzz, 1.0)
        cos_a = jnp.clip(u_l[..., 0], 1e-6, 1.0) ** (1.0 / (exp_g + 1.0))
        sin_a = jnp.sqrt(jnp.maximum(1.0 - cos_a * cos_a, 0.0))
        phi_g = 2.0 * jnp.pi * u_l[..., 1]
        wi_glo = _local_to_world_soa(
            sin_a * jnp.cos(phi_g), sin_a * jnp.sin(phi_g), cos_a, refl
        )
        cos_glo = v3.dot(wi_glo, n)
        pdf_glo = (exp_g + 1.0) / (2.0 * jnp.pi) * cos_a**exp_g
        w_glo = sh.albedo * (
            (exp_g + 2.0) / (exp_g + 1.0) * jnp.maximum(cos_glo, 0.0)
        )
        wi = v3.where(is_glo, wi_glo, wi)
        weight = v3.where(is_glo, w_glo, weight)
        pdf = jnp.where(is_glo, pdf_glo, pdf)
        valid = jnp.where(is_glo, cos_glo > 0.0, valid)

    return BsdfSampleS(wi=wi, weight=weight, pdf=pdf, specular=specular, valid=valid)


def eval_bsdf_soa(sh, hit, wi: V3, wo: V3 | None = None):
    """SoA `eval_bsdf` (f, pdf) for NEE/MIS; delta lobes return zero. The
    glossy Phong lobe needs `wo` (pass it to enable NEE on glossy surfaces;
    without it glossy evaluates to zero like a delta lobe)."""
    cos_wi = v3.dot(wi, hit.normal)
    lam = (sh.mtype == LAMBERT) & (cos_wi > 0.0)
    zero = V3.fill((0.0, 0.0, 0.0), cos_wi.shape)
    f = v3.where(lam, sh.albedo * INV_PI, zero)
    pdf = jnp.where(lam, jnp.maximum(cos_wi, 0.0) * INV_PI, 0.0)
    if wo is not None:
        exp_g = jnp.maximum(sh.fuzz, 1.0)
        r = v3.reflect(-wo, hit.normal)
        cos_a = jnp.maximum(v3.dot(r, wi), 0.0)
        glo = (sh.mtype == GLOSSY) & (cos_wi > 0.0) & (cos_a > 0.0)
        f = v3.where(glo, sh.albedo * ((exp_g + 2.0) / TWO_PI * cos_a**exp_g), f)
        pdf = jnp.where(glo, (exp_g + 1.0) / TWO_PI * cos_a**exp_g, pdf)
    return f, pdf


def emitted_soa(sh, hit) -> V3:
    """SoA `emitted`."""
    emits = hit.valid & (hit.front_face | sh.two_sided)
    zero = V3.fill((0.0, 0.0, 0.0), hit.t.shape)
    return v3.where(emits, sh.emission, zero)
