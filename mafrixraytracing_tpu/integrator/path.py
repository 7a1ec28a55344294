"""Wavefront path integrator with next-event estimation.

Wavefront replacement for the recursive `PathIntegrator.TraceRay`
(`Core/Integrator/Integrators.fs:96-141`) + `PixelIntegrator.Sample`
(`Integrators.fs:143-172`): instead of per-ray recursion, a fixed-size
wavefront of path states advances through a bounce loop; dead paths are
masked, not branched. Everything is one `jit` region: XLA fuses ray
generation, intersection, shading, and accumulation.

Two estimators:

- "physical" (default): cosine-sampled lambert, NEE with the correct
  f*cos_s*Le*cos_l/(d^2*pdf_A) weight, emissive surfaces visible, MIS
  (power-2) between light and BSDF sampling, optional Russian roulette.
- "mafrix": bit-for-the-same-math parity with the reference estimator for
  the allclose gate, reproducing its quirks deliberately (SURVEY §2.8):
  uniform-hemisphere lambert with weight `albedo*2*cos`
  (`Material.fs:33-36`); direct light `cos_s*I*|cos_l|*Area^2/d^2` — the
  extra Area comes from `L()` folding the solid-angle factor *and* the
  integrator dividing by `pdf = 1/Area` (`Light.fs:48-59` +
  `Integrators.fs:130-136`); the direct term multiplied by the *BSDF
  sample's* weight `(l/pdf_li + indirect) * f/pdf`; lights invisible to
  camera/BSDF rays; miss = black; no Russian roulette; `max_depth` counts
  interactions (reference depth 3 => 4 interactions).

Gradients flow to material albedo/emission, light radiance, vertex
positions, and camera parameters (detached closest-hit selection and
visibility; reparameterized hit attributes — see `geometry.intersect`).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
from jax import Array, lax
from jax.ad_checkpoint import checkpoint_name

from mafrixraytracing_tpu.core import rng
from mafrixraytracing_tpu.core.math import dot
from mafrixraytracing_tpu.core.sampling import uniform_hemisphere
from mafrixraytracing_tpu.core.types import Rays
from mafrixraytracing_tpu.geometry import intersect as isect
from mafrixraytracing_tpu.lights import lights as L
from mafrixraytracing_tpu.materials.bsdf import (
    EMISSIVE,
    eval_bsdf,
    emitted,
    sample_bsdf,
)

RAY_EPS = 1e-3


@dataclass(frozen=True)
class PathTracerConfig:
    """Static integrator configuration (hashable -> usable as a jit static
    argument). Replaces the reference's hard-codes: depth 3
    (`Scene/Scene.fs:304`), shadow epsilon 1e-6 (`Integrators.fs:44,108`)."""

    max_depth: int = 5          # number of surface interactions
    estimator: str = "physical"  # "physical" | "mafrix"
    mis: bool = True
    nee: bool = True
    rr_start: int = 3           # bounce index where Russian roulette begins
    rr_enable: bool = True
    t_min: float = RAY_EPS
    chunk: int = 1024           # triangle chunk for the jnp intersector
    backend: str = "auto"       # "auto" | "jnp" | "pallas" — intersection backend
    wavefront: int = 1 << 19    # target rays in flight: render_image groups
                                # several spp into one wavefront so per-op
                                # dispatch overhead amortizes (the analog of
                                # the reference saturating CPU cores with
                                # `Array.Parallel`, `Integrators.fs:164`)
    remat: bool = True          # checkpoint each spp sample with SAVE_ISECT:
                                # backward-pass memory is O(spp*depth) hit records
                                # (not activations) and the traversal kernels
                                # never re-run in the backward pass
    save_attrs: bool = True     # also save the 36 fetched attribute columns
                                # so the rematted recompute skips the packed
                                # row gather + unpack (~144 B/ray/bounce of
                                # residents; disable for very long spp scans)
    motion_blur: bool = False   # sample a shutter time per camera ray and
                                # intersect moving spheres at it (the
                                # reference's MovingSphere sample,
                                # `RenderTest/Sample/RayTracing.fs:210-253`)
    sort_secondary: bool = False  # reorder the wavefront by (origin-morton,
                                # direction octant) before each secondary
                                # bounce (wavefront ray sorting). Off by
                                # default: the compaction path already
                                # re-tiles survivors by the same key;
                                # not measured on the GPU
    compact: tuple = ()         # wavefront compaction schedule: fraction of
                                # the initial wavefront kept at each bounce
                                # (len == max_depth, first entry 1.0). After
                                # each bounce the wavefront is packed
                                # live-first (stable, preserving ray order —
                                # tile coherence survives) and sliced to the
                                # next bucket; retired lanes' radiance is
                                # collected in fragments and re-sorted by
                                # pixel id at the end. If more rays survive
                                # than the bucket holds, a uniform-random
                                # subset is kept and reweighted by
                                # live/bucket (population-control Russian
                                # roulette — unbiased; buckets are chosen
                                # with headroom so this is a rare safety
                                # valve, not the mechanism). () = off.


def _occluder(scene, config):
    def occluded_fn(shadow_rays, t_min, t_max):
        from mafrixraytracing_tpu.ops import dispatch

        return dispatch.occluded(scene, shadow_rays, t_min, t_max,
                                 chunk=config.chunk, backend=config.backend)

    return occluded_fn


def _intersect(scene, rays, config, alive=None):
    # dead lanes get t_max = 0: the Pallas cull then excludes every cluster
    # for them, so retired paths cost (nearly) nothing in later bounces
    t_max = 1e8 if alive is None else jnp.where(alive, 1e8, 0.0)
    from mafrixraytracing_tpu.ops import dispatch

    return dispatch.intersect_shade(scene, rays, config.t_min, t_max,
                                    chunk=config.chunk, backend=config.backend)


# Rematerialization policy: save the intersection-search results (named in
# `ops.dispatch`) and the wavefront sort order, and recompute everything
# else in the backward pass. The search is non-differentiable, so this
# makes the backward pass cost O(shading), not O(traversal), while residual
# memory stays at ~9 bytes/ray/bounce instead of full activations.
ISECT_SAVE_NAMES = ("isect_t", "isect_idx", "occluded",
                    "tex_r", "tex_g", "tex_b")
ATTR_SAVE_NAMES = tuple(f"attr{k}" for k in range(36))
# compaction pack-sort outputs: saving the (shrunken) sorted columns lets
# the rematted recompute skip the multi-operand pack sorts entirely (they
# would otherwise re-run once per bounce in the backward recompute);
# ~70 B/kept-lane/bounce of residents, auto-gated by the same memory check
# as the attribute saves.
PACK_SAVE_NAMES = (tuple(f"pack{k}" for k in range(18))
                   + tuple(f"packi{k}" for k in range(4))
                   + ("sortperm",))
SAVE_ISECT = jax.checkpoint_policies.save_only_these_names(*ISECT_SAVE_NAMES)
# + the 36 fetched attribute columns: skips the attribute gather in
# the rematted recompute at ~144 B/ray/bounce of extra residents — right
# for moderate spp-scan lengths (the bench), wrong for very long ones
# (Renault @ 256 spp); selected via PathTracerConfig.save_attrs.
SAVE_ISECT_ATTRS = jax.checkpoint_policies.save_only_these_names(
    *(ISECT_SAVE_NAMES + ATTR_SAVE_NAMES + PACK_SAVE_NAMES)
)


def _coherence_key_soa(scene, o, d, alive) -> Array:
    """21-bit wavefront-coherence sort key: origin Morton (4 bits/axis,
    dominant) | direction octant (3) | direction Morton (2 bits/axis). For
    primary rays (shared origin) the direction bits reproduce a screen-tile
    order; for bounce rays the origin bits group rays leaving nearby
    surface points. Dead rays sort to the end, packing whole tiles that the
    intersector then skips (their t_max is 0). o, d: V3 of (B,) columns."""
    live_min = jnp.where(scene.cluster_min < 1e30, scene.cluster_min, jnp.inf)
    live_max = jnp.where(scene.cluster_max > -1e30, scene.cluster_max, -jnp.inf)
    lo = jnp.min(live_min, axis=0)
    span = jnp.maximum(jnp.max(live_max, axis=0) - lo, 1e-6)

    def interleave(cols, bits):
        k = jnp.zeros(cols[0].shape[0], jnp.int32)
        for b in range(bits):
            k = (
                k
                | ((cols[0] >> b & 1) << (3 * b + 2))
                | ((cols[1] >> b & 1) << (3 * b + 1))
                | ((cols[2] >> b & 1) << (3 * b))
            )
        return k

    q = tuple(
        jnp.clip(((c - lo[a]) / span[a] * 16.0).astype(jnp.int32), 0, 15)
        for a, c in enumerate(o)
    )
    octant = (
        ((d.x > 0).astype(jnp.int32) << 2)
        | ((d.y > 0).astype(jnp.int32) << 1)
        | (d.z > 0).astype(jnp.int32)
    )
    qd = tuple(
        jnp.clip(((c * 0.5 + 0.5) * 4.0).astype(jnp.int32), 0, 3) for c in d
    )
    key = (interleave(q, 4) << 9) | (octant << 6) | interleave(qd, 2)
    return jnp.where(alive, key, jnp.int32(1) << 30)


@partial(jax.custom_vjp, nondiff_argnums=())
def _permute_by_key(sort_key, float_cols, int_cols):
    """Sort every column by `sort_key` via ONE multi-operand `lax.sort`
    (the values travel with the key: no argsort + per-column gathers). The
    custom VJP unsorts cotangents with another multi-operand sort instead
    of the scatter the default sort transpose would lower to. Not measured
    against argsort + gather on the GPU."""
    out, _ = _permute_fwd_impl(sort_key, float_cols, int_cols)
    return out


def _permute_fwd_impl(sort_key, float_cols, int_cols):
    B = sort_key.shape[0]
    pos = jnp.arange(B, dtype=jnp.int32)
    s = lax.sort((sort_key, pos) + tuple(float_cols) + tuple(int_cols),
                 num_keys=1)
    # the VJP residual: checkpoint-named so the remat policy saves it and
    # the backward recompute never re-runs the sort just to rebuild the
    # permutation
    perm = checkpoint_name(s[1], "sortperm")
    nf = len(float_cols)
    out = (tuple(s[2:2 + nf]), tuple(s[2 + nf:]))
    return out, perm


def _permute_fwd(sort_key, float_cols, int_cols):
    assert jnp.issubdtype(sort_key.dtype, jnp.integer), sort_key.dtype
    out, perm = _permute_fwd_impl(sort_key, float_cols, int_cols)
    return out, perm


def _permute_bwd(perm, cts):
    import numpy as np

    ct_float, ct_int = cts
    # scatter-by-perm == sort-by-perm-key: unsort the float cotangents with
    # one more vectorized multi-operand sort (integer sort keys only, so
    # the key cotangent is always float0)
    cols = tuple(
        c if c is not None else jnp.zeros(perm.shape, jnp.float32)
        for c in ct_float
    )
    uns = lax.sort((perm,) + cols, num_keys=1)[1:]
    d_key = np.zeros(perm.shape, jax.dtypes.float0)
    d_int = tuple(np.zeros(perm.shape, jax.dtypes.float0) for _ in ct_int)
    return (d_key, tuple(uns), d_int)


_permute_by_key.defvjp(_permute_fwd, _permute_bwd)


# --- wavefront compaction ---------------------------------------------------
# After each bounce, ~half the lanes are dead but still pay full NEE/BSDF/
# RNG/backward cost (the intersector already skips them via t_max = 0, the
# elementwise tail does not). The compaction path packs live lanes to the
# front with ONE stable multi-operand sort (original ray order — and hence
# tile coherence — is preserved) and slices the wavefront to a static
# per-bounce bucket. Retired lanes' radiance goes to fragments; at the end
# all fragments are re-sorted by original lane id (a sort, not a scatter).
#
# Unbiasedness: if more rays survive than the bucket holds, a UNIFORM-RANDOM
# subset of exactly K live rays is kept and each survivor's throughput is
# scaled by live/K (population-control Russian roulette): every live ray's
# inclusion probability is K/live, so the estimator stays unbiased. Buckets
# are sized with headroom so this is a rare safety valve. (The uniform pick
# ties on the f32 random key at ~1e-7 probability per pair, broken by lane
# id — a correlation far below MC noise.)


def compact_buckets(config: "PathTracerConfig", B: int):
    """Static per-bounce wavefront sizes from the fraction schedule.
    Rounded up to the intersector's ray block (`intersect_pallas.BLOCK`) so
    the padded kernel batch equals the bucket; non-increasing."""
    from mafrixraytracing_tpu.ops.intersect_pallas import BLOCK

    fr = config.compact
    assert len(fr) == config.max_depth, (fr, config.max_depth)
    assert abs(fr[0] - 1.0) < 1e-9, "first bucket must keep the full wavefront"
    ks, prev = [], B
    for f in fr:
        if B >= BLOCK:
            k = min(B, -(-int(round(f * B)) // BLOCK) * BLOCK)
        else:
            k = min(B, max(1, int(round(f * B))))
        k = min(k, prev)
        ks.append(k)
        prev = k
    return ks


def _population_rr(alive, thr_cols, keys, pid, bounce, K: int):
    """Keep a uniform-random subset of at most K live lanes, reweighting
    survivors by live/K when an actual kill happens. `keys` are the per-lane
    PRNG keys (same stream in `trace_stats`, so the bench numerator mirrors
    the kills exactly); `pid` (original lane ids) breaks random-key ties so
    the selection is identical regardless of current wavefront order.
    Returns (selected, thr_cols)."""
    Bw = alive.shape[0]
    if K >= Bw:
        return alive, thr_cols
    u = rng.uniforms(rng.bounce_key(keys, bounce), 97)
    u = lax.stop_gradient(jnp.where(alive, u, 2.0))
    su, sp = lax.sort((u, pid), num_keys=2)
    tau_u, tau_p = su[K - 1], sp[K - 1]
    selected = alive & ((u < tau_u) | ((u == tau_u) & (pid <= tau_p)))
    L = jnp.sum(alive.astype(jnp.float32))
    comp = lax.stop_gradient(jnp.maximum(L / K, 1.0))
    thr_cols = tuple(jnp.where(selected, c * comp, c) for c in thr_cols)
    return selected, thr_cols


def _compact_bounce_loop(scene, init, bounce_step, config):
    """Unrolled bounce loop with per-bounce wavefront shrinking (the scan
    form needs a fixed carry shape). Carries flat (B,) columns end-to-end
    (see the layout note below). Returns (B, 3) radiance in the original
    lane order."""
    from mafrixraytracing_tpu.core.v3 import V3

    B = init[0].shape[0]
    buckets = compact_buckets(config, B)
    carry, _ = bounce_step(init, 0)
    pid = jnp.arange(B, dtype=jnp.int32)
    frag_pid, frag_r = [], []
    for b in range(1, config.max_depth):
        K = buckets[b]
        Kp = carry[0].shape[0]
        if K < Kp:
            alive = carry[I_ALIVE]
            selected, thr = _population_rr(
                alive, carry[6:9], carry[I_KEYS], pid, b, K
            )
            carry = carry[0:6] + thr + carry[9:]
            # pack live lanes first AND re-tile them by wavefront-coherence
            # key in the same single multi-operand sort: bounce rays are
            # incoherent in pixel order (random scatter directions), so
            # ordering the survivors by (origin-Morton | direction octant |
            # direction-Morton) tightens every intersector tile's frustum
            # for free — the sort was already being paid for the pack.
            # Dead lanes sort to the end (key bit 30; coherence keys are
            # 21 bits). The estimator is exactly permutation-invariant and
            # the sort is stable, so results stay bit-identical across
            # backends.
            o = V3(carry[0], carry[1], carry[2])
            d = V3(carry[3], carry[4], carry[5])
            skey = _coherence_key_soa(scene, o, d, selected)
            kd = jax.random.key_data(carry[I_KEYS])
            # slim payload: `alive` is reconstructed from the live count
            # (selected lanes sort first), and the time column only travels
            # under motion blur (zeros otherwise)
            fcols = carry[0:13] + ((carry[13],) if config.motion_blur else ())
            icols = (carry[I_SPEC].astype(jnp.int32), kd[:, 0], kd[:, 1], pid)
            f, i = _permute_by_key(skey, fcols, icols)
            n_sel = jnp.sum(selected.astype(jnp.int32))
            # every slice of the sort's outputs is checkpoint-named so the
            # policy can save them ALL — only then is the sort itself dead
            # code in the rematted backward recompute (one live output keeps
            # the whole multi-operand sort alive)
            frag_pid.append(checkpoint_name(i[3][K:], "pack14"))
            frag_r.append(tuple(
                checkpoint_name(c[K:], f"pack{15 + j}")
                for j, c in enumerate(f[9:12])
            ))
            f = tuple(checkpoint_name(c[:K], f"pack{k}")
                      for k, c in enumerate(f))
            ik = tuple(checkpoint_name(c[:K], f"packi{k}")
                       for k, c in enumerate(i))
            times_s = f[13] if config.motion_blur else jnp.zeros((K,), jnp.float32)
            carry = (f[0:13] + (times_s,
                                jnp.arange(K, dtype=jnp.int32) < n_sel,
                                ik[0].astype(bool),
                                jax.random.wrap_key_data(
                                    jnp.stack([ik[1], ik[2]], axis=1))))
            pid = ik[3]
        carry, _ = bounce_step(carry, b)
    frag_pid.append(pid)
    frag_r.append(carry[9:12])
    all_pid = jnp.concatenate(frag_pid)
    rad = tuple(
        jnp.concatenate([fr[c] for fr in frag_r]) for c in range(3)
    )
    f, _ = _permute_by_key(all_pid, rad, ())
    return jnp.stack(f, axis=1)


# --- flat wavefront carry ----------------------------------------------------
# The bounce loop (scan or unrolled) carries the wavefront as FLAT (B,)
# columns, never (B, 3) matrices (see core.v3): `bounce_step` consumes and
# produces the flat tuple directly — V3 views are built in place, and no
# stack/unstack pair exists at a loop boundary for XLA to (fail to)
# cancel.
#
# Column layout:
#   0:3  origin   3:6  direction   6:9  throughput   9:12 radiance
#   12   prev_pdf 13   time        14   alive (bool) 15   specular (bool)
#   16   PRNG keys (typed key array)

I_ALIVE, I_SPEC, I_KEYS = 14, 15, 16


def _flat_init(rays: Rays, keys, times, B):
    one = jnp.ones((B,), jnp.float32)
    zero = jnp.zeros((B,), jnp.float32)
    return (
        rays.origin[:, 0], rays.origin[:, 1], rays.origin[:, 2],
        rays.direction[:, 0], rays.direction[:, 1], rays.direction[:, 2],
        one, one, one,
        zero, zero, zero,
        one,                         # prev_pdf
        times,
        jnp.ones((B,), bool),        # alive
        jnp.ones((B,), bool),        # camera "bounce" counts as specular
        keys,
    )


def _sort_flat(sort_key: Array, carry, pid: Array):
    """Permute the flat wavefront carry + pid by `sort_key` with ONE
    multi-operand sort (see `_permute_by_key`). The typed key column is
    sorted as its two uint32 data columns and re-wrapped."""
    kd = jax.random.key_data(carry[I_KEYS])  # (B, 2) uint32 under threefry
    f, i = _permute_by_key(
        sort_key,
        carry[0:14],
        (carry[I_ALIVE].astype(jnp.int32), carry[I_SPEC].astype(jnp.int32),
         kd[:, 0], kd[:, 1], pid),
    )
    keys = jax.random.wrap_key_data(jnp.stack(i[2:4], axis=1))
    out = f + (i[0].astype(bool), i[1].astype(bool), keys)
    return out, i[4]


def trace_radiance(scene, rays: Rays, keys: Array, config: PathTracerConfig,
                   times: Array | None = None) -> Array:
    """Estimate radiance for a batch of camera rays. rays: (B, 3) fields,
    keys: (B,) PRNG keys; `times` (B,) optional shutter times for motion
    blur (secondary rays inherit their camera ray's time). Returns (B, 3)."""
    if config.estimator == "mafrix":
        return _trace_mafrix(scene, rays, keys, config)
    return _trace_physical(scene, rays, keys, config, times)


def _trace_physical(scene, rays, keys, config, times=None):
    """The bounce loop runs as a `lax.scan` so the jaxpr (and compile time,
    especially of the backward pass) is O(1) in max_depth — the wavefront
    form of the reference's recursion. All math is SoA ((B,) component
    columns, core.v3)."""
    from mafrixraytracing_tpu.core import v3
    from mafrixraytracing_tpu.core.v3 import V3
    from mafrixraytracing_tpu.lights.lights import (
        nee_area_soa,
        nee_point_soa,
        nee_sphere_soa,
    )
    from mafrixraytracing_tpu.materials.bsdf import emitted_soa, sample_bsdf_soa
    from mafrixraytracing_tpu.ops import dispatch

    B = rays.origin.shape[0]

    if times is None:
        times = jnp.zeros((B,), jnp.float32)

    bg = V3(scene.background[0], scene.background[1], scene.background[2])
    # loop-invariant joined tables, hoisted out of the bounce scan (the
    # remat/while boundaries block XLA's own LICM)
    packed_attrs = isect.packed_attr_table(scene)

    def bounce_step(carry, bounce):
        # flat-column carry (see layout above _flat_init): V3 views are
        # built in place so no (B, 3) buffer ever crosses a loop boundary
        o = V3(carry[0], carry[1], carry[2])
        d = V3(carry[3], carry[4], carry[5])
        thr = V3(carry[6], carry[7], carry[8])
        rad = V3(carry[9], carry[10], carry[11])
        prev_pdf = carry[12]
        rtimes = carry[13]
        alive = carry[I_ALIVE]
        prev_specular = carry[I_SPEC]
        keys = carry[I_KEYS]
        bkey = rng.bounce_key(keys, bounce)

        def occluded_fn(so, sd, t_min, t_max):
            return dispatch.occluded_soa(
                scene, so, sd, t_min, t_max,
                chunk=config.chunk, backend=config.backend,
                times=rtimes if config.motion_blur else None,
            )

        # dead lanes get t_max = 0: the Pallas cull then excludes every
        # cluster for them, so retired paths cost (nearly) nothing
        t_max = jnp.where(alive, 1e8, 0.0)
        hit, sh = dispatch.intersect_shade_soa(
            scene, o, d, config.t_min, t_max,
            chunk=config.chunk, backend=config.backend,
            times=rtimes if config.motion_blur else None,
            packed=packed_attrs,
        )
        # local wavefront size: under compaction the wavefront shrinks
        # between bounces, so B from the enclosing scope is stale here
        Bw = hit.t.shape[0]
        zero = V3.fill((0.0, 0.0, 0.0), (Bw,))

        # --- miss: constant background, then retire the path ---
        miss = alive & ~hit.valid
        rad = rad + v3.where(miss, thr * bg, zero)

        # --- emissive hit (BSDF-sampling side of MIS) ---
        Le = emitted_soa(sh, hit)
        hit_light = alive & hit.valid & ((Le.x > 0.0) | (Le.y > 0.0) | (Le.z > 0.0))
        if config.nee and config.mis:
            # convert the light sampler's area pdf to solid angle at this hit
            pdf_a = L.light_pdf_area(scene)
            cos_l = jnp.abs(v3.dot(hit.normal, d))
            pdf_l_sa = pdf_a * hit.t**2 / jnp.maximum(cos_l, 1e-8)
            w_bsdf = prev_pdf**2 / jnp.maximum(prev_pdf**2 + pdf_l_sa**2, 1e-20)
            w = jnp.where(prev_specular, 1.0, w_bsdf)
        elif config.nee:
            # NEE-only: emission counted solely after specular chains
            w = jnp.where(prev_specular, 1.0, 0.0)
        else:
            w = jnp.ones((Bw,), jnp.float32)
        if config.nee:
            # sphere lights: full power-2 MIS against the cone sampler's
            # solid-angle pdf (sh.light_pdf_sa, computed in the attribute
            # recompute from this ray's origin — 0 for origins inside the
            # sphere, where NEE cannot sample and BSDF takes full weight)
            T = scene.tri_v0.shape[0]
            if config.mis:
                pls = sh.light_pdf_sa
                w_sph = prev_pdf**2 / jnp.maximum(prev_pdf**2 + pls**2, 1e-20)
                w_sph = jnp.where(prev_specular, 1.0, w_sph)
            else:
                w_sph = jnp.where(prev_specular, 1.0, 0.0)
            w = jnp.where(hit.prim_idx >= T, w_sph, w)
        rad = rad + v3.where(hit_light, thr * Le * w, zero)

        alive = alive & hit.valid & (sh.mtype != EMISSIVE)

        # --- next-event estimation ---
        if config.nee:
            # wo enables the glossy lobe inside eval_bsdf; statically omit
            # it for glossy-free scenes (saves two pow's/lane per NEE eval)
            wo = -d if scene.has_glossy else None
            direct = (
                nee_area_soa(scene, hit, bkey, occluded_fn, config.mis, sh,
                             wo=wo)
                + nee_point_soa(scene, hit, occluded_fn, sh, wo=wo)
                + nee_sphere_soa(scene, hit, bkey, occluded_fn, sh,
                                 mis=config.mis, wo=wo,
                                 times=rtimes if config.motion_blur else None)
            )
            rad = rad + v3.where(alive, thr * direct, zero)

        # --- BSDF sample & bounce (lobes statically pruned to the scene's
        # material set — spot collapses to the pure-lambert shader) ---
        bs = sample_bsdf_soa(sh, hit, -d, bkey, glossy=scene.has_glossy,
                             metal=scene.has_metal,
                             dielectric=scene.has_dielectric)
        thr = thr * bs.weight
        alive = alive & bs.valid & ((thr.x > 0.0) | (thr.y > 0.0) | (thr.z > 0.0))

        flip = jnp.where(v3.dot(hit.normal, bs.wi) >= 0.0, RAY_EPS, -RAY_EPS)
        o = hit.point + hit.normal * flip
        d = bs.wi

        # --- Russian roulette (differentiable via detached probability,
        # replaces the reference's fixed depth cut `Scene/Scene.fs:304`) ---
        if config.rr_enable:
            p = jnp.clip(thr.max_component(), 0.05, 0.95)
            p = lax.stop_gradient(p)
            rr_on = bounce >= config.rr_start
            p = jnp.where(rr_on, p, 1.0)
            u = rng.uniforms(bkey, 99)
            survive = ~rr_on | (u < p)
            thr = thr * (1.0 / p)
            alive = alive & survive

        thr = v3.where(alive, thr, zero)
        return (o.x, o.y, o.z, d.x, d.y, d.z,
                thr.x, thr.y, thr.z, rad.x, rad.y, rad.z,
                bs.pdf, rtimes, alive, bs.specular, keys), None

    init = _flat_init(rays, keys, times, B)
    if config.compact and config.max_depth > 1:
        return _compact_bounce_loop(scene, init, bounce_step, config)
    if config.sort_secondary and config.max_depth > 1:
        # primary bounce in pixel-tile order, then a wavefront re-sort
        # before *every* later bounce: bounce rays are incoherent in pixel
        # order and coherence decays again after each scatter, while the
        # intersector culls per ray block. Each path carries its
        # pixel id so radiance can be unsorted at the end; the estimator is
        # exactly permutation-invariant (each lane is an independent path).
        #
        # The permutation is applied with ONE multi-operand `lax.sort`
        # (key + every wavefront column, see `_permute_by_key`).
        pid = jnp.arange(B, dtype=jnp.int32)
        carry, _ = bounce_step(init, jnp.int32(0))

        def sorted_step(carry_pid, bounce):
            carry, pid = carry_pid
            o = V3(carry[0], carry[1], carry[2])
            d = V3(carry[3], carry[4], carry[5])
            skey = _coherence_key_soa(scene, o, d, carry[I_ALIVE])
            carry, pid = _sort_flat(skey, carry, pid)
            carry, _ = bounce_step(carry, bounce)
            return (carry, pid), None

        (carry, pid), _ = lax.scan(
            sorted_step, (carry, pid), jnp.arange(1, config.max_depth)
        )
        # unsort by pixel id — also a sort, not a scatter
        f, _ = _permute_by_key(pid, carry[9:12], ())
        return jnp.stack(f, axis=1)
    carry, _ = lax.scan(bounce_step, init, jnp.arange(config.max_depth))
    return jnp.stack(carry[9:12], axis=1)


def _trace_mafrix(scene, rays, keys, config):
    """Reference-parity estimator — see module docstring for the exact
    factorization being reproduced (`Integrators.fs:107-138`)."""
    B = rays.origin.shape[0]
    occluded_fn = _occluder(scene, config)
    total_area = scene.light_total_area

    def bounce_step(carry, bounce):
        rays, throughput, radiance, alive = carry
        bkey = rng.bounce_key(keys, bounce)
        hit, sh = _intersect(scene, rays, config, alive=alive)
        alive = alive & hit.valid
        wo = -rays.direction

        # BSDF sample first: its weight multiplies both the direct term and
        # the recursion, exactly like `(l/pdf + TraceRay(...)) * col / pdf`.
        bs = sample_bsdf(scene, hit, wo, bkey, uniform_lambert=True, sh=sh)
        throughput = jnp.where(
            alive[:, None], throughput * bs.weight, throughput
        )

        # Direct light with the reference's Area^2 fold:
        # l/pdf_li = cos_s * I * |cos_l| * Area^2 / d^2 (`Light.fs:48-59`).
        ls = L.sample_area_lights(scene, bkey, hit.t.shape)
        to_l = ls.point - hit.point
        d2 = jnp.maximum(dot(to_l, to_l), 1e-12)
        dist = jnp.sqrt(d2)
        wl = to_l / dist[:, None]
        cos_s = dot(hit.normal, wl)
        cos_l = dot(ls.normal, -wl)
        # reference-exact shadow protocol: origin AT the hit point with
        # t in (eps, dist - eps) (`Integrators.fs:44`; golden_numpy.py
        # matches) — no geometric offset, so the target light's own surface
        # can never fall inside the tested interval
        shadow = Rays(origin=hit.point, direction=wl)
        blocked = occluded_fn(shadow, L.SHADOW_EPS, dist - L.SHADOW_EPS)
        direct = (
            ls.radiance
            * (cos_s * jnp.abs(cos_l) * total_area**2 / d2)[:, None]
        )
        direct_ok = (
            alive & ls.valid & ~blocked & (cos_l > 0.0) & (cos_s > 0.0)
        )
        radiance = radiance + jnp.where(
            direct_ok[:, None], throughput * direct, 0.0
        )

        alive = alive & bs.valid
        offset_n = (
            jnp.where(dot(hit.normal, bs.wi)[:, None] >= 0.0, 1.0, -1.0) * hit.normal
        )
        rays = Rays(origin=hit.point + offset_n * RAY_EPS, direction=bs.wi)
        throughput = jnp.where(alive[:, None], throughput, 0.0)
        return (rays, throughput, radiance, alive), None

    init = (
        rays,
        jnp.ones((B, 3), jnp.float32),
        jnp.zeros((B, 3), jnp.float32),
        jnp.ones((B,), bool),
    )
    (_, _, radiance, _), _ = lax.scan(bounce_step, init, jnp.arange(config.max_depth))
    return radiance


def trace_stats(scene, rays: Rays, keys: Array, config: PathTracerConfig,
                return_profile: bool = False):
    """Count useful ray queries (closest-hit + shadow) for one wavefront —
    the measured ray accounting used by bench.py. Mirrors the physical
    estimator's control flow without shading, INCLUDING the true per-lane
    Russian-roulette survival rule (p = clip(max throughput, 0.05, 0.95)
    with the same RNG stream as `_trace_physical`) AND the compaction
    schedule's population-control kills, so the bench numerator tracks what
    the timed run actually traces.

    `return_profile=True` additionally returns the (max_depth,) live
    fraction at the top of each bounce — the survival profile bench.py uses
    to size the compaction buckets."""
    B = rays.origin.shape[0]
    alive = jnp.ones((B,), bool)
    thr = jnp.ones((B, 3), jnp.float32)
    queries = jnp.zeros((), jnp.float32)
    pid = jnp.arange(B, dtype=jnp.int32)
    buckets = compact_buckets(config, B) if config.compact else None
    profile = []
    # shadow-query families per bounce: one batched area-light query when any
    # area light exists, one per LIVE point light, one per LIVE
    # emissive-sphere light — counted via the masks, not the padded table
    # shapes (point lights bucket to 8 rows, spheres to 4; counting padding
    # would inflate the bench numerator up to 8x)
    n_shadow = (
        jnp.any(scene.light_mask).astype(jnp.float32)
        + jnp.sum(scene.plight_mask.astype(jnp.float32))
        + jnp.sum(scene.slight_mask.astype(jnp.float32))
    )

    for bounce in range(config.max_depth):
        if buckets and bounce >= 1 and buckets[bounce] < buckets[bounce - 1]:
            # mirror the compaction loop's population-control RR exactly:
            # same per-lane RNG (salt 97), same (u, lane-id) threshold pair,
            # so kill events — and hence the query counts — match the timed
            # run. (The physical packing itself does not change counts:
            # dead lanes were never counted.)
            K = buckets[bounce]
            u = rng.uniforms(rng.bounce_key(keys, bounce), 97)
            u = jnp.where(alive, u, 2.0)
            su, sp = lax.sort((u, pid), num_keys=2)
            tau_u, tau_p = su[K - 1], sp[K - 1]
            selected = alive & ((u < tau_u) | ((u == tau_u) & (pid <= tau_p)))
            L = jnp.sum(alive.astype(jnp.float32))
            comp = jnp.maximum(L / K, 1.0)
            thr = jnp.where(selected[:, None], thr * comp, thr)
            alive = selected
        bkey = rng.bounce_key(keys, bounce)
        profile.append(jnp.mean(alive.astype(jnp.float32)))
        queries = queries + jnp.sum(alive)  # closest-hit queries this bounce
        hit, sh = _intersect(scene, rays, config, alive=None if bounce == 0 else alive)
        alive = alive & hit.valid & (sh.mtype != EMISSIVE)
        if config.nee:
            queries = queries + n_shadow * jnp.sum(alive)  # shadow rays
        bs = sample_bsdf(scene, hit, -rays.direction, bkey, sh=sh)
        thr = thr * bs.weight
        alive = alive & bs.valid & (jnp.max(thr, axis=1) > 0.0)
        offset_n = (
            jnp.where(dot(hit.normal, bs.wi)[:, None] >= 0.0, 1.0, -1.0) * hit.normal
        )
        rays = Rays(origin=hit.point + offset_n * RAY_EPS, direction=bs.wi)
        if config.rr_enable and bounce >= config.rr_start:
            # exact mirror of _trace_physical's roulette: same probability,
            # same RNG salt, same throughput compensation
            p = jnp.clip(jnp.max(thr, axis=1), 0.05, 0.95)
            u = rng.uniforms(bkey, 99)
            alive = alive & (u < p)
            thr = thr / p[:, None]
        thr = jnp.where(alive[:, None], thr, 0.0)
    if return_profile:
        return queries, jnp.stack(profile)
    return queries


# ---------------------------------------------------------------------------
# Pixel sampling / full-frame rendering
# ---------------------------------------------------------------------------


def make_pixel_uv(width: int, height: int):
    """Flat pixel-center grid: u along +x (columns), v along +y downward
    (rows), matching `PixelIntegrator.Sample` (`Integrators.fs:161-171`)."""
    j, i = jnp.meshgrid(
        jnp.arange(height, dtype=jnp.float32),
        jnp.arange(width, dtype=jnp.float32),
        indexing="ij",
    )
    return i.reshape(-1), j.reshape(-1)


def _default_tile_shape():
    """Near-square pixel block covering one intersector ray block."""
    return _spp_tile_shape(1)


def tiled_pixel_order(width: int, height: int, tile_w: int = 0, tile_h: int = 0):
    """Permutation putting pixels in (tile-row, tile-col, in-tile) order so
    each consecutive run of tile_w*tile_h rays is a compact screen block.
    The intersector walks rays in blocks of `intersect_pallas.BLOCK`; a
    compact pixel block has a far tighter frustum than a scanline run of
    the same length, so cluster culling removes much more work. Returns
    (perm, inv_perm) as numpy arrays (host; width/height are static)."""
    import numpy as np

    if not tile_w or not tile_h:
        tile_w, tile_h = _default_tile_shape()
    ids = np.arange(width * height, dtype=np.int64)
    x = ids % width
    y = ids // width
    key = (
        ((y // tile_h) * ((width + tile_w - 1) // tile_w) + (x // tile_w))
        * (tile_w * tile_h)
        + (y % tile_h) * tile_w
        + (x % tile_w)
    )
    perm = np.argsort(key, kind="stable")
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return perm.astype(np.int32), inv.astype(np.int32)


def _spp_group(spp: int, B: int, target: int) -> int:
    """Largest divisor of `spp` keeping the wavefront B*G near `target`,
    preferring divisors that also divide the intersector block so a
    pixel's G samples never straddle ray blocks (which would silently
    loosen the per-block cull frustum)."""
    from mafrixraytracing_tpu.ops.intersect_pallas import BLOCK

    cap = max(1, min(spp, target // max(B, 1)))
    best = 1
    for g in range(1, cap + 1):
        if spp % g == 0 and BLOCK % g == 0:
            best = g
    if best > 1:
        return best
    g = cap
    while spp % g:
        g -= 1
    return g


def _spp_tile_shape(G: int):
    """Pixel-block shape for the intersector ray block when each pixel
    carries G consecutive samples: BLOCK/G pixels, laid out near-square."""
    from mafrixraytracing_tpu.ops.intersect_pallas import BLOCK

    px = max(1, BLOCK // max(G, 1))
    h = 1
    while h * 2 * h * 2 <= px:
        h *= 2
    w = max(1, px // h)
    return w, h


@partial(jax.jit, static_argnames=("width", "height", "spp", "config"))
def render_image(
    scene,
    camera,
    width: int,
    height: int,
    spp: int,
    key: Array,
    config: PathTracerConfig = PathTracerConfig(),
) -> Array:
    """Render a full frame: (height, width, 3) linear radiance, averaged over
    `spp` jittered samples per pixel. One jit; samples are grouped into
    wavefronts of ~config.wavefront rays (G spp per scan step) so dispatch
    overhead amortizes, and the outer spp loop is a `lax.scan` so compile
    time is O(1) in spp."""
    B = width * height
    G = _spp_group(spp, B, config.wavefront)
    # large frames are CHUNKED over the pixel axis so one wavefront never
    # exceeds ~config.wavefront rays (a 1024^2 frame would otherwise carry
    # 1M-ray buffers through every bounce and OOM at high spp — the
    # BASELINE Renault config needs this); each scan step renders one
    # (pixel-chunk, spp-group) pair.
    n_chunks = max(1, -(-B // config.wavefront)) if G == 1 else 1
    from mafrixraytracing_tpu.ops.intersect_pallas import BLOCK

    Bc = -(-B // n_chunks)
    Bc = -(-Bc // BLOCK) * BLOCK
    B_pad = n_chunks * Bc
    px, py = make_pixel_uv(width, height)
    perm, inv = tiled_pixel_order(width, height, *_spp_tile_shape(G))
    px, py = px[perm], py[perm]  # tile-swizzled ray order (see tiled_pixel_order)
    if B_pad != B:
        # pad with repeated pixels (rendered, then dropped at the end)
        reps = jnp.arange(B_pad - B) % B
        px = jnp.concatenate([px, px[reps]])
        py = jnp.concatenate([py, py[reps]])
    base_keys = rng.pixel_keys(key, B_pad)
    # interleave: a pixel's G samples sit consecutively, so one intersector
    # ray block covers only BLOCK/G distinct pixels — the block frustum
    # shrinks to a few pixels and far fewer clusters survive the cull (the
    # dominant kernel cost is proportional to survivors)
    pxg, pyg = jnp.repeat(px, G), jnp.repeat(py, G)

    def one_group(acc, step):
        # acc is a flat 3-tuple of (B_pad,) columns (see core.v3)
        g = step // n_chunks
        ci = step % n_chunks
        off = ci * Bc
        keys_c = lax.dynamic_slice_in_dim(base_keys, off, Bc)
        px_c = lax.dynamic_slice_in_dim(pxg, off * G, Bc * G)
        py_c = lax.dynamic_slice_in_dim(pyg, off * G, Bc * G)
        sidx = g * G + jnp.arange(G)
        skeys = jax.vmap(lambda s: rng.sample_key(keys_c, s))(sidx)
        skeys = jnp.swapaxes(skeys, 0, 1).reshape(Bc * G)  # pixel-major
        jit_uv = rng.uniforms(skeys, 1000, (2,))
        lens_uv = rng.uniforms(skeys, 1001, (2,))
        u = (px_c + jit_uv[:, 0]) / width
        v = (py_c + jit_uv[:, 1]) / height
        rays = camera.get_rays(u, v, lens_uv=lens_uv)
        times = rng.uniforms(skeys, 1002) if config.motion_blur else None
        rad = trace_radiance(scene, rays, skeys, config, times=times)
        rad = rad.reshape(Bc, G, 3).sum(axis=1)
        acc = tuple(
            lax.dynamic_update_slice_in_dim(
                a, lax.dynamic_slice_in_dim(a, off, Bc) + rad[:, i], off, 0
            )
            for i, a in enumerate(acc)
        )
        return acc, None

    if config.remat:
        # saved attribute columns persist for the WHOLE scan:
        # spp * depth * pixels * 144 bytes. Auto-fall back to the lean
        # policy when that would not fit comfortably in device memory (e.g.
        # Renault 1024^2 @ 256 spp would need ~184 GB). The 4 GB limit is a
        # fixed size that has not been tuned on the GPU.
        attr_gb = spp * config.max_depth * B * 144 / 1e9
        policy = (SAVE_ISECT_ATTRS if config.save_attrs and attr_gb <= 4.0
                  else SAVE_ISECT)
        one_group = jax.checkpoint(one_group, policy=policy, prevent_cse=False)
    acc, _ = lax.scan(
        one_group,
        tuple(jnp.zeros((B_pad,), jnp.float32) for _ in range(3)),
        jnp.arange((spp // G) * n_chunks),
    )
    img = jnp.stack(acc, axis=1)[:B][inv] / spp  # un-swizzle to row-major
    return img.reshape(height, width, 3)


def render_sample_batch(scene, camera, width, height, sample_idx, key, config):
    """One 1-spp pass over all pixels (the progressive-film unit of work,
    reference `Film.GetFrame(integrator, 1)` at `Scene/Scene.fs:332`).
    Returns flat (W*H, 3)."""
    px, py = make_pixel_uv(width, height)
    B = px.shape[0]
    base_keys = rng.pixel_keys(key, B)
    skeys = rng.sample_key(base_keys, sample_idx)
    jit_uv = rng.uniforms(skeys, 1000, (2,))
    lens_uv = rng.uniforms(skeys, 1001, (2,))
    u = (px + jit_uv[:, 0]) / width
    v = (py + jit_uv[:, 1]) / height
    rays = camera.get_rays(u, v, lens_uv=lens_uv)
    return trace_radiance(scene, rays, skeys, config)
