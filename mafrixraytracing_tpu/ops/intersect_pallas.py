"""Closest-hit and any-hit cluster walks as Pallas kernels (Triton route).

The hot loop of the whole framework — the wavefront replacement for the
reference's recursive BVH traversal + per-ray Moller-Trumbore
(`Core/Accelerate/BvhNode.fs:62-83`, `Core/Shape/Trangle.fs:120-145`).

Two-phase design (build in `accel.clusters`):

1. **Cull (XLA, dense):** slab-test every ray against every cluster AABB as
   one dense (B, C) computation, reduce to one survivor list per block of
   `BLOCK` rays, sorted by the block's conservative entry distance
   (front-to-back). All data-dependent control flow stays out of the
   kernel's setup.
2. **Walk (Pallas, Triton route):** one program per ray block. The program
   loads its own list row, survivor count and entry distances from device
   memory and walks the list front to back in a `lax.while_loop`; it exits
   as soon as the next entry lies at or past the block's worst best-hit
   distance (the wavefront analog of ordered BVH descent with early
   termination). Rays sit on rows and a cluster's 128 triangles on
   columns, so each visited cluster is one dense (BLOCK, 128) tile of
   Moller-Trumbore tests held in registers; the 9 x 128 packed cluster
   rows stream from L2 (the whole pack is a few MB).

Shadow rays use a separate **any-hit** kernel: no best-hit bookkeeping,
and the block exits as soon as every live ray is occluded.

Differentiability: this module only performs the *search* (t, index); the
differentiable attribute recompute stays in
`geometry.intersect.hit_attributes*` (detached-selection
reparameterization), so backward cost is O(rays) regardless of scene size.
The search results are tagged with `checkpoint_name` (in `ops.dispatch`) so
a surrounding `jax.checkpoint(policy=save_only_these_names(...))` saves
them instead of re-running the kernels in the backward pass.

Numerics: the hit test is the reference's float32 Moller-Trumbore
arithmetic with a true divide — there is no matrix product, so TF32 never
applies.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import jax.experimental.pallas as pl
import numpy as np
from jax import lax
from jax.experimental.pallas import triton as pl_triton

from mafrixraytracing_tpu.accel.clusters import CLUSTER_SIZE, SUPER

# Rays per program (a power of two) and warps per program: the fastest
# pair of a sweep of BLOCK in {8..128} x warps in {2, 4, 8} on an H100
# (PERF.md). Every wavefront alignment in the integrator (pixel tiles, spp
# grouping, compaction buckets) reads BLOCK from here.
BLOCK = 8
NUM_WARPS = 4
NUM_STAGES = 1
ROWS = 9            # rows per cluster in the packed triangle array
BIG = 1e30
DET_EPS = 1e-10
_IMAX = 2**31 - 1

# Scenes with more than this many clusters cull rays at SUPERcluster
# granularity ((B, S) slabs, 16x smaller) and let the kernel refine each
# surviving supercluster against its child cluster AABBs.
SUPER_MIN_C = 128

# t_min arrives as a STATIC Python float (PathTracerConfig.t_min is a
# hashable jit-static, and the NEE shadow epsilon is a module constant), so
# it is baked into each kernel specialization at trace time — the kernels
# honor `config.t_min` exactly like the jnp backend does (the reference's
# epsilon protocol is likewise a parameter, `Integrators.fs:44,108`). A
# traced t_min raises loudly in `find_closest_soa` / `occluded_soa`.


def supports(scene) -> bool:
    T = scene.tri_v0.shape[0]
    return (
        T % CLUSTER_SIZE == 0
        and scene.cluster_min.shape[0] * CLUSTER_SIZE == T
    )


def resolve_interpret(interpret=None) -> bool:
    """Interpret mode on the CPU, compiled through Triton on the GPU; any
    other platform has no route to these kernels."""
    if interpret is not None:
        return bool(interpret)
    platform = jax.default_backend()
    if platform == "cpu":
        return True
    if platform == "gpu":
        return False
    raise RuntimeError(
        f"the Pallas intersection kernels run on 'gpu' (Triton) or 'cpu' "
        f"(interpret mode), not on '{platform}'"
    )


# ---------------------------------------------------------------------------
# Phase 1: dense cull (plain jnp, fused by XLA)
# ---------------------------------------------------------------------------


def _cull(o, d, t_max, cmin, cmax):
    """Per-block *ordered* cluster lists. o, d: V3 of (B,) columns; t_max:
    (B,); cmin/cmax: (C, 3). Returns:
      lists   (blocks, C) i32 — cluster ids sorted by conservative entry
              distance (front-to-back), surviving clusters first
      counts  (blocks, 1) i32 — number of survivors
      entries (blocks, C) f32 — block-min entry distance per sorted slot
      far     (B,)        f32 — farthest AABB *exit* among the ray's own
              surviving clusters: once the front-to-back walk passes this
              distance no future cluster can overlap the ray, so the ray is
              resolved even without a hit. This is what lets blocks that
              contain sky/miss rays exit early at all.
    """
    B = o.x.shape[0]
    # per-axis accumulation keeps temps at (B, C) instead of (B, C, 3)
    tn = jnp.full((B, cmin.shape[0]), -BIG, jnp.float32)
    tf = jnp.full((B, cmin.shape[0]), BIG, jnp.float32)
    for oa, da, a in ((o.x, d.x, 0), (o.y, d.y, 1), (o.z, d.z, 2)):
        inv = 1.0 / jnp.where(jnp.abs(da) > 1e-12, da,
                              jnp.where(da >= 0, 1e-12, -1e-12))
        t0 = (cmin[None, :, a] - oa[:, None]) * inv[:, None]
        t1 = (cmax[None, :, a] - oa[:, None]) * inv[:, None]
        tn = jnp.maximum(tn, jnp.minimum(t0, t1))
        tf = jnp.minimum(tf, jnp.maximum(t0, t1))
    # Empty (padded) clusters are marked min > max; their +-3e38 slabs
    # overflow to +-inf under the multiply, so the interval test alone would
    # PASS them for every ray (with entry distance 0, sorting them to the
    # front of every walk). Mask them out explicitly.
    live = (cmin[:, 0] <= cmax[:, 0])[None, :]
    hit = live & (tn <= tf) & (tf > 0.0) & (tn < t_max[:, None])  # (B, C)
    entry = jnp.where(hit, jnp.maximum(tn, 0.0), BIG)
    far = jnp.max(jnp.where(hit, tf, -BIG), axis=1)
    far = jnp.minimum(far, t_max)
    block_entry = jnp.min(entry.reshape(B // BLOCK, BLOCK, -1), axis=1)
    # row sort of (entry, id): stable, so equal entries keep ascending id
    ids = lax.broadcasted_iota(jnp.int32, block_entry.shape, 1)
    entries, order = lax.sort((block_entry, ids), dimension=1, num_keys=1)
    counts = jnp.sum(block_entry < BIG, axis=1, keepdims=True)
    return order, counts.astype(jnp.int32), entries, far


# ---------------------------------------------------------------------------
# Phase 2: the walk kernels
# ---------------------------------------------------------------------------


def _mt_test(rays, tri_ref, c):
    """Moller-Trumbore (`Core/Shape/Trangle.fs:120-145`) of one ray block
    against cluster `c`, in the same arithmetic as the jnp reference
    (`geometry.intersect.tri_hit_terms`), so both searches agree on t to a
    few ulps and on which of two triangles sharing an edge is nearer.
    rays: six (BLOCK, 1) columns. Returns (t, valid) as (BLOCK, 128); t is
    the signed hit distance with no range test applied, valid covers
    det/u/v."""
    ox, oy, oz, dx, dy, dz = rays
    base = c * ROWS
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (
        tri_ref[base + k, :][None, :] for k in range(ROWS)
    )
    # pvec = d x e2
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = jnp.abs(det) > DET_EPS
    inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    # qvec = tvec x e1
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    valid = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, valid


def _load_rays(ray_refs):
    cols = [ref[...] for ref in ray_refs]
    rays = tuple(c[:, None] for c in cols[:6])
    return rays, cols[6], cols[7]


def _inv_dirs(ray_refs):
    """Origins and reciprocal directions as (BLOCK,) columns (child slab
    tests of the two-level walk)."""
    o = [ref[...] for ref in ray_refs[:3]]
    inv = []
    for ref in ray_refs[3:6]:
        da = ref[...]
        inv.append(1.0 / jnp.where(jnp.abs(da) > 1e-12, da,
                                   jnp.where(da >= 0, 1e-12, -1e-12)))
    return o, inv


def _child_hits(inv_rays, bounds_ref, c, limit):
    """(BLOCK,) bool: which rays could still hit child cluster `c` within
    their per-ray `limit`. bounds_ref rows: [min xyz, max xyz, live, 0]. The
    entry comparison is INCLUSIVE (flat children have entry == exit)."""
    o, inv = inv_rays
    tn = jnp.full(limit.shape, -BIG, jnp.float32)
    tf = jnp.full(limit.shape, BIG, jnp.float32)
    for a in range(3):
        t0 = (bounds_ref[c, a] - o[a]) * inv[a]
        t1 = (bounds_ref[c, 3 + a] - o[a]) * inv[a]
        tn = jnp.maximum(tn, jnp.minimum(t0, t1))
        tf = jnp.minimum(tf, jnp.maximum(t0, t1))
    return (bounds_ref[c, 6] > 0.5) & (tn <= tf) & (tf > 0.0) & (tn <= limit)


def _visit(entry, visit_cluster, carry, two_level, inv_rays, bounds_ref,
           limit):
    """Visit one list entry: a cluster, or (two-level) each of the
    supercluster's 16 children that some ray can still hit within
    `limit(carry)` — the others cost one slab test, not a cluster test."""
    if not two_level:
        return visit_cluster(entry, carry)

    def child(j, carry):
        c = entry * SUPER + j
        live = jnp.max(_child_hits(inv_rays, bounds_ref, c,
                                   limit(carry)).astype(jnp.int32))
        return lax.cond(live > 0, partial(visit_cluster, c),
                        lambda x: x, carry)

    return lax.fori_loop(0, SUPER, child, carry)


def _closest_kernel(list_ref, count_ref, entry_ref, *refs, t_min,
                    two_level):
    """One ray block against its surviving clusters, front to back.

    list_ref/entry_ref: (C,) this block's sorted cluster (or, two-level,
    supercluster) ids / entries; count_ref: (1,) survivor count; refs: the
    eight (BLOCK,) ray columns [ox oy oz dx dy dz t_max far], the whole
    (C*9, 128) triangle pack, the (S*16, 8) child bounds when two-level,
    then the outputs t/i: (BLOCK,) best distance and global triangle index
    (-1 = miss).

    Tie-break contract: among exactly-equal best distances the SMALLEST
    GLOBAL TRIANGLE INDEX wins, as in the jnp reference's reduction.

    Early exit: a ray is resolved once `min(best, far)` lies before the next
    entry — `far` (the exit distance of the ray's last surviving cluster,
    from the cull) bounds where it can still find geometry, so miss/sky
    rays resolve too instead of pinning the block at t_max.
    """
    ray_refs, tri_ref = refs[:8], refs[8]
    bounds_ref = refs[9] if two_level else None
    t_out, i_out = refs[-2:]
    rays, t_max, far = _load_rays(ray_refs)
    inv_rays = _inv_dirs(ray_refs) if two_level else None
    lanes = lax.broadcasted_iota(jnp.int32, (BLOCK, CLUSTER_SIZE), 1)
    n = count_ref[0]

    def visit_cluster(c, best):
        best_t, best_i = best
        t, valid = _mt_test(rays, tri_ref, c)
        valid = (valid & (t > t_min) & (t < t_max[:, None])
                 & (t <= best_t[:, None]))
        tt = jnp.where(valid, t, BIG)
        ct = jnp.min(tt, axis=1)
        ci = jnp.min(
            jnp.where(valid & (tt <= ct[:, None]), lanes + c * CLUSTER_SIZE,
                      _IMAX),
            axis=1,
        )
        better = (ct < best_t) | ((ct == best_t) & (ci < best_i))
        return jnp.where(better, ct, best_t), jnp.where(better, ci, best_i)

    def cond(state):
        k, best_t, _ = state
        worst = jnp.max(jnp.minimum(best_t, far))
        # INCLUSIVE compare: a flat axis-aligned cluster has zero AABB
        # thickness, so a ray's conservative entry equals its exit (`far`);
        # a strict < would end the walk before testing it and drop its
        # geometry (regression: tests/test_pallas.py::test_flat_clustered_*)
        return (k < n) & (entry_ref[jnp.minimum(k, n - 1)] <= worst)

    def body(state):
        k, best_t, best_i = state
        best = _visit(list_ref[k], visit_cluster, (best_t, best_i),
                      two_level, inv_rays, bounds_ref,
                      lambda b: jnp.minimum(b[0], t_max))
        return (k + 1,) + best

    init = (jnp.int32(0), jnp.full((BLOCK,), BIG, jnp.float32),
            jnp.full((BLOCK,), _IMAX, jnp.int32))
    _, best_t, best_i = lax.while_loop(cond, body, init)
    t_out[...] = best_t
    i_out[...] = jnp.where(best_i < _IMAX, best_i, -1)


def _anyhit_kernel(list_ref, count_ref, entry_ref, *refs, t_min, two_level):
    """Shadow-ray occlusion: exits as soon as every live ray is blocked.
    Same layout as `_closest_kernel`; the output is (BLOCK,) i32
    (1 = occluded). Any valid hit in (t_min, t_max) occludes."""
    ray_refs, tri_ref = refs[:8], refs[8]
    bounds_ref = refs[9] if two_level else None
    occ_out = refs[-1]
    rays, t_max, far = _load_rays(ray_refs)
    inv_rays = _inv_dirs(ray_refs) if two_level else None
    n = count_ref[0]
    dead = t_max <= t_min

    def visit_cluster(c, blocked):
        t, valid = _mt_test(rays, tri_ref, c)
        hit = valid & (t > t_min) & (t < t_max[:, None])
        return jnp.maximum(blocked, jnp.max(hit.astype(jnp.int32), axis=1))

    def cond(state):
        k, blocked = state
        next_entry = entry_ref[jnp.minimum(k, n - 1)]
        resolved = (blocked > 0) | dead | (far < next_entry)
        return (k < n) & (jnp.min(resolved.astype(jnp.int32)) == 0)

    def body(state):
        k, blocked = state
        # rays already blocked need no more child tests: zero their limit
        return k + 1, _visit(list_ref[k], visit_cluster, blocked, two_level,
                             inv_rays, bounds_ref,
                             lambda b: jnp.where(b > 0, 0.0, t_max))

    init = (jnp.int32(0), jnp.zeros((BLOCK,), jnp.int32))
    _, blocked = lax.while_loop(cond, body, init)
    occ_out[...] = blocked


def pack_bounds(scene):
    """(S*16, 8) child-cluster AABB rows for the two-level kernels:
    [min xyz, max xyz, live, 0]. Empty children carry +-3e38 sentinels
    (their slab overflows to +-inf and passes — the live column masks
    them, as in `_cull`)."""
    C = scene.cluster_min.shape[0]
    S = scene.super_min.shape[0]
    pad = S * SUPER - C
    cmin, cmax = scene.cluster_min, scene.cluster_max
    if pad:
        cmin = jnp.concatenate([cmin, jnp.full((pad, 3), 3e38)], axis=0)
        cmax = jnp.concatenate([cmax, jnp.full((pad, 3), -3e38)], axis=0)
    live = (cmin[:, 0] <= cmax[:, 0]).astype(jnp.float32)
    return jnp.concatenate(
        [cmin, cmax, live[:, None], jnp.zeros((S * SUPER, 1), jnp.float32)],
        axis=1,
    )


def pack_tris(scene):
    """(C*9, 128) component-major packed triangles: rows c*9+k hold
    component k of [v0 xyz, e1 xyz, e2 xyz] of cluster c's 128 triangles
    across columns (`_mt_test`). Mega triangles are zeroed (e1 = e2 = 0 ->
    det == 0 -> never hit): the dense jnp test in `_mega_hits` owns them,
    and the cluster AABBs exclude them."""
    T = scene.tri_v0.shape[0]
    C = T // CLUSTER_SIZE
    comp = jnp.concatenate([scene.tri_v0, scene.tri_e1, scene.tri_e2],
                           axis=1)  # (T, 9)
    safe_ids = jnp.where(scene.mega_ids >= 0, scene.mega_ids, T)
    comp = comp.at[safe_ids].set(0.0, mode="drop")
    comp = comp.reshape(C, CLUSTER_SIZE, ROWS).transpose(0, 2, 1)
    return comp.reshape(C * ROWS, CLUSTER_SIZE)


def _mega_hits(scene, o, d, t_min, t_max):
    """Dense Moller-Trumbore over the (<= MAX_MEGA) mega triangles; o, d are
    V3 of (B,) columns, temps are (B, M) component planes. Returns (t, idx):
    nearest mega hit within (t_min, t_max) per ray, with idx the *global*
    triangle index (-1 on miss / t = BIG)."""
    T = scene.tri_v0.shape[0]
    n = max(int(getattr(scene, "num_mega", 0)), 0)
    if n == 0:
        B = o.x.shape[0]
        return jnp.full((B,), BIG, jnp.float32), jnp.full((B,), -1, jnp.int32)
    # static slice to the live mega rows (mega_ids is -1-padded to MAX_MEGA;
    # the live entries are first)
    ids = scene.mega_ids[:n]
    live = ids >= 0
    idc = jnp.clip(ids, 0, T - 1)
    v0 = scene.tri_v0[idc]
    e1 = scene.tri_e1[idc]
    e2 = scene.tri_e2[idc]

    ox, oy, oz = o.x[:, None], o.y[:, None], o.z[:, None]
    dx, dy, dz = d.x[:, None], d.y[:, None], d.z[:, None]
    e1x, e1y, e1z = e1[None, :, 0], e1[None, :, 1], e1[None, :, 2]
    e2x, e2y, e2z = e2[None, :, 0], e2[None, :, 1], e2[None, :, 2]
    # pvec = d x e2
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = jnp.abs(det) > DET_EPS
    inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
    tx = ox - v0[None, :, 0]
    ty = oy - v0[None, :, 1]
    tz = oz - v0[None, :, 2]
    u = (tx * px + ty * py + tz * pz) * inv_det
    # qvec = tvec x e1
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = (
        live[None]
        & ok
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min)
        & (t < t_max[:, None])
    )
    t = jnp.where(ok, t, BIG)
    best = jnp.min(t, axis=1)
    gid = jnp.broadcast_to(idc[None, :], t.shape)
    idx = jnp.min(
        jnp.where(t <= best[:, None], gid, jnp.int32(_IMAX)), axis=1
    )
    idx = jnp.where(best < BIG, idx, -1)
    return best, idx


def _walk(kernel, out_dtypes, tri_pack, bounds, lists, counts, entries,
          ray_cols, interpret):
    B = ray_cols[0].shape[0]
    C = lists.shape[1]
    ray_spec = pl.BlockSpec((BLOCK,), lambda g: (g,))
    extra = () if bounds is None else (bounds,)
    return pl.pallas_call(
        kernel,
        grid=(B // BLOCK,),
        in_specs=[
            pl.BlockSpec((None, C), lambda g: (g, 0)),
            pl.BlockSpec((None, 1), lambda g: (g, 0)),
            pl.BlockSpec((None, C), lambda g: (g, 0)),
            *([ray_spec] * len(ray_cols)),
            pl.BlockSpec(tri_pack.shape, lambda g: (0, 0)),
            *(pl.BlockSpec(b.shape, lambda g: (0, 0)) for b in extra),
        ],
        out_specs=[ray_spec] * len(out_dtypes),
        out_shape=[jax.ShapeDtypeStruct((B,), dt) for dt in out_dtypes],
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS,
                                                 num_stages=NUM_STAGES),
        interpret=interpret,
    )(lists, counts, entries, *ray_cols, tri_pack, *extra)


# The search is non-differentiable by design (detached closest-hit
# selection); declare identically-zero tangents so AD never tries to
# differentiate through the pallas_call.
@partial(jax.custom_jvp, nondiff_argnums=(6, 7))
def _search(tri_pack, bounds, lists, counts, entries, ray_cols, t_min,
            interpret):
    kernel = partial(_closest_kernel, t_min=t_min,
                     two_level=bounds is not None)
    t, i = _walk(kernel, (jnp.float32, jnp.int32),
                 tri_pack, bounds, lists, counts, entries, ray_cols,
                 interpret)
    return t, i


@_search.defjvp
def _search_jvp(t_min, interpret, primals, tangents):
    t, i = _search(*primals, t_min, interpret)
    return (t, i), (jnp.zeros_like(t), np.zeros(i.shape, jax.dtypes.float0))


@partial(jax.custom_jvp, nondiff_argnums=(6, 7))
def _search_any(tri_pack, bounds, lists, counts, entries, ray_cols, t_min,
                interpret):
    kernel = partial(_anyhit_kernel, t_min=t_min,
                     two_level=bounds is not None)
    (occ,) = _walk(kernel, (jnp.int32,), tri_pack,
                   bounds, lists, counts, entries, ray_cols, interpret)
    return occ > 0


@_search_any.defjvp
def _search_any_jvp(t_min, interpret, primals, tangents):
    occ = _search_any(*primals, t_min, interpret)
    return occ, np.zeros(occ.shape, jax.dtypes.float0)


def _static_t_min(t_min) -> float:
    """The kernels bake t_min at trace time, so it must be a static Python
    scalar (PathTracerConfig.t_min always is). Raise loudly for tracers
    instead of silently substituting a constant."""
    try:
        return float(t_min)
    except TypeError as e:
        raise TypeError(
            "the Pallas intersection backend requires a static (Python "
            "float) t_min — pass PathTracerConfig.t_min / a module "
            f"constant, not a traced value (got {type(t_min).__name__})"
        ) from e


def _prep(scene, o, d, t_min, t_max, anyhit=False):
    """Shared preamble: detach, pad to a BLOCK multiple, dense
    mega-triangle test (capping t_max so the cull prunes everything behind
    the first mega hit), cull. o, d: V3 of (B,) columns. Returns the mega
    results for the caller to merge."""
    from mafrixraytracing_tpu.core.v3 import V3

    o = jax.tree_util.tree_map(lax.stop_gradient, o)
    d = jax.tree_util.tree_map(lax.stop_gradient, d)
    scene = jax.tree_util.tree_map(lax.stop_gradient, scene)
    B = o.x.shape[0]
    Bp = -(-B // BLOCK) * BLOCK
    t_max_arr = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (B,))
    if Bp != B:
        pad = Bp - B
        zpad = jnp.zeros((pad,), jnp.float32)
        o = V3(*(jnp.concatenate([c, zpad]) for c in o))
        d = V3(jnp.concatenate([d.x, zpad]), jnp.concatenate([d.y, zpad]),
               jnp.concatenate([d.z, jnp.ones((pad,), jnp.float32)]))
        t_max_p = jnp.concatenate([t_max_arr, zpad])
    else:
        t_max_p = t_max_arr

    mega_t, mega_idx = _mega_hits(scene, o, d, t_min, t_max_p)
    if anyhit:
        # an occluding mega hit resolves the ray: zero t_max skips every
        # cluster for it in both the cull and the kernel
        t_max_k = jnp.where(mega_idx >= 0, 0.0, t_max_p)
    else:
        t_max_k = jnp.minimum(t_max_p, mega_t)
    # two-level path for large scenes: cull at SUPERcluster granularity
    # (16x smaller dense pass; the kernel refines children)
    if scene.cluster_min.shape[0] > SUPER_MIN_C:
        bounds = pack_bounds(scene)
        lists, counts, entries, far = _cull(o, d, t_max_k, scene.super_min,
                                            scene.super_max)
    else:
        bounds = None
        lists, counts, entries, far = _cull(o, d, t_max_k, scene.cluster_min,
                                            scene.cluster_max)
    ray_cols = (o.x, o.y, o.z, d.x, d.y, d.z, t_max_k, far)
    return (scene, pack_tris(scene), bounds, (lists, counts, entries),
            ray_cols, B, t_max_arr, mega_t, mega_idx)


def find_closest_soa(scene, o, d, t_min, t_max, interpret=None, times=None):
    """SoA kernel-accelerated closest-hit search (clustered triangles via
    the kernel; mega triangles and spheres merged densely). o, d: V3 of
    (B,) columns. `times` (B,) enables sphere motion blur (the clustered
    triangles are static; only the dense sphere merge is time-shifted).
    Non-differentiable by design."""
    from mafrixraytracing_tpu.geometry.intersect import _closest_sphere_soa

    t_min = _static_t_min(t_min)
    interpret = resolve_interpret(interpret)
    (scene, tri_pack, bounds, sargs, ray_cols, B, t_max_arr,
     mega_t, mega_idx) = _prep(scene, o, d, t_min, t_max)
    tt, ti = _search(tri_pack, bounds, *sargs, ray_cols, t_min, interpret)
    tt, ti = tt[:B], ti[:B]
    mega_t, mega_idx = mega_t[:B], mega_idx[:B]

    tt = jnp.where(ti >= 0, tt, BIG)
    # merge mega triangles (kernel t_max was capped at mega_t, so any
    # clustered hit it reports is strictly closer than the mega hit)
    use_mega = (mega_idx >= 0) & (mega_t < tt)
    tt = jnp.where(use_mega, mega_t, tt)
    ti = jnp.where(use_mega, mega_idx, ti)

    # merge spheres (statically skipped when the scene has none)
    if scene.num_live_spheres > 0:
        ob = jax.tree_util.tree_map(lambda c: c[:B], o)
        db = jax.tree_util.tree_map(lambda c: c[:B], d)
        t_min_b = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (B,))
        st, si = _closest_sphere_soa(scene, ob, db, t_min_b, t_max_arr,
                                     times=None if times is None
                                     else lax.stop_gradient(times))
        T = scene.tri_v0.shape[0]
        use_sphere = st < tt
        tt = jnp.where(use_sphere, st, tt)
        ti = jnp.where(use_sphere, T + si, ti)
    idx = jnp.where(tt < BIG, ti, -1)
    return tt, idx


def find_closest(scene, rays, t_min, t_max, interpret=None):
    """(B, 3) Rays wrapper over `find_closest_soa` — same contract as
    `geometry.intersect.find_closest`."""
    from mafrixraytracing_tpu.core.v3 import V3

    return find_closest_soa(scene, V3.of(rays.origin), V3.of(rays.direction),
                            t_min, t_max, interpret)


def occluded_soa(scene, o, d, t_min, t_max, interpret=None, times=None):
    """SoA any-hit query (shadow rays): dedicated early-exit kernel for
    clustered triangles; mega triangles + spheres merged densely. `t_max`
    may be per-ray. Rays already blocked by a mega hit skip the kernel
    entirely (their zeroed t_max empties the cluster list)."""
    from mafrixraytracing_tpu.geometry.intersect import _closest_sphere_soa

    t_min = _static_t_min(t_min)
    interpret = resolve_interpret(interpret)
    (scene, tri_pack, bounds, sargs, ray_cols, B, t_max_arr,
     mega_t, mega_idx) = _prep(scene, o, d, t_min, t_max, anyhit=True)
    occ = _search_any(tri_pack, bounds, *sargs, ray_cols, t_min, interpret)
    occ = occ[:B] | (mega_idx[:B] >= 0)
    if scene.num_live_spheres > 0:
        ob = jax.tree_util.tree_map(lambda c: c[:B], o)
        db = jax.tree_util.tree_map(lambda c: c[:B], d)
        t_min_b = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (B,))
        st, _ = _closest_sphere_soa(scene, ob, db, t_min_b, t_max_arr,
                                    times=None if times is None
                                    else lax.stop_gradient(times))
        occ = occ | (st < BIG)
    return occ


def occluded(scene, rays, t_min, t_max, interpret=None):
    """(B, 3) Rays wrapper over `occluded_soa`."""
    from mafrixraytracing_tpu.core.v3 import V3

    return occluded_soa(scene, V3.of(rays.origin), V3.of(rays.direction),
                        t_min, t_max, interpret)
