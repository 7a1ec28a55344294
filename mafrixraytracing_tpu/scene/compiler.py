"""Scene compiler: `SceneSpec` -> `ScenePytree` flat SoA device arrays.

This is the array replacement for the reference's object-graph scene
build (`Scene/Scene.fs:291-313`: BVH over `IHitable[]` + `MaterialManager`
singleton + one `INewLight`). Everything becomes padded, statically-shaped
f32/i32 arrays so the whole scene is a single jit-traceable pytree:

- triangles:   v0/e1/e2 SoA (Moller-Trumbore form, reference
               `Core/Shape/Trangle.fs:120-145` precomputes the same e1/e2),
               shading normals, uvs, material id, emitter id, validity mask.
- spheres:     center/radius/material (reference `Core/Shape/Sphere.fs`).
- materials:   type enum + albedo/emission/fuzz/ior table — the array analog
               of `MaterialManager` (reference `Core/Interfaces/IMaterial.fs:20-35`).
- area lights: emissive-triangle table with an area-weighted sampling CDF
               (generalizes the single-rect `NewAreaLight`,
               `Core/Lights/Light.fs:31-64`, and fixes its uniform-triangle
               pick bug `Core/Shape/Rect.fs:33-38`).
- point lights.

Counts are padded to coarse power-of-two buckets (utils.padding) so similar
scenes share compiled executables.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from mafrixraytracing_tpu.core import struct
from jax import Array

from mafrixraytracing_tpu.scene import spec as S
from mafrixraytracing_tpu.utils.padding import bucket_size, pad_to


class ScenePytree(struct.PyTreeNode):
    # --- triangles (T,) ---
    tri_v0: Array
    tri_e1: Array
    tri_e2: Array
    tri_n0: Array   # shading normals per corner (= geometric normal if absent)
    tri_n1: Array
    tri_n2: Array
    tri_uv0: Array  # (T, 2)
    tri_uv1: Array
    tri_uv2: Array
    tri_mat: Array     # (T,) i32
    tri_light: Array   # (T,) i32 — emitter row in the light table, or -1
    tri_mask: Array    # (T,) bool
    # --- shared-vertex mesh parameterization: tri corner k of face t is
    # mesh_vertices[tri_face_vi[t, k]]. tri_v0/e1/e2 are DERIVED caches of
    # this (identical floats at compile time); optimizing `mesh_vertices`
    # re-derives them inside jit (opt.inverse.apply_params) so vertex
    # gradients accumulate into shared vertices across adjacent faces. ---
    mesh_vertices: Array  # (V, 3) f32
    tri_face_vi: Array    # (T, 3) i32 (padded rows: 0)
    # --- spheres (Sp,) ---
    sph_center: Array
    sph_radius: Array
    sph_velocity: Array  # (Sp, 3) shutter-interval motion (MovingSphere)
    sph_mat: Array
    sph_mask: Array
    # --- material table (M,) ---
    mat_type: Array      # i32: 0 lambert, 1 metal, 2 dielectric, 3 emissive
    mat_albedo: Array    # (M, 3)
    mat_emission: Array  # (M, 3)
    mat_fuzz: Array      # (M,)
    mat_ior: Array       # (M,)
    mat_tex: Array       # (M,) i32 atlas page, -1 = untextured
    tex_atlas: Array     # (K, R, R, 3) texture atlas (materials.texture)
    # --- area-light triangle table (L,) ---
    light_v0: Array
    light_e1: Array
    light_e2: Array
    light_normal: Array     # (L, 3) unit
    light_radiance: Array   # (L, 3)
    light_area: Array       # (L,)
    light_two_sided: Array  # (L,) bool
    light_mask: Array       # (L,) bool
    light_cdf: Array        # (L,) area-weighted cumulative distribution
    light_total_area: Array # ()
    # --- point lights (P,) ---
    plight_pos: Array
    plight_intensity: Array
    plight_mask: Array
    # --- sphere area lights (SL,) — emissive-material spheres, sampled by
    # NEE (revives the reference's DEAD CircleAreaLightObject,
    # `Core/Shape/CircleAreaLightObject.fs:8-25`) ---
    slight_center: Array     # (SL, 3)
    slight_radius: Array     # (SL,)
    slight_radiance: Array   # (SL, 3)
    slight_velocity: Array   # (SL, 3) shutter-interval motion (MovingSphere)
    slight_mask: Array       # (SL,) bool
    # --- environment ---
    background: Array       # (3,) constant background radiance (miss shader)
    # --- acceleration: kd-leaf clustered AABBs (accel.clusters). Triangles
    # are stored in median-split leaf order; cluster c covers tris
    # [c*CLUSTER_SIZE, (c+1)*CLUSTER_SIZE). Empty clusters have min > max. ---
    cluster_min: Array      # (C, 3)
    cluster_max: Array      # (C, 3)
    super_min: Array        # (S, 3) — SUPER consecutive clusters per group
    super_max: Array        # (S, 3)
    mega_ids: Array         # (MAX_MEGA,) i32 — huge tris excluded from the
                            # clusters, tested densely; -1 padded
    # static: True when any material references an atlas page. Lets the hot
    # path skip the per-bounce texture gather entirely for untextured
    # scenes.
    has_textures: bool = struct.field(pytree_node=False, default=False)
    # static material/shape capability flags: the hot shader and the
    # intersectors statically skip whole branches the scene cannot need
    # (e.g. the spot bench is lambert-only with zero spheres — the metal
    # fuzz sampling, dielectric Fresnel, AND the (B, Sp) sphere tests are
    # all dead weight there).
    has_glossy: bool = struct.field(pytree_node=False, default=False)
    has_metal: bool = struct.field(pytree_node=False, default=True)
    has_dielectric: bool = struct.field(pytree_node=False, default=True)
    num_live_spheres: int = struct.field(pytree_node=False, default=0)
    # static: number of live mega triangles. The dense prepass computes
    # (B, n) planes; slicing to the real count instead of MAX_MEGA=32 cuts
    # its work and temps when n is small.
    num_mega: int = struct.field(pytree_node=False, default=0)

    @property
    def num_tris(self) -> int:
        return self.tri_v0.shape[0]

    @property
    def num_spheres(self) -> int:
        return self.sph_center.shape[0]

    @property
    def num_lights(self) -> int:
        return self.light_v0.shape[0]


class CompiledScene(struct.PyTreeNode):
    scene: ScenePytree
    camera: "Array"
    film_width: int = struct.field(pytree_node=False, default=300)
    film_height: int = struct.field(pytree_node=False, default=300)


def _mesh_face_arrays(mesh: S.Mesh, transform=None):
    """Gather per-face v0/e1/e2 + shading normals + uvs from an indexed mesh.
    Also returns the transformed vertex buffer and face index triples so the
    compiler can build the scene-level shared vertex buffer (the
    parameterization that lets vertex gradients accumulate into shared mesh
    vertices instead of per-face copies)."""
    v = S.transformed_vertices(mesh, transform)
    f = np.asarray(mesh.faces, np.int64)
    p0, p1, p2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    e1 = p1 - p0
    e2 = p2 - p0
    gn = np.cross(e1, e2)
    norm = np.linalg.norm(gn, axis=1, keepdims=True)
    gn = gn / np.maximum(norm, 1e-12)

    if mesh.normals is not None and mesh.face_normals is not None:
        nrm = np.asarray(mesh.normals, np.float32)
        fn = np.asarray(mesh.face_normals, np.int64)
        n0, n1, n2 = nrm[fn[:, 0]], nrm[fn[:, 1]], nrm[fn[:, 2]]
        if transform is not None:
            inv_t = np.linalg.inv(np.asarray(transform)[:3, :3]).T
            n0, n1, n2 = (x @ inv_t.T for x in (n0, n1, n2))
            n0, n1, n2 = (
                x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
                for x in (n0, n1, n2)
            )
    else:
        n0 = n1 = n2 = gn

    if mesh.uvs is not None and mesh.face_uvs is not None:
        uv = np.asarray(mesh.uvs, np.float32)
        fu = np.asarray(mesh.face_uvs, np.int64)
        uv0, uv1, uv2 = uv[fu[:, 0]], uv[fu[:, 1]], uv[fu[:, 2]]
    else:
        uv0 = uv1 = uv2 = np.zeros((f.shape[0], 2), np.float32)

    area = 0.5 * norm[:, 0]
    return p0, e1, e2, gn, (n0, n1, n2), (uv0, uv1, uv2), area, (v, f)


def compile_scene(scene_spec: S.SceneSpec) -> CompiledScene:
    """Flatten a `SceneSpec` into device arrays. Host-side (NumPy); returns a
    `CompiledScene` whose arrays live wherever JAX places them next."""
    from mafrixraytracing_tpu.camera.camera import Camera

    materials = list(scene_spec.materials)
    if not materials:
        materials = [S.MaterialSpec()]

    tri_chunks = {k: [] for k in ("v0", "e1", "e2", "n0", "n1", "n2",
                                  "uv0", "uv1", "uv2", "mat", "light",
                                  "face_vi")}
    # scene-level shared vertex buffer: every triangle's corners are indices
    # into this buffer, so `mesh_vertices` is an optimizable leaf whose
    # gradient accumulates contributions from ALL faces sharing a vertex
    # (the BASELINE "recover spot vertices" parameterization)
    vert_chunks: list = []
    vert_offset = 0

    def add_verts(v, f):
        nonlocal vert_offset
        vert_chunks.append(np.asarray(v, np.float32))
        out = np.asarray(f, np.int64) + vert_offset
        vert_offset += v.shape[0]
        return out.astype(np.int32)

    def add_tris(p0, e1, e2, sn, uvs, mat_id, light_id, face_vi):
        n = p0.shape[0]
        tri_chunks["face_vi"].append(np.asarray(face_vi, np.int32))
        tri_chunks["v0"].append(p0)
        tri_chunks["e1"].append(e1)
        tri_chunks["e2"].append(e2)
        for key, val in zip(("n0", "n1", "n2"), sn):
            tri_chunks[key].append(val)
        for key, val in zip(("uv0", "uv1", "uv2"), uvs):
            tri_chunks[key].append(val)
        tri_chunks["mat"].append(
            np.asarray(mat_id, np.int32)
            if np.ndim(mat_id)
            else np.full(n, mat_id, np.int32)
        )
        tri_chunks["light"].append(
            np.asarray(light_id, np.int32)
            if np.ndim(light_id)
            else np.full(n, light_id, np.int32)
        )

    for shape in scene_spec.shapes:
        p0, e1, e2, gn, sn, uvs, _, (v, f) = _mesh_face_arrays(
            shape.mesh, shape.transform
        )
        mat = shape.material
        if shape.face_materials is not None:
            mat = np.asarray(shape.face_materials, np.int32)
            assert mat.shape[0] == p0.shape[0], (
                f"face_materials has {mat.shape[0]} entries for "
                f"{p0.shape[0]} faces"
            )
        add_tris(p0, e1, e2, sn, uvs, mat, -1, add_verts(v, f))

    # --- area lights: light table + (optionally) emissive hittable geometry ---
    lt = {k: [] for k in ("v0", "e1", "e2", "normal", "radiance", "area", "two_sided")}
    light_row = 0
    for al in scene_spec.area_lights:
        p0, e1, e2, gn, sn, uvs, area, (v, f) = _mesh_face_arrays(al.mesh)
        n = p0.shape[0]
        lt["v0"].append(p0)
        lt["e1"].append(e1)
        lt["e2"].append(e2)
        lt["normal"].append(gn)
        lt["radiance"].append(np.tile(np.asarray(al.radiance, np.float32), (n, 1)))
        lt["area"].append(area.astype(np.float32))
        lt["two_sided"].append(np.full(n, al.two_sided, bool))
        if al.visible:
            mat_id = len(materials)
            materials.append(
                S.MaterialSpec(type="emissive", albedo=(0, 0, 0), emission=al.radiance)
            )
            add_tris(p0, e1, e2, sn, uvs, mat_id,
                     np.arange(light_row, light_row + n, dtype=np.int32),
                     add_verts(v, f))
        light_row += n

    # --- concatenate + pad triangles ---
    if tri_chunks["v0"]:
        tri = {k: np.concatenate(v, axis=0) for k, v in tri_chunks.items()}
    else:
        tri = {
            **{k: np.zeros((0, 3), np.float32)
               for k in ("v0", "e1", "e2", "n0", "n1", "n2")},
            **{k: np.zeros((0, 2), np.float32) for k in ("uv0", "uv1", "uv2")},
            "mat": np.zeros((0,), np.int32),
            "light": np.zeros((0,), np.int32),
            "face_vi": np.zeros((0, 3), np.int32),
        }
    num_tris = tri["v0"].shape[0]
    T = bucket_size(num_tris, 128)
    tri_mask = pad_to(np.ones(num_tris, bool), T, False)
    tri = {k: pad_to(np.asarray(v), T, 0 if v.dtype != np.int32 else -1)
           for k, v in tri.items()}

    # --- acceleration build: Morton-sort triangles, cluster AABBs ---
    from mafrixraytracing_tpu.accel.clusters import build_clusters

    accel = build_clusters(tri["v0"], tri["e1"], tri["e2"], tri_mask)
    perm = accel["perm"]
    tri = {k: v[perm] for k, v in tri.items()}
    tri_mask = tri_mask[perm]

    # --- shared vertex buffer (padded) ---
    verts = (
        np.concatenate(vert_chunks, axis=0).astype(np.float32)
        if vert_chunks
        else np.zeros((0, 3), np.float32)
    )
    Vp = bucket_size(max(verts.shape[0], 1), 128)
    mesh_vertices = pad_to(verts, Vp)

    # --- spheres ---
    ns = len(scene_spec.spheres)
    Sp = bucket_size(ns, 8)
    sph_center = np.zeros((Sp, 3), np.float32)
    sph_radius = np.zeros((Sp,), np.float32)
    sph_velocity = np.zeros((Sp, 3), np.float32)
    sph_mat = np.zeros((Sp,), np.int32)
    sph_mask = np.zeros((Sp,), bool)
    for i, sp in enumerate(scene_spec.spheres):
        sph_center[i] = sp.center
        sph_radius[i] = sp.radius
        sph_velocity[i] = getattr(sp, "velocity", (0.0, 0.0, 0.0))
        sph_mat[i] = sp.material
        sph_mask[i] = True

    # --- material table ---
    M = bucket_size(len(materials), 8)
    mat_type = np.zeros((M,), np.int32)
    mat_albedo = np.zeros((M, 3), np.float32)
    mat_emission = np.zeros((M, 3), np.float32)
    mat_fuzz = np.zeros((M,), np.float32)
    mat_ior = np.full((M,), 1.5, np.float32)
    mat_tex = np.full((M,), -1, np.int32)
    for i, m in enumerate(materials):
        mat_type[i] = S.MATERIAL_TYPES[m.type]
        mat_albedo[i] = m.albedo
        mat_emission[i] = m.emission
        # the fuzz column is type-overloaded: metal roughness OR Phong
        # exponent for glossy (a material has exactly one of the two)
        mat_fuzz[i] = (
            getattr(m, "exponent", 32.0) if m.type == "glossy" else m.fuzz
        )
        mat_ior[i] = m.ior
        mat_tex[i] = m.texture_id

    from mafrixraytracing_tpu.materials.texture import build_atlas

    atlas = build_atlas(scene_spec.textures)

    # --- light table (padded) ---
    if lt["v0"]:
        light = {k: np.concatenate(v, axis=0) for k, v in lt.items()}
    else:
        light = {
            **{k: np.zeros((0, 3), np.float32)
               for k in ("v0", "e1", "e2", "normal", "radiance")},
            "area": np.zeros((0,), np.float32),
            "two_sided": np.zeros((0,), bool),
        }
    nl = light["v0"].shape[0]
    L = bucket_size(nl, 8)
    light_mask = pad_to(np.ones(nl, bool), L, False)
    light = {k: pad_to(np.asarray(v), L) for k, v in light.items()}
    areas = light["area"] * light_mask
    total_area = float(np.sum(areas))
    if total_area > 0:
        cdf = np.cumsum(areas) / total_area
    else:
        cdf = np.ones((L,), np.float32)
    cdf[-1] = 1.0 + 1e-6  # guard against u == 1.0 falling off the end

    # --- point lights ---
    npl = len(scene_spec.point_lights)
    # size 0 when there are none: nee_point's per-light shadow pass is a
    # static loop over this table, so phantom padded slots would each cost a
    # full occlusion query per bounce
    P = bucket_size(npl, 8) if npl else 0
    plight_pos = np.zeros((P, 3), np.float32)
    plight_intensity = np.zeros((P, 3), np.float32)
    plight_mask = np.zeros((P,), bool)
    for i, pl in enumerate(scene_spec.point_lights):
        plight_pos[i] = pl.position
        plight_intensity[i] = pl.intensity
        plight_mask[i] = True

    # --- sphere area lights: emissive-material spheres ---
    sl_rows = [
        i for i, sp in enumerate(scene_spec.spheres)
        if materials[sp.material].type == "emissive"
    ]
    SL = bucket_size(len(sl_rows), 4) if sl_rows else 0
    slight_center = np.zeros((SL, 3), np.float32)
    slight_radius = np.zeros((SL,), np.float32)
    slight_radiance = np.zeros((SL, 3), np.float32)
    slight_velocity = np.zeros((SL, 3), np.float32)
    slight_mask = np.zeros((SL,), bool)
    for row, i in enumerate(sl_rows):
        sp = scene_spec.spheres[i]
        slight_center[row] = sp.center
        slight_radius[row] = sp.radius
        slight_radiance[row] = materials[sp.material].emission
        # moving emissive spheres: NEE samples the cone toward the
        # time-shifted center, consistent with the time-shifted search and
        # the BSDF-side MIS pdf (hit_attributes_soa shifts the gathered
        # center the same way)
        slight_velocity[row] = getattr(sp, "velocity", (0.0, 0.0, 0.0))
        slight_mask[row] = True

    scene = ScenePytree(
        tri_v0=jnp.asarray(tri["v0"]),
        tri_e1=jnp.asarray(tri["e1"]),
        tri_e2=jnp.asarray(tri["e2"]),
        tri_n0=jnp.asarray(tri["n0"]),
        tri_n1=jnp.asarray(tri["n1"]),
        tri_n2=jnp.asarray(tri["n2"]),
        tri_uv0=jnp.asarray(tri["uv0"]),
        tri_uv1=jnp.asarray(tri["uv1"]),
        tri_uv2=jnp.asarray(tri["uv2"]),
        tri_mat=jnp.asarray(np.clip(tri["mat"], 0, M - 1)),
        tri_light=jnp.asarray(tri["light"]),
        tri_mask=jnp.asarray(tri_mask),
        mesh_vertices=jnp.asarray(mesh_vertices),
        tri_face_vi=jnp.asarray(np.clip(tri["face_vi"], 0, Vp - 1)),
        sph_center=jnp.asarray(sph_center),
        sph_radius=jnp.asarray(sph_radius),
        sph_velocity=jnp.asarray(sph_velocity),
        sph_mat=jnp.asarray(sph_mat),
        sph_mask=jnp.asarray(sph_mask),
        mat_type=jnp.asarray(mat_type),
        mat_albedo=jnp.asarray(mat_albedo),
        mat_emission=jnp.asarray(mat_emission),
        mat_fuzz=jnp.asarray(mat_fuzz),
        mat_ior=jnp.asarray(mat_ior),
        mat_tex=jnp.asarray(mat_tex),
        tex_atlas=jnp.asarray(atlas),
        light_v0=jnp.asarray(light["v0"]),
        light_e1=jnp.asarray(light["e1"]),
        light_e2=jnp.asarray(light["e2"]),
        light_normal=jnp.asarray(light["normal"]),
        light_radiance=jnp.asarray(light["radiance"]),
        light_area=jnp.asarray(light["area"]),
        light_two_sided=jnp.asarray(light["two_sided"]),
        light_mask=jnp.asarray(light_mask),
        light_cdf=jnp.asarray(cdf, dtype=jnp.float32),
        light_total_area=jnp.float32(total_area),
        plight_pos=jnp.asarray(plight_pos),
        plight_intensity=jnp.asarray(plight_intensity),
        plight_mask=jnp.asarray(plight_mask),
        slight_center=jnp.asarray(slight_center),
        slight_radius=jnp.asarray(slight_radius),
        slight_radiance=jnp.asarray(slight_radiance),
        slight_velocity=jnp.asarray(slight_velocity),
        slight_mask=jnp.asarray(slight_mask),
        background=jnp.zeros((3,), jnp.float32),
        cluster_min=jnp.asarray(accel["cluster_min"]),
        cluster_max=jnp.asarray(accel["cluster_max"]),
        super_min=jnp.asarray(accel["super_min"]),
        super_max=jnp.asarray(accel["super_max"]),
        mega_ids=jnp.asarray(accel["mega_ids"]),
        has_textures=bool((mat_tex >= 0).any()),
        has_glossy=bool((mat_type == S.MATERIAL_TYPES["glossy"]).any()),
        has_metal=bool((mat_type == S.MATERIAL_TYPES["metal"]).any()),
        has_dielectric=bool((mat_type == S.MATERIAL_TYPES["dielectric"]).any()),
        num_live_spheres=ns,
        num_mega=int((accel["mega_ids"] >= 0).sum()),
    )

    cam_spec = scene_spec.camera
    if cam_spec.type == "thin_lens":
        pos = np.asarray(cam_spec.position, np.float32)
        look = pos + np.asarray(cam_spec.direction, np.float32)
        camera = Camera.thin_lens(
            pos, look, cam_spec.fov, cam_spec.aspect,
            aperture=cam_spec.aperture, focus_dist=cam_spec.focus_dist,
            up=cam_spec.up,
        )
    else:
        camera = Camera.pinhole(
            cam_spec.position, cam_spec.direction, cam_spec.fov,
            cam_spec.aspect, up=cam_spec.up,
            fov_convention=cam_spec.fov_convention,
        )

    return CompiledScene(
        scene=scene,
        camera=camera,
        film_width=scene_spec.film.width,
        film_height=scene_spec.film.height,
    )
