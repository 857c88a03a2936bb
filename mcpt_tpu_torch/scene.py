"""Scene description and the scene → megakernel-table compiler
(counterpart of `mcpt_tpu/scene.py`, numpy only).

`TriangleMesh` / `Sphere` / `Scene` mirror the reference's object graph
(`src/Triangle.hpp:83-135`, `src/Sphere.hpp`, `src/Scene.hpp:24-152`).
`Scene.compile()` builds the `ScenePack` fields that the megakernel's tables
are cut from (`kernels/tables.py::mega_tables`, `bvh_tables`), with the same
arithmetic as `mcpt_tpu.scene.Scene.compile` so the tables are bitwise equal:
the Woop transform `w` comes from a float64 `np.linalg.inv`, the occluder
cull uses the same float64 plane test. Scenes above `cluster_threshold`
triangles also get a BVH over all primitives (the native builder of
`native/`, or `bvh.build_bvh` without g++: the same SAH tree), which the
megakernel walks per thread; OBJ meshes load through the native parser
where it builds; the JAX package's
cluster tables (`mcpt_tpu/kernels/cluster.py:65-211`) are a TPU memory
layout and have no counterpart here. The env map is kept at full
resolution.
"""

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from mcpt_tpu_torch.bvh import build_bvh
from mcpt_tpu_torch.camera import Camera
from mcpt_tpu_torch.constants import EPSILON, REL_EPS
from mcpt_tpu_torch.io.obj import load_obj
from mcpt_tpu_torch.io.png import read_png
from mcpt_tpu_torch.materials import Material
from mcpt_tpu_torch.native import bvh_build_native, obj_load_native

# Above this many triangles the megakernel walks a BVH from global memory;
# at or below it, it brute-forces the tables from shared memory.
MEGA_MAX_TRIS = 1024


@dataclass
class TriangleMesh:
    """A triangle mesh instance: (F, 3, 3) world-space vertices and (F, 3, 2)
    texcoords (Triangle.hpp:106-122)."""

    positions: np.ndarray
    texcoords: np.ndarray
    material: Material = field(default_factory=Material)
    name: str = ""

    @classmethod
    def from_obj(
        cls,
        path,
        material: Optional[Material] = None,
        translation=(0.0, 0.0, 0.0),
        zoom: float = 1.0,
        name: str = "",
    ) -> "TriangleMesh":
        """An OBJ mesh instance: world pos = zoom * v + translation
        (Triangle.hpp:106); texcoords kept only for a textured material
        (Triangle.hpp:115-122)."""
        mesh = obj_load_native(path)
        if mesh is None:
            mesh = load_obj(path)
        material = material if material is not None else Material()
        pos = mesh["positions"] * np.float32(zoom) + np.asarray(
            translation, dtype=np.float32
        )
        tc = (
            mesh["texcoords"]
            if material.textured
            else np.zeros_like(mesh["texcoords"])
        )
        return cls(positions=pos, texcoords=tc, material=material, name=name or str(path))

    @property
    def areas(self) -> np.ndarray:
        e1 = self.positions[:, 1] - self.positions[:, 0]
        e2 = self.positions[:, 2] - self.positions[:, 0]
        return 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)

    @property
    def has_emit(self) -> bool:
        return self.material.has_emission


@dataclass
class Sphere:
    """Analytic sphere (reference: src/Sphere.hpp)."""

    center: tuple
    radius: float
    material: Material = field(default_factory=Material)
    name: str = ""

    @property
    def area(self) -> float:
        return float(4.0 * np.pi * self.radius * self.radius)

    @property
    def has_emit(self) -> bool:
        return self.material.has_emission


@dataclass
class ScenePack:
    """The flat scene fields the megakernel reads (same names, layouts and
    values as the fields of `mcpt_tpu.scene.ScenePack`; numpy float32/int32).

      tri_sc (T8, 16): Woop rows w00..w22, c0..c2, nr2 (0 on pad rows), valid
      tri_shade (T, 11): unit normal, uv t0..t2, material, emissive (t_pad rows)
      tri_occ_sc (T8o, 16): tri_sc rows of the shadow-fan occluders
      sph_geom (S, 4): center, radius; sph_shade (S, 5): center, mat, emissive
      mat_fat (M, 13): type, ior_a, ior_b, rough, refl(3), emission(3),
                       textured, dirac, emissive
      emt_fat (E, 17): emitter rows (tri v0/e1/e2/n | sphere c/r), emission,
                       1/mesh_area, is_sphere
      env_pixels (H, W, 3): the env map, a (1, 1, 3) dummy without one
      bvh_* : the flat BVH over triangles then spheres (`bvh.FlatBVH`
              fields; prims -1-padded to a multiple of 8, sphere ids moved
              to >= t_pad), None when the scene brute-forces
      t_pad: the triangle count rounded up to 128 (the JAX pack's n_tris,
             the prim id of sphere 0 on the wavefront path)
    The wavefront path (`intersect.py`, `integrator.py`) also reads, at the
    JAX pack's t_pad rows:
      tri_w (T, 3, 3), tri_c (T, 3), tri_nr2 (T,), tri_valid (T,) bool: the
          Woop transform of the dense method (tri_sc's rows, uncut)
      tri_mt (T, 9): v0, e1, e2 of the BVH method's leaf tests
      prim_emissive (T + S, 1): 1.0 where a primitive's material emits
      bvh_fat (N, 8 + L): min, max, miss link, leaf count and L leaf prim
          ids per node; built by `fat_bvh` when the BVH method first needs it
      walk: the intersector's walk tables (`kernels/tables.py::WalkTables`)
          of a pack with a BVH, attached by `pack_to(..., walk=True)`
    """

    tri_sc: np.ndarray
    tri_shade: np.ndarray
    tri_occ_sc: np.ndarray
    sph_geom: np.ndarray
    sph_shade: np.ndarray
    mat_fat: np.ndarray
    mat_textured: np.ndarray
    emt_fat: np.ndarray
    emt_mesh: np.ndarray
    emt_intra_cum: np.ndarray
    emt_mesh_area: np.ndarray
    lmesh_cum: np.ndarray
    emit_total_area: np.float32
    background: np.ndarray
    rr_rate: np.float32
    inv_rr: np.float32
    n_emitters: int = 0
    n_sph_emitters: int = 0
    enable_shadow: bool = True
    n_dir_sample: int = 4
    use_env: bool = False
    env_pixels: Optional[np.ndarray] = None
    t_pad: int = 128
    bvh_min: Optional[np.ndarray] = None
    bvh_max: Optional[np.ndarray] = None
    bvh_miss: Optional[np.ndarray] = None
    bvh_leaf_start: Optional[np.ndarray] = None
    bvh_leaf_count: Optional[np.ndarray] = None
    bvh_prims: Optional[np.ndarray] = None
    tri_w: Optional[np.ndarray] = None
    tri_c: Optional[np.ndarray] = None
    tri_nr2: Optional[np.ndarray] = None
    tri_valid: Optional[np.ndarray] = None
    tri_mt: Optional[np.ndarray] = None
    prim_emissive: Optional[np.ndarray] = None
    bvh_fat: Optional[np.ndarray] = None
    walk: Optional[tuple] = None
    # per light mesh (lmesh_cum's rows): its first emitter row, its row
    # count and its area (the largest emt_mesh_area of its rows, at least
    # 0), which the light pick's binary searches read; built from the
    # emitter fields when not given (`light_mesh_rows`)
    lmesh_first: Optional[np.ndarray] = None
    lmesh_count: Optional[np.ndarray] = None
    lmesh_area: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.lmesh_first is None:
            self.lmesh_first, self.lmesh_count, self.lmesh_area = light_mesh_rows(
                self.emt_mesh, self.emt_mesh_area, self.emt_intra_cum, self.lmesh_cum)

    @property
    def use_bvh(self) -> bool:
        return self.bvh_min is not None

    @property
    def n_tris(self) -> int:
        """The JAX pack's `n_tris`: rows of the padded triangle arrays."""
        return self.t_pad


def light_mesh_rows(emt_mesh, emt_mesh_area, emt_intra_cum, lmesh_cum):
    """(first row, row count, area) of each light mesh, for the light
    pick's binary searches (`lights.pick`, `csrc/wf_lights.cuh`), which
    return the rows a scan over every emitter row returns when the pack is
    laid out as `Scene.compile` lays it out: lmesh_cum nondecreasing, each
    mesh's rows contiguous with a nondecreasing emt_intra_cum (ValueError
    otherwise). A mesh without rows gets (0, 0, 0). Tensors in, tensors
    out on their device."""
    dev = emt_mesh.device if isinstance(emt_mesh, torch.Tensor) else None
    mesh, area, intra, cum = (np.asarray(x.cpu()) if dev is not None else np.asarray(x)
                              for x in (emt_mesh, emt_mesh_area, emt_intra_cum, lmesh_cum))
    if np.any(np.diff(cum) < 0):
        raise ValueError("lmesh_cum decreases: the light pick needs it sorted")
    m = cum.shape[0]
    first, count = np.zeros(m, np.int32), np.zeros(m, np.int32)
    amax = np.zeros(m, np.float32)
    for j in range(m):
        rows = np.nonzero(mesh == j)[0]
        if not rows.size:
            continue
        if rows[-1] - rows[0] + 1 != rows.size or np.any(np.diff(intra[rows]) < 0):
            raise ValueError(f"light mesh {j}: its emitter rows are not contiguous with a "
                             f"nondecreasing emt_intra_cum")
        first[j], count[j] = rows[0], rows.size
        amax[j] = max(np.float32(0.0), area[rows].max())
    if dev is None:
        return first, count, amax
    return tuple(torch.from_numpy(x).to(dev) for x in (first, count, amax))


def fat_bvh(pack: ScenePack) -> np.ndarray:
    """`pack.bvh_fat`, the wavefront BVH method's node rows
    (mcpt_tpu/scene.py:563-578), built and kept on the pack at first use:
    from the pack's flat BVH where it has one, else from a binned-SAH build
    (leaves of at most 4) over its valid triangles and real spheres."""
    if pack.bvh_fat is not None:
        return pack.bvh_fat
    if pack.use_bvh:
        lo, hi, miss = pack.bvh_min, pack.bvh_max, pack.bvh_miss
        start, count, prim_ids = pack.bvh_leaf_start, pack.bvh_leaf_count, pack.bvh_prims
    else:
        tri_ids = np.nonzero(pack.tri_valid)[0]
        sph_ids = np.nonzero(pack.sph_geom[:, 3] > 0.0)[0]
        v0, e1, e2 = (pack.tri_mt[tri_ids, 3 * k:3 * k + 3] for k in range(3))
        c, r = pack.sph_geom[sph_ids, :3], pack.sph_geom[sph_ids, 3:4]
        flat = build_bvh(
            np.concatenate([np.minimum(np.minimum(v0, v0 + e1), v0 + e2), c - r]),
            np.concatenate([np.maximum(np.maximum(v0, v0 + e1), v0 + e2), c + r]),
            leaf_size=4, method="sah",
        )
        ids = np.concatenate([tri_ids, pack.t_pad + sph_ids]).astype(np.int32)
        lo, hi, miss = flat.node_min, flat.node_max, flat.node_miss
        start, count, prim_ids = flat.leaf_start, flat.leaf_count, ids[flat.prim_ids]
    leaf_cap = max(int(count.max()) if count.size else 1, 1)
    fat = np.full((lo.shape[0], 8 + leaf_cap), -1.0, np.float32)
    fat[:, 0:3] = lo
    fat[:, 3:6] = hi
    fat[:, 6] = miss
    fat[:, 7] = np.maximum(count, 0)
    leaves = np.nonzero(start >= 0)[0]
    if leaves.size and prim_ids.size:
        cols = np.arange(leaf_cap)[None, :]
        slot = np.minimum(start[leaves][:, None] + cols, max(prim_ids.shape[0] - 1, 0))
        fat[leaves, 8:] = np.where(
            cols < count[leaves][:, None], prim_ids[slot].astype(np.float32), -1.0
        )
    pack.bvh_fat = fat
    return fat


def pack_to(pack: ScenePack, device, bvh: bool = False, walk: bool = False) -> ScenePack:
    """A copy of `pack` whose arrays are torch tensors on `device`, as the
    wavefront path reads it; with `bvh`, `bvh_fat` is built first
    (`fat_bvh`); with `walk`, a pack with a BVH gets the intersector's walk
    tables (`kernels/tables.py::walk_tables`, kept on `pack` at first use;
    any depth). Scalars and the three background
    floats stay on the host."""
    if bvh:
        fat_bvh(pack)
    tensor = lambda v: torch.from_numpy(np.ascontiguousarray(v)).to(device)
    moved = {
        f.name: tensor(v)
        for f in dataclasses.fields(pack)
        if isinstance(v := getattr(pack, f.name), np.ndarray) and v.ndim > 0
        and f.name != "background"
    }
    if walk and pack.use_bvh:
        from mcpt_tpu_torch.kernels.tables import walk_tables  # it imports this module

        if pack.walk is None:
            pack.walk = walk_tables(pack)
        moved["walk"] = pack.walk._replace(bvh=tensor(pack.walk.bvh), leaf=tensor(pack.walk.leaf))
    else:
        moved["walk"] = None
    return dataclasses.replace(pack, **moved)


def _round_up(x: int, m: int) -> int:
    return ((max(x, 1) + m - 1) // m) * m


class Scene:
    """Host-side scene container (reference: Scene.hpp:24-152).

    Defaults: rr_rate=0.7, n_dir_sample=4, enable_shadow=True
    (Scene.hpp:25-28)."""

    def __init__(self, camera: Optional[Camera] = None):
        self.camera = camera if camera is not None else Camera()
        self.meshes: list[TriangleMesh] = []
        self.spheres: list[Sphere] = []
        self.rr_rate = 0.7
        self.enable_shadow = True
        self.n_dir_sample = 4
        self.background = np.zeros(3, dtype=np.float32)
        self.env_pixels: Optional[np.ndarray] = None  # (H, W, 3) float in [0,1]

    def add(self, obj) -> None:
        if isinstance(obj, TriangleMesh):
            self.meshes.append(obj)
        elif isinstance(obj, Sphere):
            self.spheres.append(obj)
        else:
            raise TypeError(f"cannot add {type(obj)!r} to scene")

    def set_rr_rate(self, rr: float) -> None:
        # min(rr, 0.99) like Scene::setRrRate (Scene.hpp:110-113).
        self.rr_rate = min(float(rr), 0.99)

    def load_env_map(self, path) -> None:
        """Equirect PNG → float RGB in [0,1] (Scene.hpp:39-57)."""
        img = read_png(path)
        if img.shape[2] == 1:
            img = np.repeat(img, 3, axis=2)
        self.env_pixels = img[:, :, :3].astype(np.float32) / 255.0

    def set_background(self, color) -> None:
        self.background = np.asarray(color, dtype=np.float32)

    def compile(self, cluster_threshold: int = MEGA_MAX_TRIS) -> ScenePack:
        """`cluster_threshold` has the JAX argument's meaning: above it the
        scene gets a BVH, binned SAH with leaves of at most 4 primitives as
        the JAX default builds it (tests set it low to force the BVH walk on
        small scenes)."""
        # Material table: dedupe by object identity.
        mats: list[Material] = []
        mat_index: dict[int, int] = {}
        for obj in [*self.meshes, *self.spheres]:
            if id(obj.material) not in mat_index:
                mat_index[id(obj.material)] = len(mats)
                mats.append(obj.material)
        if not mats:
            mats = [Material()]

        # Triangles: concatenate all meshes; emitter bookkeeping per mesh.
        pos_list, uv_list, mid_list = [], [], []
        emt_tri, emt_mesh, emt_area, emt_mesh_area, lmesh_areas = [], [], [], [], []
        tri_cursor = 0
        for mesh in self.meshes:
            f = mesh.positions.shape[0]
            pos_list.append(mesh.positions.astype(np.float32))
            uv_list.append(mesh.texcoords.astype(np.float32))
            mid_list.append(
                np.full(f, mat_index[id(mesh.material)], dtype=np.int32)
            )
            if mesh.has_emit:
                ordinal = len(lmesh_areas)
                areas = mesh.areas.astype(np.float64)
                lmesh_areas.append(float(areas.sum()))
                emt_tri.extend(range(tri_cursor, tri_cursor + f))
                emt_mesh.extend([ordinal] * f)
                emt_area.extend(areas.tolist())
                emt_mesh_area.extend([float(areas.sum())] * f)
            tri_cursor += f
        # Emissive spheres: each is its own one-row "light mesh", area 4πr².
        sph_emit_rows = []  # (sphere index, light-mesh ordinal, area)
        for si, sph in enumerate(self.spheres):
            if sph.has_emit:
                sph_emit_rows.append((si, len(lmesh_areas), sph.area))
                lmesh_areas.append(sph.area)

        n_tris = tri_cursor
        t8 = _round_up(n_tris, 8)
        t_pad = _round_up(n_tris, 128)
        pos = (
            np.concatenate(pos_list, axis=0)
            if pos_list
            else np.zeros((0, 3, 3), np.float32)
        )
        uv = (
            np.concatenate(uv_list, axis=0)
            if uv_list
            else np.zeros((0, 3, 2), np.float32)
        )
        mid = np.concatenate(mid_list) if mid_list else np.zeros(0, np.int32)

        v0 = np.zeros((t_pad, 3), np.float32)
        e1 = np.zeros((t_pad, 3), np.float32)
        e2 = np.zeros((t_pad, 3), np.float32)
        e2[:, 1] = 1.0  # padding rows' [e1|e2|n] trivially non-singular
        e1[:, 0] = 1.0
        uvs = np.zeros((t_pad, 3, 2), np.float32)
        tmat = np.zeros(t_pad, np.int32)
        valid = np.zeros(t_pad, bool)
        if n_tris:
            v0[:n_tris] = pos[:, 0]
            e1[:n_tris] = pos[:, 1] - pos[:, 0]
            e2[:n_tris] = pos[:, 2] - pos[:, 0]
            uvs[:n_tris] = uv
            tmat[:n_tris] = mid
            valid[:n_tris] = True

        nraw = np.cross(e1, e2)
        nr2 = np.sum(nraw * nraw, axis=-1)
        nlen = np.sqrt(np.maximum(nr2, 1e-30))
        n_unit = nraw / nlen[:, None]
        degenerate = nr2 < 1e-24
        valid &= ~degenerate
        basis = np.stack([e1, e2, nraw], axis=-1)  # (T,3,3) columns
        basis[degenerate] = np.eye(3, dtype=np.float32)
        w = np.linalg.inv(basis.astype(np.float64)).astype(np.float32)
        c = np.einsum("tij,tj->ti", w, v0).astype(np.float32)

        # Spheres (radius 0 ⇒ unhittable padding row).
        n_spheres = len(self.spheres)
        s_pad = max(n_spheres, 1)
        sph_c = np.zeros((s_pad, 3), np.float32)
        sph_r = np.zeros(s_pad, np.float32)
        sph_mat = np.zeros(s_pad, np.int32)
        for i, s in enumerate(self.spheres):
            sph_c[i] = np.asarray(s.center, np.float32)
            sph_r[i] = np.float32(s.radius)
            sph_mat[i] = mat_index[id(s.material)]

        mat_type = np.array([int(x.mtype) for x in mats], np.int32)
        mat_ior_a = np.array([x.ior_a for x in mats], np.float32)
        mat_ior_b = np.array([x.ior_b for x in mats], np.float32)
        mat_rough = np.array([x.roughness for x in mats], np.float32)
        mat_refl = np.array([x.base_reflectance for x in mats], np.float32)
        mat_emission = np.array([x.emission for x in mats], np.float32)
        mat_textured = np.array([x.textured for x in mats], bool)
        mat_emissive = np.array([x.has_emission for x in mats], bool)
        mat_dirac = np.array([x.is_dirac for x in mats], bool)

        # Emitters: intra-mesh inclusive cumulative areas (BVH.cpp:118-135).
        n_tri_emitters = len(emt_tri)
        n_emitters = n_tri_emitters + len(sph_emit_rows)
        e_pad = max(n_emitters, 1)
        a_emt_tri = np.zeros(e_pad, np.int32)
        a_emt_mesh = np.full(e_pad, -1, np.int32)
        a_intra = np.zeros(e_pad, np.float32)
        a_mesh_area = np.ones(e_pad, np.float32)
        if n_tri_emitters:
            a_emt_tri[:n_tri_emitters] = emt_tri
            a_emt_mesh[:n_tri_emitters] = emt_mesh
            intra = np.zeros(n_tri_emitters, np.float64)
            acc: dict[int, float] = {}
            for i in range(n_tri_emitters):
                k = emt_mesh[i]
                acc[k] = acc.get(k, 0.0) + emt_area[i]
                intra[i] = acc[k]
            a_intra[:n_tri_emitters] = intra.astype(np.float32)
            a_mesh_area[:n_tri_emitters] = np.asarray(emt_mesh_area, np.float32)
        for k, (si, ordinal, area) in enumerate(sph_emit_rows):
            r_i = n_tri_emitters + k
            a_emt_tri[r_i] = -1
            a_emt_mesh[r_i] = ordinal
            a_intra[r_i] = area
            a_mesh_area[r_i] = area
        l_pad = max(len(lmesh_areas), 1)
        a_lmesh_cum = np.zeros(l_pad, np.float32)
        if lmesh_areas:
            a_lmesh_cum[: len(lmesh_areas)] = np.cumsum(lmesh_areas)
        total_area = float(sum(lmesh_areas))

        mat_fat = np.concatenate(
            [
                mat_type[:, None].astype(np.float32),
                mat_ior_a[:, None],
                mat_ior_b[:, None],
                mat_rough[:, None],
                mat_refl,
                mat_emission,
                mat_textured[:, None].astype(np.float32),
                mat_dirac[:, None].astype(np.float32),
                mat_emissive[:, None].astype(np.float32),
            ],
            axis=1,
        ).astype(np.float32)
        tri_emissive = mat_emissive[tmat] & valid
        tri_shade = np.concatenate(
            [
                n_unit.astype(np.float32),
                uvs.reshape(t_pad, 6),
                tmat[:, None].astype(np.float32),
                tri_emissive[:, None].astype(np.float32),
            ],
            axis=1,
        ).astype(np.float32)
        sph_emissive = mat_emissive[sph_mat] & (sph_r > 0)
        sph_shade = np.concatenate(
            [
                sph_c,
                sph_mat[:, None].astype(np.float32),
                sph_emissive[:, None].astype(np.float32),
            ],
            axis=1,
        ).astype(np.float32)
        # Fused emitter rows (17 cols). Triangle rows: v0, e1, e2, n,
        # emission, 1/mesh_area, 0. Sphere rows: center, (radius,0,0), 0,
        # 0, emission, 1/area, 1.
        emt_fat = np.zeros((e_pad, 17), np.float32)
        if n_tri_emitters:
            ti = a_emt_tri[:n_tri_emitters]
            emt_fat[:n_tri_emitters, 0:3] = v0[ti]
            emt_fat[:n_tri_emitters, 3:6] = e1[ti]
            emt_fat[:n_tri_emitters, 6:9] = e2[ti]
            emt_fat[:n_tri_emitters, 9:12] = n_unit[ti].astype(np.float32)
            emt_fat[:n_tri_emitters, 12:15] = mat_emission[tmat[ti]]
        for k, (si, ordinal, area) in enumerate(sph_emit_rows):
            r_i = n_tri_emitters + k
            emt_fat[r_i, 0:3] = sph_c[si]
            emt_fat[r_i, 3] = sph_r[si]
            emt_fat[r_i, 12:15] = mat_emission[sph_mat[si]]
            emt_fat[r_i, 16] = 1.0
        emt_fat[:, 15] = 1.0 / np.maximum(a_mesh_area, 1e-20)

        # Woop rows; nr2 is zeroed on padding/degenerate rows so the
        # intersectors' |det| >= EPSILON test rejects them unconditionally.
        tri_sc = np.zeros((t8, 16), np.float32)
        tri_sc[:, 0:9] = w[:t8].reshape(t8, 9)
        tri_sc[:, 9:12] = c[:t8]
        tri_sc[:, 12] = np.where(valid, nr2, 0.0)[:t8].astype(np.float32)
        tri_sc[:, 13] = valid[:t8].astype(np.float32)

        # Static occluder cull for the NEE shadow fan: a triangle whose plane
        # has every primitive surface on one side can never block a
        # (vertex → light sample) segment (mcpt_tpu/scene.py:519-561). Only
        # brute-force-sized scenes get it, as in JAX; BVH scenes' fans walk
        # the whole triangle table.
        if 0 < n_tris <= MEGA_MAX_TRIS:
            pts = pos.reshape(-1, 3).astype(np.float64)
            diag = float(np.linalg.norm(pts.max(0) - pts.min(0)))
            coord_max = float(np.abs(pts).max()) if pts.size else 0.0
            eps_o = max(
                1e-3, 1e-5 * diag, 4.0 * EPSILON, 2.0 * REL_EPS * coord_max
            )
            nrm = n_unit[:n_tris].astype(np.float64)
            dpl = np.einsum("td,td->t", nrm, v0[:n_tris].astype(np.float64))
            s = pts @ nrm.T - dpl[None, :]  # (P, T) signed distances
            smin = s.min(axis=0)
            smax = s.max(axis=0)
            if n_spheres:
                scn = sph_c[:n_spheres].astype(np.float64) @ nrm.T - dpl[None, :]
                rr_ = sph_r[:n_spheres].astype(np.float64)[:, None]
                smin = np.minimum(smin, (scn - rr_).min(axis=0))
                smax = np.maximum(smax, (scn + rr_).max(axis=0))
            one_side = (smin >= -eps_o) | (smax <= eps_o)
            occ_idx = np.nonzero(valid[:n_tris] & ~one_side)[0]
            tri_occ_sc = np.zeros((_round_up(int(occ_idx.size), 8), 16), np.float32)
            if occ_idx.size:
                tri_occ_sc[: occ_idx.size] = tri_sc[occ_idx]
        else:
            tri_occ_sc = np.zeros((8, 16), np.float32)

        sph_geom = np.concatenate([sph_c, sph_r[:, None]], axis=1).astype(np.float32)
        prim_emissive = np.concatenate([tri_emissive, sph_emissive]).astype(np.float32)[:, None]

        # One BVH over triangles then spheres (mcpt_tpu/scene.py:419-447);
        # sphere ids move to >= t_pad like the JAX pack's.
        bvh = {}
        if n_tris > cluster_threshold:
            prim_min = np.concatenate([
                np.minimum(np.minimum(v0, v0 + e1), v0 + e2)[:n_tris],
                sph_c[:n_spheres] - sph_r[:n_spheres, None],
            ])
            prim_max = np.concatenate([
                np.maximum(np.maximum(v0, v0 + e1), v0 + e2)[:n_tris],
                sph_c[:n_spheres] + sph_r[:n_spheres, None],
            ])
            flat = bvh_build_native(prim_min, prim_max, leaf_size=4, method="sah")
            if flat is None:
                flat = build_bvh(prim_min, prim_max, leaf_size=4, method="sah")
            prim_ids = flat.prim_ids.copy()
            prim_ids[prim_ids >= n_tris] += t_pad - n_tris
            a_prims = np.full(_round_up(prim_ids.shape[0], 8), -1, np.int32)
            a_prims[: prim_ids.shape[0]] = prim_ids
            bvh = dict(
                bvh_min=flat.node_min, bvh_max=flat.node_max,
                bvh_miss=flat.node_miss, bvh_leaf_start=flat.leaf_start,
                bvh_leaf_count=flat.leaf_count, bvh_prims=a_prims,
            )
        use_env = self.env_pixels is not None
        env = (
            np.ascontiguousarray(self.env_pixels, np.float32)
            if use_env
            else np.zeros((1, 1, 3), np.float32)
        )
        return ScenePack(
            tri_sc=tri_sc,
            tri_shade=tri_shade,
            tri_occ_sc=tri_occ_sc,
            sph_geom=sph_geom,
            sph_shade=sph_shade,
            mat_fat=mat_fat,
            mat_textured=mat_textured,
            emt_fat=emt_fat,
            emt_mesh=a_emt_mesh,
            emt_intra_cum=a_intra,
            emt_mesh_area=a_mesh_area,
            lmesh_cum=a_lmesh_cum,
            emit_total_area=np.float32(total_area),
            background=np.asarray(self.background, dtype=np.float32),
            rr_rate=np.float32(self.rr_rate),
            inv_rr=np.float32(1.0 / max(self.rr_rate, 1e-6)),
            n_emitters=n_emitters,
            n_sph_emitters=len(sph_emit_rows),
            enable_shadow=bool(self.enable_shadow),
            n_dir_sample=int(self.n_dir_sample),
            use_env=use_env,
            env_pixels=env,
            t_pad=t_pad,
            tri_w=w,
            tri_c=c,
            tri_nr2=nr2.astype(np.float32),
            tri_valid=valid,
            tri_mt=np.concatenate([v0, e1, e2], axis=1).astype(np.float32),
            prim_emissive=prim_emissive,
            **bvh,
        )
