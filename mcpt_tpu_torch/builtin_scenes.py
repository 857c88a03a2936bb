"""Built-in scene geometry (counterpart of `mcpt_tpu/builtin_scenes.py`):
the DEMO Cornell box of the reference `src/main.cpp:99-129` (compile-time
``-DDEMO``), embedded as numpy data, and the floor, light and backwall quads
of the config-driven chessboard scene (`config.py`, main.cpp:130-328). Quads
are listed as (4, 3) corner arrays and triangulated (0,1,2)+(0,2,3),
matching the OBJ face order the reference loads.
"""

import numpy as np

from mcpt_tpu_torch.camera import Camera
from mcpt_tpu_torch.materials import (
    Material,
    make_light_material,
    standard_materials,
)
from mcpt_tpu_torch.scene import Scene, Sphere, TriangleMesh


def _quads_to_tris(quads: np.ndarray) -> np.ndarray:
    """(Q,4,3) quad corners → (2Q,3,3) triangles, fan order like the OBJs."""
    quads = np.asarray(quads, np.float32)
    t1 = quads[:, [0, 1, 2]]
    t2 = quads[:, [0, 2, 3]]
    return np.concatenate([t1, t2], axis=0).reshape(-1, 3, 3)[
        _interleave(quads.shape[0])
    ]


def _interleave(q: int) -> np.ndarray:
    """Order tris as (q0t0, q0t1, q1t0, q1t1, ...)."""
    idx = np.empty(2 * q, np.int64)
    idx[0::2] = np.arange(q)
    idx[1::2] = np.arange(q) + q
    return idx


def _mesh(quads, material: Material, name: str, translation=(0, 0, 0)) -> TriangleMesh:
    tris = _quads_to_tris(quads) + np.asarray(translation, np.float32)
    return TriangleMesh(
        positions=tris,
        texcoords=np.zeros((tris.shape[0], 3, 2), np.float32),
        material=material,
        name=name,
    )


# GAMES101 Cornell box quad corners (cornellbox/*.obj data).
CORNELL_FLOOR = [
    [[552.8, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 559.2], [549.6, 0.0, 559.2]],
    [[556.0, 548.8, 0.0], [556.0, 548.8, 559.2], [0.0, 548.8, 559.2], [0.0, 548.8, 0.0]],
    [[549.6, 0.0, 559.2], [0.0, 0.0, 559.2], [0.0, 548.8, 559.2], [556.0, 548.8, 559.2]],
]
CORNELL_LEFT = [
    [[552.8, 0.0, 0.0], [549.6, 0.0, 559.2], [556.0, 548.8, 559.2], [556.0, 548.8, 0.0]],
]
CORNELL_RIGHT = [
    [[0.0, 0.0, 559.2], [0.0, 0.0, 0.0], [0.0, 548.8, 0.0], [0.0, 548.8, 559.2]],
]
CORNELL_LIGHT = [
    [[343.0, 548.7, 227.0], [343.0, 548.7, 332.0], [213.0, 548.7, 332.0], [213.0, 548.7, 227.0]],
]
CORNELL_SHORTBOX = [
    [[130.0, 165.0, 65.0], [82.0, 165.0, 225.0], [240.0, 165.0, 272.0], [290.0, 165.0, 114.0]],
    [[290.0, 0.0, 114.0], [290.0, 165.0, 114.0], [240.0, 165.0, 272.0], [240.0, 0.0, 272.0]],
    [[130.0, 0.0, 65.0], [130.0, 165.0, 65.0], [290.0, 165.0, 114.0], [290.0, 0.0, 114.0]],
    [[82.0, 0.0, 225.0], [82.0, 165.0, 225.0], [130.0, 165.0, 65.0], [130.0, 0.0, 65.0]],
    [[240.0, 0.0, 272.0], [240.0, 165.0, 272.0], [82.0, 165.0, 225.0], [82.0, 0.0, 225.0]],
]
CORNELL_TALLBOX = [
    [[423.0, 330.0, 247.0], [265.0, 330.0, 296.0], [314.0, 330.0, 456.0], [472.0, 330.0, 406.0]],
    [[423.0, 0.0, 247.0], [423.0, 330.0, 247.0], [472.0, 330.0, 406.0], [472.0, 0.0, 406.0]],
    [[472.0, 0.0, 406.0], [472.0, 330.0, 406.0], [314.0, 330.0, 456.0], [314.0, 0.0, 456.0]],
    [[314.0, 0.0, 456.0], [314.0, 330.0, 456.0], [265.0, 330.0, 296.0], [265.0, 0.0, 296.0]],
    [[265.0, 0.0, 296.0], [265.0, 330.0, 296.0], [423.0, 330.0, 247.0], [423.0, 0.0, 247.0]],
]

# Chessboard-scene quads (models/light.obj, models/backwall.obj data; the
# floor with its board texcoords is built in chess_floor_mesh below).
CHESS_LIGHT = [
    [[278.0, 548.7, -152.5], [278.0, 548.7, 152.5], [-278.0, 548.7, 152.5], [-278.0, 548.7, -152.5]],
]
CHESS_BACKWALL = [
    [[4049.6, -3500.0, 1059.2], [-3500.0, -3500.0, 1059.2], [-3500.0, 4048.8, 1059.2], [4056.0, 4048.8, 1059.2]],
]


def chess_floor_mesh(material: Material) -> TriangleMesh:
    """The chessboard floor: bottom.obj's two triangles WITH its texcoords
    (f 1/1 3/3 2/2 ; f 1/1 4/4 3/3 — note the vertex order)."""
    v = np.asarray(
        [[2052.8, 0.0, -2212.0], [2049.6, 0.0, 2059.2], [-1500.0, 0.0, 2059.2], [-1500.0, 0.0, -2212.0]],
        np.float32,
    )
    t = np.asarray([[0, 0], [0, 1], [1, 1], [1, 0]], np.float32)
    faces = [(0, 2, 1), (0, 3, 2)]
    pos = np.stack([v[list(f)] for f in faces])
    uv = np.stack([t[list(f)] for f in faces])
    if not material.textured:
        uv = np.zeros_like(uv)
    return TriangleMesh(positions=pos, texcoords=uv, material=material, name="floor")


def chess_light_mesh(brightness_scale: float, translation) -> TriangleMesh:
    return _mesh(
        CHESS_LIGHT, make_light_material(brightness_scale), "light", translation
    )


def chess_backwall_mesh(material: Material) -> TriangleMesh:
    return _mesh(CHESS_BACKWALL, material, "backwall")


def demo_scene() -> Scene:
    """The `-DDEMO` Cornell-box material-test scene (main.cpp:99-129):
    every material class on boxes and three spheres, 384x384, no DoF."""
    mats = standard_materials()
    light_mat = make_light_material(3.9)

    camera = Camera(
        width=384,
        height=384,
        fov=40.0,
        position=(278.0, 273.0, -800.0),
        target=(278.0, 273.0, 0.0),
        up=(0.0, 1.0, 0.0),
        use_dof=False,
        focal_distance=900.0,
        aperture_radius=40.0,
    )
    scene = Scene(camera)
    scene.add(_mesh(CORNELL_FLOOR, mats["rough_white_conductor"], "back"))
    scene.add(_mesh(CORNELL_SHORTBOX, mats["green_mirror"], "shortbox"))
    scene.add(_mesh(CORNELL_TALLBOX, mats["rough_plastic"], "tallbox"))
    scene.add(_mesh(CORNELL_LEFT, mats["rough_red_conductor"], "left"))
    scene.add(_mesh(CORNELL_RIGHT, mats["gold_conductor"], "right"))
    scene.add(_mesh(CORNELL_LIGHT, light_mat, "light"))
    scene.add(Sphere((400.0, 90.0, 3.0), 80.0, mats["smooth_glass"], "big_sphere"))
    scene.add(Sphere((250.0, 260.0, 230.0), 60.0, mats["clear_rough_plastic"], "mid_sphere"))
    scene.add(Sphere((120.0, 390.0, 400.0), 50.0, mats["silver_mirror"], "small_sphere"))
    return scene
