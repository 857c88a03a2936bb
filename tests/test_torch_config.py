"""The port's conf.json loader and OBJ loader against the JAX package.

`mcpt_tpu_torch.config.build_scene` must build the same scene as
`mcpt_tpu.config.build_scene` from conf.json and from variants of it, in
both quirk modes (strict parity and fixed): camera, render options, scene
settings, env map, and every mesh with its material, positions and
texcoords, all exactly equal. The chess meshes of the reference are not in
the repo, so both load the same small stand-in OBJs (`chip_smoke.py`'s
`write_stand_in_models` at 112 triangles a piece).
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from mcpt_tpu.config import build_scene as jax_build_scene
from mcpt_tpu.config import load_config
from mcpt_tpu.io.obj import load_obj as jax_load_obj
from mcpt_tpu.scene import TriangleMesh as JaxTriangleMesh

from chip_smoke import write_stand_in_models
from mcpt_tpu_torch.config import build_scene
from mcpt_tpu_torch.io.obj import load_obj
from mcpt_tpu_torch.materials import standard_materials
from mcpt_tpu_torch.scene import TriangleMesh

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("models")
    write_stand_in_models(d, segs_steps=(8, 8))
    return d


def _base_conf(**scene):
    """tests/test_config.py's base configuration."""
    return {
        "camera": {"width": 64, "height": 48, "fov": 70,
                   "position": [278, 150, -2550], "target": [278, 0, 0]},
        "renderer": {"spp": 7, "output": "x.png"},
        "scene": scene,
    }


def _path_conf():
    conf = _base_conf()
    del conf["renderer"]["output"]
    conf["renderer"]["path"] = "y.png"
    return conf


VARIANTS = {
    "conf_json": lambda: load_config(ROOT / "conf.json"),
    "add_diamond_false": lambda: _base_conf(addDiamond=False),
    "renderer_path": _path_conf,
    "direct_light_sample": lambda: _base_conf(directLightSample=32),
    "light_brightness_int": lambda: _base_conf(lightBrightness=100),
    "soldier_grid": lambda: _base_conf(
        soldierLeftRowPosition=[-559, 0, -200], soldierRightRowPosition=[160, 0, -200],
        soldierXSpacing=0.0, soldierYSpacing=0.0, soldierZSpacing=-356.0,
        soldierCountPerRow=2,
        soldierMaterials=["smooth_glass", "smooth_glass", "rough_white_conductor",
                          "rough_white_conductor"],
    ),
    "env_color_rr_shadow": lambda: _base_conf(
        envMap=[0.2, 0.3, 0.4], RussianRouletteRate=0.4, includeShadow=False
    ),
    "rr_clamp_floor_texture": lambda: _base_conf(
        RussianRouletteRate=1.5, floorMaterial="silver_mirror", floor_isTextured=True,
        kingMaterial="gold_conductor",
    ),
}


def _material(m):
    return {k: (int(v) if k == "mtype" else v) for k, v in dataclasses.asdict(m).items()}


@pytest.mark.parametrize("strict", [True, False], ids=["strict", "fixed"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_build_scene_matches_jax(variant, strict, models, monkeypatch):
    monkeypatch.chdir(ROOT)  # conf.json's envMap is relative to the repo root
    want, wopts = jax_build_scene(VARIANTS[variant](), models_dir=models, strict_parity=strict)
    got, opts = build_scene(VARIANTS[variant](), models_dir=models, strict_parity=strict)
    assert opts == wopts
    assert dataclasses.asdict(got.camera) == dataclasses.asdict(want.camera)
    for k in ("rr_rate", "enable_shadow", "n_dir_sample"):
        assert getattr(got, k) == getattr(want, k), k
    np.testing.assert_array_equal(got.background, want.background)
    assert (got.env_pixels is None) == (want.env_pixels is None)
    if want.env_pixels is not None:
        np.testing.assert_array_equal(got.env_pixels, want.env_pixels)
    assert [m.name for m in got.meshes] == [m.name for m in want.meshes]
    assert not got.spheres and not want.spheres
    for a, b in zip(got.meshes, want.meshes):
        assert _material(a.material) == _material(b.material), a.name
        np.testing.assert_array_equal(a.positions, b.positions, err_msg=a.name)
        np.testing.assert_array_equal(a.texcoords, b.texcoords, err_msg=a.name)
    if variant == "conf_json":
        assert got.env_pixels is not None and got.camera.use_dof
        assert sum(m.positions.shape[0] for m in got.meshes) == 16 * 112 + 4


def test_missing_obj_raises(tmp_path):
    with pytest.raises(OSError):
        build_scene(_base_conf(), models_dir=tmp_path)


def test_load_obj_matches_jax(tmp_path):
    """A small OBJ with texcoords, normals, a quad, a pentagon (fan
    triangulation), negative (relative) indices and a comment."""
    path = tmp_path / "mesh.obj"
    path.write_text(
        "# test mesh\n"
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0.5 1.5 0.25\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "vn 0 0 1\nvn 0 0.6 0.8\n"
        "f 1/1/1 2/2/1 3/3/1 4/4/1\n"
        "f 1 3 5\n"
        "f -5//2 -4//2 -3//2 -2//2 -1//2\n"
        "f 2/2 3/3 5/4\n"
    )
    want = jax_load_obj(path)
    got = load_obj(path)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["positions"].shape == (2 + 1 + 3 + 1, 3, 3)
    mat = standard_materials()["rough_plastic"]
    mat.textured = True
    a = TriangleMesh.from_obj(path, mat, translation=(1.0, 2.0, 3.0), zoom=2.0)
    b = JaxTriangleMesh.from_obj(path, mat, translation=(1.0, 2.0, 3.0), zoom=2.0)
    np.testing.assert_array_equal(a.positions, b.positions)
    np.testing.assert_array_equal(a.texcoords, b.texcoords)
    assert a.name == b.name == str(path)
