"""The port's native OBJ parser and BVH builder (`mcpt_tpu_torch/native/`,
built with g++ into `mcpt_tpu_torch/_build/`) against `mcpt_tpu.native` on
the same inputs, bit for bit, and against the port's numpy versions; the
structural invariants and the traversal check of tests/test_native.py:52
and :82 on the port.
"""

import numpy as np
import pytest
import torch

from mcpt_tpu.native.native import bvh_build_native as jax_bvh_build_native
from mcpt_tpu.native.native import obj_load_native as jax_obj_load_native

from mcpt_tpu_torch.bvh import build_bvh
from mcpt_tpu_torch.intersect import intersect_brute, intersect_bvh
from mcpt_tpu_torch.io.obj import load_obj
from mcpt_tpu_torch.native import bvh_build_native, native_available, obj_load_native
from mcpt_tpu_torch.native.native import library_path
from mcpt_tpu_torch.scene import Scene, TriangleMesh, pack_to

FLAT = ("node_min", "node_max", "node_miss", "leaf_start", "leaf_count", "prim_ids")
OBJ = (
    "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
    "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
    "vn 0 0 1\n"
    "f 1/1/1 2/2/1 3/3/1 4/4/1\n"
    "f -4//-1 -3//-1 -2//-1\n"
)


@pytest.fixture(scope="module", autouse=True)
def built():
    """The library builds here (g++ is part of the test host)."""
    assert native_available()
    assert library_path().exists()


def _boxes(n, seed):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    return lo, lo + rng.uniform(0.01, 2.0, (n, 3)).astype(np.float32)


def test_obj_bitwise_equal_jax_and_numpy(tmp_path):
    obj = tmp_path / "m.obj"
    obj.write_text(OBJ)
    got, want, numpy_ = obj_load_native(obj), jax_obj_load_native(obj), load_obj(obj)
    for k in ("positions", "texcoords", "normals"):
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
        assert np.array_equal(got[k], numpy_[k]), k
    with pytest.raises(FileNotFoundError):
        obj_load_native(tmp_path / "absent.obj")


@pytest.mark.parametrize("method", ["median", "sah"])
@pytest.mark.parametrize("n", [1, 5, 777])
def test_bvh_bitwise_equal_jax(method, n):
    lo, hi = _boxes(n, n)
    got = bvh_build_native(lo, hi, leaf_size=4, method=method)
    want = jax_bvh_build_native(lo, hi, leaf_size=4, method=method)
    for f in FLAT:
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    if method == "sah":  # Scene.compile's build: the numpy tree, bit for bit
        numpy_ = build_bvh(lo, hi, leaf_size=4, method=method)
        for f in FLAT:
            assert np.array_equal(getattr(got, f), getattr(numpy_, f)), f


@pytest.mark.parametrize("method", ["median", "sah"])
def test_bvh_structural_invariants(method):
    n = 777
    lo, hi = _boxes(n, 5)
    bvh = bvh_build_native(lo, hi, leaf_size=4, method=method)
    assert sorted(bvh.prim_ids.tolist()) == list(range(n))
    leaves = np.nonzero(bvh.leaf_start >= 0)[0]
    spans = sorted((int(bvh.leaf_start[i]), int(bvh.leaf_count[i])) for i in leaves)
    cursor = 0
    for s, c in spans:
        assert s == cursor and 1 <= c <= 4
        cursor += c
    assert cursor == n
    for i in range(bvh.n_nodes):
        if bvh.leaf_start[i] < 0:
            left = i + 1
            right = int(bvh.node_miss[left])
            for c in (left, right):
                assert (bvh.node_min[i] <= bvh.node_min[c] + 1e-5).all()
                assert (bvh.node_max[i] >= bvh.node_max[c] - 1e-5).all()
        else:
            ids = bvh.prim_ids[bvh.leaf_start[i]:bvh.leaf_start[i] + bvh.leaf_count[i]]
            assert (lo[ids] >= bvh.node_min[i] - 1e-5).all()
            assert (hi[ids] <= bvh.node_max[i] + 1e-5).all()


def test_bvh_traversal_equivalence():
    """A scene compiled over the native tree: the `bvh` method's nearest
    hits agree with brute force on random rays."""
    rng = np.random.default_rng(9)
    f = 200
    a = rng.uniform(-5, 5, (f, 3)).astype(np.float32)
    pos = np.stack([a, a + rng.normal(0, 1, (f, 3)), a + rng.normal(0, 1, (f, 3))], axis=1)
    sc = Scene()
    sc.add(TriangleMesh(positions=pos.astype(np.float32), texcoords=np.zeros((f, 3, 2), np.float32)))
    host = sc.compile(cluster_threshold=8)
    assert host.use_bvh
    pack = pack_to(host, "cpu", bvh=True)
    o = torch.from_numpy(rng.uniform(-8, 8, (512, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(512, 3)).astype(np.float32))
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    hb, hr = intersect_bvh(pack, o, d), intersect_brute(pack, o, d)
    assert (hb.prim == hr.prim).float().mean() > 0.998
