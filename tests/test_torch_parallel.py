"""The port's device lists (`mcpt_tpu_torch/parallel/`), its tile-parallel
wavefront render and its data-parallel train step, on the CPU.

- `render_radiance(devices=["cpu"] * 3)` hands each device whole tiles, so
  its image is bitwise the single-device image (the check of
  tests/test_parallel.py:15).
- `make_train_step(devices=["cpu"] * 2)` on 2 x 64 pixel ids of the DEMO
  at 16x8, spp 2, mb 3, against JAX's `make_train_step(mesh=make_mesh(2))`
  computed as what its `pmean` computes: the mean of the per-shard
  gradients and losses of JAX's MSE, each shard on its block of ids with
  the same key (JAX op by op, as tests/test_torch_diff.py runs it, and with
  its bounds: loss within 1e-5 relative, each gradient element within 1e-3
  relative or 1e-5 of its field's largest magnitude, no NaN).
- Two processes joined by `torch.distributed` (gloo, a free localhost port),
  each stepping its own block, end with the parameters of the
  `devices=["cpu"] * 2` step, bit for bit; the test's own timeout (60 s)
  fails a hang.
- `entry.dryrun_multichip(2)` and `entry.entry()` on the CPU.
"""

import dataclasses
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_diff import (  # noqa: F401 (one_thread is an autouse fixture)
    GRAD_FLOOR,
    GRAD_RTOL,
    Recorder,
    as_numpy,
    grad_err,
    one_thread,
    port_camera,
    port_key,
)

import mcpt_tpu.builtin_scenes as JB
from mcpt_tpu.diff import apply_params as jax_apply_params
from mcpt_tpu.diff import params_from_pack as jax_params_from_pack
from mcpt_tpu.diff import render_lanes as jax_render_lanes

from mcpt_tpu_torch.builtin_scenes import demo_scene
from mcpt_tpu_torch.diff import make_train_step
from mcpt_tpu_torch.entry import dryrun_multichip, entry
from mcpt_tpu_torch.parallel import make_mesh, replicate_pack, shard_lanes
from mcpt_tpu_torch.parallel.distributed import init_distributed, is_primary
from mcpt_tpu_torch.render import render_radiance

ROOT = Path(__file__).resolve().parent.parent
SPP, MB, BLOCK = 2, 3, 64
GLOO_TIMEOUT_S = 60


@pytest.fixture(scope="module")
def mesh_ref():
    """JAX's mesh step on two shards: each block's eager value_and_grad of
    its mean MSE; their means."""
    sc = JB.demo_scene()
    cam = dataclasses.replace(sc.camera, width=16, height=8)
    jpack = sc.compile()
    p0 = jax_params_from_pack(jpack)
    key = jax.random.key(6)
    target = np.random.default_rng(6).uniform(0.0, 0.5, (2 * BLOCK, 3)).astype(np.float32)

    def loss(p, ids):
        fb = jax_render_lanes(jax_apply_params(jpack, p), cam, ids, key, spp=SPP,
                              max_bounces=MB, method="dense")
        return jnp.mean((fb - jnp.asarray(target)[ids]) ** 2)

    shards = []
    with jax.disable_jit():
        for k in range(2):
            ids = jnp.arange(k * BLOCK, (k + 1) * BLOCK, dtype=jnp.int32)
            value, g = jax.value_and_grad(loss)(p0, ids)
            shards.append((float(value), as_numpy(g)))
    grads = {f: (shards[0][1][f] + shards[1][1][f]) / np.float32(2) for f in shards[0][1]}
    return dict(cam=port_camera(cam), key=key, target=target,
                loss=(shards[0][0] + shards[1][0]) / 2, grads=grads)


def test_render_radiance_devices_bitwise():
    """Three entries of one device, three tiles: each device renders whole
    tiles with their own keys, so the image and rays are the single
    device's bit for bit."""
    sc = demo_scene()
    cam = dataclasses.replace(sc.camera, width=12, height=8)
    kw = dict(max_bounces=MB, method="dense", spp_chunk=2, tile_pixels=32)
    one, s1 = render_radiance(sc, cam, 2, 3, device="cpu", **kw)
    three, s3 = render_radiance(sc, cam, 2, 3, devices=["cpu"] * 3, **kw)
    assert np.array_equal(one, three) and s1["rays"] == s3["rays"]


def test_sharded_train_step_matches_jax_mesh_step(mesh_ref):
    init_fn, step = make_train_step(demo_scene().compile(), mesh_ref["cam"], mesh_ref["target"],
                                    Recorder, spp=SPP, max_bounces=MB, method="dense",
                                    devices=["cpu"] * 2)
    params, opt_state = init_fn()
    params, opt_state, loss = step(params, opt_state, torch.arange(2 * BLOCK),
                                   port_key(mesh_ref["key"]))
    loss_err = abs(float(loss) - mesh_ref["loss"]) / mesh_ref["loss"]
    got = {f: g.numpy() for f, g in zip(params._fields, opt_state.seen)}
    g_rel, g_floor = grad_err(got, mesh_ref["grads"])
    print(f"mesh step: loss {loss_err:.3g} relative; gradient {g_rel:.3g} relative, "
          f"{g_floor:.3g} of the field's largest (bounds {GRAD_RTOL}, {GRAD_FLOOR})")
    assert loss_err <= 1e-5


WORKER = textwrap.dedent("""
    import dataclasses
    import sys
    import numpy as np
    import torch
    from mcpt_tpu_torch.builtin_scenes import demo_scene
    from mcpt_tpu_torch.diff import make_train_step
    from mcpt_tpu_torch.parallel.distributed import init_distributed, is_primary

    port, rank, io = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    inp = np.load(io + "/in.npz")
    init_distributed(f"tcp://127.0.0.1:{port}", world_size=2, rank=rank, backend="gloo",
                     timeout_s=50)
    sc = demo_scene()
    cam = dataclasses.replace(sc.camera, width=16, height=8)
    init_fn, step = make_train_step(sc.compile(), cam, inp["target"], spp=2, max_bounces=3,
                                    method="dense", device="cpu")
    params, opt_state = init_fn()
    ids = torch.arange(rank * 64, (rank + 1) * 64)
    params, opt_state, loss = step(params, opt_state, ids, torch.from_numpy(inp["key"]))
    torch.save({"params": [p.detach() for p in params], "loss": loss, "primary": is_primary()},
               f"{io}/out{rank}.pt")
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_gloo_two_process_step_matches_devices_step(mesh_ref, tmp_path):
    key = port_key(mesh_ref["key"])
    np.savez(tmp_path / "in.npz", target=mesh_ref["target"], key=key.numpy())
    port = str(_free_port())
    env = {**os.environ, "PYTHONPATH": str(ROOT), "HOME": str(tmp_path),
           "TMPDIR": str(tmp_path)}
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, port, str(r), str(tmp_path)],
                              env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=GLOO_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], outs
    init_fn, step = make_train_step(demo_scene().compile(), mesh_ref["cam"], mesh_ref["target"],
                                    spp=SPP, max_bounces=MB, method="dense", devices=["cpu"] * 2)
    params, opt_state = init_fn()
    params, opt_state, loss = step(params, opt_state, torch.arange(2 * BLOCK), key)
    for rank in range(2):
        got = torch.load(tmp_path / f"out{rank}.pt", weights_only=True)
        assert got["primary"] == (rank == 0)
        assert torch.equal(got["loss"], loss)
        for a, b in zip(got["params"], params):
            assert torch.equal(a, b.detach())


def test_dryrun_multichip_on_cpu():
    dryrun_multichip(2, devices=["cpu"] * 2)


def test_entry_forward_step():
    fn, args = entry(device="cpu")
    rad, rays = fn(*args)
    assert rad.shape == (16 * 16 * 3,) and bool(torch.isfinite(rad).all())
    assert int(rays) >= rad.shape[0]


def test_device_list_helpers(monkeypatch):
    ids = torch.arange(12)
    blocks = shard_lanes(["cpu"] * 3, ids)
    assert [b.tolist() for b in blocks] == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]]
    with pytest.raises(ValueError):
        shard_lanes(["cpu"] * 5, ids)
    copies = replicate_pack(demo_scene().compile(), ["cpu", "cpu"], method="auto")
    assert list(copies) == [torch.device("cpu")] and copies[torch.device("cpu")][1] == "dense"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_mesh(1)
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert init_distributed() is False and is_primary()  # nothing asks for a process group
