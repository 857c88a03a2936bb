"""Top-level entry points (counterpart of the JAX package's `__graft_entry__.py`).

entry(device) -> (fn, example_args): the forward radiance step of the DEMO
scene through the wavefront integrator on `device` (one call of fn is one
pass of `integrator.trace_paths`).

dryrun_multichip(n_devices, devices=None): one inverse-rendering training
run (forward render, backward pass, Adam update; four steps) with the
pixel lanes split over `n_devices` entries of a device list and the
gradients averaged over them, on small shapes.
"""

import dataclasses

import torch

from mcpt_tpu_torch import prng


def _demo_pack_and_camera(width=16, height=16):
    from mcpt_tpu_torch.builtin_scenes import demo_scene

    sc = demo_scene()
    return sc.compile(), dataclasses.replace(sc.camera, width=width, height=height)


def _check(ok, what):
    if not ok:
        raise AssertionError(what)


def entry(device="cuda"):
    from mcpt_tpu_torch.constants import WAVELEN_UM
    from mcpt_tpu_torch.integrator import trace_paths
    from mcpt_tpu_torch.intersect import wavefront_pack
    from mcpt_tpu_torch.kernels.wavefront import camera_rays
    from mcpt_tpu_torch.render import resolve_device

    dev = resolve_device(device)
    host, cam = _demo_pack_and_camera()
    pack, method = wavefront_pack(host, dev)
    ids = torch.arange(cam.width * cam.height, device=dev)
    key = prng.key(0, dev)
    o, d = camera_rays(cam, ids, key)
    o3 = torch.stack(o, dim=1).repeat_interleave(3, dim=0)
    d3 = torch.stack(d, dim=1).repeat_interleave(3, dim=0)
    chan = torch.arange(3, device=dev).repeat(ids.shape[0])
    lam = torch.tensor(WAVELEN_UM, device=dev)[chan]

    def fn(pack, o, d, lam, chan, key):
        rad, stats = trace_paths(pack, o, d, lam, chan, key, max_bounces=4, method=method)
        return rad, stats.rays

    return fn, (pack, o3, d3, lam, chan, key)


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Four train steps of the DEMO (64 pixels per device, spp 4, mb 4)
    toward a darkened render of itself, over `devices` (default: the first
    `n_devices` CUDA devices, or ["cuda:0"] * n_devices on a host with
    fewer). Raises unless every loss is finite, the parameters moved and a
    later loss is below the first."""
    from mcpt_tpu_torch.diff import make_train_step, params_from_pack, render_lanes
    from mcpt_tpu_torch.parallel.mesh import make_mesh, replicate_pack

    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = make_mesh(n_devices) if have >= n_devices else ["cuda:0"] * n_devices
    _check(len(devices) == n_devices, f"{len(devices)} devices for n_devices={n_devices}")
    # 64 pixels per device, spp 4, 4 bounces: the NEE fan and several
    # samples a step, in seconds
    host, cam = _demo_pack_and_camera(width=64, height=n_devices)
    n_pix = 64 * n_devices
    (pack, method), = replicate_pack(host, devices[:1]).values()
    ids = torch.arange(n_pix, device=devices[0])
    # a real inverse problem: fit toward a darkened render of the scene
    with torch.no_grad():
        target = 0.5 * render_lanes(pack, cam, ids, prng.key(42, ids.device), spp=4,
                                    max_bounces=4, method=method)
    init_fn, step = make_train_step(host, cam, target.cpu().numpy(), spp=4, max_bounces=4,
                                    devices=devices)
    params, opt_state = init_fn()
    losses = []
    for i in range(4):
        params, opt_state, loss = step(params, opt_state, ids, prng.key(i))
        losses.append(float(loss))
    _check(all(torch.isfinite(torch.tensor(losses))), f"non-finite loss: {losses}")
    start = params_from_pack(host, params[0].device)
    moved = any(float((a.detach() - b).abs().max()) > 0 for a, b in zip(params, start))
    _check(moved, "the training step produced no update")
    # a single step's comparison is brittle against unrelated numeric
    # changes, so only SOME later step must improve on the first
    _check(min(losses[1:]) < losses[0], f"the loss did not decrease over 4 steps: {losses}")
