"""Differentiable rendering and inverse-rendering optimisation (counterpart
of `mcpt_tpu/diff.py`).

Gradients of rendered radiance with respect to the continuous scene
parameters (`SceneParams`: roughness, Cauchy ior_a / ior_b and base
reflectance per material, and a global light scale) through the
detached-sampling estimator: every discrete or stochastic decision
(microfacet-normal draws, the reflect/refract branch, Russian roulette,
light picks) is fixed by the counter-based random numbers, hits are
detached (`integrator._detach_hit`), and the gradient follows the shading
pathwise through the eval, pdf, Fresnel and emission terms. Visibility
discontinuities are not differentiated.

`render_lanes` runs the wavefront integrator with every bounce
(`early_exit=False`, as JAX's `lax.scan`). Each bounce's halves and the
fold are `torch.autograd.Function`s (`kernels/wavefront.py`): on the card
the wavefront's CUDA kernels forward and their backward kernels
(`csrc/wavefront_bwd.cu`) back, on the CPU their plain versions, the
hand-written reverse modes of `kernels/wavefront_ref.py`. The intersector
is the CUDA kernel (K2's sweep and its occlusion fan form, or K3's walk on
a pack with a BVH), forward only: its hits carry no gradient. `make_train_step` fits the
parameters to a target with `torch.optim.Adam`; with `devices` each device
renders its block of the pixel ids and the gradients and losses are
averaged over them (JAX's `pmean` under `shard_map`), and over processes
when `torch.distributed` is initialised. `make_train_step_hybrid` renders
the residual with the CUDA megakernel (K1, forward only) and pulls it back
through `render_lanes` (`torch.autograd.grad` with the residual as the
output gradient).

The pack of every function here is a compiled host `ScenePack`
(`Scene.compile()`); each moves it to its devices with `scene.pack_to`
outside `torch.inference_mode`, so that autograd can save its tensors.
"""

import dataclasses
from functools import partial
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from mcpt_tpu_torch.kernels.tables import SceneTables
from mcpt_tpu_torch.parallel.mesh import replicate_pack, shard_lanes
from mcpt_tpu_torch.render import _render_tile, render_mega, resolve_device, resolve_devices
from mcpt_tpu_torch.utils.profiling import PhaseTimer

# the optimiser of both train steps unless the caller gives one: optax's
# adam(1e-2), whose update has the same formula (eps outside the root)
default_optimizer = partial(torch.optim.Adam, lr=1e-2)


class SceneParams(NamedTuple):
    """Differentiable parameters (rows match the pack's material table)."""

    rough: torch.Tensor  # (M,)
    ior_a: torch.Tensor  # (M,)
    ior_b: torch.Tensor  # (M,)
    refl: torch.Tensor  # (M, 3)
    light_scale: torch.Tensor  # ()


def params_from_pack(pack, device=None) -> SceneParams:
    """The pack's parameters (columns 1-6 of `mat_fat`) and light scale 1,
    as float32 tensors on `device` (default: the pack's own)."""
    mat = torch.as_tensor(pack.mat_fat, dtype=torch.float32)
    mat = mat.to(device if device is not None else mat.device)
    return SceneParams(
        rough=mat[:, 3].clone(),
        ior_a=mat[:, 1].clone(),
        ior_b=mat[:, 2].clone(),
        refl=mat[:, 4:7].clone(),
        light_scale=torch.ones((), dtype=torch.float32, device=mat.device),
    )


def apply_params(pack, p: SceneParams):
    """`pack` (moved with `scene.pack_to`) with `mat_fat` and `emt_fat`
    rebuilt from `p` by torch ops, so autograd reaches every parameter:
    ior_a, ior_b, rough and refl in columns 1-6 and the emission in 7-9
    scaled by light_scale; `emt_fat`'s emission columns 12-14 scaled too
    (`mcpt_tpu/diff.py:56-88`)."""
    mat, emt = pack.mat_fat, pack.emt_fat
    mat_fat = torch.cat(
        [mat[:, 0:1], p.ior_a[:, None], p.ior_b[:, None], p.rough[:, None], p.refl,
         mat[:, 7:10] * p.light_scale, mat[:, 10:13]],
        dim=1,
    )
    emt_fat = torch.cat([emt[:, 0:12], emt[:, 12:15] * p.light_scale, emt[:, 15:17]], dim=1)
    return dataclasses.replace(pack, mat_fat=mat_fat, emt_fat=emt_fat)


def render_lanes(pack, camera, pixel_ids, key, *, spp: int = 1, max_bounces: int = 4,
                 method: str = "auto"):
    """Differentiable mean radiance (P, 3) of the pixels `pixel_ids` over
    `spp` camera samples: `prng.split(key, spp)`, each sample's key split
    into a camera key and a path key, every bounce traced (JAX's `lax.scan`
    order). `pack` is a moved pack (`scene.pack_to`, or `apply_params` of
    one); `method` the intersector (`intersect.resolve_method`)."""
    return _render_tile(pack, camera, pixel_ids, key, spp, max_bounces, method,
                        early_exit=False)[0]


def _masked(grads, param_mask):
    if param_mask is None:
        return grads
    return [g * torch.as_tensor(m, dtype=g.dtype, device=g.device)
            for g, m in zip(grads, param_mask)]


def _apply(params, opt_state, grads):
    """One optimiser step with `grads` as the parameters' gradients."""
    for p, g in zip(params, grads):
        p.grad = g.to(p.device)
    opt_state.step()
    opt_state.zero_grad(set_to_none=True)


def _init(pack, optimizer, device):
    def init_fn():
        params = SceneParams(*(x.requires_grad_() for x in params_from_pack(pack, device)))
        return params, optimizer(list(params))

    return init_fn


def make_train_step(pack, camera, target, optimizer=None, *, spp=1, max_bounces=3,
                    method="auto", device="cuda", devices=None, param_mask=None):
    """Inverse rendering: fit `SceneParams` so that the render of `pack`
    matches `target`, (H·W, 3) linear radiance.

    Returns (init_fn, step): init_fn() -> (params, opt_state), the pack's
    parameters as leaf tensors on the first device and `optimizer(params)`
    (default `torch.optim.Adam(lr=1e-2)`); step(params, opt_state,
    pixel_ids, key) -> (params, opt_state, loss), the MSE of the pixels
    against `target`, after one optimiser step that updates `params` in
    place. With `devices` (a list of torch devices; one may be listed
    several times) in place of `device`, the pixel ids split into one equal
    block per entry (`parallel.shard_lanes`), each block's loss and
    gradient are taken on its device with the same key, and their mean is
    applied; under `torch.distributed` each process passes its own block
    and the mean runs over the processes too. `param_mask`: optional
    `SceneParams` of 0/1 selecting the parameters that may move."""
    optimizer = optimizer or default_optimizer
    devs = resolve_devices(device, devices)
    packs = replicate_pack(pack, devs, method)
    target = torch.as_tensor(np.asarray(target, np.float32))
    targets = {dev: target.to(dev) for dev in packs}

    def shard_loss(params, dev, ids, key):
        leaves = [x.detach().to(dev).requires_grad_() for x in params]
        moved, meth = packs[dev]
        fb = render_lanes(apply_params(moved, SceneParams(*leaves)), camera, ids, key.to(dev),
                          spp=spp, max_bounces=max_bounces, method=meth)
        loss = torch.mean((fb - targets[dev][ids]) ** 2)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    def step(params, opt_state, pixel_ids, key):
        home = params[0].device
        shards = [shard_loss(params, dev, ids, key)
                  for dev, ids in zip(devs, shard_lanes(devs, pixel_ids))]
        n = len(shards)
        loss = sum(ls.to(home) for ls, _ in shards) / n
        grads = [sum(gs[i].to(home) for _, gs in shards) / n for i in range(len(params))]
        grads = _masked(grads, param_mask)
        if dist.is_initialized():
            flat = torch.cat([loss.reshape(1)] + [g.reshape(-1) for g in grads])
            dist.all_reduce(flat)
            flat = flat / dist.get_world_size()
            loss, at = flat[0], 1
            for i, g in enumerate(grads):
                grads[i], at = flat[at:at + g.numel()].reshape(g.shape), at + g.numel()
        _apply(params, opt_state, grads)
        return params, opt_state, loss

    return _init(pack, optimizer, devs[0]), step


def make_train_step_hybrid(pack, camera, target_img, optimizer=None, *, spp_res=64,
                           spp_grad=1, max_bounces=4, method="auto", device="cuda",
                           param_mask=None):
    """Megakernel-forward hybrid train step (`mcpt_tpu/diff.py:172-251`).

    With the residual R = 2·(I − target)/N held fixed, the gradient of the
    image MSE is ⟨R, ∂I/∂θ⟩, a vector-Jacobian product of the render. Each
    step renders I(θ) with the megakernel at `spp_res` (forward only, on
    the parameters detached), then pulls R back through `render_lanes` at
    `spp_grad` (`torch.autograd.grad(fb, params, grad_outputs=R)`) and
    applies the optimiser. Only the megakernel's `mat` and `emt` tables
    are rewritten per step: a parameter touches nothing else, and the BVH
    tables are the costly part of a big scene.

    Returns (init_fn, step): step(params, opt_state, key, seed) -> (params,
    opt_state, loss), the loss the megakernel image's MSE. `target_img`:
    (H, W, 3) linear radiance. `step.timer` (a `utils.profiling.PhaseTimer`)
    accumulates the wall of the two halves, `render` and `vjp` (with its
    optimiser step)."""
    optimizer = optimizer or default_optimizer
    dev = resolve_device(device)
    (moved, meth), = replicate_pack(pack, [dev], method).values()
    tables = SceneTables.from_pack(pack, device=dev)
    target_img = np.asarray(target_img, np.float32)
    h, w = target_img.shape[:2]
    n_pix = h * w
    pixel_ids = torch.arange(n_pix, device=dev)
    timer = PhaseTimer()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def step(params, opt_state, key, seed):
        with timer.phase("render"):
            with torch.no_grad():
                now = apply_params(moved, SceneParams(*(x.detach() for x in params)))
                tables.mat.copy_(now.mat_fat)
                tables.emt.copy_(now.emt_fat)
            img, _ = render_mega(tables, camera, spp_res, seed=seed, max_bounces=max_bounces,
                                 device=dev)
            diff = img - target_img
            loss = float(np.mean(diff ** 2))
            resid = torch.from_numpy((np.float32(2.0 / n_pix) * diff).reshape(n_pix, 3)).to(dev)
        with timer.phase("vjp"):
            leaves = [x.detach().requires_grad_() for x in params]
            fb = render_lanes(apply_params(moved, SceneParams(*leaves)), camera, pixel_ids,
                              key.to(dev), spp=spp_grad, max_bounces=max_bounces, method=meth)
            grads = _masked(list(torch.autograd.grad(fb, leaves, grad_outputs=resid)),
                            param_mask)
            _apply(params, opt_state, grads)
            sync()
        return params, opt_state, loss

    step.timer = timer
    return _init(pack, optimizer, dev), step


# ---------------------------------------------------------------------------
# Train-state persistence (torch.save in place of orbax)
# ---------------------------------------------------------------------------


def save_train_state(path, params: SceneParams, opt_state, step: int) -> None:
    """Write the parameters, the optimiser's state_dict and the step."""
    torch.save(
        {"params": {k: v.detach().cpu() for k, v in params._asdict().items()},
         "opt_state": opt_state.state_dict(), "step": int(step)},
        path,
    )


def load_train_state(path, like_params: SceneParams, like_opt_state):
    """(params, opt_state, step) from `save_train_state`'s file: the values
    are copied into `like_params` (whose tensors `like_opt_state` steps)
    and the optimiser's state is loaded into `like_opt_state`."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    with torch.no_grad():
        for name, dst in like_params._asdict().items():
            dst.copy_(state["params"][name])
    like_opt_state.load_state_dict(state["opt_state"])
    return like_params, like_opt_state, int(state["step"])
