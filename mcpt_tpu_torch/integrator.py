"""Wavefront path-tracing integrator (counterpart of
`mcpt_tpu/integrator.py:91-390`).

Semantics are the reference's recursive `Scene::castRay` and
`Scene::directLighting` (Scene.cpp:56-184), as in the JAX package: a bounce
loop over a pool of lanes, each carrying (origin, direction, nearest hit,
alive), records per bounce (l_dir, weight, leaf, terminal) and a reverse
fold that reproduces the nested per-level firefly clamps exactly:

    L_d = terminal_d ? leaf_d : clamp15(l_dir_d) + clamp5(w_d · L_{d+1})

A bounce is `kernels/wavefront.py`'s `shade_pre`, the intersector (the
S·B shadow rays through `occlude_t_c` in its fan form, the B origins once
and ray k·B + i from origin i; the next rays through `intersect_c`), then
`shade_post`; the radiance is `fold` of the records. On a CUDA pack each of
the three is a CUDA kernel (`csrc/wavefront.cu`), so a bounce is four
launches; on the CPU they are their plain versions
(`kernels/wavefront_ref.py`). The random numbers are `jax.random`'s,
reproduced by `prng`: per bounce `kd = fold_in(key, depth)`, the vertex
draws of `uniform(fold_in(kd, 0), (B, 4))` and the light draws of
`uniform(fold_in(kd, 1), (S·B, 4))`, so a lane draws what it draws in the
JAX function.

With `early_exit` the bounce loop is a Python loop that stops once no lane
is alive (one host sync per bounce); records are preallocated (D, B).

The training route: when grad mode is on and `mat_fat` or `emt_fat`
requires grad (`diff.render_lanes` under `make_train_step` and the hybrid
step's pull-back), the halves and the fold run as `torch.autograd.Function`s
on the same route (the kernels on a CUDA device), each with its backward
kernel (`csrc/wavefront_bwd.cu`; on the CPU their plain versions, the
hand-written reverse modes of `wavefront_ref`). A depth's records come back
as rows of `shade_post_row` and are stacked for the fold. Inside
`wavefront.autograd_oracle()` such a pass runs the plain forward under
autograd instead (route `plain (autograd)`, the tests' oracle). The
gradient is the detached-sampling estimator of the JAX package: every hit's
t, u and v are detached (`_detach_hit`), so gradients flow through the
shading terms (eval, pdf, Fresnel, emission, the reparameterized GGX draw),
not through the intersector.
"""

from typing import NamedTuple

import torch

from mcpt_tpu_torch.intersect import Hit, intersect_c, occlude_t_c
from mcpt_tpu_torch.kernels import wavefront
from mcpt_tpu_torch.kernels.wavefront_ref import n_samples, new_records


def _detach_hit(hit: Hit) -> Hit:
    """Hit distances and barycentrics held fixed by the sampled path
    (`mcpt_tpu/integrator.py:75-88`): the kernel's outputs carry no
    gradient, and the CPU's routes would carry one through t."""
    return Hit(t=hit.t.detach(), prim=hit.prim, u=hit.u.detach(), v=hit.v.detach())


class PathStats(NamedTuple):
    rays: torch.Tensor  # () total rays traced (primary + shadow + bounce)


def trace_route(pack, device) -> str:
    """The route of the bounce's halves and the fold: the device's
    (`wavefront.device_route`: the kernels on a CUDA device, the plain
    versions on the CPU or inside `wavefront.plain_route()`), with or
    without gradients; `plain (autograd)` for a pack that needs gradients
    inside `wavefront.autograd_oracle()`."""
    if wavefront.oracle_active() and wavefront.needs_grad(pack):
        return "plain (autograd)"
    return wavefront.device_route(device)


def trace_paths_c(pack, o, d, lam, chan, key, max_bounces=8, method="auto", early_exit=True):
    """Radiance for a batch of primary rays (component form): o, d 3-tuples
    of (B,) tensors, lam (B,) wavelength in µm, chan (B,) RGB channel, key
    a `prng` key. Returns (radiance (B,), PathStats). `early_exit` stops
    the bounce loop once every lane has terminated (the same result)."""
    b = o[0].shape[0]
    dev = o[0].device
    route = trace_route(pack, dev)
    rows = [] if route != "plain (autograd)" and wavefront.needs_grad(pack) else None
    s = n_samples(pack)
    hit = _detach_hit(intersect_c(pack, o, d, method=method))
    alive = torch.ones(b, dtype=torch.bool, device=dev)
    rec = new_records(max_bounces, b, dev) if rows is None else None
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    for depth in range(max_bounces):
        if early_exit and not bool(alive.any()):
            break
        pre = wavefront.shade_pre(pack, o, d, hit, alive, depth, key, lam, chan, route=route)
        sh_t = None
        if s and pack.enable_shadow:
            # a fan of s shadow rays from each of the b points, ray k·b + i from p[i]
            sh_t = occlude_t_c(pack, pre.p_dl, pre.ws, method=method, fan=s)
        nxt = _detach_hit(intersect_c(pack, pre.p_new, pre.wi, method=method))
        if rows is None:
            alive = wavefront.shade_post(pack, pre, sh_t, nxt.prim, rec, depth, rays, route=route)
        else:
            alive, row = wavefront.shade_post_row(pack, pre, sh_t, nxt.prim, rays, route=route)
            rows.append(row)
        o, d, hit = pre.p_new, pre.wi, nxt
    if rows is not None:
        rec = wavefront.stack_records(rows, max_bounces, b, dev)
    return wavefront.fold(rec, route=route), PathStats(rays=rays + b)


def trace_paths(pack, o, d, lam, chan, key, max_bounces=8, method="auto", early_exit=True):
    """(B, 3)-row wrapper over `trace_paths_c`."""
    return trace_paths_c(
        pack,
        tuple(o[:, k] for k in range(3)),
        tuple(d[:, k] for k in range(3)),
        lam, chan, key, max_bounces=max_bounces, method=method, early_exit=early_exit,
    )
