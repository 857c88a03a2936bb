"""Differentiable rendering of the port (`mcpt_tpu_torch/diff.py`) against
`mcpt_tpu/diff.py` on the CPU, on tests/test_diff.py's two-quad scene (a
light quad above a rough-conductor floor) at 8x8, spp 2, mb 3.

The JAX pack and parameters are carried across with `convert`, the keys are
the two words of `jax.random.key_data`, the target is numpy's. The JAX side
runs op by op (`jax.disable_jit()`): under `jit` XLA's CPU backend contracts
products into FMAs across operations, which now and then flips a grazing
shadow ray's visibility (tests/test_torch_wavefront_render.py), and one flip
moves a gradient at this size far past any bound; op by op JAX and the
port's `dense` method agree per entry. It costs
about 45 s for the first value_and_grad (each primitive compiles once) and
about 20 s for each later one, so a module makes at most three.

Bounds: the MSE loss within 1e-5 relative; each (pixel, channel) radiance
entry within 1e-5 relative, except that the `kernel` method (the CUDA
kernel's plain sweep, whose Woop tests round otherwise than the dense
matmul) may flip entries in number up to 2% of the paths traced (3 lanes a
pixel x spp; the repo's wavefront bound is 2% of lanes), which then carry
weight 0 in the loss on both sides; every gradient element
within 1e-3 relative or within 1e-5 of its field's largest magnitude (the
float32 sums over lanes run in another order: on the DEMO an element of
ior_a at 2e-3 of its field's largest differs by 1.2e-3 relative, 2e-6 of
that largest); no NaN. A train step's parameters within 1e-4 of optax's, relative to the
larger of their values before and after the step (Adam's first step moves
each parameter by about its learning rate, which can cancel it). The
worst cases measured are printed (`-s`).
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mcpt_tpu.camera as JC
import mcpt_tpu.materials as JM
import mcpt_tpu.scene as JS
from mcpt_tpu.diff import apply_params as jax_apply_params
from mcpt_tpu.diff import params_from_pack as jax_params_from_pack
from mcpt_tpu.diff import render_lanes as jax_render_lanes

from mcpt_tpu_torch import prng
from mcpt_tpu_torch.convert import PACK_FIELDS, PACK_STATIC, pack_from_arrays, params_from_arrays
from mcpt_tpu_torch.diff import (
    SceneParams,
    apply_params,
    load_train_state,
    make_train_step,
    make_train_step_hybrid,
    params_from_pack,
    render_lanes,
    save_train_state,
)
from mcpt_tpu_torch.kernels.tables import SceneTables
from mcpt_tpu_torch.render import render_mega
from mcpt_tpu_torch.scene import pack_to

SPP, MB = 2, 3
HYBRID_SEED = 7
# a gradient element's bound: GRAD_RTOL relative, or GRAD_FLOOR of its
# field's largest magnitude (float32 sums over the lanes in another order
# leave about 3e-6 of it on elements that cancel)
GRAD_RTOL, GRAD_FLOOR = 1e-3, 1e-5
FLIP_SHARE = 0.02


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch's CPU thread pool costs far more than it saves at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quad(y, size, material, flip=False):
    c = [[-size, y, -size], [size, y, -size], [size, y, size], [-size, y, size]]
    f1, f2 = ([0, 2, 1], [0, 3, 2]) if flip else ([0, 1, 2], [0, 2, 3])
    pos = np.array([[c[i] for i in f1], [c[i] for i in f2]], np.float32)
    return JS.TriangleMesh(positions=pos, texcoords=np.zeros((2, 3, 2), np.float32),
                           material=material)


def two_quads():
    """tests/test_diff.py's scene and camera (the JAX package's)."""
    floor = JM.Material(JM.MaterialType.ROUGH_CONDUCTOR, roughness=0.5,
                        base_reflectance=(0.8, 0.6, 0.4))
    sc = JS.Scene()
    sc.add(_quad(4.0, 1.5, JM.make_light_material(2.0)))
    sc.add(_quad(0.0, 5.0, floor, flip=True))
    sc.set_rr_rate(0.6)
    cam = JC.Camera(width=8, height=8, fov=60, position=(0.0, 2.0, -6.0), target=(0.0, 1.0, 0.0))
    return sc, cam


def port_camera(cam):
    from mcpt_tpu_torch.camera import Camera

    return Camera(**{f.name: getattr(cam, f.name) for f in dataclasses.fields(Camera)})


def port_key(key):
    return torch.tensor(np.asarray(jax.random.key_data(key)).astype(np.int64))


def as_numpy(params):
    return {f: np.asarray(v) for f, v in params._asdict().items()}


class Reference:
    """One scene's JAX side: its pack carried across, the eager
    value_and_grad of mean(weight · (fb − target)²) with fb as aux, and its
    result at weight 1 and the module's target.

    That target also makes the gradient a VJP of the hybrid step's residual
    R = 2·(img − target_img)/P of the port's megakernel image (the plain
    version, spp 4, seed HYBRID_SEED): with target = fb − R·3P/2, where fb
    is JAX's render at the same key (a forward pass), the loss's output
    cotangent 2·(fb − target)/3P is R. One value_and_grad serves both."""

    def __init__(self, scene, cam, seed):
        self.jpack = scene.compile()
        self.cam = cam
        self.n_pix = cam.width * cam.height
        self.ids = jnp.arange(self.n_pix, dtype=jnp.int32)
        self.key = jax.random.key(seed)
        self.host = pack_from_arrays({f: np.asarray(getattr(self.jpack, f)) for f in PACK_FIELDS},
                                     {s: getattr(self.jpack, s) for s in PACK_STATIC})
        self.pack = pack_to(self.host, "cpu")
        self.tcam = port_camera(cam)
        self.p0 = jax_params_from_pack(self.jpack)
        rng = np.random.default_rng(seed)
        self.target_img = rng.uniform(0.0, 0.5, (cam.height, cam.width, 3)).astype(np.float32)
        img, _ = render_mega(self.host, self.tcam, 4, seed=HYBRID_SEED, max_bounces=MB,
                             device="cpu")
        self.resid = (np.float32(2.0 / self.n_pix) * (img - self.target_img)).reshape(-1, 3)
        with jax.disable_jit():
            fb = np.asarray(self._render(self.p0))
        self.target = fb - self.resid * np.float32(3 * self.n_pix / 2)
        self.loss, self.fb, self.grads = self.grad(self.target, np.ones_like(self.target))

    def _render(self, p):
        return jax_render_lanes(jax_apply_params(self.jpack, p), self.cam, self.ids, self.key,
                                spp=SPP, max_bounces=MB, method="dense")

    def grad(self, target, weight):
        """(loss, fb, {field: gradient}) of JAX's weighted MSE, op by op."""
        def loss(p):
            fb = self._render(p)
            return jnp.mean(jnp.asarray(weight) * (fb - jnp.asarray(target)) ** 2), fb

        with jax.disable_jit():
            (value, fb), g = jax.value_and_grad(loss, has_aux=True)(self.p0)
        return float(value), np.asarray(fb), as_numpy(g)

    def port_params(self):
        return SceneParams(*(x.requires_grad_() for x in params_from_arrays(as_numpy(self.p0))))

    def port(self, method, target, weight):
        """The port's (loss, fb, {field: gradient}) of the same loss."""
        p = self.port_params()
        fb = render_lanes(apply_params(self.pack, p), self.tcam, torch.arange(self.n_pix),
                          port_key(self.key), spp=SPP, max_bounces=MB, method=method)
        loss = torch.mean(torch.from_numpy(weight) * (fb - torch.from_numpy(target)) ** 2)
        g = torch.autograd.grad(loss, list(p))
        return float(loss), fb.detach().numpy(), {f: x.numpy() for f, x in zip(p._fields, g)}


def grad_err(got, want):
    """(the largest relative error over the elements whose magnitude exceeds
    1e-6 of their field's largest, the largest absolute error over each
    field's largest magnitude); checks that no gradient is NaN and that
    each element is within GRAD_RTOL relative or GRAD_FLOOR of its field's
    largest magnitude."""
    rel = floor = 0.0
    for f, w in want.items():
        g = got[f]
        assert np.isfinite(g).all(), f"{f}: non-finite gradient {g}"
        top = np.abs(w).max(initial=0.0)
        err = np.abs(g - w)
        assert np.all(err <= np.maximum(GRAD_RTOL * np.abs(w), GRAD_FLOOR * top)), (f, g, w)
        big = np.abs(w) > 1e-6 * top
        if big.any():
            rel = max(rel, float((err[big] / np.abs(w)[big]).max()))
            floor = max(floor, float(err.max() / top))
    return rel, floor


def check_against_jax(ref, method):
    """The module's bounds for one method; returns the worst cases."""
    loss, fb, grads = ref.port(method, ref.target, np.ones_like(ref.target))
    rel = np.abs(fb - ref.fb) / np.maximum(np.abs(ref.fb), 1e-30)
    flipped = rel > 1e-5
    share = float(flipped.sum()) / (flipped.size * SPP)  # of the paths traced
    assert share <= (FLIP_SHARE if method == "kernel" else 0.0), (method, share)
    want_loss, want = ref.loss, ref.grads
    if flipped.any():  # weight 0 on the flipped entries, on both sides
        weight = (~flipped).astype(np.float32)
        loss, _, grads = ref.port(method, ref.target, weight)
        want_loss, _, want = ref.grad(ref.target, weight)
    loss_err = abs(loss - want_loss) / abs(want_loss)
    g_rel, g_floor = grad_err(grads, want)
    print(f"{method}: flipped entries {int(flipped.sum())} of {flipped.size} ({share:.4f} of "
          f"the paths); radiance "
          f"{rel[~flipped].max():.3g}, loss {loss_err:.3g} relative; gradient {g_rel:.3g} "
          f"relative, {g_floor:.3g} of the field's largest")
    assert loss_err <= 1e-5


class Recorder(torch.optim.Optimizer):
    """An optimiser that keeps the gradients it is handed and moves nothing."""

    def __init__(self, params):
        super().__init__(params, {})
        self.seen = None

    def step(self, closure=None):
        self.seen = [p.grad.clone() for g in self.param_groups for p in g["params"]]


@pytest.fixture(scope="module")
def ref():
    return Reference(*two_quads(), seed=3)


@pytest.mark.parametrize("method", ["dense", "kernel"])
def test_gradients_match_jax(ref, method):
    check_against_jax(ref, method)


def test_train_step_matches_optax(ref):
    check_train_step(ref)


def check_train_step(ref):
    """One make_train_step step (torch Adam, lr 1e-2) against JAX's gradient
    followed by optax.adam(1e-2)'s update."""
    opt = optax.adam(1e-2)
    updates, _ = opt.update(ref.grads, opt.init(as_numpy(ref.p0)), as_numpy(ref.p0))
    want = optax.apply_updates(as_numpy(ref.p0), updates)
    init_fn, step = make_train_step(ref.host, ref.tcam, ref.target, spp=SPP, max_bounces=MB,
                                    method="dense", device="cpu")
    params, opt_state = init_fn()
    params, opt_state, loss = step(params, opt_state, torch.arange(ref.n_pix), port_key(ref.key))
    assert abs(float(loss) - ref.loss) <= 1e-5 * ref.loss
    p0 = as_numpy(ref.p0)
    # relative to the parameter's size before the step: a step can cancel it
    worst = max(float(np.max(np.abs(getattr(params, f).detach().numpy() - np.asarray(w))
                             / np.maximum(np.maximum(np.abs(np.asarray(w)), np.abs(p0[f])),
                                          1e-30)))
                for f, w in want.items())
    print(f"train step: parameters within {worst:.3g} relative of optax's")
    assert worst <= 1e-4


def test_hybrid_step_matches_jax_vjp(ref):
    check_hybrid_step(ref)


def check_hybrid_step(ref):
    """make_train_step_hybrid's pull-back of the residual of its megakernel
    render (the plain version on the CPU, spp 4) against JAX's VJP at the
    same residual (the fixture's gradient, see `Reference`)."""
    init_fn, step = make_train_step_hybrid(
        ref.host, ref.tcam, ref.target_img, Recorder, spp_res=4, spp_grad=SPP, max_bounces=MB,
        method="dense", device="cpu")
    params, opt_state = init_fn()
    params, opt_state, loss = step(params, opt_state, port_key(ref.key), HYBRID_SEED)
    assert loss == float(np.mean((ref.resid * np.float32(ref.n_pix / 2)) ** 2))
    got = {f: g.numpy() for f, g in zip(SceneParams._fields, opt_state.seen)}
    g_rel, g_floor = grad_err(got, ref.grads)
    print(f"hybrid step: gradient within {g_rel:.3g} relative, {g_floor:.3g} of the field's "
          f"largest, of jax.vjp's")
    assert set(step.timer.totals) == {"render", "vjp"}


def _mean_radiance(ref, p):
    fb = render_lanes(apply_params(ref.pack, p), ref.tcam, torch.arange(ref.n_pix),
                      prng.key(0), spp=SPP, max_bounces=MB, method="dense")
    return fb.mean()


def test_fd_gradients_match(ref):
    """tests/test_diff.py:56 on the port: pathwise gradients against central
    differences with the random numbers fixed."""
    p0 = params_from_pack(ref.host)
    leaves = SceneParams(*(x.clone().requires_grad_() for x in p0))
    grads = SceneParams(*torch.autograd.grad(_mean_radiance(ref, leaves), list(leaves)))
    eps = 1e-3

    def fd(field, delta):
        with torch.no_grad():
            up = _mean_radiance(ref, p0._replace(**{field: getattr(p0, field) + delta}))
            down = _mean_radiance(ref, p0._replace(**{field: getattr(p0, field) - delta}))
        return float((up - down) / (2 * eps))

    g_light = float(grads.light_scale)
    assert g_light != 0.0
    np.testing.assert_allclose(g_light, fd("light_scale", torch.tensor(eps)), rtol=0.05)
    row = int(torch.argmax(p0.refl.sum(dim=1)))
    e = torch.zeros_like(p0.refl)
    e[row, 0] = eps
    fd_r = fd("refl", e)
    if abs(fd_r) > 1e-6:
        np.testing.assert_allclose(float(grads.refl[row, 0]), fd_r, rtol=0.08, atol=1e-5)
    er = torch.zeros_like(p0.rough)
    er[row] = eps
    fd_a = fd("rough", er)
    if abs(fd_a) > 1e-5:
        np.testing.assert_allclose(float(grads.rough[row]), fd_a, rtol=0.15, atol=1e-4)


def _light_only(p):
    return SceneParams(*(torch.zeros_like(x) for x in p[:4]), torch.ones(()))


def test_inverse_rendering_recovers_brightness(ref):
    """tests/test_diff.py:102 on the port: Adam (lr 0.1) fits light_scale
    to a target rendered at 1.6."""
    p_true = params_from_pack(ref.host)._replace(light_scale=torch.tensor(1.6))
    with torch.no_grad():
        target = render_lanes(apply_params(ref.pack, p_true), ref.tcam, torch.arange(ref.n_pix),
                              prng.key(1), spp=4, max_bounces=MB, method="dense")
    init_fn, step = make_train_step(ref.host, ref.tcam, target.numpy(),
                                    partial(torch.optim.Adam, lr=1e-1), spp=SPP,
                                    max_bounces=MB, method="dense", device="cpu",
                                    param_mask=_light_only(p_true))
    params, opt_state = init_fn()
    for k in range(80):
        params, opt_state, loss = step(params, opt_state, torch.arange(ref.n_pix),
                                       prng.fold_in(prng.key(1), k))
    assert abs(float(params.light_scale) - 1.6) < 0.25, float(params.light_scale)


def test_hybrid_train_step_climbs(ref):
    """tests/test_diff.py:133 on the port: the megakernel-residual step moves
    light_scale toward a brighter target and lowers the megakernel MSE."""
    bright = dataclasses.replace(ref.host, mat_fat=ref.host.mat_fat.copy(),
                                 emt_fat=ref.host.emt_fat.copy())
    bright.mat_fat[:, 7:10] *= np.float32(1.6)
    bright.emt_fat[:, 12:15] *= np.float32(1.6)
    target_img, _ = render_mega(SceneTables.from_pack(bright), ref.tcam, 8, seed=3,
                                max_bounces=MB, device="cpu")
    init_fn, step = make_train_step_hybrid(
        ref.host, ref.tcam, target_img, partial(torch.optim.Adam, lr=1e-1), spp_res=4,
        spp_grad=SPP, max_bounces=MB, method="dense", device="cpu",
        param_mask=_light_only(params_from_pack(ref.host)))
    params, opt_state = init_fn()
    losses = []
    for k in range(10):
        params, opt_state, loss = step(params, opt_state, prng.fold_in(prng.key(5), k), k)
        losses.append(loss)
    assert all(np.isfinite(losses)), losses
    assert float(params.light_scale) > 1.15, float(params.light_scale)
    assert min(losses[-3:]) < losses[0], losses


def test_train_state_round_trip(ref, tmp_path):
    """tests/test_train_ckpt.py:17 on the port: parameters, Adam state and
    step survive save_train_state / load_train_state."""
    init_fn, step = make_train_step(ref.host, ref.tcam, ref.target, spp=1, max_bounces=2,
                                    method="dense", device="cpu")
    params, opt_state = init_fn()
    params, opt_state, _ = step(params, opt_state, torch.arange(ref.n_pix), prng.key(2))
    with torch.no_grad():
        params.light_scale.fill_(1.37)
    path = tmp_path / "ckpt.pt"
    save_train_state(path, params, opt_state, step=7)
    fresh, fresh_opt = init_fn()
    p2, o2, s2 = load_train_state(path, fresh, fresh_opt)
    assert s2 == 7 and float(p2.light_scale) == np.float32(1.37)
    for a, b in zip(p2, params):
        assert torch.equal(a.detach(), b.detach())
    got, want = o2.state_dict()["state"], opt_state.state_dict()["state"]
    assert got.keys() == want.keys()
    for k in want:
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(got[k][name], want[k][name])
