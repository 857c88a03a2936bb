"""The backward kernels' plain versions on the CPU: the hand-written reverse
modes of the wavefront's halves and fold (`wavefront_ref.shade_pre_bwd`,
`shade_post_bwd`, `fold_bwd`), which `csrc/wavefront_bwd.cu` equals bit for
bit on the card, against `torch.autograd.grad` of their plain forwards.

Tolerance: each gradient element within 1e-5 relative or 1e-6 of its
field's largest magnitude (the two sum a value's adjoints in different
orders, and autograd takes a float64 sqrt's derivative in float64 where the
reverse mode rounds its seed first).

- `shade_pre` on the x4-scaled Cornell box of tests/test_megakernel.py:
  207-279 (all four material types: rough and smooth conductors, rough and
  smooth dielectrics) with and without the sky map, at depth 0 (the
  emitter leaf) and depth 1 (gradients into the ray, total internal
  reflection inside the glass sphere), at 1, 4 and 40 light samples, with
  Russian roulette killing paths: the ray's adjoints and the tables'
  gradients (`mat_fat`, `emt_fat`, through `fold_rows`).
- The traced forward (`vertex_program`, `sample_program`) replays to the
  plain forward bit for bit.
- `shade_post` (shadows on and off) and `fold`.
- A train step's gradients twice: bitwise equal.
- csrc/wavefront_bwd_lanes.cuh is what `wavefront_lanes` writes now.
"""

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import cornell_x4
from mcpt_tpu_torch import prng
from mcpt_tpu_torch.builtin_scenes import demo_scene
from mcpt_tpu_torch.diff import SceneParams, apply_params, params_from_pack, render_lanes
from mcpt_tpu_torch.intersect import Hit, intersect_c, occlude_t_c, surface_rows
from mcpt_tpu_torch.kernels import lane_ad, wavefront_lanes
from mcpt_tpu_torch.kernels import wavefront_ref as ref
from mcpt_tpu_torch.scene import pack_to

W, H = 20, 16


def close(got, want):
    """Within 1e-5 relative or 1e-6 of the field's largest magnitude."""
    assert got.shape == want.shape
    err = (got - want).abs()
    floor = 1e-6 * float(want.abs().max())
    ok = (err <= 1e-5 * want.abs()) | (err <= floor)
    assert bool(ok.all()), f"{int((~ok).sum())} of {ok.numel()} off, worst {float(err.max())}"


def _detach(h):
    return Hit(t=h.t.detach(), prim=h.prim, u=h.u.detach(), v=h.v.detach())


@pytest.fixture(scope="module", params=["box", "sky"])
def box(request):
    sc = cornell_x4(sky=request.param == "sky")
    return sc, sc.compile()


def _lanes(sc, host, n_dir, depth):
    """A pack whose mat_fat and emt_fat require grad, and a batch of lanes at
    `depth` (its o and d requiring grad at depth 1), with their key."""
    pack = pack_to(dataclasses.replace(host, n_dir_sample=n_dir), "cpu")
    pack = dataclasses.replace(pack, mat_fat=pack.mat_fat.clone().requires_grad_(),
                               emt_fat=pack.emt_fat.clone().requires_grad_())
    cam = dataclasses.replace(sc.camera, width=W, height=H)
    key = prng.key(11)
    o, d = ref.camera_rays(cam, torch.arange(W * H), key, 3)
    b = o[0].numel()
    chan = torch.arange(b) % 3
    lam = torch.tensor([0.7, 0.5461, 0.4358])[chan]
    alive = torch.ones(b, dtype=torch.bool)
    hit = _detach(intersect_c(pack, o, d, method="dense"))
    if depth:
        with torch.no_grad():
            pre = ref.shade_pre(pack, o, d, hit, alive, 0, key, lam, chan)
        o = tuple(x.clone().requires_grad_() for x in pre.p_new)
        d = tuple(x.clone().requires_grad_() for x in pre.wi)
        hit = _detach(intersect_c(pack, o, d, method="dense"))
    return pack, (o, d, hit, alive, depth, key, lam, chan)


@pytest.mark.parametrize("n_dir", [1, 4, 40])
@pytest.mark.parametrize("depth", [0, 1])
def test_shade_pre_reverse_mode_matches_autograd(box, n_dir, depth):
    sc, host = box
    pack, args = _lanes(sc, host, n_dir, depth)
    o, d = args[0], args[1]
    pre = ref.shade_pre(pack, *args)
    rng = np.random.default_rng(depth * 100 + n_dir)
    outs = dict(zip(ref.RAY_OUT, (*pre.p_new, *pre.wi)))
    outs.update(fac=pre.fac, leaf_pre=pre.leaf_pre, env_c=pre.env_c, w=pre.w,
                contrib=pre.contrib)
    grads = {k: torch.tensor(rng.normal(size=v.shape), dtype=torch.float32)
             for k, v in outs.items()}
    loss = sum((v * grads[k]).sum() for k, v in outs.items())
    ins = [pack.mat_fat, pack.emt_fat, *(o + d if depth else ())]
    want = torch.autograd.grad(loss, ins)
    with torch.no_grad():
        g_o, g_d, g_mat, g_emt = ref.shade_pre_bwd(pack, *args, grads)
    for got, w in zip([g_mat, g_emt, *(g_o + g_d if depth else ())], want):
        close(got, w)
    # what the batch covers: every material type at a vertex, roulette kills,
    # the depth-0 emitter leaf, total internal reflection at depth 1
    at = pre.at_vertex
    mtype = pack.mat_fat.detach()[:, 0]
    _, _, _, _, mat, emissive = surface_rows(pack, args[2])
    kinds = set(mtype[mat[at]].tolist())
    assert kinds == {0.0, 1.0, 2.0, 3.0}, kinds
    assert bool((pre.rr_kill & at).any())
    if depth == 0:
        assert bool((emissive & ~at).any())  # the emitter leaf
    else:
        tir = at & (mtype[mat] > 1.5) & ((pre.fac == 1.0) | (pre.fac == 0.0))
        assert bool(tir.any())


def test_traced_forward_replays_the_plain_forward(box):
    """`vertex_program`'s and `sample_program`'s forward ops, replayed with
    torch, give shade_pre's outputs bit for bit."""
    sc, host = box
    pack, (o, d, hit, alive, depth, key, lam, chan) = _lanes(sc, host, 4, 0)
    with torch.no_grad():
        pre = ref.shade_pre(pack, o, d, hit, alive, depth, key, lam, chan)
        kd = prng.fold_in(key, depth)
        x, _ = ref.vertex_inputs(pack, o, d, hit, alive, depth, kd, lam, chan)
        vp = ref.vertex_program(bool(pack.use_env), True)
        env = {v.id: x[n] for n, v in vp.tape.inputs.items() if not n.startswith("g_")}
        prm = {"rr_rate": float(pack.rr_rate), "inv_rr": float(pack.inv_rr),
               "env_h": pack.env_pixels.shape[0], "env_w": pack.env_pixels.shape[1],
               **{f"bg{k}": float(pack.background[k]) for k in range(3)}}
        env.update({v.id: prm[n] for n, v in vp.tape.params.items()})
        lane_ad.replay(vp.tape.ops[:vp.n_fwd], env, x["t"], {"env": pack.env_pixels})
        for name, want in zip(ref.RAY_OUT + ref.LEAF_OUT,
                              (*pre.p_new, *pre.wi, pre.fac, pre.leaf_pre, pre.env_c, pre.w)):
            assert torch.equal(env[vp.outs[name].id], want), name
        b = o[0].numel()
        xs, _ = ref.sample_inputs(pack, prng.fold_in(kd, 1), b, chan)
        sp = ref.sample_program(bool(pack.n_sph_emitters))
        senv = {sp.tape.inputs[n].id: env[vp.outs["sh_" + n].id].repeat(4)
                for n in (*ref.SHARED_FLOATS, "is_reflect")}
        senv.update({sp.tape.inputs[n].id: v for n, v in xs.items()})
        senv[sp.tape.params["s"].id] = 4
        lane_ad.replay(sp.tape.ops[:sp.n_fwd], senv, xs["lu2"])
        assert torch.equal(senv[sp.outs["contrib"].id], pre.contrib)
        assert torch.equal(senv[sp.outs["thr"].id], pre.thr)


@pytest.mark.parametrize("shadows", [True, False])
def test_shade_post_reverse_mode_matches_autograd(box, shadows):
    sc, host = box
    pack, args = _lanes(sc, host, 4, 1)
    with torch.no_grad():
        pre = ref.shade_pre(pack, *args)
    leaves = {k: getattr(pre, k).clone().requires_grad_()
              for k in ("contrib", "fac", "leaf_pre", "env_c", "w")}
    pre = pre._replace(**leaves)
    s = ref.n_samples(pack)
    sh_t = occlude_t_c(pack, pre.p_dl, pre.ws, method="dense", fan=s) if shadows else None
    nxt = intersect_c(pack, pre.p_new, pre.wi, method="dense")
    b = pre.fac.numel()
    rec = ref.new_records(2, b, "cpu")
    rays = torch.zeros((), dtype=torch.int64)
    ref.shade_post(pack, pre, sh_t, nxt.prim, rec, 1, rays)
    rng = np.random.default_rng(7)
    g = [torch.tensor(rng.normal(size=b), dtype=torch.float32) for _ in range(3)]
    loss = (rec.l_dir[1] * g[0]).sum() + (rec.w[1] * g[1]).sum() + (rec.leaf[1] * g[2]).sum()
    want = torch.autograd.grad(loss, list(leaves.values()))
    got = ref.shade_post_bwd(pre, sh_t, s, *g)
    for a, w in zip(got, want):
        close(a, w)
    assert bool(pre.rr_kill.any()) and bool((~pre.at_vertex).any())


def test_fold_reverse_mode_matches_autograd():
    """Records past both clamps' bounds, with terminal depths: every
    record's gradient, autograd's subgradient at the bounds included."""
    rng = np.random.default_rng(5)
    depth, b = 6, 4096
    l_dir = torch.tensor(rng.normal(0.0, 12.0, (depth, b)), dtype=torch.float32)
    l_dir[0, :64] = 15.0  # on the bound
    w = torch.tensor(rng.uniform(0.0, 3.0, (depth, b)), dtype=torch.float32)
    leaf = torch.tensor(rng.uniform(0.0, 8.0, (depth, b)), dtype=torch.float32)
    term = torch.tensor(rng.uniform(size=(depth, b)) < 0.25)
    parts = [x.clone().requires_grad_() for x in (l_dir, w, leaf)]
    rec = ref.Records(*parts, term)
    g = torch.tensor(rng.normal(size=b), dtype=torch.float32)
    want = torch.autograd.grad((ref.fold(rec) * g).sum(), parts)
    got = ref.fold_bwd(ref.Records(l_dir, w, leaf, term), g)
    for a, wt in zip(got, want):
        close(a, wt)


def test_train_step_gradients_repeat_bitwise():
    """The CPU's train pass (the Functions on the plain route: the plain
    forward, the hand-written reverse modes) twice: the same bits."""
    sc = demo_scene()
    host = sc.compile()
    pack = pack_to(host, "cpu")
    cam = dataclasses.replace(sc.camera, width=8, height=8)
    runs = []
    for _ in range(2):
        p = SceneParams(*(x.requires_grad_() for x in params_from_pack(host, "cpu")))
        fb = render_lanes(apply_params(pack, p), cam, torch.arange(64), prng.key(2), spp=1,
                          max_bounces=3, method="dense")
        runs.append(torch.autograd.grad(((fb - 0.3) ** 2).mean(), list(p)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_other_pack_tensors_with_grad_are_refused():
    """The backward kernels reach mat_fat and emt_fat only: a pack whose
    other tensor requires grad is refused before any half runs."""
    from mcpt_tpu_torch.kernels import wavefront as WF

    pack = pack_to(demo_scene().compile(), "cpu")
    live = dataclasses.replace(pack, tri_shade=pack.tri_shade.clone().requires_grad_())
    with pytest.raises(ValueError, match="tri_shade"):
        WF.needs_grad(live)
    assert WF.needs_grad(dataclasses.replace(pack, mat_fat=pack.mat_fat.clone().requires_grad_()))
    with torch.no_grad():
        assert not WF.needs_grad(live)


def test_generated_header_is_current():
    assert wavefront_lanes.HEADER.read_text() == wavefront_lanes.header()
