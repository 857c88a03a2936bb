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
- Each piece's hand-written reverse (`vertex_ref`: the surface, the env
  leaf, the light point, the microfacet normal, Fresnel, refraction and
  reflection, the BSDF, its pdf) against autograd of its plain forward, on
  random lanes of all four material types, with total internal reflection.
- The light pick's binary searches return the rows of a scan over every
  emitter row.
- `shade_post` (shadows on and off) and `fold`.
- A train step's gradients twice: bitwise equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import cornell_x4, lens_lamp_demo
from mcpt_tpu_torch import prng
from mcpt_tpu_torch.builtin_scenes import demo_scene
from mcpt_tpu_torch.diff import SceneParams, apply_params, params_from_pack, render_lanes
from mcpt_tpu_torch.envmap import sample_env_chan
from mcpt_tpu_torch.intersect import Hit, intersect_c, occlude_t_c, surface_math, surface_rows
from mcpt_tpu_torch.kernels import megakernel_ref as R
from mcpt_tpu_torch.kernels import vertex_ref as V
from mcpt_tpu_torch.kernels import wavefront_ref as ref
from mcpt_tpu_torch.lights import light_point, pick
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


N_PIECE = 4096  # random lanes a piece's reverse is held on


def _unit(rng, n):
    v = rng.normal(size=(3, n))
    v /= np.linalg.norm(v, axis=0)
    return tuple(torch.tensor(c, dtype=torch.float32) for c in v)


def _piece_lanes(rng):
    """Random lanes: the four material types in turn, glass-like iors
    (1.3-1.8, a little dispersion), roughness 0.05-0.6, reflectance, unit
    wi, wo and n and a reflect/refract branch each; about half the wi on
    the far side of n, where refraction and Fresnel meet total internal
    reflection."""
    n_ = N_PIECE
    f = lambda lo, hi: torch.tensor(rng.uniform(lo, hi, n_), dtype=torch.float32)
    return {"mtype": torch.arange(n_, dtype=torch.float32) % 4, "ior": f(1.3, 1.8),
            "alpha": f(0.05, 0.6), "refl": f(0.1, 0.9), "wi": _unit(rng, n_),
            "wo": _unit(rng, n_), "n": _unit(rng, n_),
            "is_reflect": torch.tensor(rng.uniform(size=n_) < 0.5)}


def _grads_of(fwd, ins, rng):
    """(the forward's outputs, a random seed per output, autograd's
    adjoints of `ins`) for the forward `fwd(*ins)` (a tensor or a tuple of
    them)."""
    ins = [x.clone().requires_grad_() for x in ins]
    outs = fwd(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    seeds = [torch.tensor(rng.normal(size=o.shape), dtype=torch.float32) for o in outs]
    loss = sum((o * g).sum() for o, g in zip(outs, seeds))
    want = torch.autograd.grad(loss, ins, allow_unused=True)
    return [o.detach() for o in outs], seeds, [torch.zeros_like(x) if w is None else w
                                               for x, w in zip(ins, want)]


def _tir(ior, inc, nrm):
    """Lanes where Fresnel meets total internal reflection."""
    cosi = torch.clamp(R._dot(inc, nrm), -1.0, 1.0)
    eta = torch.where(cosi <= 0.0, 1.0 / ior, ior)
    return eta * torch.sqrt(torch.clamp_min(1.0 - cosi * cosi, 0.0)) >= 1.0


def _piece(name, rng):
    """(autograd's adjoints, the hand-written reverse's) of one piece."""
    L = _piece_lanes(rng)
    m3 = lambda t: (t[0], t[1], t[2])
    if name == "surface":
        ts = [torch.tensor(rng.normal(size=N_PIECE), dtype=torch.float32) for _ in range(11)]
        ss = [torch.tensor(rng.normal(0.0, 3.0, N_PIECE), dtype=torch.float32)
              for _ in range(5)]
        t = torch.tensor(rng.uniform(0.5, 4.0, N_PIECE), dtype=torch.float32)
        u, v = (torch.tensor(rng.uniform(0.0, 0.5, N_PIECE), dtype=torch.float32)
                for _ in range(2))
        happened = torch.tensor(rng.uniform(size=N_PIECE) < 0.9)
        is_tri = happened & torch.tensor(rng.uniform(size=N_PIECE) < 0.5)
        o = tuple(torch.tensor(rng.normal(0.0, 3.0, N_PIECE), dtype=torch.float32)
                  for _ in range(3))
        def fwd(o0, o1, o2, d0, d1, d2):
            p, n, _ = surface_math((o0, o1, o2), (d0, d1, d2), t, u, v, happened, is_tri, ts, ss)
            return (*p, *n)
        _, g, want = _grads_of(fwd, [*o, *L["wi"]], rng)
        g_o, g_d = V.surface_bwd(o, L["wi"], torch.where(happened, t, 0.0), is_tri, ss[:3],
                                 g[:3], g[3:])
        return want, [*g_o, *g_d]
    if name == "env":
        env = torch.tensor(rng.uniform(0.0, 3.0, (8, 16, 3)), dtype=torch.float32)
        chan = torch.tensor(rng.integers(0, 3, N_PIECE))
        d = tuple(c * torch.tensor(rng.uniform(0.5, 2.0, N_PIECE), dtype=torch.float32)
                  for c in L["wi"])
        fwd = lambda d0, d1, d2: sample_env_chan(env, None, True, (d0, d1, d2), chan)
        _, g, want = _grads_of(fwd, list(d), rng)
        return want, list(V.env_bwd(env, d, chan, g[0]))
    if name == "light_point":
        row = torch.tensor(rng.normal(size=(N_PIECE, 17)), dtype=torch.float32)
        row[:, 16] = torch.tensor(rng.uniform(size=N_PIECE) < 0.3, dtype=torch.float32)
        area = torch.tensor(rng.uniform(0.5, 4.0, N_PIECE), dtype=torch.float32)
        u2, u3 = (torch.tensor(rng.uniform(size=N_PIECE), dtype=torch.float32)
                  for _ in range(2))
        chan = torch.tensor(rng.integers(0, 3, N_PIECE))
        def fwd(r):
            ls = light_point(r.unbind(1), area, u2, u3, chan, True)
            return (*ls.p, *ls.n, ls.emit)
        _, g, want = _grads_of(fwd, [row], rng)
        got = V.light_point_bwd(row.unbind(1), u2, u3, chan, True, g[:3], g[3:6], g[6])
        return want, [torch.stack(got, 1)]
    if name == "sample_mfn":
        xi1, xi2 = (torch.tensor(rng.uniform(size=N_PIECE), dtype=torch.float32)
                    for _ in range(2))
        fwd = lambda a, n0, n1, n2: R.sample_mfn({"mtype": L["mtype"], "rough": a},
                                                 (n0, n1, n2), xi1, xi2)
        _, g, want = _grads_of(fwd, [L["alpha"], *L["n"]], rng)
        g_n, g_a = V.sample_mfn_bwd(L["mtype"], L["alpha"], L["n"], xi1, xi2, m3(g))
        return want, [g_a, *g_n]
    if name == "fresnel":
        inc = L["wi"]
        assert bool(_tir(L["ior"], inc, L["n"]).any())
        fwd = lambda ior, i0, i1, i2, n0, n1, n2: R.fresnel(
            {"mtype": L["mtype"]}, ior, (i0, i1, i2), (n0, n1, n2))
        _, g, want = _grads_of(fwd, [L["ior"], *inc, *L["n"]], rng)
        g_ior, g_inc, g_n = V.fresnel_bwd(L["mtype"], L["ior"], inc, L["n"], g[0])
        return want, [g_ior, *g_inc, *g_n]
    if name == "refract_reflect":
        inc = L["wi"]
        assert bool(_tir(L["ior"], inc, L["n"]).any())
        fwd = lambda ior, i0, i1, i2, n0, n1, n2: (
            *R.refract(ior, (i0, i1, i2), (n0, n1, n2)), *R._reflect((i0, i1, i2), (n0, n1, n2)))
        _, g, want = _grads_of(fwd, [L["ior"], *inc, *L["n"]], rng)
        g_ior, g_inc, g_n = V.refract_bwd(L["ior"], inc, L["n"], m3(g[:3]))
        g_wo, g_n2 = V.reflect_bwd(inc, L["n"], m3(g[3:]))
        return want, [g_ior, *(a + b for a, b in zip(g_inc, g_wo)),
                      *(a + b for a, b in zip(g_n, g_n2))]
    m = lambda a: {"mtype": L["mtype"], "rough": a}
    if name == "eval_bsdf":
        fwd = lambda ior, a, refl, i0, i1, i2, o0, o1, o2, n0, n1, n2: R.eval_bsdf(
            m(a), ior, refl, (i0, i1, i2), (o0, o1, o2), (n0, n1, n2), L["is_reflect"])
        out, g, want = _grads_of(fwd, [L["ior"], L["alpha"], L["refl"], *L["wi"], *L["wo"],
                                       *L["n"]], rng)
        gi, ga, gr, g_wi, g_wo, g_n, ev = V.eval_bsdf_bwd(L["mtype"], L["ior"], L["alpha"],
                                                           L["refl"], L["wi"], L["wo"], L["n"],
                                                           L["is_reflect"], g[0])
        assert torch.equal(ev, out[0])  # the value it recomputes, bitwise eval_bsdf's
        return want, [gi, ga, gr, *g_wi, *g_wo, *g_n]
    assert name == "pdf"
    fwd = lambda ior, a, i0, i1, i2, o0, o1, o2, n0, n1, n2: R.pdf(
        m(a), ior, (i0, i1, i2), (o0, o1, o2), (n0, n1, n2), L["is_reflect"])
    _, g, want = _grads_of(fwd, [L["ior"], L["alpha"], *L["wi"], *L["wo"], *L["n"]], rng)
    gi, ga, g_wi, g_wo, g_n = V.pdf_bwd(L["mtype"], L["ior"], L["alpha"], L["wi"], L["wo"],
                                        L["n"], L["is_reflect"], g[0])
    return want, [gi, ga, *g_wi, *g_wo, *g_n]


@pytest.mark.parametrize("name", ["surface", "env", "light_point", "sample_mfn", "fresnel",
                                  "refract_reflect", "eval_bsdf", "pdf"])
def test_vertex_piece_reverse_matches_autograd(name):
    """A piece's hand-written reverse (`vertex_ref`) against autograd of its
    plain forward on random lanes (all four material types, total internal
    reflection among them), each input's adjoint at the file's tolerance."""
    rng = np.random.default_rng(sum(map(ord, name)))
    want, got = _piece(name, rng)
    for g, w in zip(got, want):
        assert bool(w.abs().max() > 0.0)
        close(g.expand_as(w), w)


def _pick_by_scan(pack, u):
    """The light pick as a scan over every emitter row (the pick before its
    binary searches)."""
    e = pack.emt_mesh.shape[0]
    target = u[:, 0] * float(pack.emit_total_area)
    mesh = torch.searchsorted(pack.lmesh_cum, target, right=False)
    mesh = mesh.clamp(0, pack.lmesh_cum.shape[0] - 1)
    idx = torch.arange(e)
    same_mesh = pack.emt_mesh[None, :] == mesh[:, None]
    mesh_area = torch.amax(torch.where(same_mesh, pack.emt_mesh_area[None, :], 0.0), dim=1)
    p_tgt = torch.sqrt(u[:, 1].double()).float() * mesh_area
    hit = same_mesh & (p_tgt[:, None] < pack.emt_intra_cum[None, :])
    sel = torch.amin(torch.where(hit, idx[None, :], e), dim=1)
    last = torch.amax(torch.where(same_mesh, idx[None, :], -1), dim=1)
    return torch.where(sel >= e, last, sel).clamp(0, e - 1), mesh_area


@pytest.mark.parametrize("scene", ["x4 box", "40 light samples", "thin lens and lamp"])
def test_light_pick_binary_search_returns_the_scan_rows(scene):
    sc = {"x4 box": lambda: cornell_x4(sky=False), "40 light samples": demo_scene,
          "thin lens and lamp": lens_lamp_demo}[scene]()
    sc.n_dir_sample = 40
    pack = pack_to(sc.compile(), "cpu")
    u = prng.uniform(prng.key(7), (65536, 4))
    # the draws' edges: the first and last of each mesh's rows, and 0 and 1
    u[:8, 0] = torch.tensor([0.0, 1.0, 0.5, 0.25, 0.75, 0.999999, 1e-7, 0.5])
    u[:8, 1] = torch.tensor([0.0, 1.0, 0.999999, 0.0, 1e-7, 0.5, 0.5, 1.0])
    sel, area = pick(pack, u)
    want_sel, want_area = _pick_by_scan(pack, u)
    assert torch.equal(sel, want_sel) and torch.equal(area, want_area)
    assert int(pack.lmesh_count.max()) > 1 and sel.unique().numel() > 1


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
