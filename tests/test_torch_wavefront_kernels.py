"""The wavefront kernels' plain versions (`kernels/wavefront_ref.py`: the
camera rays, `shade_pre`, `shade_post`, `fold`) and their routes, on the
CPU.

- The per-index draws (`prng.uniform_at`) equal `prng.uniform` and
  `jax.random.uniform` bitwise at the bounce's shapes.
- shade_pre -> intersector -> shade_post -> fold, as `trace_paths_c` runs
  them, equals the integrator as it was before the split (a frozen copy
  below) bitwise, ray counts included, on the DEMO, the sky-lit DEMO, the
  x4 Cornell box and the DEMO with an emissive sphere, through the `dense`
  method and the kernel's plain sweep; and JAX's `trace_paths_c` within
  tests/test_torch_wavefront_render.py's bounds.
- The route rule: the kernels on a CUDA device, the plain versions on the
  CPU, the plain versions under autograd when a pack tensor requires grad;
  no fallback from the kernel route.
- `auto` on a CUDA pack takes the kernel at any table size with the walk's
  tables; a tree deeper than the walk's stack raises naming method="bvh".
"""

import contextlib
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcpt_tpu.builtin_scenes as JB
from mcpt_tpu.camera import generate_rays_c as jax_generate_rays_c
from mcpt_tpu.integrator import trace_paths as jax_trace_paths

import mcpt_tpu_torch.intersect as I
from chip_smoke import EDGE_DEPTHS, cornell_x4, fold_records, write_lathe_obj
from mcpt_tpu_torch import integrator, prng
from mcpt_tpu_torch.bsdf import (
    eval_bsdf_c,
    fresnel_c,
    gather_material,
    pdf_c,
    refract_c,
    sample_mfn_c,
)
from mcpt_tpu_torch.builtin_scenes import demo_scene
from mcpt_tpu_torch.constants import BVH_STACK, CLAMP_DIRECT, CLAMP_INDIRECT, EPSILON, REL_EPS
from mcpt_tpu_torch.constants import WAVELEN_UM
from mcpt_tpu_torch.diff import SceneParams, apply_params, params_from_pack
from mcpt_tpu_torch.envmap import sample_env_chan
from mcpt_tpu_torch.intersect import intersect_c, occlude_t_c, surface_at_c
from mcpt_tpu_torch.kernels import wavefront as WF
from mcpt_tpu_torch.kernels import wavefront_ref as ref
from mcpt_tpu_torch.kernels.megakernel_ref import _dot, _neg, _reflect, _where3
from mcpt_tpu_torch.kernels.megakernel_ref import sqrt_f32 as _sqrt
from mcpt_tpu_torch.lights import sample_light_c
from mcpt_tpu_torch.materials import make_light_material, standard_materials
from mcpt_tpu_torch.scene import Sphere, TriangleMesh, pack_to
from test_torch_bvh_walk import chain_pack
from test_torch_wavefront_render import _agree

SKY = "assets/sky.png"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch's CPU thread pool costs far more than it saves at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The integrator before the split into kernels, frozen (integrator.py as of
# the parent of this file's commit): the bitwise reference of the split.
# ---------------------------------------------------------------------------


def _env(pack, d, chan):
    bg = tuple(float(b) for b in pack.background)
    return sample_env_chan(pack.env_pixels, bg, pack.use_env, d, chan)


def _frozen_direct_lighting_c(pack, key, wo, p, n, uv, m, lam, chan, is_reflect, method):
    b = p[0].shape[0]
    if pack.n_emitters == 0:
        return torch.zeros(b, dtype=torch.float32, device=p[0].device)
    s = pack.n_dir_sample
    u = prng.uniform(key, (s * b, 4))
    ls = sample_light_c(pack, u, chan.expand(s, b).reshape(-1))
    lp = tuple(x.reshape(s, b) for x in ls.p)
    ln = tuple(x.reshape(s, b) for x in ls.n)
    emit = ls.emit.reshape(s, b)
    lpdf = ls.pdf.reshape(s, b)
    delta = tuple(lp[k] - p[k] for k in range(3))
    dist = _sqrt(torch.clamp_min(_dot(delta, delta), 1e-20))
    inv_dist = 1.0 / dist
    ws = tuple(x * inv_dist for x in delta)
    if pack.enable_shadow:
        sh_t = occlude_t_c(pack, p, tuple(x.reshape(s * b) for x in ws), method=method,
                           fan=s).reshape(s, b)
        visible = sh_t >= dist - torch.clamp_min(REL_EPS * dist, EPSILON)
    else:
        visible = torch.ones((s, b), dtype=torch.bool, device=dist.device)
    ev = eval_bsdf_c(m, ws, wo, n, lam, uv, is_reflect)
    contrib = (
        emit * ev * _dot(ws, n) * -_dot(ws, ln) * (inv_dist * inv_dist)
        / lpdf / torch.full_like(lpdf, s)
    )
    contrib = torch.where(visible, contrib, 0.0)
    total = contrib[0]
    for k in range(1, s):
        total = total + contrib[k]
    return total


def _frozen_bounce(pack, o, d, hit, alive, depth, key, lam, chan, method):
    b = o[0].shape[0]
    kd = prng.fold_in(key, depth)
    surf = surface_at_c(pack, o, d, hit)
    happened = surf.happened
    wo = _neg(d)
    env_leaf = _env(pack, d, chan)
    m = gather_material(pack, surf.mat, chan)
    b_leaf = torch.clamp(m["emit"] * torch.abs(_dot(wo, surf.n)), 0.0, 1.0)
    is_b = happened & surf.emissive if depth == 0 else torch.zeros_like(happened)
    at_vertex = alive & happened & ~is_b
    xi = prng.uniform(prng.fold_in(kd, 0), (b, 4))
    mfn = sample_mfn_c(m, surf.n, xi[:, 0], xi[:, 1])
    kr = fresnel_c(m, d, mfn, lam)
    p = surf.p
    off_scale = torch.clamp_min(
        REL_EPS * torch.maximum(torch.abs(p[0]), torch.maximum(torch.abs(p[1]), torch.abs(p[2]))),
        EPSILON,
    )
    p_dl = tuple(p[k] + surf.n[k] * off_scale for k in range(3))
    inner = _dot(wo, surf.n) < 0.0
    l_dir_raw = _frozen_direct_lighting_c(
        pack, prng.fold_in(kd, 1), wo, p_dl, surf.n, surf.uv, m, lam, chan, ~inner, method
    )
    l_dir = torch.where(inner, 1.0 - kr, kr) * l_dir_raw
    rr_kill = xi[:, 2] >= float(pack.rr_rate)
    branch_reflect = xi[:, 3] < kr
    sign_reflect = torch.where(_dot(wo, mfn) < 0.0, -1.0, 1.0)
    sign = torch.where(branch_reflect, sign_reflect, -sign_reflect)
    p_new = tuple(p[k] + surf.n[k] * (off_scale * sign) for k in range(3))
    wi = _where3(branch_reflect, _reflect(wo, mfn), refract_c(m, d, mfn, lam))
    nxt = integrator._detach_hit(intersect_c(pack, p_new, wi, method=method))
    nprim = nxt.prim.to(torch.int64)
    nxt_emissive = (nprim >= 0) & (pack.prim_emissive[nprim.clamp(min=0), 0] > 0.5)
    inv_rr = float(pack.inv_rr)
    ev = eval_bsdf_c(m, wi, wo, surf.n, lam, surf.uv, branch_reflect)
    pv = pdf_c(m, wi, wo, surf.n, lam, branch_reflect)
    pv_ok = torch.abs(pv) > 1e-10
    w_rough = torch.where(
        pv_ok, ev * torch.abs(_dot(wo, surf.n)) / torch.where(pv_ok, pv, 1.0) * inv_rr, 0.0
    )
    w = torch.where(m["dirac"] > 0.5, ev * inv_rr, w_rough)
    cont = at_vertex & ~rr_kill & (nprim >= 0) & ~nxt_emissive
    env_ind = _env(pack, wi, chan) * ev * inv_rr
    leaf = torch.where(
        ~alive, 0.0,
        torch.where(~happened, env_leaf, torch.where(is_b, b_leaf, torch.where(
            rr_kill, l_dir,
            torch.clamp(l_dir, 0.0, CLAMP_DIRECT) + torch.clamp(env_ind, 0.0, CLAMP_INDIRECT)))),
    )
    shadow_rays = pack.n_dir_sample if pack.n_emitters else 0
    n_rays = at_vertex.sum() * (1 + shadow_rays)
    return (p_new, wi, nxt, cont), (l_dir, w, leaf, ~cont, n_rays)


def frozen_trace_paths_c(pack, o, d, lam, chan, key, max_bounces=8, method="auto"):
    b = o[0].shape[0]
    hit = integrator._detach_hit(intersect_c(pack, o, d, method=method))
    carry = (o, d, hit, torch.ones(b, dtype=torch.bool))
    l_dirs = torch.zeros((max_bounces, b), dtype=torch.float32)
    ws = torch.zeros_like(l_dirs)
    leaves = torch.zeros_like(l_dirs)
    terminals = torch.ones((max_bounces, b), dtype=torch.bool)
    rays = torch.zeros((), dtype=torch.int64)
    for depth in range(max_bounces):
        if not bool(carry[3].any()):
            break
        carry, rec = _frozen_bounce(pack, *carry, depth, key, lam, chan, method)
        l_dirs[depth], ws[depth], leaves[depth], terminals[depth] = rec[:4]
        rays = rays + rec[4]
    radiance = torch.zeros(b, dtype=torch.float32)
    for depth in range(max_bounces - 1, -1, -1):
        radiance = torch.where(
            terminals[depth], leaves[depth],
            torch.clamp(l_dirs[depth], 0.0, CLAMP_DIRECT)
            + torch.clamp(ws[depth] * radiance, 0.0, CLAMP_INDIRECT),
        )
    return radiance, rays + b


# ---------------------------------------------------------------------------
# Scenes and helpers
# ---------------------------------------------------------------------------


def _scene(name):
    if name == "demo":
        return demo_scene()
    if name == "demo sky":
        sc = demo_scene()
        sc.load_env_map(SKY)
        return sc
    if name == "x4 cornell":
        return cornell_x4(sky=True)
    if name == "demo emissive sphere":
        sc = demo_scene()
        sc.add(Sphere((200.0, 120.0, 300.0), 40.0, make_light_material(1.0), "lamp"))
        return sc
    raise ValueError(name)


def _lanes(sc, w, h, seed):
    cam = dataclasses.replace(sc.camera, width=w, height=h)
    o, d = WF.camera_rays(cam, torch.arange(w * h), prng.key(seed), 3)
    chan = torch.arange(3).repeat(w * h)
    lam = torch.tensor(WAVELEN_UM)[chan]
    return o, d, lam, chan


def _bits(x):
    return x.view(torch.int32)


def _jax_words(k):
    return torch.tensor(np.asarray(jax.random.key_data(k)).astype(np.int64))


# ---------------------------------------------------------------------------
# The per-index draws
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows,what", [(196, "vertex (B, 4)"), (4 * 196, "lights (S·B, 4), S 4"),
                                       (40 * 196, "lights (S·B, 4), S 40"),
                                       (96, "camera (P, 4)")])
def test_per_index_draws_bitwise(rows, what):
    """prng.uniform_at at the flat index 4·row + c equals prng.uniform(k,
    (rows, 4)) and jax.random.uniform bitwise, on the bounce's keys
    fold_in(fold_in(key, depth), 0 or 1) and a camera key."""
    jk, tk = jax.random.key(11), prng.key(11)
    jkd, tkd = jax.random.fold_in(jk, 3), prng.fold_in(tk, 3)
    for jkey, tkey in ((jax.random.fold_in(jkd, 0), prng.fold_in(tkd, 0)),
                       (jax.random.fold_in(jkd, 1), prng.fold_in(tkd, 1)),
                       (jax.random.split(jk)[0], prng.split(tk)[0])):
        np.testing.assert_array_equal(tkey.numpy(), _jax_words(jkey).numpy())
        idx = 4 * torch.arange(rows)[:, None] + torch.arange(4)
        got = prng.uniform_at(tkey, idx)
        want = np.asarray(jax.random.uniform(jkey, (rows, 4), dtype=jnp.float32))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32), what)
        assert torch.equal(_bits(got), _bits(prng.uniform(tkey, (rows, 4))))
        np.testing.assert_array_equal(prng.bits_at(tkey, idx).numpy(),
                                      prng.random_bits(tkey, (rows, 4)).numpy())


def test_host_keys_equal_the_device_keys():
    """The render's per-chunk and per-sample keys hashed on the host in
    Python ints equal fold_in and split on tensors, and JAX's."""
    jk, tk = jax.random.key(4), prng.key(4)
    words = tk.tolist()
    for tile, chunk in ((0, 0), (3, 1), (31, 7)):
        host = prng.host_fold_in(prng.host_fold_in(words, tile), chunk)
        assert list(host) == prng.fold_in(prng.fold_in(tk, tile), chunk).tolist()
        jkc = jax.random.fold_in(jax.random.fold_in(jk, tile), chunk)
        np.testing.assert_array_equal(np.asarray(host), _jax_words(jkc).numpy())
        samples = prng.host_split(host, 5)
        assert [list(x) for x in samples] == prng.split(torch.tensor(host), 5).tolist()
        for s, pair in enumerate(samples):
            assert [list(x) for x in prng.host_split(pair)] == prng.split(
                torch.tensor(pair)).tolist()


@pytest.mark.parametrize("dof", [False, True])
@pytest.mark.parametrize("per", [1, 3])
@pytest.mark.parametrize("w,h,first,pixels", [(9, 5, 0, 45), (9, 5, 0, 1), (9, 5, 0, 5),
                                              (9, 5, 0, 43), (1920, 1080, 3 * 65536, 43)])
def test_camera_rays_lanes_repeat_the_pixel_ray(w, h, first, pixels, per, dof):
    """The camera's plain version on the CPU (the wrapper's route) gives
    each of a pixel's `per` lanes the pixel's one ray, at pixel counts of
    1, 5 and 4k + 3 (lane counts that the card's 16-byte stores do not
    divide) and 45, and for a tile's ids at an offset (as `_render_tile`
    passes them); each ray is JAX's `generate_rays_c` on the same ids, as
    test_torch_wavefront.py holds it (bitwise through a pinhole; the thin
    lens's sin/cos and XLA's FMAs move its rays by a few ULPs)."""
    sc = demo_scene()
    cam = dataclasses.replace(sc.camera, width=w, height=h, use_dof=dof, focal_distance=800.0,
                              aperture_radius=8.0)
    ids = torch.arange(first, first + pixels)
    o, d = WF.camera_rays(cam, ids, prng.key(2), per)
    o1, d1 = WF.camera_rays(cam, ids, prng.key(2))
    for a, b in zip(o + d, o1 + d1):
        assert a.shape == (pixels * per,)
        assert torch.equal(_bits(a), _bits(b.repeat_interleave(per)))
    cam_j = dataclasses.replace(JB.demo_scene().camera, width=w, height=h, use_dof=dof,
                                focal_distance=800.0, aperture_radius=8.0)
    oj, dj = jax_generate_rays_c(cam_j, jnp.asarray(ids.numpy().astype(np.int32)),
                                 jax.random.key(2))
    for k in range(3):
        if dof:
            np.testing.assert_allclose(o1[k].numpy(), np.asarray(oj[k]), rtol=0, atol=1e-4)
            np.testing.assert_allclose(d1[k].numpy(), np.asarray(dj[k]), rtol=0, atol=2e-6)
        else:
            np.testing.assert_array_equal(o1[k].numpy(), np.asarray(oj[k]))
            np.testing.assert_array_equal(d1[k].numpy(), np.asarray(dj[k]))


# ---------------------------------------------------------------------------
# The split against the integrator before it, and against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["demo", "demo sky", "x4 cornell", "demo emissive sphere"])
@pytest.mark.parametrize("method", ["dense", "kernel"])
def test_split_bounce_bitwise_to_the_pre_split_integrator(name, method):
    """The four plain halves through `trace_paths_c` (routed as on the CPU)
    give the radiance and ray count of the integrator before the split, bit
    for bit; the wrapper counts every call under the route `plain` and
    launches nothing."""
    sc = _scene(name)
    pack = pack_to(sc.compile(), "cpu")
    o, d, lam, chan = _lanes(sc, 10, 8, 3)
    WF.reset_counts()
    got, st = integrator.trace_paths_c(pack, o, d, lam, chan, prng.key(7), max_bounces=5,
                                       method=method)
    want, rays = frozen_trace_paths_c(pack, o, d, lam, chan, prng.key(7), max_bounces=5,
                                      method=method)
    assert torch.equal(_bits(got), _bits(want))
    assert int(st.rays) == int(rays)
    assert float(got.abs().sum()) > 0.0
    assert not WF.launches
    assert {r for _, r in WF.calls} == {"plain"}
    assert WF.calls[("shade_pre", "plain")] == WF.calls[("shade_post", "plain")] >= 1


def test_split_at_forty_light_samples_bitwise():
    """S = 40 (the megakernels' generic count): 40 shadow rays a vertex in
    the fan, the S-sum from k = 0 up."""
    sc = demo_scene()
    sc.n_dir_sample = 40
    pack = pack_to(sc.compile(), "cpu")
    o, d, lam, chan = _lanes(sc, 6, 4, 5)
    got, st = integrator.trace_paths_c(pack, o, d, lam, chan, prng.key(9), max_bounces=4,
                                       method="kernel")
    want, rays = frozen_trace_paths_c(pack, o, d, lam, chan, prng.key(9), max_bounces=4,
                                      method="kernel")
    assert torch.equal(_bits(got), _bits(want)) and int(st.rays) == int(rays)


def test_split_without_shadows_or_emitters_bitwise():
    """enable_shadow False (no occlusion query: every sample visible) and a
    scene with no emitter (no light draws) through the split."""
    for mutate in ("no shadow", "no emitter"):
        sc = demo_scene()
        if mutate == "no shadow":
            sc.enable_shadow = False
        else:
            sc.meshes = [m for m in sc.meshes if not m.has_emit]
            sc.load_env_map(SKY)
        pack = pack_to(sc.compile(), "cpu")
        assert (pack.n_emitters == 0) == (mutate == "no emitter")
        o, d, lam, chan = _lanes(sc, 6, 4, 1)
        got, st = integrator.trace_paths_c(pack, o, d, lam, chan, prng.key(2), max_bounces=4,
                                           method="dense")
        want, rays = frozen_trace_paths_c(pack, o, d, lam, chan, prng.key(2), max_bounces=4,
                                          method="dense")
        assert torch.equal(_bits(got), _bits(want)) and int(st.rays) == int(rays), mutate


def test_halves_one_bounce_fields():
    """One bounce by hand: shade_pre's fan is S·B rays plane-major, its
    thresholds are below the light distance, shade_post writes only its
    depth's row and counts 1 + S rays a vertex."""
    sc = demo_scene()
    pack = pack_to(sc.compile(), "cpu")
    o, d, lam, chan = _lanes(sc, 4, 3, 8)
    b, s = o[0].shape[0], pack.n_dir_sample
    hit = intersect_c(pack, o, d, method="dense")
    alive = torch.ones(b, dtype=torch.bool)
    pre = ref.shade_pre(pack, o, d, hit, alive, 0, prng.key(1), lam, chan)
    assert all(x.shape == (s * b,) for x in (*pre.ws, pre.thr, pre.contrib))
    assert all(x.shape == (b,) for x in (*pre.p_new, *pre.wi, pre.fac, pre.w))
    norm = pre.ws[0] ** 2 + pre.ws[1] ** 2 + pre.ws[2] ** 2
    assert torch.allclose(norm, torch.ones_like(norm), atol=1e-5)
    sh_t = occlude_t_c(pack, pre.p_dl, pre.ws, method="dense", fan=s)
    nxt = intersect_c(pack, pre.p_new, pre.wi, method="dense")
    rec = ref.new_records(3, b, "cpu")
    rays = torch.zeros((), dtype=torch.int64)
    cont = ref.shade_post(pack, pre, sh_t, nxt.prim, rec, 1, rays)
    assert int(rays) == int(pre.at_vertex.sum()) * (1 + s)
    assert torch.equal(rec.terminal[1], ~cont)
    assert bool(rec.terminal[0].all() and rec.terminal[2].all())
    assert float(rec.leaf[0].abs().sum()) == 0.0 and float(rec.leaf[2].abs().sum()) == 0.0


def test_halves_ragged_lanes_bitwise_to_the_frozen_bounce():
    """At an odd lane count (15: on the card, shade_post's scalar
    instance, whose record rows at depth > 0 start off the vector's 8-byte
    grid), shade_post through its wrapper writes row 1 of three records
    bitwise as the pre-split integrator's bounce makes it, leaves rows 0
    and 2 as they were and counts its rays."""
    sc = demo_scene()
    pack = pack_to(sc.compile(), "cpu")
    o, d, lam, chan = _lanes(sc, 5, 1, 4)
    b, s = o[0].shape[0], pack.n_dir_sample
    assert b % WF.VECTOR_LANES != 0
    hit = integrator._detach_hit(intersect_c(pack, o, d, method="dense"))
    alive = torch.ones(b, dtype=torch.bool)
    key = prng.key(3)
    pre = WF.shade_pre(pack, o, d, hit, alive, 1, key, lam, chan)
    sh_t = occlude_t_c(pack, pre.p_dl, pre.ws, method="dense", fan=s)
    nxt = integrator._detach_hit(intersect_c(pack, pre.p_new, pre.wi, method="dense"))
    rec = ref.new_records(3, b, "cpu")
    rays = torch.full((), 5, dtype=torch.int64)
    cont = WF.shade_post(pack, pre, sh_t, nxt.prim, rec, 1, rays)
    (_, _, _, want_cont), want = _frozen_bounce(pack, o, d, hit, alive, 1, key, lam, chan,
                                                "dense")
    assert torch.equal(cont, want_cont)
    for k, f in enumerate(ref.Records._fields):
        assert torch.equal(getattr(rec, f)[1].view(torch.int32 if k < 3 else torch.bool),
                           want[k].view(torch.int32 if k < 3 else torch.bool)), f
    fresh = ref.new_records(3, b, "cpu")
    assert all(torch.equal(getattr(rec, f)[r], getattr(fresh, f)[r])
               for f in ref.Records._fields for r in (0, 2))
    assert int(rays) == 5 + int(want[4])


def _jax_fold(rec):
    """The reverse clamp scan of mcpt_tpu/integrator.py:347-360, as it
    writes it (a closure inside `trace_paths_c` there)."""
    from mcpt_tpu.constants import CLAMP_DIRECT as J_DIRECT
    from mcpt_tpu.constants import CLAMP_INDIRECT as J_INDIRECT

    def fold(l_next, r):
        l_dir, w, leaf, terminal = r
        l_here = jnp.where(
            terminal,
            leaf,
            jnp.clip(l_dir, 0.0, J_DIRECT)
            + jnp.clip(w * l_next, 0.0, J_INDIRECT),
        )
        return l_here, None

    b = rec["leaf"].shape[1]
    radiance, _ = jax.lax.scan(
        fold, jnp.zeros(b, jnp.float32),
        tuple(jnp.asarray(rec[k]) for k in ("l_dir", "w", "leaf", "terminal")), reverse=True)
    return np.asarray(radiance)


@pytest.mark.parametrize("depth", EDGE_DEPTHS)
@pytest.mark.parametrize("b", [1, 3, 5, 4097])
def test_fold_bitwise_to_jax_on_adversarial_records(depth, b):
    """`wavefront_ref.fold`, which the card's fold is held to, equals JAX's
    reverse scan bitwise on adversarial records (`chip_smoke.fold_records`:
    the first terminal depth at every depth and none, NaN, ±inf and ±1e30
    after it, the clamps' edges before it); nothing after a lane's first
    terminal depth reaches its value."""
    rec = fold_records(depth, b, 100 * depth + b)
    got = ref.fold(ref.Records(*(torch.from_numpy(rec[k]) for k in ref.Records._fields)))
    want = _jax_fold(rec)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    assert np.isfinite(want).all()


@pytest.mark.parametrize("name,method", [("demo sky", "dense"), ("demo emissive sphere", "dense")])
def test_split_trace_paths_within_jax_bounds(name, method):
    """Through the split, `trace_paths_c` against mcpt_tpu's jitted
    `trace_paths_c` with the same keys: the bounds of
    tests/test_torch_wavefront_render.py."""
    w, h, mb = 8, 8, 3
    sc_t = _scene(name)
    sc_j = JB.demo_scene()
    if name == "demo sky":
        sc_j.load_env_map(SKY)
    else:
        from mcpt_tpu.materials import make_light_material as jml
        from mcpt_tpu.scene import Sphere as JSphere
        sc_j.add(JSphere((200.0, 120.0, 300.0), 40.0, jml(1.0), "lamp"))
    o, d, lam, chan = _lanes(sc_t, w, h, 2)
    rows = lambda c: np.stack([x.numpy() for x in c], axis=1)
    jr, js = jax_trace_paths(sc_j.compile(), jnp.asarray(rows(o)), jnp.asarray(rows(d)),
                             jnp.asarray(lam.numpy()), jnp.asarray(chan.numpy().astype(np.int32)),
                             jax.random.key(5), max_bounces=mb, method=method)
    pack = pack_to(sc_t.compile(), "cpu")
    tr, ts = integrator.trace_paths_c(pack, o, d, lam, chan, prng.key(5), max_bounces=mb,
                                      method=method)
    _agree(tr.numpy(), np.asarray(jr), int(ts.rays), int(js.rays))


# ---------------------------------------------------------------------------
# Routes
# ---------------------------------------------------------------------------


def test_route_rule_as_a_function_of_device_and_grad():
    """Kernels on a CUDA device, plain versions on the CPU, with or without
    gradients (a pack that needs them takes the Functions around the same
    route); inside `plain_route()`, the plain versions on any device; autograd
    through the plain forward only inside `autograd_oracle()`."""
    host = demo_scene().compile()
    pack = pack_to(host, "cpu")
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert integrator.trace_route(pack, cuda) == "cuda"
    assert integrator.trace_route(pack, cpu) == "plain"
    with WF.plain_route():
        assert integrator.trace_route(pack, cuda) == "plain"
        assert integrator.trace_route(pack, cpu) == "plain"
    assert integrator.trace_route(pack, cuda) == "cuda"
    p = SceneParams(*(x.requires_grad_() for x in params_from_pack(host, "cpu")))
    live = apply_params(pack, p)
    assert integrator.trace_route(live, cuda) == "cuda"
    assert integrator.trace_route(live, cpu) == "plain"
    with WF.plain_route():
        assert integrator.trace_route(live, cuda) == "plain"
    with WF.autograd_oracle():
        assert integrator.trace_route(live, cuda) == "plain (autograd)"
        assert integrator.trace_route(live, cpu) == "plain (autograd)"
        assert integrator.trace_route(pack, cuda) == "cuda"
    with torch.no_grad():
        assert integrator.trace_route(live, cuda) == "cuda"
    with torch.inference_mode():
        assert integrator.trace_route(pack, cuda) == "cuda"
    with pytest.raises(ValueError, match="unsupported device"):
        WF.device_route("meta")


def test_autograd_route_counts_and_carries_gradients():
    """A render of grad-requiring parameters on the CPU runs the Functions
    on the plain route: the halves and the fold forward, their hand-written
    reverse modes backward, counted by name and route, and the gradients
    reach the parameters; inside `autograd_oracle()` the plain halves run
    under autograd instead, counted as `plain (autograd)`, to the same
    image."""
    from mcpt_tpu_torch.diff import render_lanes

    host = demo_scene().compile()
    pack = pack_to(host, "cpu")
    cam = dataclasses.replace(demo_scene().camera, width=4, height=3)
    fbs = []
    for oracle in (False, True):
        p = SceneParams(*(x.requires_grad_() for x in params_from_pack(host, "cpu")))
        WF.reset_counts()
        with WF.autograd_oracle() if oracle else contextlib.nullcontext():
            fb = render_lanes(apply_params(pack, p), cam, torch.arange(12), prng.key(3), spp=1,
                              max_bounces=3, method="dense")
            g = torch.autograd.grad(fb.sum(), [p.refl, p.light_scale])
        routes = {r for (name, r) in WF.calls if name != "camera_rays"}
        assert routes == {"plain (autograd)" if oracle else "plain"} and not WF.launches
        assert all(bool(torch.isfinite(x).all()) for x in g) and float(g[1]) != 0.0
        backward = {name for (name, r) in WF.calls if name.endswith("_bwd")}
        assert backward == (set() if oracle else set(WF.BWD_KERNELS))
        fbs.append(fb.detach())
    assert torch.equal(fbs[0], fbs[1])


def test_ran_since_reads_the_route_from_the_counts():
    """`render.ran_since` reports the routes the wrappers counted over a
    render: the plain versions on the CPU, no intersector kernel launch
    (the CPU's `auto` is `dense`); inside `plain_route()` the same."""
    from mcpt_tpu_torch.render import ran_since, render_radiance, wavefront_counts

    sc = demo_scene()
    cam = dataclasses.replace(sc.camera, width=4, height=3)
    before = wavefront_counts()
    render_radiance(sc, cam, 1, 0, max_bounces=2, device="cpu")
    assert ran_since(before) == "route plain, intersector kernel launches none"
    before = wavefront_counts()
    assert ran_since(before) == "route none, intersector kernel launches none"
    with WF.plain_route():
        render_radiance(sc, cam, 1, 0, max_bounces=2, device="cpu")
    assert ran_since(before) == "route plain, intersector kernel launches none"


def test_kernel_route_never_falls_back():
    """The kernel route asked for CPU tensors raises; the plain route on the
    CPU launches nothing."""
    sc = demo_scene()
    pack = pack_to(sc.compile(), "cpu")
    o, d, lam, chan = _lanes(sc, 2, 2, 0)
    hit = intersect_c(pack, o, d, method="dense")
    alive = torch.ones(12, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA tensors"):
        WF.shade_pre(pack, o, d, hit, alive, 0, prng.key(0), lam, chan, route="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        WF.camera_rays(sc.camera, torch.arange(4), prng.key(0), route="cuda")
    with pytest.raises(ValueError, match="unknown route"):
        WF.fold(ref.new_records(2, 12, "cpu"), route="triton")


# ---------------------------------------------------------------------------
# Big scenes: `auto` on the card takes the kernel's walk
# ---------------------------------------------------------------------------


@pytest.fixture
def fake_card(monkeypatch):
    """`intersect.wavefront_pack` as it runs for a CUDA device, on the CPU:
    packs move to the CPU and report the device type `cuda`; nothing is
    built."""
    real = I.pack_to
    built = []

    def moved(host, device, bvh=False, walk=False):
        pack = real(host, "cpu", bvh=bvh, walk=walk)
        return dataclasses.replace(pack, tri_sc=SimpleNamespace(device=torch.device(device)))

    monkeypatch.setattr(I, "pack_to", moved)
    monkeypatch.setattr(I, "load_library", lambda: built.append("intersect_prims"))
    return built


def _big_scene(tmp_path):
    """The DEMO with a lathe mesh of 4,480 triangles (4,512 in all, more
    than DENSE_MAX_TRIS), which gets a BVH."""
    sc = demo_scene()
    path = tmp_path / "big.obj"
    n = write_lathe_obj(path, 64, 36, 260.0, 80.0, (0.0, 0.0, 0.0), "soldier")
    assert n == 4480
    sc.add(TriangleMesh.from_obj(path, standard_materials()["rough_plastic"],
                                 translation=(140.0, 0.0, 440.0), name="big"))
    return sc


def test_auto_takes_the_walk_on_the_card_at_any_size(tmp_path, fake_card):
    host = _big_scene(tmp_path).compile()
    assert host.n_tris > I.DENSE_MAX_TRIS and host.use_bvh
    pack, method = I.wavefront_pack(host, "cuda")
    assert method == "kernel" and pack.walk is not None and pack.walk.depth <= BVH_STACK
    assert fake_card == ["intersect_prims"]
    assert I.resolve_method(pack, "auto") == "kernel"
    # the CPU's routes stay: dense up to 4096 padded triangles, bvh above
    assert I.resolve_method(pack_to(host, "cpu"), "auto") == "bvh"
    assert I.resolve_method(pack_to(demo_scene().compile(), "cpu"), "auto") == "dense"
    # an explicit bvh stays the eager walk
    pack_b, method_b = I.wavefront_pack(host, "cuda", "bvh")
    assert method_b == "bvh" and pack_b.walk is None and pack_b.bvh_fat is not None


def test_auto_refuses_a_deep_tree_naming_bvh(fake_card):
    """Nothing is refused any more: `auto` on the card walks a tree deeper
    than the kernel's local stack (the deep walk, its stack in device
    memory) as any other; an explicit bvh stays the eager walk."""
    deep = chain_pack(BVH_STACK + 1)
    pack, method = I.wavefront_pack(deep, "cuda")
    assert method == "kernel" and pack.walk is not None
    assert pack.walk.depth == BVH_STACK + 1 and fake_card == ["intersect_prims"]
    pack, method = I.wavefront_pack(deep, "cuda", "bvh")
    assert method == "bvh" and pack.walk is None
