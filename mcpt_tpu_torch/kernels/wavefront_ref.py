"""Plain PyTorch versions of the wavefront kernels (`csrc/wavefront.cu`):
the camera rays, the two halves of a bounce around the intersector, and the
reverse clamp fold. They replace no Pallas kernel: they are what XLA
compiles of `mcpt_tpu/camera.py:55-107` (`generate_rays_c`) and of
`mcpt_tpu/integrator.py:172-365` (`trace_paths_c`: its bounce body, with
`direct_lighting_c`, and its reverse fold) under `jit`.

Each function computes what its kernel computes, in the kernel's order:
one lane at a time in the kernel, all lanes at once here. The random
numbers are drawn per element at the flat index the kernel uses
(`prng.uniform_at`), which equals `prng.uniform(k, shape)` element for
element: the vertex draws (B, 4) at index 4i + c, the light draws (S·B, 4)
plane-major at 4(k·B + i) + c, the camera's (P, 4) at 4i + c.

A bounce is `shade_pre` (the surface, the material, the depth-0 emitter and
env leaves, the microfacet normal and Fresnel kr, the ε-offset points, the
S light samples with their shadow directions, visibility thresholds and
unshadowed contributions, roulette, the reflect/refract branch, the next
ray and its weight), then the intersector (the shadow fan and the next
ray's nearest hit), then `shade_post` (visibility, the NEE sum, `l_dir`,
`leaf`, `cont`, the depth's records and the ray count). `shade_pre`'s
arithmetic is `vertex_math` and `sample_math` on per-lane values, after a
discrete half of row gathers, draws and light picks.

The backward kernels' plain versions close the module: `shade_pre_bwd`
replays the reverse mode of `vertex_math` and `sample_math`, traced from
this very code by `lane_ad` (`vertex_program`, `sample_program`; the
kernel's C++ is generated from the same traces, `wavefront_lanes`), and
`shade_post_bwd` and `fold_bwd` are written out by hand. Autograd through
the forward functions here is the tests' oracle of them (the route
`plain (autograd)`).
"""

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from mcpt_tpu_torch import prng
from mcpt_tpu_torch.bsdf import eval_bsdf_c, fresnel_c, pdf_c, refract_c, sample_mfn_c
from mcpt_tpu_torch.constants import CLAMP_DIRECT, CLAMP_INDIRECT, EPSILON, REL_EPS
from mcpt_tpu_torch.envmap import sample_env_chan
from mcpt_tpu_torch.intersect import surface_math, surface_rows
from mcpt_tpu_torch.kernels import lane_ad
from mcpt_tpu_torch.kernels.megakernel_ref import (
    _dot,
    _neg,
    _reflect,
    _where3,
    fold_rows,
    mat_fields,
    mat_rows,
    take_rows,
)
from mcpt_tpu_torch.kernels.megakernel_ref import sqrt_f32 as _sqrt
from mcpt_tpu_torch.lights import light_point, pick


class PreOut(NamedTuple):
    """What `shade_pre` hands the intersector and `shade_post`, per lane
    (B,) unless noted; vectors are 3-tuples."""

    p_new: tuple  # the next ray's origin
    wi: tuple  # the next ray's direction
    p_dl: tuple  # the shadow fan's origin (the ε-offset point)
    ws: tuple  # 3 x (S·B,) shadow directions, ray k·B + i from p_dl[i]
    thr: torch.Tensor  # (S·B,) visible when the fan's t >= thr
    contrib: torch.Tensor  # (S·B,) a light sample's contribution if visible
    fac: torch.Tensor  # the Fresnel weight of the NEE sum: 1 - kr inside, kr outside
    leaf_pre: torch.Tensor  # the leaf of a lane that is no vertex: 0, env, or emitter
    env_c: torch.Tensor  # the clamped env term of a vertex's leaf
    w: torch.Tensor  # the indirect weight (the depth's `w` record)
    at_vertex: torch.Tensor  # bool: alive, hit, not the depth-0 emitter leaf
    rr_kill: torch.Tensor  # bool: Russian roulette ends the path here


class Records(NamedTuple):
    """The bounce loop's per-depth records, each (D, B)."""

    l_dir: torch.Tensor
    w: torch.Tensor
    leaf: torch.Tensor
    terminal: torch.Tensor  # bool


def new_records(depth: int, b: int, device) -> Records:
    """Records of `depth` bounces for `b` lanes: a depth the loop never
    reaches stays terminal with a zero leaf."""
    l_dir = torch.zeros((depth, b), dtype=torch.float32, device=device)
    return Records(l_dir, torch.zeros_like(l_dir), torch.zeros_like(l_dir),
                   torch.ones((depth, b), dtype=torch.bool, device=device))


def n_samples(pack) -> int:
    """Light samples (shadow rays) a vertex: none without emitters."""
    return pack.n_dir_sample if pack.n_emitters else 0


def _draws(key, rows: int, device):
    """The (rows, 4) uniforms of `prng.uniform(key, (rows, 4))`, each
    drawn at its own flat index."""
    idx = 4 * torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    return prng.uniform_at(key, idx + torch.arange(4, device=device))


def camera_rays(camera, pixel_ids, key, lanes_per_pixel: int = 1):
    """Primary rays of the flat pixel ids (row-major, i = id % W, j = id //
    W) with the draws of `prng.uniform(key, (P, 4))` (Renderer.cpp:44-76):
    pinhole, or a thin lens with r = R·sqrt(u2), θ = 2π·u3 and the focal
    point at (x, y, 1)·focal_distance. Each ray repeats for
    `lanes_per_pixel` consecutive lanes (the render's three channels).
    Returns (o, d), 3-tuples of (P·lanes_per_pixel,) float32; d is unit
    length."""
    w, h = camera.width, camera.height
    scale = float(np.float32(np.tan(np.deg2rad(camera.fov * 0.5))))
    aspect = float(np.float32(w / float(h)))
    om = camera.orientation().tolist()
    i = (pixel_ids % w).to(torch.float32)
    j = torch.div(pixel_ids, w, rounding_mode="floor").to(torch.float32)
    u = _draws(key, pixel_ids.shape[0], pixel_ids.device)
    # true division by tensors: CUDA torch multiplies by the reciprocal of
    # a Python scalar divisor, which rounds differently
    x = (1.0 - 2.0 * (i + u[:, 0]) / torch.full_like(i, w)) * aspect * scale
    y = (1.0 - 2.0 * (j + u[:, 1]) / torch.full_like(j, h)) * scale

    def rot(v):
        return tuple(om[k][0] * v[0] + om[k][1] * v[1] + om[k][2] * v[2] for k in range(3))

    if camera.use_dof:
        fd = float(np.float32(camera.focal_distance))
        r = float(np.float32(camera.aperture_radius)) * _sqrt(u[:, 2])
        theta = 2.0 * math.pi * u[:, 3]
        dx = r * torch.cos(theta)
        dy = r * torch.sin(theta)
        lens_w = rot((dx, dy, torch.zeros_like(dx)))
        origins = tuple(float(np.float32(camera.position[k])) + lens_w[k] for k in range(3))
        dirs = (x * fd - dx, y * fd - dy, torch.ones_like(x) * fd)
    else:
        dirs = (x, y, torch.ones_like(x))
        origins = tuple(torch.full_like(x, float(np.float32(camera.position[k]))) for k in range(3))
    inv = 1.0 / _sqrt(dirs[0] * dirs[0] + dirs[1] * dirs[1] + dirs[2] * dirs[2])
    d = rot(tuple(c * inv for c in dirs))
    if lanes_per_pixel != 1:
        origins = tuple(c.repeat_interleave(lanes_per_pixel) for c in origins)
        d = tuple(c.repeat_interleave(lanes_per_pixel) for c in d)
    return origins, d


def env_chan(pack, d, chan):
    """The env map (or the background) along d at each lane's channel."""
    bg = tuple(float(b) for b in pack.background)
    return sample_env_chan(pack.env_pixels, bg, pack.use_env, d, chan)


# ---------------------------------------------------------------------------
# shade_pre: its discrete half (row gathers, draws, light picks), then its
# arithmetic on per-lane values, `vertex_math` and `sample_math`, which the
# backward kernels' programs are traced from (`lane_programs`)
# ---------------------------------------------------------------------------

VERTEX_FLOATS = ("o0", "o1", "o2", "d0", "d1", "d2", "t", "u", "v", "lam",
                 *(f"ts{k}" for k in range(11)), *(f"ss{k}" for k in range(5)),
                 *(f"m{k}" for k in range(13)), *(f"xi{k}" for k in range(4)))
VERTEX_FLAGS = ("happened", "is_tri", "mat_ok", "alive", "is_b")
# the values of a vertex that its light samples read
SHARED_FLOATS = ("p_dl0", "p_dl1", "p_dl2", "n0", "n1", "n2", "wo0", "wo1", "wo2", "uv0", "uv1",
                 "lam", "mtype", "ior_a", "ior_b", "rough", "refl", "textured")
SAMPLE_FLOATS = (*(f"e{k}" for k in range(17)), "mesh_area", "lu2", "lu3")
# shade_pre's outputs that carry a gradient, in the backward seeds' order
RAY_OUT = ("p_new0", "p_new1", "p_new2", "wi0", "wi1", "wi2")
LEAF_OUT = ("fac", "leaf_pre", "env_c", "w")


def vertex_inputs(pack, o, d, hit, alive, depth: int, kd, lam, chan):
    """The per-lane inputs of `vertex_math` (names as VERTEX_FLOATS,
    VERTEX_FLAGS and `chan`) and the lanes' int64 material rows."""
    b = o[0].shape[0]
    happened, is_tri, ts, ss, mat, emissive = surface_rows(pack, hit)
    rows, ok, idx = mat_rows(pack.mat_fat, mat.float())
    xi = _draws(prng.fold_in(kd, 0), b, o[0].device)
    x = {"o0": o[0], "o1": o[1], "o2": o[2], "d0": d[0], "d1": d[1], "d2": d[2],
         "t": hit.t, "u": hit.u, "v": hit.v, "lam": lam, "chan": chan,
         "happened": happened, "is_tri": is_tri, "mat_ok": ok, "alive": alive,
         # the depth-0 emitter hit (Scene.cpp:102-107)
         "is_b": happened & emissive if depth == 0 else torch.zeros_like(happened)}
    x.update({f"ts{k}": ts[:, k] for k in range(11)})
    x.update({f"ss{k}": ss[:, k] for k in range(5)})
    x.update({f"m{k}": rows[:, k] for k in range(13)})
    x.update({f"xi{k}": xi[:, k] for k in range(4)})
    return x, idx


def vertex_math(x, prm, env):
    """The arithmetic of shade_pre but for its light samples, per lane:
    the surface (Scene.cpp:85-159 up to the ray queries), `x` the inputs of
    `vertex_inputs`, `prm` the scalars rr_rate and inv_rr, `env(d, chan)`
    the env term. Returns (outputs, shared): the PreOut fields but ws, thr
    and contrib as names (vectors by component), and what `sample_math`
    reads of the vertex (SHARED_FLOATS, `is_reflect`)."""
    o = (x["o0"], x["o1"], x["o2"])
    d = (x["d0"], x["d1"], x["d2"])
    lam, chan, happened = x["lam"], x["chan"], x["happened"]
    p, n, uv = surface_math(o, d, x["t"], x["u"], x["v"], happened, x["is_tri"],
                            [x[f"ts{k}"] for k in range(11)], [x[f"ss{k}"] for k in range(5)])
    wo = _neg(d)

    env_leaf = env(d, chan)  # miss: env/background (Scene.cpp:88-95)
    m = mat_fields([x[f"m{k}"] for k in range(13)], x["mat_ok"], chan)
    # depth-0 emitter hit (Scene.cpp:102-107)
    b_leaf = torch.clamp(m["emit"] * torch.abs(_dot(wo, n)), 0.0, 1.0)
    at_vertex = x["alive"] & happened & ~x["is_b"]

    # microfacet normal + Fresnel split (Scene.cpp:109-110)
    mfn = sample_mfn_c(m, n, x["xi0"], x["xi1"])
    kr = fresnel_c(m, d, mfn, lam)

    # NEE from the scale-relative ε-offset point (Scene.cpp:113-119)
    off_scale = torch.clamp_min(
        REL_EPS * torch.maximum(torch.abs(p[0]), torch.maximum(torch.abs(p[1]), torch.abs(p[2]))),
        EPSILON,
    )
    p_dl = tuple(p[k] + n[k] * off_scale for k in range(3))
    inner = _dot(wo, n) < 0.0
    fac = torch.where(inner, 1.0 - kr, kr)

    # Russian roulette + stochastic reflect/refract (Scene.cpp:121-159)
    rr_kill = x["xi2"] >= prm["rr_rate"]
    branch_reflect = x["xi3"] < kr
    sign_reflect = torch.where(_dot(wo, mfn) < 0.0, -1.0, 1.0)
    sign = torch.where(branch_reflect, sign_reflect, -sign_reflect)
    p_new = tuple(p[k] + n[k] * (off_scale * sign) for k in range(3))
    wi = _where3(branch_reflect, _reflect(wo, mfn), refract_c(m, d, mfn, lam))

    inv_rr = prm["inv_rr"]
    ev = eval_bsdf_c(m, wi, wo, n, lam, uv, branch_reflect)
    pv = pdf_c(m, wi, wo, n, lam, branch_reflect)
    # indirect weight (Scene.cpp:135-144,162-171), the reference's |wo·n|
    pv_ok = torch.abs(pv) > 1e-10
    w_rough = torch.where(
        pv_ok, ev * torch.abs(_dot(wo, n)) / torch.where(pv_ok, pv, 1.0) * inv_rr, 0.0
    )
    w = torch.where(m["dirac"] > 0.5, ev * inv_rr, w_rough)
    env_ind = env(wi, chan) * ev * inv_rr
    leaf_pre = torch.where(~x["alive"], 0.0, torch.where(~happened, env_leaf, b_leaf))
    out = {"fac": fac, "leaf_pre": leaf_pre, "env_c": torch.clamp(env_ind, 0.0, CLAMP_INDIRECT),
           "w": w, "at_vertex": at_vertex, "rr_kill": rr_kill}
    for name, vec in (("p_new", p_new), ("wi", wi), ("p_dl", p_dl)):
        out.update({f"{name}{k}": vec[k] for k in range(3)})
    shared = {f"p_dl{k}": p_dl[k] for k in range(3)}
    shared.update({f"n{k}": n[k] for k in range(3)})
    shared.update({f"wo{k}": wo[k] for k in range(3)})
    shared.update({"uv0": uv[0], "uv1": uv[1], "lam": lam, "is_reflect": ~inner})
    shared.update({k: m[k] for k in ("mtype", "ior_a", "ior_b", "rough", "refl", "textured")})
    return out, shared


def sample_inputs(pack, k_light, b: int, chan):
    """The per-sample inputs of `sample_math` (SAMPLE_FLOATS and `chan`,
    sample k of lane i at k·B + i, with the draws of uniform(k_light,
    (S·B, 4))) and the samples' int64 emitter rows."""
    s = n_samples(pack)
    u = _draws(k_light, s * b, chan.device)
    sel, mesh_area = pick(pack, u)
    rows = take_rows(pack.emt_fat, sel)
    x = {f"e{k}": rows[:, k] for k in range(17)}
    x.update({"mesh_area": mesh_area, "lu2": u[:, 2], "lu3": u[:, 3],
              "chan": chan.expand(s, b).reshape(-1)})
    return x, sel


def sample_math(x, s, spheres: bool):
    """The light-sample half of the NEE estimator (Scene.cpp:56-82) for one
    sample: the point on the picked emitter row, the shadow direction from
    p_dl, its visibility threshold and its contribution if visible,
    emit · eval · (ws·n) · (−ws·n_light) / dist² / pdf / s. `x` holds the
    vertex's shared values and the sample's inputs (broadcastable); returns
    (ws, thr, contrib)."""
    ls = light_point([x[f"e{k}"] for k in range(17)], x["mesh_area"], x["lu2"], x["lu3"],
                     x["chan"], spheres)
    p = (x["p_dl0"], x["p_dl1"], x["p_dl2"])
    n = (x["n0"], x["n1"], x["n2"])
    wo = (x["wo0"], x["wo1"], x["wo2"])
    m = {k: x[k] for k in ("mtype", "ior_a", "ior_b", "rough", "refl", "textured")}
    delta = tuple(ls.p[k] - p[k] for k in range(3))
    dist = _sqrt(torch.clamp_min(_dot(delta, delta), 1e-20))
    inv_dist = 1.0 / dist
    ws = tuple(c * inv_dist for c in delta)
    # no hit strictly closer than the light sample, by a relative margin
    thr = dist - torch.clamp_min(REL_EPS * dist, EPSILON)
    ev = eval_bsdf_c(m, ws, wo, n, x["lam"], (x["uv0"], x["uv1"]), x["is_reflect"])
    contrib = (
        ls.emit * ev * _dot(ws, n) * -_dot(ws, ls.n) * (inv_dist * inv_dist)
        / ls.pdf / torch.full_like(ls.pdf, s)
    )
    return ws, thr, contrib


def shade_pre(pack, o, d, hit, alive, depth: int, key, lam, chan) -> PreOut:
    """The first half of bounce `depth` for the lanes (o, d) with nearest
    hit `hit` (Scene.cpp:85-159 up to the two ray queries): `key` is the
    path key; the bounce draws from fold_in(fold_in(key, depth), 0) (B, 4)
    and fold_in(fold_in(key, depth), 1) (S·B, 4)."""
    b = o[0].shape[0]
    kd = prng.fold_in(key, depth)
    x, _ = vertex_inputs(pack, o, d, hit, alive, depth, kd, lam, chan)
    prm = {"rr_rate": float(pack.rr_rate), "inv_rr": float(pack.inv_rr)}
    out, shared = vertex_math(x, prm, lambda dd, ch: env_chan(pack, dd, ch))
    s = n_samples(pack)
    if s:
        xs, _ = sample_inputs(pack, prng.fold_in(kd, 1), b, chan)
        xs = {k: v.reshape(s, b) for k, v in xs.items()}
        ws, thr, contrib = sample_math({**shared, **xs}, s, bool(pack.n_sph_emitters))
        ws, thr, contrib = tuple(c.reshape(s * b) for c in ws), thr.reshape(-1), contrib.reshape(-1)
    else:
        empty = o[0].new_empty((0,))
        ws, thr, contrib = (empty, empty, empty), empty, empty
    return PreOut(
        p_new=tuple(out[f"p_new{k}"] for k in range(3)), wi=tuple(out[f"wi{k}"] for k in range(3)),
        p_dl=tuple(out[f"p_dl{k}"] for k in range(3)), ws=ws, thr=thr, contrib=contrib,
        fac=out["fac"], leaf_pre=out["leaf_pre"], env_c=out["env_c"], w=out["w"],
        at_vertex=out["at_vertex"], rr_kill=out["rr_kill"],
    )


def shade_post(pack, pre: PreOut, sh_t, nxt_prim, rec: Records, depth: int, rays):
    """The second half of bounce `depth`: the fan's visibility (`sh_t`, the
    occlusion query's t per shadow ray; None when shadows are off), the NEE
    sum over the samples from k = 0 up, `l_dir`, `leaf` (a roulette kill
    keeps the raw `l_dir`, Scene.cpp:129,156) and `cont` from the next
    ray's hit `nxt_prim`. Writes row `depth` of `rec`, adds the bounce's
    rays (1 + S a vertex) to `rays` (a 0-dim int64 tensor), and returns
    `cont`, the lanes still alive."""
    b = pre.fac.shape[0]
    s = n_samples(pack)
    if s:
        contrib = pre.contrib.reshape(s, b)
        if sh_t is not None:
            contrib = torch.where(sh_t.reshape(s, b) >= pre.thr.reshape(s, b), contrib, 0.0)
        total = contrib[0]
        for k in range(1, s):
            total = total + contrib[k]
    else:
        total = torch.zeros_like(pre.fac)
    l_dir = pre.fac * total

    nprim = nxt_prim.to(torch.int64)
    nxt_emissive = (nprim >= 0) & (pack.prim_emissive[nprim.clamp(min=0), 0] > 0.5)
    cont = pre.at_vertex & ~pre.rr_kill & (nprim >= 0) & ~nxt_emissive
    vertex_leaf = torch.where(
        pre.rr_kill,
        l_dir,  # raw early return (Scene.cpp:129,156)
        torch.clamp(l_dir, 0.0, CLAMP_DIRECT) + pre.env_c,
    )
    rec.l_dir[depth] = l_dir
    rec.w[depth] = pre.w
    rec.leaf[depth] = torch.where(pre.at_vertex, vertex_leaf, pre.leaf_pre)
    rec.terminal[depth] = ~cont
    rays += pre.at_vertex.sum() * (1 + s)
    return cont


def fold(rec: Records):
    """Radiance per lane from the records (Scene.cpp:180-183), the reverse
    fold reproducing the nested per-level clamps:
    L_d = terminal_d ? leaf_d : clamp15(l_dir_d) + clamp5(w_d · L_{d+1})."""
    radiance = torch.zeros_like(rec.leaf[0])
    for depth in range(rec.leaf.shape[0] - 1, -1, -1):
        radiance = torch.where(
            rec.terminal[depth],
            rec.leaf[depth],
            torch.clamp(rec.l_dir[depth], 0.0, CLAMP_DIRECT)
            + torch.clamp(rec.w[depth] * radiance, 0.0, CLAMP_INDIRECT),
        )
    return radiance


# ---------------------------------------------------------------------------
# The backward kernels' plain versions: the reverse mode of shade_pre (traced
# from vertex_math and sample_math, `lane_ad`), of shade_post and of fold
# ---------------------------------------------------------------------------


class LaneProgram(NamedTuple):
    """A traced lane program with its reverse: `tape` holds the forward's
    `n_fwd` ops, then the adjoint's; `outs` names forward values, `seeds`
    the seed inputs in seed order, `adj` each input's adjoint."""

    tape: lane_ad.Tape
    n_fwd: int
    outs: dict
    seeds: tuple
    adj: dict

    def split(self, wanted):
        """The live ops toward the values `wanted`: (the forward's, the
        adjoint's)."""
        ops = lane_ad.live_ops(self.tape, wanted)
        first = self.tape.ops[self.n_fwd].out
        return [op for op in ops if op.out < first], [op for op in ops if op.out >= first]


def _trace_inputs(tp, floats, flags=(), ints=()):
    x = {n: tp.input(n) for n in floats}
    x.update({n: tp.input(n, "b") for n in flags})
    x.update({n: tp.input(n, "i") for n in ints})
    return x


def _reversed(tp, outs, seed_names):
    n_fwd = len(tp.ops)
    seeds = [(outs[n], tp.input("g_" + n)) for n in seed_names]
    return LaneProgram(tp, n_fwd, outs, tuple(seed_names), lane_ad.reverse(tp, seeds))


@functools.lru_cache(maxsize=None)
def vertex_program(use_env: bool, ray: bool) -> LaneProgram:
    """`vertex_math` traced, with its reverse for the seeds of LEAF_OUT,
    RAY_OUT (with `ray`; the last bounce's next ray takes no gradient) and
    SHARED_FLOATS (the light samples' adjoints of the vertex's values).
    Parameters: rr_rate, inv_rr, and the map's env_h, env_w (`use_env`) or
    the background bg0-2; table: env."""
    tp = lane_ad.Tape()
    x = _trace_inputs(tp, VERTEX_FLOATS, VERTEX_FLAGS, ("chan",))
    prm = {"rr_rate": tp.param("rr_rate"), "inv_rr": tp.param("inv_rr")}
    if use_env:
        hw = (tp.param("env_h", "pi"), tp.param("env_w", "pi"))
        table = lane_ad.Table("env")

        def env(dd, ch):
            return sample_env_chan(table, None, True, dd, ch, hw=hw)
    else:
        bg = tuple(tp.param(f"bg{k}") for k in range(3))

        def env(dd, ch):
            return sample_env_chan(None, bg, False, dd, ch)
    out, shared = vertex_math(x, prm, env)
    outs = {**out, **{"sh_" + k: v for k, v in shared.items()}}
    seeds = (RAY_OUT if ray else ()) + LEAF_OUT + tuple("sh_" + k for k in shared_seeds())
    return _reversed(tp, outs, seeds)


def shared_seeds() -> tuple:
    """The vertex values (SHARED_FLOATS) that a light sample's reverse
    gives an adjoint."""
    got = set(sample_program(False).adj) | set(sample_program(True).adj)
    return tuple(n for n in SHARED_FLOATS if n in got and n != "lam")  # lam is an input


@functools.lru_cache(maxsize=None)
def sample_program(spheres: bool) -> LaneProgram:
    """`sample_math` traced for one (sample, lane), with its reverse for the
    contribution's seed. Parameter: s, the samples a vertex."""
    tp = lane_ad.Tape()
    x = _trace_inputs(tp, SHARED_FLOATS + SAMPLE_FLOATS, ("is_reflect",), ("chan",))
    ws, thr, contrib = sample_math(x, tp.param("s", "pi"), spheres)
    outs = {"ws0": ws[0], "ws1": ws[1], "ws2": ws[2], "thr": thr, "contrib": contrib}
    return _reversed(tp, outs, ("contrib",))


def _run(prog, env, wanted, like, tables, part):
    """Replay the live ops of `prog` toward `wanted` values: its forward
    (`part` 0) or its adjoint (1)."""
    return lane_ad.replay(prog.split(wanted)[part], env, like, tables)


def shade_pre_bwd(pack, o, d, hit, alive, depth: int, key, lam, chan, grads):
    """The reverse mode of `shade_pre` (the plain version of the backward
    kernel `shade_pre_bwd`): `grads` maps the names of RAY_OUT (all or
    none), LEAF_OUT and "contrib" ((S·B,)) to output gradients. Returns
    (g_o, g_d, g_mat, g_emt): the lanes' o and d adjoints (3-tuples of
    (B,)) and the gradients of `pack.mat_fat` and `pack.emt_fat`, their
    per-lane row adjoints folded into the tables by `fold_rows`.

    Every lane first recomputes its vertex (`vertex_program`'s forward), then
    each light sample k from 0 up runs forward and back (`sample_program`),
    its adjoints of the vertex's values summed in k order, then the vertex
    runs back with those sums and the output gradients as seeds."""
    b = o[0].shape[0]
    s = n_samples(pack)
    kd = prng.fold_in(key, depth)
    x, mat_idx = vertex_inputs(pack, o, d, hit, alive, depth, kd, lam, chan)
    ray = "p_new0" in grads
    vp = vertex_program(bool(pack.use_env), ray)
    tables = {"env": pack.env_pixels}
    prm = {"rr_rate": float(pack.rr_rate), "inv_rr": float(pack.inv_rr),
           "env_h": pack.env_pixels.shape[0], "env_w": pack.env_pixels.shape[1],
           **{f"bg{k}": float(pack.background[k]) for k in range(3)}}
    env = {v.id: x[n] for n, v in vp.tape.inputs.items() if not n.startswith("g_")}
    env.update({v.id: prm[n] for n, v in vp.tape.params.items()})
    wanted = [vp.adj[n] for n in ("o0", "o1", "o2", "d0", "d1", "d2",
                                  *(f"m{k}" for k in range(13))) if n in vp.adj]
    shared_names = (*SHARED_FLOATS, "is_reflect")
    _run(vp, env, wanted + [vp.outs["sh_" + n] for n in shared_names], x["t"], tables, 0)
    acc = {n: torch.zeros_like(x["t"]) for n in shared_seeds()}
    g_emt = pack.emt_fat.new_zeros((0, 17))
    sel = torch.zeros(0, dtype=torch.int64, device=x["t"].device)
    if s:
        xs, sel = sample_inputs(pack, prng.fold_in(kd, 1), b, chan)
        sp = sample_program(bool(pack.n_sph_emitters))
        senv = {sp.tape.inputs[n].id: env[vp.outs["sh_" + n].id].repeat(s)
                for n in shared_names}
        senv.update({sp.tape.inputs[n].id: v for n, v in xs.items()})
        senv[sp.tape.inputs["g_contrib"].id] = grads["contrib"]
        senv[sp.tape.params["s"].id] = s
        like = xs["lu2"]
        want_s = [sp.adj[n] for n in (*SHARED_FLOATS, *(f"e{k}" for k in range(17)))
                  if n in sp.adj]
        _run(sp, senv, want_s, like, tables, 0)
        _run(sp, senv, want_s, like, tables, 1)
        for n in acc:
            if n in sp.adj:
                a = senv[sp.adj[n].id].reshape(s, b)
                for k in range(s):
                    acc[n] = acc[n] + a[k]
        zero = torch.zeros_like(like)
        g_emt = torch.stack([senv[sp.adj[f"e{k}"].id] if f"e{k}" in sp.adj else zero
                             for k in range(17)], dim=1)
    for n in vp.seeds:
        env[vp.tape.inputs["g_" + n].id] = acc[n[3:]] if n.startswith("sh_") else grads[n]
    _run(vp, env, wanted, x["t"], tables, 1)
    zero = torch.zeros_like(x["t"])

    def adj(n):
        return env[vp.adj[n].id] if n in vp.adj else zero

    g_mat = torch.stack([adj(f"m{k}") for k in range(13)], dim=1)
    return (tuple(adj(f"o{k}") for k in range(3)), tuple(adj(f"d{k}") for k in range(3)),
            fold_rows(g_mat, mat_idx, pack.mat_fat.shape[0]),
            fold_rows(g_emt, sel, pack.emt_fat.shape[0]))


def shade_post_bwd(pre: PreOut, sh_t, s: int, g_l_dir, g_w, g_leaf):
    """The reverse mode of `shade_post` for the gradients of its record row
    (l_dir, w, leaf): (g_contrib (S·B,), g_fac, g_leaf_pre, g_env_c, g_w),
    each lane's in the kernel `shade_post_bwd`'s order."""
    b = pre.fac.shape[0]
    total = torch.zeros_like(pre.fac)
    vis = None
    if s:
        contrib = pre.contrib.reshape(s, b)
        if sh_t is not None:
            vis = sh_t.reshape(s, b) >= pre.thr.reshape(s, b)
            contrib = torch.where(vis, contrib, 0.0)
        total = contrib[0]
        for k in range(1, s):
            total = total + contrib[k]
    l_dir = pre.fac * total
    gv = torch.where(pre.at_vertex, g_leaf, 0.0)  # the vertex's leaf
    g_leaf_pre = torch.where(pre.at_vertex, 0.0, g_leaf)
    g_env_c = torch.where(pre.rr_kill, 0.0, gv)
    inside = (l_dir >= 0.0) & (l_dir <= CLAMP_DIRECT)
    g_l = (g_l_dir + torch.where(pre.rr_kill, gv, 0.0)
           + torch.where(inside & ~pre.rr_kill, gv, 0.0))
    g_fac = g_l * total
    g_total = g_l * pre.fac
    g_contrib = g_total.repeat(s)
    if vis is not None:
        g_contrib = torch.where(vis.reshape(-1), g_contrib, 0.0)
    return g_contrib, g_fac, g_leaf_pre, g_env_c, g_w


def fold_bwd(rec: Records, g):
    """The reverse mode of `fold` for the radiance gradient `g` (B,):
    (g_l_dir, g_w, g_leaf), each (D, B), autograd's formulas through every
    depth (a terminal depth passes nothing on)."""
    depth = rec.leaf.shape[0]
    radiance = torch.zeros_like(rec.leaf[0])
    nxt = [None] * depth
    for k in range(depth - 1, -1, -1):
        nxt[k] = radiance
        radiance = torch.where(
            rec.terminal[k],
            rec.leaf[k],
            torch.clamp(rec.l_dir[k], 0.0, CLAMP_DIRECT)
            + torch.clamp(rec.w[k] * radiance, 0.0, CLAMP_INDIRECT),
        )
    g_l_dir, g_w, g_leaf = [], [], []
    for k in range(depth):
        g_leaf.append(torch.where(rec.terminal[k], g, 0.0))
        gn = torch.where(rec.terminal[k], 0.0, g)
        inside = (rec.l_dir[k] >= 0.0) & (rec.l_dir[k] <= CLAMP_DIRECT)
        g_l_dir.append(torch.where(inside, gn, 0.0))
        z = rec.w[k] * nxt[k]
        gz = torch.where((z >= 0.0) & (z <= CLAMP_INDIRECT), gn, 0.0)
        g_w.append(gz * nxt[k])
        g = gz * rec.w[k]
    return torch.stack(g_l_dir), torch.stack(g_w), torch.stack(g_leaf)
