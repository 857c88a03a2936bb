"""Launch wrapper of the wavefront kernels `csrc/wavefront.cu` (the camera
rays, the two shading halves of a bounce around the intersector, and the
reverse clamp fold) and of their backward kernels `csrc/wavefront_bwd.cu`,
which replace no Pallas kernel but the XLA program of `mcpt_tpu`'s
`trace_paths_c` / `_render_tile` and its compiled backward under
`jax.value_and_grad` (see `wavefront_ref`, their plain versions).

Each function takes its plain version (`wavefront_ref`) for tensors on the
CPU and launches its kernel for tensors on a CUDA device; there is no
fallback between the two. Under grad mode, when `mat_fat` or `emt_fat` of
the pack (or the ray) requires grad, the two halves and the fold run as
`torch.autograd.Function`s (`ShadePre`, `ShadePost`, `Fold`) whose forward
is the same kernel (or plain version) and whose backward is the backward
kernel (or its plain version, the hand-written reverse mode on the CPU);
any other pack tensor that requires grad is refused. `route=` names a route
explicitly; inside `with plain_route():` every call without a `route=` runs
the plain versions on any device: the oracle the card's checks compare
with. The route `"plain (autograd)"` is autograd through the plain forward
ops, the tests' oracle of the hand-written reverse modes, taken only inside
`with autograd_oracle():` (or by an explicit `route=`). `launches[name]`
counts the kernel launches, and `calls[(name, route)]` every call by route,
which is where a render's route is read. `shade_post` comes in two
instances, `VECTOR_LANES` lanes a thread with one vector access a plane or
1 lane a thread, which its C entry picks by the lane count and the rows'
alignment and reports; `camera_rays` (one pixel a thread, its draws hashed
once) in two, `CAMERA_VECTOR` floats a store or 1, picked by the lane count
and the output planes' alignment; `by_instance[(kernel, lanes a thread or
floats a store)]` counts their launches by instance.
"""

import collections
import contextlib
import ctypes

import numpy as np
import torch

from mcpt_tpu_torch.intersect import Hit
from mcpt_tpu_torch.kernels import build as _build
from mcpt_tpu_torch.kernels import wavefront_ref as ref

SOURCE = _build.CSRC / "wavefront.cu"
BWD_SOURCE = _build.CSRC / "wavefront_bwd.cu"
KERNELS = ("camera_rays", "shade_pre", "shade_post", "fold")
BWD_KERNELS = ("shade_pre_bwd", "shade_post_bwd", "fold_bwd")
ROUTES = ("cuda", "plain", "plain (autograd)")
# the pack tensors a gradient may reach (`diff.apply_params` rebuilds them)
TRAINABLE = ("mat_fat", "emt_fat")
# the kernels whose C entries report the instance they launched (in a sixth
# argument: shade_post its lanes a thread, camera_rays the floats of its
# stores), and those of their vector instances: csrc/wavefront.cu's kLanes
# and kCamVec, repeated here for the checks that predict the instance
# (chip_smoke.edge_instance, camera_instance), which fail if the two drift
# apart; the other instance takes 1
INSTANCED = ("shade_post", "camera_rays")
VECTOR_LANES = 2
CAMERA_VECTOR = 4
# kernel launches by name, by instance, and calls by (name, route)
launches = collections.Counter()
by_instance = collections.Counter()
calls = collections.Counter()
_plain = False  # set inside `plain_route()`
_oracle = False  # set inside `autograd_oracle()`


def _bind(names):
    def bind(lib):
        for name in names:
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * (
                6 if name.removeprefix("mcpt_wf_") in INSTANCED else 5)
            fn.restype = ctypes.c_int

    return bind


def load_library(source=SOURCE):
    """Build (if needed) and load a kernel library (the forward's, or
    BWD_SOURCE's) once per process."""
    names = (("mcpt_wf_camera", "mcpt_wf_shade_pre", "mcpt_wf_shade_post", "mcpt_wf_fold")
             if source == SOURCE else
             ("mcpt_wf_shade_pre_bwd", "mcpt_wf_shade_post_bwd", "mcpt_wf_fold_bwd"))
    return _build.load(source, _bind(names))


def reset_counts():
    launches.clear()
    by_instance.clear()
    calls.clear()


@contextlib.contextmanager
def plain_route():
    """Within the block, calls without `route=` run the plain versions on
    every device (the oracle of the card's checks)."""
    global _plain
    was, _plain = _plain, True
    try:
        yield
    finally:
        _plain = was


@contextlib.contextmanager
def autograd_oracle():
    """Within the block, the integrator runs a pack that needs gradients
    through the plain forward ops under autograd (route `plain
    (autograd)`), the oracle of the hand-written reverse modes."""
    global _oracle
    was, _oracle = _oracle, True
    try:
        yield
    finally:
        _oracle = was


def oracle_active() -> bool:
    """Whether the caller is inside `autograd_oracle()`."""
    return _oracle


def needs_grad(pack, *xs) -> bool:
    """Grad mode is on and `mat_fat` or `emt_fat` of `pack`, or one of the
    tensors `xs`, requires grad; raises if another pack tensor does."""
    if not torch.is_grad_enabled():
        return False
    other = [k for k, v in vars(pack).items()
             if isinstance(v, torch.Tensor) and v.requires_grad and k not in TRAINABLE]
    if other:
        raise ValueError(f"pack tensors {other} require grad: the backward kernels reach only "
                         f"{TRAINABLE}")
    return any(getattr(pack, k).requires_grad for k in TRAINABLE) or any(
        x.requires_grad for x in xs)


def device_route(device) -> str:
    """The route of tensors on `device`: the kernel on a CUDA device, the
    plain version on the CPU or inside `plain_route()`."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return "plain" if _plain else "cuda"
    if dev.type == "cpu":
        return "plain"
    raise ValueError(f"unsupported device {dev}")


def _route(name, device, route):
    route = route or device_route(device)
    if route not in ROUTES:
        raise ValueError(f"unknown route {route!r}")
    if route == "cuda" and torch.device(device).type != "cuda":
        raise ValueError(f"{name}: the kernel route needs CUDA tensors, got {device}")
    calls[(name, route)] += 1
    return route


def _ptr(name, x, dev, dtype, shape=None):
    """The data pointer of `x`, checked: on `dev`, of `dtype`, contiguous,
    of `shape` where given."""
    if x.device != dev or x.dtype != dtype:
        raise ValueError(f"{name}: need {dtype} on {dev}, got {x.dtype} on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, need {tuple(shape)}")
    return x.data_ptr()


def _launch(fn_name, kernel, dev, ins, outs, ipar, fpar):
    """One call of the C entry `fn_name` on `dev`'s current stream; counts
    a launch of `kernel` where the entry made one (it makes none for zero
    lanes), and of the instance it reports (`INSTANCED`). A refused launch
    raises."""
    lib = load_library(BWD_SOURCE if kernel in BWD_KERNELS else SOURCE)
    in_p = (ctypes.c_void_p * len(ins))(*ins)
    out_p = (ctypes.c_void_p * len(outs))(*outs)
    ip = (ctypes.c_int * len(ipar))(*(int(v) for v in ipar))
    fp = (ctypes.c_float * max(len(fpar), 1))(*(float(v) for v in fpar))
    instanced = kernel in INSTANCED
    lanes = ctypes.c_int(0)
    extra = (ctypes.byref(lanes),) if instanced else ()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = getattr(lib, fn_name)(ctypes.cast(in_p, ctypes.c_void_p),
                                       ctypes.cast(out_p, ctypes.c_void_p),
                                       ctypes.cast(ip, ctypes.c_void_p),
                                       ctypes.cast(fp, ctypes.c_void_p), stream, *extra)
    if status < 0:
        raise RuntimeError(f"{kernel}: the kernel refuses its arguments ({status})")
    if status > 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {status}")
    if ipar[0] > 0:
        launches[kernel] += 1
    if lanes.value:
        by_instance[kernel, lanes.value] += 1


def _key_ptr(key, dev):
    return _ptr("key", key, dev, torch.int64, (2,))


def camera_rays(camera, pixel_ids, key, lanes_per_pixel: int = 1, route=None):
    """Primary rays of the flat pixel ids with the draws of
    `prng.uniform(key, (P, 4))`, each repeated for `lanes_per_pixel`
    consecutive lanes (`wavefront_ref.camera_rays`). Returns (o, d),
    3-tuples of (P·lanes_per_pixel,) float32. The kernel hashes each
    pixel's draws once and writes its ray to its lanes."""
    dev = pixel_ids.device
    if _route("camera_rays", dev, route) != "cuda":
        return ref.camera_rays(camera, pixel_ids, key, lanes_per_pixel)
    p = pixel_ids.shape[0]
    n = p * lanes_per_pixel
    if 4 * p >= 1 << 32:
        raise ValueError(f"{p} pixels: draw indices past 2^32")
    out = torch.empty((6, n), dtype=torch.float32, device=dev)
    # aspect, scale, the orientation's rows, position, focal distance, aperture
    fpar = [np.float32(camera.width / float(camera.height)),
            np.float32(np.tan(np.deg2rad(camera.fov * 0.5))),
            *camera.orientation().ravel().tolist(), *camera.position,
            camera.focal_distance, camera.aperture_radius]
    _launch("mcpt_wf_camera", "camera_rays", dev,
            [_ptr("pixel_ids", pixel_ids, dev, torch.int64), _key_ptr(key, dev)],
            [out[k].data_ptr() for k in range(6)],
            [p, lanes_per_pixel, camera.width, camera.height, int(bool(camera.use_dof))], fpar)
    return (out[0], out[1], out[2]), (out[3], out[4], out[5])


def _table(pack, name):
    return getattr(pack, name).detach().contiguous()


def _vertex_args(pack, o, d, hit, alive, depth, key, lam, chan):
    """The inputs, int and float parameters that `shade_pre` and
    `shade_pre_bwd` share (`csrc/wf_vertex.cuh` unpack_vtx): the lanes'
    ray, hit, flags, wavelength, channel and the path key's words, then the
    tables (the per-mesh ones of the light pick's searches among them)."""
    dev = o[0].device
    b = o[0].shape[0]
    s = ref.n_samples(pack)
    if 4 * max(s, 1) * b >= 1 << 32:
        raise ValueError(f"{s} light samples x {b} lanes: draw indices past 2^32")
    lanes = [("o0", o[0]), ("o1", o[1]), ("o2", o[2]), ("d0", d[0]), ("d1", d[1]),
             ("d2", d[2]), ("t", hit.t), ("prim", hit.prim), ("u", hit.u), ("v", hit.v),
             ("alive", alive), ("lam", lam), ("chan", chan.to(torch.int64))]
    types = {"prim": torch.int32, "alive": torch.bool, "chan": torch.int64}
    ins = [_ptr(k, x.detach(), dev, types.get(k, torch.float32), (b,)) for k, x in lanes]
    ins.append(_key_ptr(key, dev))
    tabs = {k: _table(pack, k) for k in ("tri_shade", "sph_shade", "mat_fat", "emt_fat",
                                          "emt_intra_cum", "lmesh_cum", "lmesh_area",
                                          "lmesh_first", "lmesh_count", "env_pixels")}
    cols = {"tri_shade": 11, "sph_shade": 5, "mat_fat": 13, "emt_fat": 17}
    for k, c in cols.items():
        ins.append(_ptr(k, tabs[k], dev, torch.float32, (tabs[k].shape[0], c)))
    e = tabs["emt_fat"].shape[0]
    m = tabs["lmesh_cum"].numel()
    ins.append(_ptr("emt_intra_cum", tabs["emt_intra_cum"], dev, torch.float32, (e,)))
    for k, dtype in (("lmesh_cum", torch.float32), ("lmesh_area", torch.float32),
                     ("lmesh_first", torch.int32), ("lmesh_count", torch.int32)):
        ins.append(_ptr(k, tabs[k], dev, dtype, (m,)))
    env = tabs["env_pixels"]
    ins.append(_ptr("env_pixels", env, dev, torch.float32, (env.shape[0], env.shape[1], 3)))
    ipar = [b, depth, pack.n_tris, tabs["tri_shade"].shape[0], tabs["sph_shade"].shape[0],
            tabs["mat_fat"].shape[0], e, m, s, pack.n_sph_emitters, int(bool(pack.use_env)),
            env.shape[0], env.shape[1]]
    fpar = [pack.emit_total_area, pack.rr_rate, pack.inv_rr, *pack.background]
    return ins, ipar, fpar


def shade_pre(pack, o, d, hit, alive, depth: int, key, lam, chan, route=None) -> ref.PreOut:
    """The first half of bounce `depth` (`wavefront_ref.shade_pre`): the
    kernel reads the path key's words from device memory and derives the
    bounce's keys itself. When gradients are wanted (`needs_grad`), the
    `ShadePre` Function around it."""
    dev = o[0].device
    route = _route("shade_pre", dev, route)
    if route == "plain (autograd)":
        return ref.shade_pre(pack, o, d, hit, alive, depth, key, lam, chan)
    if needs_grad(pack, *o, *d):
        out = ShadePre.apply(route, pack, depth, key, lam, chan, hit.t, hit.prim, hit.u, hit.v,
                             alive, *o, *d, pack.mat_fat, pack.emt_fat)
        return ref.PreOut(p_new=out[0:3], wi=out[3:6], p_dl=out[6:9], ws=out[9:12],
                          thr=out[12], contrib=out[13], fac=out[14], leaf_pre=out[15],
                          env_c=out[16], w=out[17], at_vertex=out[18], rr_kill=out[19])
    return _shade_pre(route, pack, o, d, hit, alive, depth, key, lam, chan)


def _shade_pre(route, pack, o, d, hit, alive, depth, key, lam, chan) -> ref.PreOut:
    if route != "cuda":
        return ref.shade_pre(pack, o, d, hit, alive, depth, key, lam, chan)
    dev = o[0].device
    b = o[0].shape[0]
    s = ref.n_samples(pack)
    ins, ipar, fpar = _vertex_args(pack, o, d, hit, alive, depth, key, lam, chan)
    f = torch.empty((13, b), dtype=torch.float32, device=dev)
    fan = torch.empty((5, s * b), dtype=torch.float32, device=dev)
    flags = torch.empty((2, b), dtype=torch.bool, device=dev)
    outs = [f[k].data_ptr() for k in range(9)] + [fan[k].data_ptr() for k in range(5)]
    outs += [f[k].data_ptr() for k in range(9, 13)] + [flags[0].data_ptr(), flags[1].data_ptr()]
    _launch("mcpt_wf_shade_pre", "shade_pre", dev, ins, outs, ipar, fpar)
    return ref.PreOut(
        p_new=(f[0], f[1], f[2]), wi=(f[3], f[4], f[5]), p_dl=(f[6], f[7], f[8]),
        ws=(fan[0], fan[1], fan[2]), thr=fan[3], contrib=fan[4], fac=f[9], leaf_pre=f[10],
        env_c=f[11], w=f[12], at_vertex=flags[0], rr_kill=flags[1],
    )


def shade_post(pack, pre: ref.PreOut, sh_t, nxt_prim, rec: ref.Records, depth: int, rays,
               route=None):
    """The second half of bounce `depth` (`wavefront_ref.shade_post`):
    writes row `depth` of `rec`, adds the bounce's rays to `rays` (the
    kernel: an integer block sum, then one atomicAdd a block) and returns
    the lanes still alive. No gradient: see `shade_post_row`."""
    route = _route("shade_post", pre.fac.device, route)
    return _shade_post(route, pack, pre, sh_t, nxt_prim, rec, depth, rays)


def shade_post_row(pack, pre: ref.PreOut, sh_t, nxt_prim, rays, route=None):
    """`shade_post` with gradients (the `ShadePost` Function): returns
    (alive, the depth's record row, a `Records` of (B,) tensors), since a
    Function cannot write into records that autograd follows."""
    route = _route("shade_post", pre.fac.device, route)
    l_dir, w, leaf, terminal, alive = ShadePost.apply(
        route, pack, sh_t, pre.thr, pre.at_vertex, pre.rr_kill, nxt_prim, [rays],
        pre.contrib, pre.fac, pre.leaf_pre, pre.env_c, pre.w)
    return alive, ref.Records(l_dir, w, leaf, terminal)


def _shade_post(route, pack, pre, sh_t, nxt_prim, rec, depth, rays):
    dev = pre.fac.device
    if route != "cuda":
        return ref.shade_post(pack, pre, sh_t, nxt_prim, rec, depth, rays)
    b = pre.fac.shape[0]
    s = ref.n_samples(pack)
    emissive = _table(pack, "prim_emissive")
    ins = [0 if sh_t is None else _ptr("sh_t", sh_t.detach(), dev, torch.float32, (s * b,))]
    ins += [_ptr(k, getattr(pre, k), dev, torch.float32, (s * b,)) for k in ("thr", "contrib")]
    ins += [_ptr(k, getattr(pre, k), dev, torch.float32, (b,))
            for k in ("fac", "leaf_pre", "env_c", "w")]
    ins += [_ptr(k, getattr(pre, k), dev, torch.bool, (b,)) for k in ("at_vertex", "rr_kill")]
    ins.append(_ptr("nxt_prim", nxt_prim, dev, torch.int32, (b,)))
    ins.append(_ptr("prim_emissive", emissive, dev, torch.float32))
    if not 0 <= depth < rec.leaf.shape[0]:
        raise ValueError(f"depth {depth} outside the records' {rec.leaf.shape[0]}")
    rows = [(k, getattr(rec, k), torch.bool if k == "terminal" else torch.float32)
            for k in ("l_dir", "w", "leaf", "terminal")]
    for k, x, dt in rows:
        _ptr(k, x, dev, dt, (rec.leaf.shape[0], b))
    alive = torch.empty(b, dtype=torch.bool, device=dev)
    outs = [x[depth].data_ptr() for _, x, _ in rows]
    outs += [alive.data_ptr(), _ptr("rays", rays, dev, torch.int64, ())]
    _launch("mcpt_wf_shade_post", "shade_post", dev, ins, outs, [b, s, emissive.shape[0]], [])
    return alive


def fold(rec: ref.Records, route=None):
    """Radiance per lane from the records (`wavefront_ref.fold`); the `Fold`
    Function when they carry gradients."""
    route = _route("fold", rec.leaf.device, route)
    if route != "plain (autograd)" and torch.is_grad_enabled() and any(
            x.requires_grad for x in (rec.l_dir, rec.w, rec.leaf)):
        return Fold.apply(route, rec.l_dir, rec.w, rec.leaf, rec.terminal)
    return _fold(route, rec)


def _fold(route, rec):
    dev = rec.leaf.device
    if route != "cuda":
        return ref.fold(rec)
    depth, b = rec.leaf.shape
    ins = [_ptr(k, getattr(rec, k), dev, torch.bool if k == "terminal" else torch.float32,
                (depth, b)) for k in ("l_dir", "w", "leaf", "terminal")]
    out = torch.empty(b, dtype=torch.float32, device=dev)
    _launch("mcpt_wf_fold", "fold", dev, ins, [out.data_ptr()], [b, depth], [])
    return out


def stack_records(rows, depth: int, b: int, device) -> ref.Records:
    """The (D, B) records from the rows of the depths traced (`rows`, each a
    `Records` of (B,) tensors); depths not reached stay terminal with a
    zero leaf, as in `wavefront_ref.new_records`."""
    rest = ref.new_records(depth - len(rows), b, device)
    return ref.Records(*(torch.cat([torch.stack([getattr(r, f) for r in rows]), getattr(rest, f)])
                         if rows else getattr(rest, f) for f in ref.Records._fields))


# ---------------------------------------------------------------------------
# The backward kernels and the Functions that launch them
# ---------------------------------------------------------------------------


def _zeros_for(grads, like, n):
    """The gradients, a (n,) zero tensor like `like` for each that is None."""
    return [like.new_zeros(n) if g is None else g.contiguous() for g in grads]


def shade_pre_bwd(pack, o, d, hit, alive, depth: int, key, lam, chan, grads, route=None):
    """The reverse mode of `shade_pre` (`wavefront_ref.shade_pre_bwd`, whose
    `grads` and result it takes and gives): the kernel writes each lane's o
    and d adjoints, its material row's adjoint and each light sample's
    emitter row's adjoint; `megakernel_ref.fold_rows` folds the rows into
    the tables' gradients in a fixed order."""
    dev = o[0].device
    route = _route("shade_pre_bwd", dev, route)
    if route != "cuda":
        return ref.shade_pre_bwd(pack, o, d, hit, alive, depth, key, lam, chan, grads)
    g_o, g_d, g_mat, mat_row, g_emt, emt_row = shade_pre_bwd_rows(
        pack, o, d, hit, alive, depth, key, lam, chan, grads)
    return (g_o, g_d, ref.fold_rows(g_mat, mat_row, pack.mat_fat.shape[0]),
            ref.fold_rows(g_emt, emt_row, pack.emt_fat.shape[0]))


def shade_pre_bwd_rows(pack, o, d, hit, alive, depth: int, key, lam, chan, grads):
    """The launch of the kernel `shade_pre_bwd` alone: (g_o, g_d, the
    lanes' material-row adjoints (B, 13), their rows (B,), the samples'
    emitter-row adjoints (S·B, 17), their rows (S·B,))."""
    dev = o[0].device
    b = o[0].shape[0]
    s = ref.n_samples(pack)
    ins, ipar, fpar = _vertex_args(pack, o, d, hit, alive, depth, key, lam, chan)
    ray = "p_new0" in grads
    ins += [_ptr(k, grads[k], dev, torch.float32, (b,)) if ray else 0 for k in ref.RAY_OUT]
    ins += [_ptr(k, grads[k], dev, torch.float32, (b,)) for k in ref.LEAF_OUT]
    ins.append(_ptr("contrib", grads["contrib"], dev, torch.float32, (s * b,)) if s else 0)
    g = torch.empty((6, b), dtype=torch.float32, device=dev)
    g_mat = torch.empty((b, 13), dtype=torch.float32, device=dev)
    mat_row = torch.empty(b, dtype=torch.int64, device=dev)
    g_emt = torch.empty((s * b, 17), dtype=torch.float32, device=dev)
    emt_row = torch.empty(s * b, dtype=torch.int64, device=dev)
    outs = [g[k].data_ptr() for k in range(6)]
    outs += [g_mat.data_ptr(), mat_row.data_ptr(), g_emt.data_ptr(), emt_row.data_ptr()]
    _launch("mcpt_wf_shade_pre_bwd", "shade_pre_bwd", dev, ins, outs, ipar, fpar)
    return (g[0], g[1], g[2]), (g[3], g[4], g[5]), g_mat, mat_row, g_emt, emt_row


def shade_post_bwd(pre: ref.PreOut, sh_t, s: int, g_l_dir, g_w, g_leaf, route=None):
    """The reverse mode of `shade_post` (`wavefront_ref.shade_post_bwd`):
    (g_contrib, g_fac, g_leaf_pre, g_env_c, g_w)."""
    dev = pre.fac.device
    route = _route("shade_post_bwd", dev, route)
    if route != "cuda":
        return ref.shade_post_bwd(pre, sh_t, s, g_l_dir, g_w, g_leaf)
    b = pre.fac.shape[0]
    ins = [0 if sh_t is None or not s else _ptr("sh_t", sh_t.detach(), dev, torch.float32,
                                                 (s * b,))]
    ins += [_ptr(k, getattr(pre, k).detach(), dev, torch.float32, (n,))
            for k, n in (("thr", s * b), ("contrib", s * b), ("fac", b))]
    ins += [_ptr(k, getattr(pre, k), dev, torch.bool, (b,)) for k in ("at_vertex", "rr_kill")]
    ins += [_ptr(k, x, dev, torch.float32, (b,))
            for k, x in (("g_l_dir", g_l_dir), ("g_w", g_w), ("g_leaf", g_leaf))]
    out = torch.empty((4, b), dtype=torch.float32, device=dev)
    g_contrib = torch.empty(s * b, dtype=torch.float32, device=dev)
    outs = [g_contrib.data_ptr()] + [out[k].data_ptr() for k in range(4)]
    _launch("mcpt_wf_shade_post_bwd", "shade_post_bwd", dev, ins, outs, [b, s], [])
    return g_contrib, out[0], out[1], out[2], out[3]


def fold_bwd(rec: ref.Records, g, route=None):
    """The reverse mode of `fold` (`wavefront_ref.fold_bwd`): (g_l_dir,
    g_w, g_leaf), each (D, B)."""
    dev = rec.leaf.device
    route = _route("fold_bwd", dev, route)
    if route != "cuda":
        return ref.fold_bwd(rec, g)
    depth, b = rec.leaf.shape
    ins = [_ptr(k, getattr(rec, k).detach(), dev,
                torch.bool if k == "terminal" else torch.float32, (depth, b))
           for k in ("l_dir", "w", "leaf", "terminal")]
    ins.append(_ptr("g", g, dev, torch.float32, (b,)))
    out = torch.empty((3, depth, b), dtype=torch.float32, device=dev)
    _launch("mcpt_wf_fold_bwd", "fold_bwd", dev, ins, [out[k].data_ptr() for k in range(3)],
            [b, depth], [])
    return out[0], out[1], out[2]


class ShadePre(torch.autograd.Function):
    """`shade_pre` with its reverse mode: the forward kernel (or plain
    version), then `shade_pre_bwd` from the bounce's saved inputs (the ray,
    the hit, the flags and the key: about 60 bytes a lane, no
    intermediate). Differentiable inputs: the ray (o, d) and the tables
    mat_fat and emt_fat; outputs without a gradient: p_dl, ws, thr (they
    reach only the detached intersector and its comparison), the flags."""

    @staticmethod
    def forward(ctx, route, pack, depth, key, lam, chan, t, prim, u, v, alive, o0, o1, o2, d0,
                d1, d2, mat_fat, emt_fat):
        hit = Hit(t=t, prim=prim, u=u, v=v)
        pre = _shade_pre(route, pack, (o0, o1, o2), (d0, d1, d2), hit, alive, depth, key, lam,
                         chan)
        ctx.save_for_backward(t, prim, u, v, alive, lam, chan, key, o0, o1, o2, d0, d1, d2)
        ctx.route, ctx.pack, ctx.depth = route, pack, depth
        ctx.set_materialize_grads(False)
        out = (*pre.p_new, *pre.wi, *pre.p_dl, *pre.ws, pre.thr, pre.contrib, pre.fac,
               pre.leaf_pre, pre.env_c, pre.w, pre.at_vertex, pre.rr_kill)
        ctx.mark_non_differentiable(*out[6:13], *out[18:])
        return out

    @staticmethod
    def backward(ctx, *g):
        t, prim, u, v, alive, lam, chan, key, *od = ctx.saved_tensors
        b = t.shape[0]
        grads = {}
        if any(x is not None for x in g[0:6]):
            grads.update(zip(ref.RAY_OUT, _zeros_for(g[0:6], t, b)))
        grads.update(zip(ref.LEAF_OUT, _zeros_for(g[14:18], t, b)))
        grads["contrib"] = _zeros_for(g[13:14], t, ref.n_samples(ctx.pack) * b)[0]
        g_o, g_d, g_mat, g_emt = shade_pre_bwd(ctx.pack, od[0:3], od[3:6],
                                               Hit(t=t, prim=prim, u=u, v=v), alive, ctx.depth,
                                               key, lam, chan, grads, route=ctx.route)
        need = ctx.needs_input_grad
        ins = (*g_o, *g_d, g_mat, g_emt)
        return (None,) * 11 + tuple(x if need[11 + k] else None for k, x in enumerate(ins))


class ShadePost(torch.autograd.Function):
    """`shade_post` with its reverse mode, on a record row of its own: the
    forward kernel (or plain version) writes the depth's (l_dir, w, leaf,
    terminal) rows and the live lanes; `shade_post_bwd` takes the rows'
    gradients back to the contributions, fac, leaf_pre, env_c and w."""

    @staticmethod
    def forward(ctx, route, pack, sh_t, thr, at_vertex, rr_kill, nxt_prim, rays, contrib, fac,
                leaf_pre, env_c, w):
        b = fac.shape[0]
        rec = ref.new_records(1, b, fac.device)
        pre = ref.PreOut(p_new=None, wi=None, p_dl=None, ws=None, thr=thr, contrib=contrib,
                         fac=fac, leaf_pre=leaf_pre, env_c=env_c, w=w, at_vertex=at_vertex,
                         rr_kill=rr_kill)
        alive = _shade_post(route, pack, pre, sh_t, nxt_prim, rec, 0, rays[0])
        ctx.save_for_backward(sh_t, thr, contrib, fac, at_vertex, rr_kill)
        ctx.route, ctx.s = route, ref.n_samples(pack)
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(rec.terminal[0], alive)
        return rec.l_dir[0], rec.w[0], rec.leaf[0], rec.terminal[0], alive

    @staticmethod
    def backward(ctx, g_l_dir, g_w, g_leaf, _terminal, _alive):
        sh_t, thr, contrib, fac, at_vertex, rr_kill = ctx.saved_tensors
        pre = ref.PreOut(p_new=None, wi=None, p_dl=None, ws=None, thr=thr, contrib=contrib,
                         fac=fac, leaf_pre=None, env_c=None, w=None, at_vertex=at_vertex,
                         rr_kill=rr_kill)
        g_l_dir, g_w, g_leaf = _zeros_for((g_l_dir, g_w, g_leaf), fac, fac.shape[0])
        g = shade_post_bwd(pre, sh_t, ctx.s, g_l_dir, g_w, g_leaf, route=ctx.route)
        return (None,) * 8 + tuple(g)


class Fold(torch.autograd.Function):
    """`fold` with its reverse mode `fold_bwd`, from the saved records."""

    @staticmethod
    def forward(ctx, route, l_dir, w, leaf, terminal):
        rec = ref.Records(l_dir, w, leaf, terminal)
        ctx.save_for_backward(l_dir, w, leaf, terminal)
        ctx.route = route
        return _fold(route, rec)

    @staticmethod
    def backward(ctx, g):
        rec = ref.Records(*ctx.saved_tensors)
        return (None, *fold_bwd(rec, g.contiguous(), route=ctx.route), None)
