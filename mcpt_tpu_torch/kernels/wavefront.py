"""Launch wrapper of the wavefront kernels `csrc/wavefront.cu` (the camera
rays, the two shading halves of a bounce around the intersector, and the
reverse clamp fold), which replace no Pallas kernel but the XLA program of
`mcpt_tpu`'s `trace_paths_c` / `_render_tile` (see `wavefront_ref`, their
plain versions).

Each function takes its plain version (`wavefront_ref`) for tensors on the
CPU and launches its kernel for tensors on a CUDA device; there is no
fallback between the two. `route=` names a route explicitly: the training
path's rule, `"plain (autograd)"`, which `integrator.trace_paths_c` takes
when a pack tensor requires grad under grad mode (the kernels have no
backward yet). Inside `with plain_route():` every call without a `route=`
runs the plain version on any device: the oracle the card's checks compare
with. `launches[name]` counts the kernel launches, and `calls[(name,
route)]` every call by route, which is where a render's route is read.
"""

import collections
import contextlib
import ctypes

import numpy as np
import torch

from mcpt_tpu_torch.kernels import build as _build
from mcpt_tpu_torch.kernels import wavefront_ref as ref

SOURCE = _build.CSRC / "wavefront.cu"
KERNELS = ("camera_rays", "shade_pre", "shade_post", "fold")
ROUTES = ("cuda", "plain", "plain (autograd)")
# kernel launches by name, and calls by (name, route)
launches = collections.Counter()
calls = collections.Counter()
_plain = False  # set inside `plain_route()`


def build(verbose: bool = False):
    """Compile csrc/wavefront.cu if no library for this source exists; with
    `verbose`, print each kernel's registers and spills."""
    return _build.build(SOURCE, verbose)


def _bind(lib):
    for name in ("mcpt_wf_camera", "mcpt_wf_shade_pre", "mcpt_wf_shade_post", "mcpt_wf_fold"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 5
        fn.restype = ctypes.c_int


def load_library():
    """Build (if needed) and load the kernel library once per process."""
    return _build.load(SOURCE, _bind)


def reset_counts():
    launches.clear()
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
    lanes). A refused launch raises."""
    lib = load_library()
    in_p = (ctypes.c_void_p * len(ins))(*ins)
    out_p = (ctypes.c_void_p * len(outs))(*outs)
    ip = (ctypes.c_int * len(ipar))(*(int(v) for v in ipar))
    fp = (ctypes.c_float * max(len(fpar), 1))(*(float(v) for v in fpar))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = getattr(lib, fn_name)(ctypes.cast(in_p, ctypes.c_void_p),
                                       ctypes.cast(out_p, ctypes.c_void_p),
                                       ctypes.cast(ip, ctypes.c_void_p),
                                       ctypes.cast(fp, ctypes.c_void_p), stream)
    if status < 0:
        raise RuntimeError(f"{kernel}: the kernel refuses its arguments ({status})")
    if status > 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {status}")
    if ipar[0] > 0:
        launches[kernel] += 1


def _key_ptr(key, dev):
    return _ptr("key", key, dev, torch.int64, (2,))


def camera_rays(camera, pixel_ids, key, lanes_per_pixel: int = 1, route=None):
    """Primary rays of the flat pixel ids with the draws of
    `prng.uniform(key, (P, 4))`, each repeated for `lanes_per_pixel`
    consecutive lanes (`wavefront_ref.camera_rays`). Returns (o, d),
    3-tuples of (P·lanes_per_pixel,) float32."""
    dev = pixel_ids.device
    if _route("camera_rays", dev, route) != "cuda":
        return ref.camera_rays(camera, pixel_ids, key, lanes_per_pixel)
    n = pixel_ids.shape[0] * lanes_per_pixel
    if 4 * pixel_ids.shape[0] >= 1 << 32:
        raise ValueError(f"{pixel_ids.shape[0]} pixels: draw indices past 2^32")
    out = torch.empty((6, n), dtype=torch.float32, device=dev)
    # aspect, scale, the orientation's rows, position, focal distance, aperture
    fpar = [np.float32(camera.width / float(camera.height)),
            np.float32(np.tan(np.deg2rad(camera.fov * 0.5))),
            *camera.orientation().ravel().tolist(), *camera.position,
            camera.focal_distance, camera.aperture_radius]
    _launch("mcpt_wf_camera", "camera_rays", dev,
            [_ptr("pixel_ids", pixel_ids, dev, torch.int64), _key_ptr(key, dev)],
            [out[k].data_ptr() for k in range(6)],
            [n, lanes_per_pixel, camera.width, camera.height, int(bool(camera.use_dof))], fpar)
    return (out[0], out[1], out[2]), (out[3], out[4], out[5])


def _table(pack, name):
    return getattr(pack, name).detach().contiguous()


def shade_pre(pack, o, d, hit, alive, depth: int, key, lam, chan, route=None) -> ref.PreOut:
    """The first half of bounce `depth` (`wavefront_ref.shade_pre`): the
    kernel reads the path key's words from device memory and derives the
    bounce's keys itself."""
    dev = o[0].device
    route = _route("shade_pre", dev, route)
    if route != "cuda":
        return ref.shade_pre(pack, o, d, hit, alive, depth, key, lam, chan)
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
                                          "emt_mesh", "emt_intra_cum", "emt_mesh_area",
                                          "lmesh_cum", "env_pixels")}
    cols = {"tri_shade": 11, "sph_shade": 5, "mat_fat": 13, "emt_fat": 17}
    for k, c in cols.items():
        ins.append(_ptr(k, tabs[k], dev, torch.float32, (tabs[k].shape[0], c)))
    e = tabs["emt_fat"].shape[0]
    ins.append(_ptr("emt_mesh", tabs["emt_mesh"], dev, torch.int32, (e,)))
    ins.append(_ptr("emt_intra_cum", tabs["emt_intra_cum"], dev, torch.float32, (e,)))
    ins.append(_ptr("emt_mesh_area", tabs["emt_mesh_area"], dev, torch.float32, (e,)))
    ins.append(_ptr("lmesh_cum", tabs["lmesh_cum"], dev, torch.float32))
    env = tabs["env_pixels"]
    ins.append(_ptr("env_pixels", env, dev, torch.float32, (env.shape[0], env.shape[1], 3)))

    f = torch.empty((13, b), dtype=torch.float32, device=dev)
    fan = torch.empty((5, s * b), dtype=torch.float32, device=dev)
    flags = torch.empty((2, b), dtype=torch.bool, device=dev)
    outs = [f[k].data_ptr() for k in range(9)] + [fan[k].data_ptr() for k in range(5)]
    outs += [f[k].data_ptr() for k in range(9, 13)] + [flags[0].data_ptr(), flags[1].data_ptr()]
    ipar = [b, depth, pack.n_tris, tabs["tri_shade"].shape[0], tabs["sph_shade"].shape[0],
            tabs["mat_fat"].shape[0], e, tabs["lmesh_cum"].numel(), s, pack.n_sph_emitters,
            int(bool(pack.use_env)), env.shape[0], env.shape[1]]
    fpar = [pack.emit_total_area, pack.rr_rate, pack.inv_rr, *pack.background]
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
    the lanes still alive."""
    dev = pre.fac.device
    route = _route("shade_post", dev, route)
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
    """Radiance per lane from the records (`wavefront_ref.fold`)."""
    dev = rec.leaf.device
    if _route("fold", dev, route) != "cuda":
        return ref.fold(rec)
    depth, b = rec.leaf.shape
    ins = [_ptr(k, getattr(rec, k), dev, torch.bool if k == "terminal" else torch.float32,
                (depth, b)) for k in ("l_dir", "w", "leaf", "terminal")]
    out = torch.empty(b, dtype=torch.float32, device=dev)
    _launch("mcpt_wf_fold", "fold", dev, ins, [out.data_ptr()], [b, depth], [])
    return out
