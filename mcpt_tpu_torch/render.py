"""Full-image renders: through the megakernels (`render_mega` and
`render_mega_sharded`, counterparts of `mcpt_tpu/kernels/megakernel.py:
3301-3387` and `:3161-3298`) and through the wavefront
engine (`render_radiance` and `render`, counterparts of
`mcpt_tpu/render.py:35-178`).

The wavefront render walks tiles of `tile_pixels` pixels × chunks of
`spp_chunk` camera samples; each (tile, chunk) runs `_render_tile` with the
key `fold_in(fold_in(key, tile), chunk)`, split into one key per sample and
each of those into a camera key and a path key, as the JAX function does, so
the draws are `jax.random`'s (`prng`); these keys are hashed on the host
(`prng.host_fold_in`, `host_split`), the bounce's own on the device. The
framebuffer accumulates in float64 on the host and a checkpoint `.npz` (fb,
chunk_weights, start_chunk, total_rays) is written every 16 chunks and
removed on completion.
"""

import collections
import os
import time

import numpy as np
import torch

from mcpt_tpu_torch import prng
from mcpt_tpu_torch.constants import WAVELEN_UM
from mcpt_tpu_torch.integrator import trace_paths_c
from mcpt_tpu_torch.kernels import wavefront
from mcpt_tpu_torch.kernels.intersect_prims import intersect_prims_c
from mcpt_tpu_torch.kernels.megakernel import load_library, trace_block
from mcpt_tpu_torch.kernels.megakernel_ref import cam_static
from mcpt_tpu_torch.kernels.tables import SceneTables
from mcpt_tpu_torch.parallel.mesh import replicate_pack
from mcpt_tpu_torch.scene import ScenePack
from mcpt_tpu_torch.utils.profiling import device_trace
from mcpt_tpu_torch.utils.progress import ProgressBar

# Lanes per kernel launch: bounds the plain version's (lanes, primitives)
# temporaries on the CPU; on the card each launch is one kernel.
BLOCK_LANES = 1 << 20
# the sharded render rounds each device's lanes up to a multiple of this
# (mcpt_tpu/kernels/megakernel.py CHUNK)
LANE_CHUNK = 1024


def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA device without a usable card raises
    (there is no fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is False"
        )
    return dev


def resolve_devices(device, devices) -> list:
    """The torch devices of `devices` (a list; one may repeat), or of
    `device` alone where `devices` is None; an empty list raises."""
    devs = [resolve_device(dv) for dv in (devices if devices is not None else [device])]
    if not devs:
        raise ValueError("empty device list")
    return devs


def _tables_on(scene, dev):
    """`scene` (a `ScenePack` or `SceneTables`) as `SceneTables` on `dev`."""
    if isinstance(scene, SceneTables):
        return scene.to(dev)
    return SceneTables.from_pack(scene, device=dev)


def _check_regen(tables, regen):
    if tables.use_env and not regen:
        raise ValueError("env-map scenes require the regen megakernel")


def render_mega(scene, camera, spp, seed=0, *, max_bounces=8, device="cuda", regen=True):
    """Render `camera`'s image of `scene` (a `ScenePack` or `SceneTables`)
    through the path-regeneration kernel, or with regen=False through the
    lockstep kernel (no env maps).

    Returns ((H, W, 3) float32 linear radiance as numpy, stats) with the JAX
    function's stats keys. Rays are counted as bench.py counts them: 1 per
    camera sample, `n_dir_sample` shadow rays per path vertex, 1 per bounce
    ray traced."""
    dev = resolve_device(device)
    tables = _tables_on(scene, dev)
    _check_regen(tables, regen)
    if dev.type == "cuda":
        load_library(regen)  # build outside the timed region
    cam = cam_static(camera)
    w, h = camera.width, camera.height
    lanes = w * h * 3
    t0 = time.monotonic()
    rads, rays = [], []
    for off in range(0, lanes, BLOCK_LANES):
        r, ry = trace_block(
            tables, cam, seed, off, spp, min(BLOCK_LANES, lanes - off), max_bounces,
            regen=regen,
        )
        rads.append(r)
        rays.append(ry)
    rad = torch.cat(rads)
    total_rays = float(torch.cat(rays).to(torch.float64).sum().item())
    img = rad.cpu().numpy().reshape(h, w, 3)
    elapsed = time.monotonic() - t0
    stats = {
        "elapsed_s": elapsed,
        "rays": int(total_rays),
        "rays_per_s": total_rays / max(elapsed, 1e-9),
        "camera_samples": w * h * spp,
        "wavelength_paths": lanes * spp,
    }
    return img, stats


def render_mega_sharded(scene, camera, spp, seed=0, *, devices=None, max_bounces=8,
                        regen=True):
    """The megakernel render with lanes interleaved over `devices`
    (counterpart of `mcpt_tpu/kernels/megakernel.py:3161-3298`).

    Device d of nd owns lanes d, d + nd, d + 2·nd, ... (so each samples the
    whole image and their work stays balanced): per_dev = ceil(lanes /
    (nd·1024))·1024 lanes each, in launches of up to BLOCK_LANES at
    lane_offset d + done·nd with lane_stride nd. Pad lanes past the image
    trace real paths, as in JAX. Every device's launches are queued before
    any result is copied back; the host de-interleaves the planes. The
    random numbers key on the absolute lane, so the image equals
    `render_mega`'s bit for bit.

    `devices` is a list of torch devices (default: every CUDA device; none
    raises). One device may be listed more than once (["cuda:0"] * 4, or
    ["cpu"] * 3), which runs the strided launches on one device. Each
    distinct device gets one copy of the tables. Returns ((H, W, 3) float32
    radiance, stats): elapsed_s, rays (image lanes), rays_per_s, devices,
    per_device_rays (pad lanes included) and pad_lanes."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("render_mega_sharded: no CUDA device")
        devices = [f"cuda:{k}" for k in range(torch.cuda.device_count())]
    devs = [resolve_device(dv) for dv in devices]
    if not devs:
        raise ValueError("render_mega_sharded: empty device list")
    nd = len(devs)
    tables = {}
    for dev in devs:
        if dev not in tables:
            tables[dev] = _tables_on(scene, dev)
            _check_regen(tables[dev], regen)
            if dev.type == "cuda":
                load_library(regen)  # build outside the timed region
    cam = cam_static(camera)
    w, h = camera.width, camera.height
    lanes = w * h * 3
    per_dev = -(-lanes // (nd * LANE_CHUNK)) * LANE_CHUNK
    t0 = time.monotonic()
    out = []
    for d_i, dev in enumerate(devs):
        parts = []
        for done in range(0, per_dev, BLOCK_LANES):
            parts.append(trace_block(
                tables[dev], cam, seed, d_i + done * nd, spp, min(BLOCK_LANES, per_dev - done),
                max_bounces, regen=regen, lane_stride=nd,
            ))
        out.append(parts)
    rad = np.stack([torch.cat([r for r, _ in parts]).cpu().numpy() for parts in out])
    rays = np.stack([torch.cat([ry for _, ry in parts]).cpu().numpy() for parts in out])
    # de-interleave: device-major (nd, per_dev) -> lane-major
    rad_l = rad.T.ravel()
    rays_l = rays.T.ravel()
    img = rad_l[:lanes].reshape(h, w, 3)
    total_rays = float(rays_l[:lanes].astype(np.float64).sum())
    elapsed = time.monotonic() - t0
    stats = {
        "elapsed_s": elapsed,
        "rays": int(total_rays),
        "rays_per_s": total_rays / max(elapsed, 1e-9),
        "devices": nd,
        "per_device_rays": rays.astype(np.float64).sum(axis=1).tolist(),
        "pad_lanes": int(nd * per_dev - lanes),
    }
    return img, stats


def _render_tile(pack, camera, pixel_ids, key, n_sub, max_bounces, method, early_exit=True):
    """Mean radiance over n_sub camera samples for one pixel tile: ((P, 3)
    float32 radiance, total ray count as a 0-dim tensor)."""
    p = pixel_ids.shape[0]
    dev = pixel_ids.device
    chan = torch.arange(3, device=dev).repeat(p)
    lam = torch.tensor(WAVELEN_UM, device=dev)[chan]
    fb = torch.zeros((p, 3), dtype=torch.float32, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    # per sample split(key, n_sub)[s], split once more into a camera key and
    # a path key, hashed on the host and moved once: (n_sub, 2, 2)
    keys = torch.tensor([prng.host_split(k) for k in prng.host_split(key.tolist(), n_sub)],
                        dtype=torch.int64, device=dev)
    for s in range(n_sub):
        o3, d3 = wavefront.camera_rays(camera, pixel_ids, keys[s, 0], 3)
        rad, stats = trace_paths_c(
            pack, o3, d3, lam, chan, keys[s, 1], max_bounces=max_bounces, method=method,
            early_exit=early_exit,
        )
        fb = fb + rad.reshape(p, 3)
        rays = rays + stats.rays
    return fb / torch.full_like(fb, n_sub), rays


@torch.inference_mode()
def render_radiance(
    scene_or_pack,
    camera,
    spp: int,
    key=None,
    *,
    max_bounces: int = 8,
    method: str = "auto",
    tile_pixels: int = 65536,
    spp_chunk: int = 8,
    progress: bool = False,
    checkpoint_path=None,
    device="cuda",
    devices=None,
    trace_dir=None,
):
    """Full-image linear radiance through the wavefront engine: an (H, W, 3)
    float32 numpy array and the JAX function's stats dict. `scene_or_pack`
    is a `Scene` or a `ScenePack`; `key` a `prng` key or an int seed
    (default `prng.key(0)`). `method` is the intersector (`intersect.
    resolve_method`): on a CUDA device `auto` launches the CUDA kernel at
    any scene size, which walks the scene's BVH where it has one.

    `devices`, a list of torch devices (one may be listed several times),
    takes the place of `device`: tile i runs on devices[i % len(devices)],
    each distinct device holding one copy of the pack. A tile keeps its own
    key, so the image is bitwise the single-device image (the counterpart
    of JAX's `sharding=`, whose lanes the counter-based draws would key
    differently if a tile were split). With `trace_dir`, the tile loop runs
    under `utils.profiling.device_trace`, which writes a torch.profiler
    Chrome trace there.

    On a CUDA device the camera, each bounce's two shading halves and the
    fold are CUDA kernels (`csrc/wavefront.cu`, built here, outside the
    timed region); this function runs under `torch.inference_mode`, so the
    training rule never applies. The stats keep the JAX function's keys;
    the wrappers' counts (`kernels/wavefront.py`'s `calls` by route,
    `intersect_prims_c.by_mode`) say what ran."""
    devs = resolve_devices(device, devices)
    host = scene_or_pack if isinstance(scene_or_pack, ScenePack) else scene_or_pack.compile()
    if key is None or isinstance(key, int):
        key = prng.key(key or 0)
    words = key.tolist()  # the chunks' keys are hashed on the host
    on = replicate_pack(host, devs, method)  # device -> (pack, method)
    if any(dev.type == "cuda" for dev in on):
        wavefront.load_library()
    w, h = camera.width, camera.height
    n_pix = w * h
    tile_pixels = min(tile_pixels, n_pix)
    n_tiles = (n_pix + tile_pixels - 1) // tile_pixels
    spp_chunk = max(1, min(spp_chunk, spp))
    n_chunks = (spp + spp_chunk - 1) // spp_chunk

    fb = np.zeros((n_pix, 3), np.float64)
    chunk_weights = np.zeros(n_tiles, np.float64)
    total_rays = 0
    start_chunk = np.zeros(n_tiles, np.int64)
    if checkpoint_path and os.path.exists(checkpoint_path):
        ckpt = np.load(checkpoint_path)
        fb = ckpt["fb"].astype(np.float64)
        chunk_weights = ckpt["chunk_weights"]
        start_chunk = ckpt["start_chunk"]
        total_rays = int(ckpt["total_rays"])

    bar = ProgressBar() if progress else None
    t0 = time.monotonic()
    work = 0
    total_work = n_tiles * n_chunks
    with device_trace(trace_dir):
        for tile in range(n_tiles):
            dev = devs[tile % len(devs)]
            pack, method_d = on[dev]
            lo = tile * tile_pixels
            hi = min(lo + tile_pixels, n_pix)
            ids = torch.arange(lo, lo + tile_pixels, device=dev).clamp(max=n_pix - 1)
            for chunk in range(int(start_chunk[tile]), n_chunks):
                sub = min(spp_chunk, spp - chunk * spp_chunk)
                k = torch.tensor(prng.host_fold_in(prng.host_fold_in(words, tile), chunk))
                tile_fb, rays = _render_tile(pack, camera, ids, k, sub, max_bounces, method_d)
                fb[lo:hi] += tile_fb.cpu().numpy()[: hi - lo] * sub
                chunk_weights[tile] += sub
                total_rays += int(rays)
                work += 1
                if bar:
                    bar.update(work / total_work)
                if checkpoint_path and (chunk + 1) % 16 == 0:
                    start_chunk[tile] = chunk + 1
                    np.savez(
                        checkpoint_path,
                        fb=fb,
                        chunk_weights=chunk_weights,
                        start_chunk=start_chunk,
                        total_rays=total_rays,
                    )
            start_chunk[tile] = n_chunks
            fb[lo:hi] /= max(chunk_weights[tile], 1.0)
    if bar:
        bar.finish()
    elapsed = time.monotonic() - t0
    stats = {
        "elapsed_s": elapsed,
        "rays": total_rays,
        "rays_per_s": total_rays / max(elapsed, 1e-9),
        "camera_samples": n_pix * spp,
        "wavelength_paths": n_pix * spp * 3,
        "wavelength_paths_per_s": n_pix * spp * 3 / max(elapsed, 1e-9),
    }
    if checkpoint_path and os.path.exists(checkpoint_path):
        os.remove(checkpoint_path)
    return fb.reshape(h, w, 3).astype(np.float32), stats


def wavefront_counts():
    """A snapshot of the wavefront's counts, for `ran_since`: the calls by
    route (`kernels/wavefront.py`) and the intersector kernel's launches by
    mode."""
    return collections.Counter(wavefront.calls), collections.Counter(intersect_prims_c.by_mode)


def ran_since(snapshot) -> str:
    """What the wavefront ran since `snapshot` (`wavefront_counts()`): the
    routes of its camera, bounce halves and fold, and the intersector
    kernel's launches by mode (none for the `dense` and `bvh` methods)."""
    calls, modes = wavefront_counts()
    routes = sorted({route for _, route in calls - snapshot[0]})
    return (f"route {', '.join(routes) or 'none'}, intersector kernel launches "
            f"{dict(modes - snapshot[1]) or 'none'}")


def render(scene, camera=None, spp=None, key=None, out_path=None, **kw):
    """Scene (and its camera) → PNG on disk + stats, through the wavefront
    engine."""
    from mcpt_tpu_torch.film import save_png

    camera = camera if camera is not None else scene.camera
    spp = spp if spp is not None else 32
    fb, stats = render_radiance(scene, camera, spp, key, **kw)
    if out_path:
        save_png(out_path, fb)
        stats["output"] = str(out_path)
    return fb, stats
