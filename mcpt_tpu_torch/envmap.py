"""Equirectangular environment map lookup (counterpart of
`mcpt_tpu/envmap.py`, the reference's `Scene.hpp:60-99`).

Direction → UV with the longitude wrapped and the latitude clamped, then a
bilinear filter over texel centres at -0.5, at the map's full resolution;
the constant `background` when the scene has no map. The megakernel's plain
version calls `sample_env_chan` per lane; `csrc/megakernel.cu::env_lookup`
is the same float32 arithmetic in the same order.
"""

import math

import torch

PI = math.pi  # rounded to float32 where it meets a float32 tensor
TWO_PI = 2.0 * math.pi


def _sqrt(x):
    # correctly rounded float32 sqrt (torch's CPU kernel is not always)
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _texel_coords(env, d0, d1, d2):
    """Shared front half of both lookups: safe-normalize the direction,
    map it to (u, v) and to the four bilinear taps. Returns the flat texel
    indices (00, 10, 01, 11) and the weights (sx, sy)."""
    h, w = env.shape[0], env.shape[1]
    n2 = d0 * d0 + d1 * d1 + d2 * d2
    ok = n2 > 1e-12
    inv = torch.where(ok, 1.0 / _sqrt(torch.where(ok, n2, 1.0)), 0.0)
    x_, y_, z_ = d0 * inv, d1 * inv, d2 * inv
    phi = torch.atan2(z_, x_)
    theta = torch.acos(torch.clamp(y_, -1.0, 1.0))
    # true division by tensors: CUDA torch multiplies by the reciprocal of
    # a Python scalar divisor, which rounds differently
    u = (phi + PI) / torch.full_like(phi, TWO_PI)
    v = theta / torch.full_like(theta, PI)
    u = u - torch.floor(u)
    v = torch.clamp(v, 0.0, 1.0)
    x = u * w - 0.5  # an int below 2^24 scales as its float32 does
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    sx = x - x0
    sy = y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    x0w = torch.remainder(x0i, w)
    x1w = torch.remainder(x0i + 1, w)
    y0c = torch.clamp(y0i, 0, h - 1)
    y1c = torch.clamp(y0i + 1, 0, h - 1)
    taps = (y0c * w + x0w, y0c * w + x1w, y1c * w + x0w, y1c * w + x1w)
    return taps, sx, sy


def _bilerp(c00, c10, c01, c11, sx, sy):
    c0 = c00 * (1.0 - sx) + c10 * sx
    c1 = c01 * (1.0 - sx) + c11 * sx
    return c0 * (1.0 - sy) + c1 * sy


def sample_env_chan(env, background, use_env, d, chan):
    """Per-lane single-channel env radiance: `d` a 3-tuple of same-shape
    float32 tensors (any direction length), `chan` an int tensor of that
    shape (0, 1, 2 = R, G, B). `env` is the (H, W, 3) float32 map and
    `background` three floats; without a map (`use_env` False) the lane's
    background channel is returned (`mcpt_tpu/envmap.py:14`)."""
    if not use_env:
        bg = [torch.full_like(d[0], b) for b in background]
        return torch.where(chan == 0, bg[0], torch.where(chan == 1, bg[1], bg[2]))
    taps, sx, sy = _texel_coords(env, *d)
    c = [torch.take(env, t * 3 + chan) for t in taps]
    return _bilerp(*c, sx, sy)


def sample_env(env, background, use_env, dirs):
    """(N, 3) RGB radiance for (N, 3) directions (`mcpt_tpu/envmap.py:61`)."""
    if not use_env:
        bg = torch.as_tensor(background, dtype=torch.float32, device=dirs.device)
        return bg.expand(dirs.shape).clone()
    taps, sx, sy = _texel_coords(env, dirs[:, 0], dirs[:, 1], dirs[:, 2])
    flat = env.reshape(-1, 3)
    c = [flat[t] for t in taps]
    return _bilerp(*c, sx[:, None], sy[:, None])
