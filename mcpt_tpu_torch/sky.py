"""Procedural equirectangular sky generator (a numpy copy of
`mcpt_tpu/sky.py`, the same image bit for bit).

The reference's `models/envoMaps/sky.png` is absent from the public mount
(`.MISSING_LARGE_BLOBS`), so the "sky" configs need a stand-in equirect
environment map (SURVEY.md §7 hard-part 6). This synthesizes a plausible
cumulus sky like the one visible in the reference's published
`final_render_result_sky_with_dof.png`: saturated blue gradient, fBm value-
noise clouds, sun disk with glow, ground haze.

    python -m mcpt_tpu_torch.sky assets/sky.png [width] [--clear]
"""

import sys

import numpy as np


def _value_noise(h, w, cells_y, cells_x, rng):
    """Periodic-in-x bilinear value noise on an (h, w) grid."""
    g = rng.random((cells_y + 1, cells_x), dtype=np.float64)
    gx = np.concatenate([g, g[:, :1]], axis=1)  # wrap longitude
    ys = np.linspace(0, cells_y, h, endpoint=False)
    xs = np.linspace(0, cells_x, w, endpoint=False)
    y0 = ys.astype(int)
    x0 = xs.astype(int)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    fy = fy * fy * (3 - 2 * fy)
    fx = fx * fx * (3 - 2 * fx)
    a = gx[y0][:, x0]
    b = gx[y0][:, x0 + 1]
    c = gx[y0 + 1][:, x0]
    d = gx[y0 + 1][:, x0 + 1]
    return (a * (1 - fx) + b * fx) * (1 - fy) + (c * (1 - fx) + d * fx) * fy


def _fbm(h, w, octaves=5, seed=7):
    rng = np.random.default_rng(seed)
    out = np.zeros((h, w))
    amp, cy, cx = 1.0, 4, 8
    total = 0.0
    for _ in range(octaves):
        out += amp * _value_noise(h, w, cy, cx, rng)
        total += amp
        amp *= 0.55
        cy *= 2
        cx *= 2
    return out / total


def generate_sky(
    width: int = 1024,
    height: int = 512,
    sun_dir=(0.35, 0.45, 0.6),
    zenith=(0.05, 0.42, 0.75),
    horizon=(0.55, 0.85, 0.95),
    ground=(0.55, 0.68, 0.75),
    sun_intensity: float = 18.0,
    clouds: float = 0.55,
) -> np.ndarray:
    """(H, W, 3) float32 linear radiance in [0, ~sun_intensity].

    `clouds` is the cumulus coverage in [0, 1]; 0 gives the clear sky."""
    sd = np.asarray(sun_dir, np.float64)
    sd = sd / np.linalg.norm(sd)
    v = (np.arange(height) + 0.5) / height  # theta/pi
    u = (np.arange(width) + 0.5) / width  # (phi+pi)/2pi
    theta = v * np.pi
    phi = u * 2 * np.pi - np.pi
    st = np.sin(theta)[:, None]
    y = np.cos(theta)[:, None] * np.ones((1, width))
    x = st * np.cos(phi)[None, :]
    z = st * np.sin(phi)[None, :]

    up = np.clip(y, 0.0, 1.0)
    sky = (
        np.asarray(zenith)[None, None, :] * (up**0.7)[:, :, None]
        + np.asarray(horizon)[None, None, :] * (1 - up**0.7)[:, :, None]
    )
    below = y < 0
    g = np.asarray(ground)[None, None, :] * (1 + 0.5 * y)[:, :, None]
    img = np.where(below[:, :, None], g, sky)

    if clouds > 0.0:
        # fBm cumulus: denser near the horizon (perspective), soft edges,
        # slightly grey shaded bottoms
        n = _fbm(height, width)
        thresh = 1.0 - clouds * (0.8 + 0.2 * (1.0 - np.abs(y)))
        dens = np.clip((n - thresh) * 5.0, 0.0, 1.0)
        dens = np.where(y < -0.05, 0.0, dens)  # keep the ground clear
        shade = 1.0 - 0.25 * np.clip((n - thresh) * 2.0, 0.0, 1.0)
        cloud_col = np.stack([shade, shade, shade], axis=-1) * np.array(
            [1.0, 1.0, 1.02]
        )
        img = img * (1.0 - dens[:, :, None]) + cloud_col * dens[:, :, None]

    cos_sun = x * sd[0] + y * sd[1] + z * sd[2]
    disk = np.clip((cos_sun - 0.9995) / 0.0005, 0.0, 1.0)
    glow = np.clip(cos_sun, 0.0, 1.0) ** 350
    img = img + (sun_intensity * disk + 1.5 * glow)[:, :, None] * np.array(
        [1.0, 0.95, 0.85]
    )
    return img.astype(np.float32)


def write_sky_png(path, width: int = 1024, clouds: float = 0.55) -> None:
    """Tonemapped 8-bit PNG (the reference env loader reads 8-bit PNGs and
    maps to [0,1], Scene.hpp:49-56; intensity >1 is lost, as it would be for
    any PNG map the reference loaded)."""
    from mcpt_tpu_torch.io.png import write_png

    img = generate_sky(width, width // 2, clouds=clouds)
    out = np.clip(img * 255.0, 0, 255).astype(np.uint8)  # sun saturates
    write_png(path, out)


if __name__ == "__main__":
    argv = [a for a in sys.argv[1:] if a != "--clear"]
    clouds = 0.0 if "--clear" in sys.argv else 0.55
    path = argv[0] if argv else "sky.png"
    width = int(argv[1]) if len(argv) > 1 else 1024
    write_sky_png(path, width, clouds=clouds)
    print(f"wrote {path}")
