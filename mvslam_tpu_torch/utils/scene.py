"""Synthetic two-plane scene renderer (numpy only).

The camera translates along an arbitrary path looking +z at a z=8
background plane (optionally slanted) with a z=4 foreground band; block
texture gives FAST/ORB clean structure. A copy of the JAX package's test
fixture, so the port's smoke run and tests need neither JAX nor the test
tree.
"""

from __future__ import annotations

import numpy as np


def _texture(rng, h, w, blur=2):
    t = rng.uniform(size=(h, w)).astype(np.float32)
    for _ in range(blur):
        t = 0.25 * (np.roll(t, 1, 0) + np.roll(t, -1, 0)
                    + np.roll(t, 1, 1) + np.roll(t, -1, 1))
    sq = rng.uniform(size=(h // 16 + 1, w // 16 + 1)) > 0.5
    blocks = np.kron(sq, np.ones((16, 16))).astype(np.float32)[:h, :w]
    return 0.6 * t + 0.4 * blocks


def _sample_bilinear(tex, u, v):
    h, w = tex.shape
    u = np.clip(u, 0.0, w - 1.001)
    v = np.clip(v, 0.0, h - 1.001)
    u0 = np.floor(u).astype(np.int32)
    v0 = np.floor(v).astype(np.int32)
    du = u - u0
    dv = v - v0
    return ((1 - dv) * ((1 - du) * tex[v0, u0] + du * tex[v0, u0 + 1])
            + dv * ((1 - du) * tex[v0 + 1, u0] + du * tex[v0 + 1, u0 + 1]))


def render_planes_sequence(ts, h=240, w=320, focal=280.0, seed=42,
                           bg_slope=0.0, yaws=None):
    """Render (N, h, w) float32 frames for camera translations ``ts``
    (N, 3). ``bg_slope`` tilts the background to ``z = 8 + slope*(x -
    mid)`` (continuous depth spread); ``yaws`` (N,) rotates the camera
    about +y (radians). Rays meet the planes analytically, so the ground
    truth is exact."""
    ts = np.asarray(ts, np.float64)
    n = ts.shape[0]
    yaws = np.zeros(n) if yaws is None else np.asarray(yaws, np.float64)
    rng = np.random.default_rng(seed)
    ppu_bg, z_bg = 40.0, 8.0
    ppu_fg, z_fg = 70.0, 4.0
    x_lo = float(ts[:, 0].min()) - z_bg * w / focal * 1.5
    x_hi = float(ts[:, 0].max()) + z_bg * w / focal * 1.5
    tex_bg = _texture(rng, int(z_bg * h / focal * ppu_bg) + 160,
                      int((x_hi - x_lo) * ppu_bg) + 160)
    tex_fg = _texture(rng, int(z_fg * h / focal * ppu_fg) + 160,
                      int((x_hi - x_lo) * ppu_fg) + 160)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    rx = (xs - cx) / focal
    ry = (ys - cy) / focal
    mid = 0.5 * (x_lo + x_hi)
    frames = []
    for t, psi in zip(ts, yaws):
        c, si = np.cos(psi), np.sin(psi)
        dx = c * rx + si * 1.0
        dy = ry
        dz = -si * rx + c * 1.0

        def plane_hit(z0, slope=0.0):
            s = (z0 + slope * (t[0] - mid) - t[2]) / (dz - slope * dx)
            return t[0] + s * dx, t[1] + s * dy

        wx, wy = plane_hit(z_bg, bg_slope)
        img = _sample_bilinear(
            tex_bg, (wx - x_lo) * ppu_bg + 80,
            (wy + z_bg * h / focal / 2) * ppu_bg + 80,
        )
        wxf, wyf = plane_hit(z_fg)
        fg = _sample_bilinear(
            tex_fg, (wxf - x_lo) * ppu_fg + 80,
            (wyf + z_bg * h / focal / 2) * ppu_fg + 80,
        )
        band = ys > (0.62 * h)
        frames.append(np.where(band, fg, img).astype(np.float32))
    return np.stack(frames)


def ellipse_loop(n: int = 90, a: float = 2.75, b: float = 0.35) -> np.ndarray:
    """Camera translations (n, 3) on a closed ellipse in the x-z plane (plus
    a small y wobble), starting at theta = pi/2 where the velocity is pure
    +x: the loop-closure scenario (the JAX package's
    ``tests/test_loop_closure.py``)."""
    th = np.linspace(np.pi / 2, np.pi / 2 + 2 * np.pi, n)
    return np.stack(
        [a * (1 - np.cos(th)), 0.02 * np.sin(3 * th), b * np.sin(th)], 1)
