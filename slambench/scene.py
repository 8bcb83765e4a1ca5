"""The benchmark's synthetic camera: a frozen copy of
``mvslam_tpu_torch/utils/scene.py`` (``render_planes_sequence``,
``ellipse_loop``), rewritten in torch to render on the device from a
``torch.Generator``, for any pinhole camera (fx, fy, cx, cy).

The camera looks along +z at a z = 8 background plane (optionally slanted
to ``z = 8 + slope * (x - mid)``) with a z = 4 foreground plane showing in
the image rows below 0.62 h; block texture gives FAST/ORB clean
structure. Rays meet the planes analytically in float64, so the ground
truth (camera poses, plane depths) is exact. With fx = fy and the centred
principal point ((w - 1) / 2, (h - 1) / 2), and the same textures, the
frames equal the port's renderer's.

Camera-to-world poses: ``R = R_y(yaw)``, centre ``ts[i]``; camera axes x
right, y down, z forward.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

Tensor = torch.Tensor

Z_BG, PPU_BG = 8.0, 40.0        # background plane depth, texels per unit
Z_FG, PPU_FG = 4.0, 70.0        # foreground plane
BAND_ROW = 0.62                 # foreground below this share of the rows


class Camera(NamedTuple):
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float

    def K(self) -> np.ndarray:
        return np.array([[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy],
                         [0.0, 0.0, 1.0]])


class Extent(NamedTuple):
    """Where the textures lie in x, and the slant's pivot."""

    x_lo: float
    x_hi: float

    @property
    def mid(self) -> float:
        return 0.5 * (self.x_lo + self.x_hi)


def extent(ts: np.ndarray, cam: Camera) -> Extent:
    """The textures' x range for camera centres ``ts`` (N, 3): the whole
    path with a margin, so a prefix of a path is the same scene only when
    the whole path is given."""
    margin = Z_BG * cam.width / cam.fx * 1.5
    return Extent(float(ts[:, 0].min()) - margin,
                  float(ts[:, 0].max()) + margin)


def texture_shapes(ext: Extent, cam: Camera) -> tuple[tuple[int, int], ...]:
    """(rows, cols) of the background and the foreground texture."""
    span = ext.x_hi - ext.x_lo
    return ((int(Z_BG * cam.height / cam.fy * PPU_BG) + 160,
             int(span * PPU_BG) + 160),
            (int(Z_FG * cam.height / cam.fy * PPU_FG) + 160,
             int(span * PPU_FG) + 160))


def make_texture(gen: torch.Generator, shape: tuple[int, int],
                 device, blur: int = 2) -> Tensor:
    """0.6 x (uniform noise, blurred by ``blur`` wrap-around 4-neighbour
    means) + 0.4 x (16-texel blocks, each on with probability 1/2), float64
    on ``device``: the port's ``_texture`` with torch's generator."""
    h, w = shape
    t = torch.rand((h, w), generator=gen, device=device, dtype=torch.float64)
    for _ in range(blur):
        t = 0.25 * (torch.roll(t, 1, 0) + torch.roll(t, -1, 0)
                    + torch.roll(t, 1, 1) + torch.roll(t, -1, 1))
    sq = torch.rand((h // 16 + 1, w // 16 + 1), generator=gen, device=device,
                    dtype=torch.float64) > 0.5
    blocks = sq.to(torch.float64).repeat_interleave(16, 0) \
        .repeat_interleave(16, 1)[:h, :w]
    return 0.6 * t + 0.4 * blocks


def _sample_bilinear(tex: Tensor, u: Tensor, v: Tensor) -> Tensor:
    h, w = tex.shape
    u = torch.clamp(u, 0.0, w - 1.001)
    v = torch.clamp(v, 0.0, h - 1.001)
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    du, dv = u - u0, v - v0
    i0 = v0.to(torch.int64) * w + u0.to(torch.int64)
    flat = tex.reshape(-1)
    a, b = flat[i0], flat[i0 + 1]
    c, d = flat[i0 + w], flat[i0 + w + 1]
    return (1 - dv) * ((1 - du) * a + du * b) + dv * ((1 - du) * c + du * d)


def rotation_y(yaw) -> np.ndarray:
    """(N, 3, 3) camera-to-world rotations about +y."""
    yaw = np.asarray(yaw, np.float64)
    c, s = np.cos(yaw), np.sin(yaw)
    z, o = np.zeros_like(yaw), np.ones_like(yaw)
    return np.stack([np.stack([c, z, s], -1), np.stack([z, o, z], -1),
                     np.stack([-s, z, c], -1)], -2)


def render(tex_bg: Tensor, tex_fg: Tensor, ts: np.ndarray, yaws: np.ndarray,
           cam: Camera, ext: Extent, bg_slope: float = 0.0) -> Tensor:
    """(N, h, w) float64 frames in [0, 1] for camera centres ``ts`` (N, 3)
    and yaws (N,), on the textures' device."""
    dev = tex_bg.device
    f64 = torch.float64
    ys, xs = torch.meshgrid(torch.arange(cam.height, device=dev, dtype=f64),
                            torch.arange(cam.width, device=dev, dtype=f64),
                            indexing="ij")
    # the port computes the normalised pixel grid in float32
    rx = ((xs - cam.cx) / cam.fx).to(torch.float32).to(f64)[None]
    ry = ((ys - cam.cy) / cam.fy).to(torch.float32).to(f64)[None]
    t = torch.as_tensor(ts, dtype=f64, device=dev)[:, :, None, None]
    yaw = torch.as_tensor(yaws, dtype=f64, device=dev)[:, None, None]
    c, si = torch.cos(yaw), torch.sin(yaw)
    dx = c * rx + si
    dy = ry
    dz = -si * rx + c
    v_off = Z_BG * cam.height / cam.fy / 2

    def plane_hit(z0, slope=0.0):
        s = (z0 + slope * (t[:, 0] - ext.mid) - t[:, 2]) / (dz - slope * dx)
        return t[:, 0] + s * dx, t[:, 1] + s * dy

    wx, wy = plane_hit(Z_BG, bg_slope)
    bg = _sample_bilinear(tex_bg, (wx - ext.x_lo) * PPU_BG + 80,
                          (wy + v_off) * PPU_BG + 80)
    wxf, wyf = plane_hit(Z_FG)
    fg = _sample_bilinear(tex_fg, (wxf - ext.x_lo) * PPU_FG + 80,
                          (wyf + v_off) * PPU_FG + 80)
    band = (ys > BAND_ROW * cam.height)[None]
    return torch.where(band, fg, bg)


def to_uint8(frames: Tensor) -> Tensor:
    """Frames in [0, 1] as 8-bit grey levels, rounded to nearest."""
    return torch.round(torch.clamp(frames, 0.0, 1.0) * 255.0).to(torch.uint8)


def render_uint8(gen: torch.Generator, ts: np.ndarray, yaws: np.ndarray,
                 cam: Camera, bg_slope: float, out: Tensor,
                 chunk: int = 32) -> Tensor:
    """Render (N, h, w) uint8 frames into ``out`` (pinned host memory, for
    one), on ``gen``'s device from its textures, ``chunk`` frames at a
    time."""
    device = gen.device
    ext = extent(ts, cam)
    (hb, wb), (hf, wf) = texture_shapes(ext, cam)
    tex_bg = make_texture(gen, (hb, wb), device)
    tex_fg = make_texture(gen, (hf, wf), device)
    for a in range(0, ts.shape[0], chunk):
        b = min(a + chunk, ts.shape[0])
        out[a:b] = to_uint8(render(tex_bg, tex_fg, ts[a:b], yaws[a:b], cam,
                                   ext, bg_slope))
    return out


# ---- paths ---------------------------------------------------------------

def line_path(n: int, step: float, y_amp: float, y_freq: float) -> np.ndarray:
    """``x = step i, y = y_amp sin(y_freq i), z = 0`` (the port's bench
    trajectory at step 0.12, 0.03, 0.25)."""
    i = np.arange(n, dtype=np.float64)
    return np.stack([step * i, y_amp * np.sin(y_freq * i), np.zeros(n)], 1)


def ellipse_path(n: int, a: float, b: float, lap_frames: int,
                 y_amp: float) -> np.ndarray:
    """Laps of the closed ellipse of ``ellipse_loop`` in the x-z plane with
    a small y wobble, ``lap_frames`` distinct positions a lap, starting at
    theta = pi/2 where the velocity is pure +x."""
    th = np.pi / 2 + 2 * np.pi * np.arange(n, dtype=np.float64) / lap_frames
    return np.stack([a * (1 - np.cos(th)), y_amp * np.sin(3 * th),
                     b * np.sin(th)], 1)


def yaw_path(n: int, amp: float, freq: float) -> np.ndarray:
    return amp * np.sin(freq * np.arange(n, dtype=np.float64))

