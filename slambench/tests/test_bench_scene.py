"""The benchmark's renderer against the port's (same textures, small size)
and against the scene's analytic truth."""

import numpy as np
import pytest
import torch

from mvslam_tpu_torch.utils import scene as port_scene
from slambench import scene


@pytest.mark.parametrize("bg_slope,yaw_amp", [(0.0, 0.0), (0.18, 0.06)])
def test_frames_equal_the_port_renderer(bg_slope, yaw_amp):
    h, w, focal = 48, 64, 56.0
    ts = scene.line_path(6, 0.12, 0.03, 0.25)
    yaws = scene.yaw_path(6, yaw_amp, 0.3)
    cam = scene.Camera(w, h, focal, focal, (w - 1) / 2, (h - 1) / 2)
    ext = scene.extent(ts, cam)
    (hb, wb), (hf, wf) = scene.texture_shapes(ext, cam)
    rng = np.random.default_rng(42)
    tex_bg = torch.from_numpy(port_scene._texture(rng, hb, wb)).double()
    tex_fg = torch.from_numpy(port_scene._texture(rng, hf, wf)).double()
    ours = scene.render(tex_bg, tex_fg, ts, yaws, cam, ext, bg_slope)
    theirs = port_scene.render_planes_sequence(ts, h=h, w=w, focal=focal,
                                               seed=42, bg_slope=bg_slope,
                                               yaws=yaws)
    np.testing.assert_allclose(ours.float().numpy(), theirs, atol=2e-6)


def test_parallax_of_the_two_planes():
    # a sideways step of dx moves a point at depth z by fx dx / z pixels:
    # 2 px on the background (z 8), 4 px on the foreground band (z 4)
    cam = scene.Camera(64, 48, 50.0, 53.0, 30.25, 22.5)
    dx = 2 * 8.0 / cam.fx
    ts = np.array([[0.0, 0.0, 0.0], [dx, 0.0, 0.0]])
    gen = torch.Generator().manual_seed(7)
    ext = scene.extent(ts, cam)
    (hb, wb), (hf, wf) = scene.texture_shapes(ext, cam)
    tb = scene.make_texture(gen, (hb, wb), "cpu")
    tf = scene.make_texture(gen, (hf, wf), "cpu")
    f = scene.render(tb, tf, ts, np.zeros(2), cam, ext).numpy()
    band = int(np.floor(scene.BAND_ROW * cam.height)) + 1
    np.testing.assert_allclose(f[1, :band, 4:-4], f[0, :band, 6:-2],
                               atol=1e-5)
    np.testing.assert_allclose(f[1, band:, 4:-4], f[0, band:, 8:], atol=1e-5)


def test_the_same_seed_gives_the_same_frames():
    cam = scene.Camera(40, 30, 35.0, 35.0, 19.5, 14.5)
    ts = scene.ellipse_path(5, 2.75, 0.35, 90, 0.02)
    a, b, c = (torch.empty((5, 30, 40), dtype=torch.uint8) for _ in range(3))
    for out, seed in ((a, 5), (b, 5), (c, 6)):
        scene.render_uint8(torch.Generator().manual_seed(seed), ts,
                           np.zeros(5), cam, 0.18, out)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_ellipse_laps_close():
    ts = scene.ellipse_path(180, 2.75, 0.35, 90, 0.02)
    np.testing.assert_allclose(ts[90], ts[0], atol=1e-12)
    # theta = pi/2: x = a, moving along +x
    np.testing.assert_allclose(ts[0], [2.75, -0.02, 0.35], atol=1e-12)
    assert ts[1, 0] > ts[0, 0]
