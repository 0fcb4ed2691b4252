"""The port's live viewer (``io.viewer``) and ``gs_viewer --serve``:
``tests/test_viewer.py``'s cases against the port, the serve loop end to
end over localhost HTTP (64 splats, 256x256, port 0), its frame builder
against direct renders, and ``--serve`` without PIL.

Every wait has its own deadline: HTTP requests time out after 5 s, the
client thread gives up after 60 s and is joined with a timeout. Frames
are compared u8 for u8 (the same ops on the same inputs).
"""

import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from ray_eater_tpu_torch import gs_viewer
from ray_eater_tpu_torch.core import animation
from ray_eater_tpu_torch.core.context import Context, ContextConfig
from ray_eater_tpu_torch.core.swapchain import Swapchain, encode_present
from ray_eater_tpu_torch.io import viewer as viewer_mod
from ray_eater_tpu_torch.io.viewer import LiveViewer, encode_jpeg
from ray_eater_tpu_torch.models.gaussians import random_cloud
from ray_eater_tpu_torch.ops import gs

torch.set_num_threads(1)

DEADLINE_S = 60.0


def _get(port, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=5) as r:
        return r.status, r.read()


def test_encode_jpeg_rgba():
    frame = np.zeros((16, 32, 4), np.uint8)
    frame[..., 0] = 200
    assert encode_jpeg(frame)[:2] == b"\xff\xd8"        # JPEG SOI marker


def test_frame_and_events_roundtrip():
    v = LiveViewer(port=0, host="127.0.0.1")
    try:
        assert _get(v.port, "/")[0] == 200
        v.present(np.random.randint(0, 255, (24, 48, 3), np.uint8))
        status, body = _get(v.port, "/frame")
        assert status == 200 and body[:2] == b"\xff\xd8"
        _get(v.port, "/input?key=w&action=down")
        assert v.poll_events().get("w") is True
        _get(v.port, "/input?key=w&action=up")
        assert v.poll_events().get("w") is False
        assert not v.should_close
        _get(v.port, "/close")
        assert v.should_close
    finally:
        v.stop()


def test_mouse_state_roundtrip():
    v = LiveViewer(port=0, host="127.0.0.1")
    try:
        _get(v.port, "/input?mx=0.25&my=0.75&btn=0&action=down")
        ms = v.poll_mouse()
        assert abs(ms.x - 0.25) < 1e-6 and abs(ms.y - 0.75) < 1e-6
        assert 0 in ms.buttons and ms.wheel == 0.0
        _get(v.port, "/input?mx=0.5&my=0.5&btn=0&action=up")
        _get(v.port, "/input?wheel=120.0")
        _get(v.port, "/input?wheel=-40.0")
        ms = v.poll_mouse()
        assert 0 not in ms.buttons and abs(ms.wheel - 80.0) < 1e-6
        assert v.poll_mouse().wheel == 0.0     # the accumulator resets
    finally:
        v.stop()


def test_resize_request_drives_swapchain_recreation():
    v = LiveViewer(port=0, host="127.0.0.1")
    try:
        assert v.poll_resize() is None
        _get(v.port, "/input?rw=640&rh=480")
        rq = v.poll_resize()
        assert rq == (640, 480)
        assert v.poll_resize() is None         # honoured once
        sc = Swapchain(Context(ContextConfig(platform="cpu")), 64, 32)
        sc2 = sc.resize(*rq)
        assert (sc2.width, sc2.height) == (640, 480)
    finally:
        v.stop()


def test_stream_yields_parts():
    v = LiveViewer(port=0, host="127.0.0.1")
    try:
        v.present(np.zeros((8, 16, 3), np.uint8))
        req = urllib.request.urlopen(
            f"http://127.0.0.1:{v.port}/stream", timeout=5)
        assert b"--rayeaterframe" in req.read(64)
        req.close()
    finally:
        v.stop()


def _args(*extra):
    return gs_viewer.parse_args(["--serve", "0", "--width", "256",
                                 "--height", "256", "--static-camera",
                                 "--tile-w", "32", "--device", "cpu",
                                 *extra])


def _cloud():
    return random_cloud(64, seed=3, extent=0.5, scale_range=(0.05, 0.1),
                        device="cpu")


def test_serve_loop_end_to_end(monkeypatch):
    """Drag orbit, wheel zoom, one resize (whose old frames are
    released), then /close, over the real HTTP channel."""
    released = []
    monkeypatch.setattr(gs_viewer.ServeFrames, "release",
                        lambda self: released.append((self.viewer.width,
                                                      self.viewer.height)))
    ready, errors = [], []

    def drive():
        try:
            end = time.monotonic() + DEADLINE_S
            while not ready:
                assert time.monotonic() < end, "the viewer never listened"
                time.sleep(0.02)
            port = ready[0].port
            while True:
                assert time.monotonic() < end, "no frame was presented"
                try:
                    if _get(port, "/frame")[0] == 200:
                        break
                except urllib.error.HTTPError:
                    time.sleep(0.05)
            _get(port, "/input?mx=0.2&my=0.5&btn=0&action=down")
            _get(port, "/input?mx=0.6&my=0.4&btn=0&action=up")
            _get(port, "/input?wheel=-100")
            _get(port, "/input?rw=330&rh=300")
            while not released:
                assert time.monotonic() < end, "the resize was not served"
                time.sleep(0.02)
        except Exception as e:       # reported by the test's thread
            errors.append(e)
        finally:
            if ready:
                ready[0].request_close()

    th = threading.Thread(target=drive, daemon=True)
    th.start()
    n = gs_viewer.serve(_args("--max-per-tile", "0", "--cap-factor", "0"),
                        _cloud(), host="127.0.0.1", on_ready=ready.append)
    th.join(timeout=10)
    assert not th.is_alive() and not errors, errors
    assert n >= 2
    # the 256x256 frames released at the resize, the 320x256 ones at exit
    assert released == [(256, 256), (320, 256)]


@pytest.mark.parametrize("mpt", ["0", "64"])
def test_serve_frames_match_direct_renders(mpt):
    """ServeFrames' frames are render_gaussians' at orbit_at of the camera
    state (SH at the eye), u8 for u8, with the budget carried."""
    cloud = _cloud()
    cloud.sh_rest = torch.from_numpy(np.random.RandomState(1).randn(
        64, 3, 3).astype(np.float32) * 0.1)
    args = _args("--max-per-tile", mpt, "--cap-factor", "4")
    frames = gs_viewer.ServeFrames(cloud, args, 256, 192)
    budget = frames.budget
    for az, hgt, rad in ((0.0, 0.8, 2.5), (0.7, 1.1, 2.0)):
        got = frames(az, hgt, rad)
        view, proj, eye = gs_viewer.orbit_at(az, hgt, rad, aspect=256 / 192,
                                             device="cpu")
        kw = dict(cam_pos=eye, pairs_cap_factor=4, tile_w=32)
        if mpt == "0":
            img = gs.render_gaussians(cloud, view, proj, 256, 192, **kw)
        else:
            img, st = gs.render_gaussians(
                cloud, view, proj, 256, 192, max_splats_per_tile=64,
                lod_budget=budget, return_stats=True, **kw)
            budget = gs.update_lod_budget(st["tile_exec"], 64, 8, 6,
                                          st["tile_kept"], st["tile_count"])
            assert torch.equal(frames.budget, budget)
        assert torch.equal(got, encode_present(img, 256, 192))
    assert frames.info["path"] == "eager"
    frames.release()
    assert not any(k[0] == frames.step for k in animation._graphs)


def test_serve_without_pil_exits_before_binding(monkeypatch, capsys):
    bound = []
    monkeypatch.setattr(viewer_mod, "LiveViewer",
                        lambda *a, **k: bound.append(1))
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    assert not gs_viewer.has_pil()
    assert gs_viewer.main(["--serve", "0", "--splats", "16", "--device",
                           "cpu"]) == 2
    assert "PIL" in capsys.readouterr().err
    assert not bound
