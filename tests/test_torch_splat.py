"""Port vs JAX: the particle splat (``ray_eater_tpu_torch.ops.splat`` with
the plain version of K10), ``ComputePipeline``, ``encode_present`` and the
``compute_drawing`` sample end to end.

The JAX side runs its Pallas kernels in interpret mode, as
``tests/test_splat.py`` does. Particles are drawn with numpy and handed to
both packages.

Tolerances and why:
- ``splat_mask``, ``splat_particles`` and ``encode_present``: equal (the
  same integer boxes; the same float32 operations in the same order).
- compute_drawing: the quad's uv is interpolated from λ, which XLA's
  interpreted raster kernel contracts into an FMA (ROADMAP queue 3), so
  uv may differ by ~1e-7 and a tap beside a 0/1 texel edge by ~2e-5; the
  frames are compared within 1e-4 (measured 1.9e-6) and their presented
  uint8 frames equal.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import ray_eater_tpu as jre  # noqa: E402
from ray_eater_tpu.core import swapchain as jswap  # noqa: E402
from ray_eater_tpu.ops import splat as jsplat  # noqa: E402
from ray_eater_tpu_torch import compute_drawing  # noqa: E402
from ray_eater_tpu_torch.core import pipeline as tpipe  # noqa: E402
from ray_eater_tpu_torch.core.swapchain import encode_present  # noqa: E402
from ray_eater_tpu_torch.ops import splat  # noqa: E402

torch.set_num_threads(1)


def _both_masks(pos, h, w, r):
    j = np.asarray(jsplat.splat_mask(jnp.asarray(pos), h, w, r,
                                     interpret=True))
    t = splat.splat_mask(torch.from_numpy(pos), h, w, r).numpy()
    return j, t


def _scatter_mask(pos, h, w, r):
    """Independent numpy scatter of compute_slime.glsl's boxes, skipping
    boxes that lie wholly off the image."""
    mask = np.zeros((h, w), np.float32)
    for x, y in pos:
        xi, yi = int(x), int(y)
        x0, x1 = max(0, xi - r), min(w, xi + r)
        y0, y1 = max(0, yi - r), min(h, yi + r)
        if x0 < x1 and y0 < y1:
            mask[y0:y1, x0:x1] = 1.0
    return mask


def test_splat_mask_matches_jax_random():
    rng = np.random.RandomState(3)
    h, w = 96, 200
    pos = np.stack([rng.rand(50) * w, rng.rand(50) * h], -1
                   ).astype(np.float32)
    j, t = _both_masks(pos, h, w, 7)
    assert t.shape == j.shape == (96, 256)
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t[:h, :w], _scatter_mask(pos, h, w, 7))
    assert not t[:, w:].any()


def test_splat_mask_matches_jax_off_image():
    # corners, negative positions (truncated toward zero), beyond the far
    # border, and boxes wholly above or left of the image (p + r <= 0),
    # which must write nothing
    h, w = 64, 128
    pos = np.array([[0, 0], [w - 1, h - 1], [-5.5, -5.5], [w + 30, h + 30],
                    [5, -25], [-25, 5], [-10, 30], [60, -10.5],
                    [w + 9.9, 20], [70, h + 10]], np.float32)
    j, t = _both_masks(pos, h, w, 10)
    assert t.shape == j.shape == (64, 128)
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t, _scatter_mask(pos, h, w, 10))
    assert t[0, 0] == 1.0 and t[h - 1, w - 1] == 1.0
    # (-5.5, -5.5) truncates to (-5, -5): its box ends at column/row 5
    assert t[1:5, 1:5].all()


def test_splat_particles_color_write():
    h, w = 32, 128
    img = torch.zeros((h, w, 4))
    pos = torch.tensor([[64.0, 16.0]])
    out = splat.splat_particles(img, pos, (1.0, 1.0, 0.0), radius=4).numpy()
    np.testing.assert_array_equal(out[16, 64], [1, 1, 0, 1])
    np.testing.assert_array_equal(out[0, 0], [0, 0, 0, 0])
    # half-open box: [p - r, p + r)
    assert out[16, 60, 0] == 1.0 and out[16, 68, 0] == 0.0
    assert out[12, 64, 0] == 1.0 and out[20, 64, 0] == 0.0
    assert int((out[..., 0] == 1.0).sum()) == 64
    jout = np.asarray(jsplat.splat_particles(
        jnp.zeros((h, w, 4)), jnp.asarray(pos.numpy()), (1.0, 1.0, 0.0),
        radius=4, interpret=True))
    np.testing.assert_array_equal(out, jout)


def test_compute_pipeline_is_frozen_and_hashable():
    p = tpipe.ComputePipeline(fn=compute_drawing.compute_image)
    assert p.name == "compute"
    assert hash(p) == hash(tpipe.ComputePipeline(
        fn=compute_drawing.compute_image))
    assert {p: 1}[tpipe.ComputePipeline(fn=compute_drawing.compute_image)]
    with pytest.raises(AttributeError):
        p.name = "other"


@pytest.mark.parametrize("srgb", [True, False])
def test_encode_present_matches_jax(srgb):
    rng = np.random.RandomState(5)
    color = (rng.rand(16, 256, 4) * 1.4 - 0.2).astype(np.float32)
    color[0, :4] = [[0.0031308, 0.5, 1.0, 0.0], [1.5, -0.1, 0.25, 2.0],
                    [0.04, 0.9999, 0.002, 0.5], [0.0, 1.0, 0.5, 1.0]]
    j = np.asarray(jswap.encode_present(jnp.asarray(color), 250, 13, srgb))
    t = encode_present(torch.from_numpy(color), 250, 13, srgb)
    assert t.dtype == torch.uint8 and t.shape == (13, 250, 4)
    np.testing.assert_array_equal(t.numpy(), j)


W, H, N = 200, 128, 64


def _jax_drawing(pos):
    """samples/compute_drawing.py's compute pass and one frame, eagerly,
    at W x H."""
    image = jnp.zeros((H, W, 4), jnp.float32).at[..., 3].set(1.0)
    target = jsplat.splat_particles(image, jnp.asarray(pos),
                                    compute_drawing.COLOR,
                                    compute_drawing.PIXELS_RAD,
                                    interpret=True)
    tex = jre.Texture(data=target, sampler=jre.Sampler(
        address_mode=jre.AddressMode.CLAMP_TO_EDGE))
    pipe = jre.GraphicsPipeline(
        vertex_fn=jre.shaders.passthrough_vertex,
        fragment_fn=jre.shaders.quad_sample_fragment,
        state=jre.RasterState(depth_test=False, depth_write=False))
    fb = jre.render_mesh(pipe, jre.fullscreen_quad(), {"time": 0.0},
                         {"compute_image": tex}, jre.create_framebuffer(W, H),
                         interpret=True)
    return np.asarray(target), np.asarray(fb.color)


def test_compute_drawing_matches_jax():
    pos = compute_drawing.particle_positions(0, W, H, N)
    jimg, jcolor = _jax_drawing(pos)
    d = compute_drawing.setup("cpu", 0, W, H, N)
    np.testing.assert_array_equal(d.image.numpy(), jimg)
    assert 0.0 < jimg[..., 0].mean() < 1.0   # edges between 0 and 1
    color = d.frame(0.0).color
    np.testing.assert_allclose(color.numpy(), jcolor, atol=1e-4, rtol=0)
    u8 = encode_present(color, W, H, srgb=False).numpy()
    np.testing.assert_array_equal(
        u8, np.asarray(jswap.encode_present(jnp.asarray(jcolor), W, H,
                                            srgb=False)))
    # the quad's taps land on texel centres: the frame presents the image
    np.testing.assert_array_equal(
        u8, encode_present(d.image, W, H, srgb=False).numpy())


def test_entry_point_runs_on_cpu(tmp_path):
    assert compute_drawing.main(
        ["--device", "cpu", "--frames", "2", "--out", str(tmp_path)]) == 0
    with open(tmp_path / "frame_last.png", "rb") as f:
        png = f.read()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    assert png[16:24] == (900).to_bytes(4, "big") + (600).to_bytes(4, "big")
    assert compute_drawing.parse_args([]).device == "cuda"
