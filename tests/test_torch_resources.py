"""Port vs JAX: framebuffers, blending, the sRGB encoders, the PNG writer,
meshes and the fullscreen-quad shaders (``core.resources``,
``core.pipeline``, ``io.image``, ``models.mesh``, ``core.shaders``).

Tolerances: framebuffers, meshes and u8 encodes equal; float encodes and
blends within 1e-6 (``pow`` may differ by an ulp between libraries).
"""

import inspect
import os
import sys
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import ray_eater_tpu as jre  # noqa: E402
from ray_eater_tpu.core import pipeline as jpipe  # noqa: E402
from ray_eater_tpu.core import shaders as jshaders  # noqa: E402
from ray_eater_tpu.io import image as jimage  # noqa: E402
from ray_eater_tpu_torch import basic_planes, multipass  # noqa: E402
from ray_eater_tpu_torch import raster_scenes  # noqa: E402
from ray_eater_tpu_torch.core import pipeline as tpipe  # noqa: E402
from ray_eater_tpu_torch.core import resources as tres  # noqa: E402
from ray_eater_tpu_torch.core import shaders as tshaders  # noqa: E402
from ray_eater_tpu_torch.io import image  # noqa: E402
from ray_eater_tpu_torch.models import mesh as tmesh  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("w,h", [(900, 600), (120, 80), (1920, 1080),
                                 (481, 271)])
def test_create_framebuffer_matches_jax(w, h):
    jfb = jre.create_framebuffer(w, h, clear_color=(0.1, 0.2, 0.3, 1.0),
                                 clear_depth=0.75)
    fb = tres.create_framebuffer(w, h, clear_color=(0.1, 0.2, 0.3, 1.0),
                                 clear_depth=0.75, device="cpu")
    assert (fb.padded_height, fb.padded_width) == (jfb.padded_height,
                                                   jfb.padded_width)
    assert fb.padded_width % 128 == 0 and fb.padded_height % 8 == 0
    np.testing.assert_array_equal(fb.color.numpy(), np.asarray(jfb.color))
    np.testing.assert_array_equal(fb.depth.numpy(), np.asarray(jfb.depth))
    c = tres.clear(fb)
    np.testing.assert_array_equal(c.color.numpy(),
                                  np.asarray(jre.clear(jfb).color))
    assert float(c.depth.max()) == 1.0 and (c.width, c.height) == (w, h)


def test_blend_color_matches_jax():
    rng = np.random.RandomState(0)
    src = rng.rand(7, 5, 4).astype(np.float32)
    dst = rng.rand(7, 5, 4).astype(np.float32)
    for jm, tm in ((jpipe.BlendMode.NONE, tpipe.BlendMode.NONE),
                   (jpipe.BlendMode.ALPHA, tpipe.BlendMode.ALPHA)):
        want = np.asarray(jpipe.blend_color(jm, jnp.asarray(src),
                                            jnp.asarray(dst)))
        got = tpipe.blend_color(tm, torch.from_numpy(src),
                                torch.from_numpy(dst)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_srgb_encoders_match_jax():
    x = np.linspace(-0.1, 1.1, 257, dtype=np.float32).reshape(257, 1)
    np.testing.assert_array_equal(image.srgb_to_linear(x),
                                  jimage.srgb_to_linear(x))
    np.testing.assert_allclose(image.linear_to_srgb(torch.from_numpy(x)),
                               np.asarray(jimage.linear_to_srgb(
                                   jnp.asarray(x))), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(image.linear_to_srgb(x),
                                  jimage.linear_to_srgb(x))
    img = np.random.RandomState(2).rand(9, 11, 4).astype(np.float32)
    want = jimage.to_srgb_u8(jnp.asarray(img))
    np.testing.assert_array_equal(image.to_srgb_u8(torch.from_numpy(img)),
                                  want)
    np.testing.assert_array_equal(image.to_srgb_u8(img), want)


def _decode_png(data: bytes) -> np.ndarray:
    """Minimal decoder of the writer's output (filter 0 rows only)."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc = int.from_bytes(data[pos + 8 + n:pos + 12 + n], "big")
        assert zlib.crc32(tag + body) & 0xFFFFFFFF == crc
        if tag == b"IHDR":
            hdr = body
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h = int.from_bytes(hdr[:4], "big"), int.from_bytes(hdr[4:8], "big")
    ch = 4 if hdr[9] == 6 else 3
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + w * ch)
    assert not raw[:, 0].any()
    return raw[:, 1:].reshape(h, w, ch)


@pytest.mark.parametrize("ch", [3, 4])
def test_png_writer_round_trip(ch, tmp_path):
    img = (np.random.RandomState(ch).rand(13, 17, ch) * 255).astype(np.uint8)
    path = tmp_path / "f.png"
    image.save_png(str(path), img)
    np.testing.assert_array_equal(_decode_png(path.read_bytes()), img)
    with pytest.raises(ValueError):
        image.encode_png(img[..., 0])


def test_meshes_match_jax():
    for jm, tm in ((jre.two_planes(), tmesh.two_planes(device="cpu")),
                   (jre.fullscreen_quad(),
                    tmesh.fullscreen_quad(device="cpu"))):
        np.testing.assert_array_equal(tm.positions.numpy(),
                                      np.asarray(jm.positions))
        np.testing.assert_array_equal(tm.indices.numpy(),
                                      np.asarray(jm.indices))
        assert tm.attributes.keys() == jm.attributes.keys()
        for k in tm.attributes:
            np.testing.assert_array_equal(tm.attributes[k].numpy(),
                                          np.asarray(jm.attributes[k]))
        assert tm.num_triangles == jm.num_triangles


def test_fullscreen_quad_shaders_match_jax():
    jm, tm = jre.fullscreen_quad(), tmesh.fullscreen_quad(device="cpu")
    jc, jv = jshaders.passthrough_vertex(jm.positions, jm.attributes, {})
    tc, tv = tshaders.passthrough_vertex(tm.positions, tm.attributes, {})
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tv["uv"].numpy(), np.asarray(jv["uv"]))
    u8 = (np.random.RandomState(4).rand(16, 16, 4) * 255).astype(np.uint8)
    uv = np.random.RandomState(5).rand(24, 20, 2).astype(np.float32)
    want = jshaders.quad_sample_fragment(
        {"uv": jnp.asarray(uv)},
        {"compute_image": jre.texture_from_array(u8, srgb=False)})
    got = tshaders.quad_sample_fragment(
        {"uv": torch.from_numpy(uv)},
        {"compute_image": tres.texture_from_array(u8, srgb=False,
                                                  device="cpu")})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def test_entry_points_and_uploads_default_to_cuda():
    for fn in (tres.create_framebuffer, tres.texture_from_array,
               tmesh.mesh, tmesh.two_planes, raster_scenes.quad_grid_mesh,
               raster_scenes.scene):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    for mod in (basic_planes, multipass):
        assert mod.parse_args([]).device == "cuda"


def test_multipass_entry_point_on_cpu(tmp_path):
    """Two frames of the prepass + LESS_EQUAL lit pass at 256x144 through
    the entry point's host loop (whose record keeps the last framebuffer):
    the lit pass draws every pixel the prepass kept, and the PNG is
    written."""
    args = multipass.parse_args(["--frames", "2", "--width", "256",
                                 "--height", "144", "--device", "cpu",
                                 "--host-loop", "--out", str(tmp_path)])
    r = multipass.run(args)
    fb = r["frame"]
    assert r["triangles"] == 32 and os.path.exists(r["png"])
    drawn = fb.depth[:144, :256] < 1.0
    assert drawn.float().mean() > 0.05
    lit = (fb.color[:144, :256, :3] != 0).any(-1)
    assert bool((lit | ~drawn).all())
    png = _decode_png(open(r["png"], "rb").read())
    assert png.shape == (144, 256, 4)
