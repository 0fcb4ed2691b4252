"""Port vs JAX: PNG decoding (``io.image.decode_png``, ``load_image``), the
port's native tier (``native.loader``: ``read_ply``, ``png_encode``,
``png_decode``) and ``core.resources.texture_from_file``.

Tolerances: none. Decoded pixels equal the image written, byte for byte,
and equal the native decoder's and JAX's ``load_image``; the native PLY
reader equals the numpy reader; texel tables equal JAX's.
"""

import struct
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from ray_eater_tpu.core import resources as jres
from ray_eater_tpu.io import image as jimage
from ray_eater_tpu.models import gaussians as jgauss
from ray_eater_tpu_torch.core import resources as tres
from ray_eater_tpu_torch.io import image
from ray_eater_tpu_torch.models import gaussians
from ray_eater_tpu_torch.native import loader as native

ROOT = Path(__file__).resolve().parent.parent
#: channels and PNG colour type of each layout
MODES = {"gray": (1, 0), "gray_alpha": (2, 4), "rgb": (3, 2), "rgba": (4, 6)}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else b if pb <= pc else c


def _filter_row(ft, cur, prior, bpp):
    """PNG row filter ``ft`` of one row (the encoder's side)."""
    out = bytearray(len(cur))
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[ft]
        out[i] = (cur[i] - pred) & 255
    return bytes(out)


def _png(img, ctype, filters, depth=8, interlace=0):
    """PNG bytes of ``img`` (h, w, c) u8 with row y filtered by
    ``filters[y % len(filters)]``."""
    h, w, c = img.shape
    rows, prior = [], bytes(w * c)
    for y in range(h):
        cur = img[y].tobytes()
        ft = filters[y % len(filters)]
        rows.append(bytes([ft]) + _filter_row(ft, cur, prior, c))
        prior = cur

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


def _image(mode, seed, h=11, w=13):
    c = MODES[mode][0]
    return (np.random.RandomState(seed).rand(h, w, c) * 256).astype(np.uint8)


@pytest.mark.parametrize("mode", list(MODES))
def test_decode_png_all_filters(mode, tmp_path):
    """Every layout with each of the five filters forced (rows cycle None,
    Sub, Up, Average, Paeth), and with one filter for every row: the
    pixels written, the native decoder's, and JAX's ``load_image``."""
    img = _image(mode, seed=len(mode))
    for filters in ([0, 1, 2, 3, 4], [4], [3], [1], [2]):
        data = _png(img, MODES[mode][1], filters)
        got = image.decode_png(data)
        np.testing.assert_array_equal(got, img, err_msg=str(filters))
        np.testing.assert_array_equal(native.png_decode(data), got)
        path = tmp_path / f"{mode}.png"
        path.write_bytes(data)
        rgba = image._to_rgba(got)
        np.testing.assert_array_equal(jimage.load_image(str(path)), rgba)
        np.testing.assert_array_equal(image.load_image(str(path)), rgba)


def test_decode_png_of_the_encoders(tmp_path):
    """PNGs written by the port's stdlib encoder and the native encoder
    (RGB and RGBA) decode to the pixels written."""
    for c in (3, 4):
        img = (np.random.RandomState(c).rand(19, 23, c) * 256).astype(
            np.uint8)
        for data in (image.encode_png(img), native.png_encode(img)):
            np.testing.assert_array_equal(image.decode_png(data), img)


@pytest.mark.parametrize("case", ["16-bit", "palette", "interlaced"])
def test_unsupported_png_raises(case, tmp_path, monkeypatch):
    img = _image("rgb", seed=3, h=4, w=4)
    kw = {"16-bit": dict(depth=16), "palette": dict(),
          "interlaced": dict(interlace=1)}[case]
    ctype = 3 if case == "palette" else 2
    data = _png(img, ctype, [0], **kw)
    want = {"16-bit": "bit depth 16",
            "palette": r"colour type 3 \(palette\)",
            "interlaced": "interlaced"}[case]
    with pytest.raises(image.UnsupportedPNG, match=want):
        image.decode_png(data)
    with pytest.raises(ValueError):
        native.png_decode(data)
    # load_image: neither decoder reads it; without PIL the error stands
    path = tmp_path / "x.png"
    path.write_bytes(data)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(image.UnsupportedPNG, match=want):
        image.load_image(str(path))


def test_load_image_falls_back_to_pil(tmp_path):
    """A palette PNG (PIL's own) goes to PIL, as JAX's load_image reads
    it."""
    from PIL import Image
    img = _image("rgb", seed=5, h=9, w=7)
    path = str(tmp_path / "p.png")
    Image.fromarray(img).convert("P").save(path)
    np.testing.assert_array_equal(image.load_image(path),
                                  jimage.load_image(path))


def test_native_source_is_the_jax_copy():
    port = ROOT / "ray_eater_tpu_torch/native/src/rayeater_native.cpp"
    jax_ = ROOT / "ray_eater_tpu/native/src/rayeater_native.cpp"
    assert port.read_bytes() == jax_.read_bytes()
    assert native.available()
    so = native.library_path()
    assert so.parent == ROOT / "ray_eater_tpu_torch" / "_build"
    assert so.exists()


@pytest.fixture(scope="module")
def ply_files(tmp_path_factory):
    """``tests/test_torch_sh.py``'s files: a degree-3 cloud written by the
    JAX package (binary) and the same vertices as ascii with a trailing
    face element."""
    root = tmp_path_factory.mktemp("ply")
    rng = np.random.RandomState(4)
    n, bands = 40, 15
    jc = jgauss.gaussian_cloud(
        rng.randn(n, 3), np.exp(rng.randn(n, 3) * 0.3 - 3.0),
        rng.randn(n, 4), rng.rand(n) * 0.9 + 0.05, rng.rand(n, 3),
        (rng.randn(n, bands, 3) * 0.3).astype(np.float32))
    binary = str(root / "jax.ply")
    jgauss.save_ply(binary, jc)
    props, data = gaussians._read_ply_numpy(binary)
    ascii_ = str(root / "ascii.ply")
    with open(ascii_, "w") as f:
        f.write("ply\nformat ascii 1.0\ncomment written by the test\n"
                f"element vertex {len(data)}\n")
        f.writelines(f"property float {p}\n" for p in props)
        f.write("element face 0\nproperty list uchar int vertex_indices\n"
                "end_header\n")
        for row in data:
            f.write(" ".join(repr(float(v)) for v in row) + "\n")
    return binary, ascii_


@pytest.mark.parametrize("which", [0, 1])
def test_native_read_ply_matches_numpy(ply_files, which):
    path = ply_files[which]
    props, data = native.read_ply(path)
    want_props, want = gaussians._read_ply_numpy(path)
    assert props == want_props and len(props) == 62
    np.testing.assert_array_equal(data, want)
    # load_ply takes the native reader when it is built
    assert gaussians._read_ply_vertices(path)[0] == props


def test_texture_from_file_matches_jax(tmp_path):
    """The checkerboard written as PNG and read back by texture_from_file:
    the texel tables of JAX's texture_from_file, and of the array
    upload."""
    from ray_eater_tpu_torch.raster_scenes import checker_rgba
    u8 = checker_rgba()
    path = str(tmp_path / "checker.png")
    image.save_png(path, u8)
    jt = jres.texture_from_file(path, jres.Sampler(
        address_mode=jres.AddressMode.MIRRORED_REPEAT, mipmap=True))
    tt = tres.texture_from_file(path, tres.Sampler(
        address_mode=tres.AddressMode.MIRRORED_REPEAT, mipmap=True),
        device="cpu")
    ta = tres.texture_from_array(u8, tres.Sampler(
        address_mode=tres.AddressMode.MIRRORED_REPEAT, mipmap=True),
        device="cpu")
    for name in ("data", "packed", "mip_table", "win_table"):
        got = getattr(tt, name)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(jt, name)), name)
        assert torch.equal(got, getattr(ta, name)), name
    assert tt.mip_dims == jt.mip_dims and tt.win_dims == jt.win_dims
    assert tt.data.device.type == "cpu"


def test_basic_planes_texture_search(tmp_path, monkeypatch):
    """$RAYEATER_TEXTURE first, then the checkerboard."""
    from ray_eater_tpu_torch import basic_planes
    from ray_eater_tpu_torch.raster_scenes import checker_rgba
    u8 = checker_rgba()[::-1].copy()
    path = tmp_path / "t.png"
    image.save_png(str(path), u8)
    monkeypatch.setenv("RAYEATER_TEXTURE", str(path))
    assert basic_planes.texture_candidates() == (str(path),)
    got = basic_planes.load_texture("cpu")
    assert torch.equal(got.data,
                       tres.texture_from_array(u8, device="cpu").data)
    monkeypatch.setenv("RAYEATER_TEXTURE", str(tmp_path / "missing.png"))
    got = basic_planes.load_texture("cpu")
    assert torch.equal(got.data, tres.texture_from_array(
        checker_rgba(), device="cpu").data)
