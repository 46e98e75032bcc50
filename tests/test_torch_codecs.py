"""The port's image codecs against PIL and OpenCV on the CPU: the baseline
JPEG decoder on PIL-written files (4:4:4, 4:2:2, 4:2:0, grey, restart
intervals, odd sizes, quality 75 and 97), the JPEG encoder's files decoded
by PIL, 16-bit PNG round trips, the image-size readers, and the files the
decoder refuses by name. The port never imports PIL or cv2; these tests do,
where the machine has them."""

import io

import numpy as np
import pytest

from nerf_kbs_tpu_torch.utils import images, jpeg

Image = pytest.importorskip("PIL.Image")


def _street(h, w, seed=0):
    """A frame with edges, gradients and noise: every run length and
    magnitude class of the entropy coder."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([np.sin(xx / 7.0) * 100 + 128, np.cos(yy / 5.0) * 80 + 120,
                    (xx * 3 + yy) % 256], -1)
    img[h // 3:h // 2, w // 4:w // 2] = [250, 20, 30]
    img = img + rng.normal(0, 10, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _pil_jpeg(img, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


# PIL's subsampling: 0 = 4:4:4, 1 = 4:2:2, 2 = 4:2:0
@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("quality", [75, 97])
@pytest.mark.parametrize("hw", [(47, 156), (33, 17), (64, 48)])
def test_jpeg_decoder_matches_pil(subsampling, quality, hw):
    """Colour files PIL writes, with and without restart markers: the
    decoder's RGB equals PIL's convert("RGB") (libjpeg-turbo's islow IDCT
    and fancy upsampling): max abs error 0, mean 0."""
    img = _street(*hw)
    for restart in ({}, {"restart_marker_blocks": 2}):
        data = _pil_jpeg(img, quality=quality, subsampling=subsampling, **restart)
        got, want = jpeg.decode_jpeg(data), _pil_rgb(data)
        assert got.dtype == np.uint8 and got.shape == want.shape == (*hw, 3)
        err = np.abs(got.astype(int) - want)
        assert err.max() == 0 and err.mean() == 0.0


@pytest.mark.parametrize("hw", [(47, 156), (9, 13)])
def test_jpeg_decoder_grey_and_views(hw, tmp_path):
    """A grey file decodes to (H, W) equal to PIL's 'L'; read_image gives the
    'RGB' and 'L' views PIL gives, by suffix (.jpg and .jpeg)."""
    img = _street(*hw)
    grey = _pil_jpeg(img[..., 1], quality=90)
    np.testing.assert_array_equal(jpeg.decode_jpeg(grey),
                                  np.asarray(Image.open(io.BytesIO(grey))))
    for name, data in (("g.jpeg", grey), ("c.jpg", _pil_jpeg(img, quality=85))):
        (tmp_path / name).write_bytes(data)
        for mode in ("RGB", "L"):
            np.testing.assert_array_equal(images.read_image(tmp_path / name, mode),
                                          np.asarray(Image.open(tmp_path / name).convert(mode)))
        assert images.image_size(tmp_path / name) == (hw[1], hw[0])


@pytest.mark.parametrize("quality", [75, 97])
@pytest.mark.parametrize("hw", [(47, 156), (375, 1242), (5, 7)])
def test_jpeg_encoder_files_decode_in_pil(quality, hw):
    """The encoder's baseline 4:2:0 files: PIL reads them at the right size,
    the port's decoder gives PIL's pixels exactly, and they are as close to
    the source as PIL's own file at the same quality (mean abs error within
    10% + 0.1 of PIL's; at q97 on the street frame both ~0.9)."""
    img = _street(*hw, seed=1)
    data = jpeg.encode_jpeg(img, quality=quality)
    im = Image.open(io.BytesIO(data))
    assert im.format == "JPEG" and im.size == (hw[1], hw[0]) and im.mode == "RGB"
    back = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), back)
    mine = np.abs(back.astype(int) - img).mean()
    pil = np.abs(_pil_rgb(_pil_jpeg(img, quality=quality)).astype(int) - img).mean()
    assert mine <= 1.1 * pil + 0.1, (mine, pil)
    grey = jpeg.encode_jpeg(img[..., 0], quality=quality)
    assert Image.open(io.BytesIO(grey)).mode == "L"
    np.testing.assert_array_equal(jpeg.decode_jpeg(grey), np.asarray(Image.open(io.BytesIO(grey))))


def test_jpeg_refuses_what_it_does_not_read():
    """Progressive files raise ValueError by name; so do 12-bit and
    arithmetic-coded frame headers, and bytes that are not a JPEG."""
    img = _street(24, 40)
    with pytest.raises(ValueError, match="progressive"):
        jpeg.decode_jpeg(_pil_jpeg(img, quality=90, progressive=True))
    data = bytearray(_pil_jpeg(img, quality=90))
    sof = data.index(b"\xff\xc0")
    twelve = bytearray(data)
    twelve[sof + 4] = 12
    with pytest.raises(ValueError, match="12-bit"):
        jpeg.decode_jpeg(bytes(twelve))
    arith = bytearray(data)
    arith[sof + 1] = 0xC9
    with pytest.raises(ValueError, match="arithmetic"):
        jpeg.decode_jpeg(bytes(arith))
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.decode_jpeg(b"\x89PNG\r\n\x1a\n")


@pytest.mark.parametrize("shape", [(47, 156), (1, 1), (13, 300)])
def test_png16_round_trips_bit_exact(shape, tmp_path):
    """uint16 depth maps: the port's 16-bit PNG decodes to the same array in
    the port, in PIL and in OpenCV (IMREAD_ANYDEPTH); PIL's and OpenCV's
    16-bit files decode bit-exact in the port (every filter type they
    choose)."""
    rng = np.random.default_rng(2)
    d = rng.integers(0, 65536, shape, dtype=np.uint16)
    d[:, : shape[1] // 2] = np.arange(shape[1] // 2, dtype=np.uint16) * 257  # smooth part
    data = images.encode_png_u16(d)
    np.testing.assert_array_equal(images.decode_png(data), d)
    (tmp_path / "d.png").write_bytes(data)
    pil = np.asarray(Image.open(tmp_path / "d.png"))
    np.testing.assert_array_equal(pil.astype(np.uint16), d)
    Image.fromarray(d).save(tmp_path / "p.png")
    got = images.decode_png((tmp_path / "p.png").read_bytes())
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, d)
    cv2 = pytest.importorskip("cv2")
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "d.png"), cv2.IMREAD_ANYDEPTH), d)
    cv2.imwrite(str(tmp_path / "c.png"), d)
    np.testing.assert_array_equal(images.decode_png((tmp_path / "c.png").read_bytes()), d)
    assert images.image_size(tmp_path / "c.png") == (shape[1], shape[0])


def test_png16_colour_and_refusals(tmp_path):
    """16-bit RGB decodes to uint16 (H, W, 3); its 8-bit views raise; an
    unknown suffix raises by name."""
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 65536, (6, 9, 3), dtype=np.uint16)
    np.testing.assert_array_equal(images.decode_png(images.encode_png_u16(rgb)), rgb)
    with pytest.raises(ValueError, match="8-bit"):
        images.convert(rgb, "RGB")
    with pytest.raises(ValueError, match="uint16"):
        images.encode_png_u16(rgb.astype(np.int32))
    (tmp_path / "f.bmp").write_bytes(b"BM")
    with pytest.raises(ValueError, match=r"\.png, \.jpg and \.jpeg"):
        images.read_image(tmp_path / "f.bmp", "RGB")
