"""Image helpers: 8-bit conversion, the turbo depth colormap, a PNG encoder
and decoder built on ``zlib`` and NumPy, and the readers a dataset needs
(``read_image`` by suffix, ``image_size`` from the header); JPEG is
``utils.jpeg``. No imaging package is needed.

The PNG decoder reads what a dataset holds: grey, grey + alpha, RGB, RGBA
and palette images, non-interlaced, with any of the five row filters, at 8
bits a sample (1, 2 and 4 for grey and palette) and at 16 (uint16, as depth
maps in centimetres are stored). ``convert`` gives the 'RGB' and 'L' views a
loader asks for, with PIL's integer luma for 'L', so
``convert(decode_png(b), "L") > 0`` is what ``np.asarray(Image.open(f)
.convert("L")) > 0`` gives.

The resizers give, in NumPy, what a loader got from an imaging package:
``resize_lanczos`` and ``resize_nearest`` are PIL's ``Image.resize`` with
LANCZOS (its fixed-point separable passes, bit for bit on uint8) and
NEAREST; ``resize_nearest_cv`` and ``resize_linear_cv`` are OpenCV's
``cv2.resize`` with INTER_NEAREST and INTER_LINEAR. The two nearest rules
pick different source pixels: PIL samples at pixel centres, OpenCV at
floor(x * scale)."""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np

from nerf_kbs_tpu_torch.utils import jpeg

# polynomial approximation of the turbo colormap (Google AI blog, 2019)
_TURBO_R = np.array([0.13572138, 4.61539260, -42.66032258, 132.13108234,
                     -152.94239396, 59.28637943])
_TURBO_G = np.array([0.09140261, 2.19418839, 4.84296658, -14.18503333,
                     4.27729857, 2.82956604])
_TURBO_B = np.array([0.10667330, 12.64194608, -60.58204836, 110.36276771,
                     -89.90310912, 27.34824973])


def _poly(c: np.ndarray, x: np.ndarray) -> np.ndarray:
    y = np.zeros_like(x)
    for coef in c[::-1]:
        y = y * x + coef
    return y


def apply_depth_colormap(depth: np.ndarray, accumulation: np.ndarray | None = None) -> np.ndarray:
    """Turbo colormap of depth normalised between its 2nd and 98th
    percentiles, modulated by accumulation. (H, W[, 1]) -> (H, W, 3)."""
    d = depth[..., 0] if depth.ndim == 3 else depth
    lo, hi = float(np.percentile(d, 2)), float(np.percentile(d, 98))
    x = np.clip((d - lo) / max(hi - lo, 1e-10), 0.0, 1.0)
    img = np.clip(np.stack([_poly(_TURBO_R, x), _poly(_TURBO_G, x), _poly(_TURBO_B, x)], -1), 0, 1)
    if accumulation is not None:
        a = accumulation[..., 0] if accumulation.ndim == 3 else accumulation
        img = img * a[..., None]
    return img


def to_uint8(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


def _chunk(tag: bytes, data: bytes) -> bytes:
    body = tag + data
    return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))


# PNG colour types by channel count of an 8-bit image: grey, grey + alpha,
# RGB, RGBA
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4, 3: 1}


def _encode(px: np.ndarray, depth: int, level: int) -> bytes:
    """(H, W, C) samples as big-endian bytes (H, W, C * depth / 8) -> PNG.
    Every row uses the Sub filter (each byte minus the same byte of the pixel
    to its left), which compresses photographs, depth maps and flat label
    maps well and decodes with one cumulative sum."""
    h, w, c = px.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"{c} channels: a PNG holds 1 to 4")
    b = px.astype(">u2").view(np.uint8).reshape(h, w, 2 * c) if depth == 16 else px
    sub = b.copy()
    sub[:, 1:] -= b[:, :-1]  # uint8 arithmetic wraps, as the filter does
    raw = np.concatenate([np.ones((h, 1), np.uint8), sub.reshape(h, -1)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, _COLOR_TYPE[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level)) + _chunk(b"IEND", b""))


def encode_png_u8(pixels: np.ndarray, level: int = 6) -> bytes:
    """(H, W) or (H, W, C) uint8, C in 1..4 -> 8-bit PNG bytes."""
    px = np.ascontiguousarray(pixels, dtype=np.uint8)
    return _encode(px[:, :, None] if px.ndim == 2 else px, 8, level)


def encode_png_u16(pixels: np.ndarray, level: int = 6) -> bytes:
    """(H, W) or (H, W, C) uint16, C in 1..4 -> 16-bit PNG bytes (a depth map
    in centimetres: one channel)."""
    px = np.asarray(pixels)
    if px.dtype != np.uint16:
        raise ValueError(f"a 16-bit PNG takes uint16 samples, not {px.dtype}")
    return _encode(px[:, :, None] if px.ndim == 2 else px, 16, level)


def encode_png(img: np.ndarray) -> bytes:
    """(H, W, 3) float in [0, 1] -> 8-bit RGB PNG bytes."""
    return encode_png_u8(to_uint8(img))


def _unfilter_loop(kind: int, line: bytearray, prior: bytes, bpp: int) -> None:
    """Average (3) and Paeth (4) in place: each byte depends on the
    reconstructed byte to its left, so they go along the row."""
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        b = prior[i]
        if kind == 3:
            line[i] = (line[i] + ((a + b) >> 1)) & 0xFF
        else:
            c = prior[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            line[i] = (line[i] + pred) & 0xFF


def png_size(data: bytes) -> tuple[int, int]:
    """(width, height) from the IHDR chunk."""
    if data[:8] != b"\x89PNG\r\n\x1a\n" or data[12:16] != b"IHDR":
        raise ValueError("not a PNG file")
    return struct.unpack(">II", data[16:24])


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> pixels: (H, W) grey, (H, W, 2) grey + alpha, (H, W, 3)
    RGB or (H, W, 4) RGBA, uint8, or uint16 for a 16-bit file; a palette
    image comes back as (H, W, 3) RGB from its palette. Raises ValueError on
    interlaced files and on a bad chunk CRC."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG file")
    pos, idat, palette, ihdr = 8, [], None, None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(tag + body) != crc:
            raise ValueError(f"PNG chunk {tag!r}: bad CRC")
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + length
    if ihdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = ihdr
    if interlace:
        raise ValueError("interlaced PNG: not read")
    if color not in _CHANNELS:
        raise ValueError(f"PNG colour type {color}")
    # 1, 2 and 4 bits a sample only for grey and palette images, 16 for all
    # but palette, as the format allows
    if not (depth == 8 or (depth in (1, 2, 4) and color in (0, 3))
            or (depth == 16 and color != 3)):
        raise ValueError(f"PNG bit depth {depth} (colour type {color}): not a valid PNG")
    channels = _CHANNELS[color]
    bpp = channels * 2 if depth == 16 else channels  # bytes a pixel for the filters
    stride = w * bpp if depth >= 8 else (w * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"PNG data of {raw.size} bytes for {h} rows of {stride + 1}")
    rows = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for r in range(h):
        kind, line = int(rows[r, 0]), rows[r, 1:]
        if kind == 0:
            out[r] = line
        elif kind == 1:
            out[r] = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            out[r] = line + prior
        elif kind in (3, 4):
            buf = bytearray(line.tobytes())
            _unfilter_loop(kind, buf, prior.tobytes(), bpp)
            out[r] = np.frombuffer(buf, np.uint8)
        else:
            raise ValueError(f"PNG row filter {kind}")
        prior = out[r]
    if depth == 16:
        out = out.view(">u2").astype(np.uint16)
        return out.reshape(h, w) if channels == 1 else out.reshape(h, w, channels)
    if depth < 8:
        # samples packed from the high bits down; grey scales to 0..255
        bits = np.unpackbits(out, axis=1).reshape(h, -1, depth)
        out = (bits << np.arange(depth - 1, -1, -1, dtype=np.uint8)).sum(-1, dtype=np.uint8)[:, :w]
        if color == 0:
            out = out * np.uint8(255 // (2**depth - 1))
    if color == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        return palette[out]
    return out.reshape(h, w) if bpp == 1 else out.reshape(h, w, bpp)


def convert(pixels: np.ndarray, mode: str) -> np.ndarray:
    """PIL's ``convert`` of decoded 8-bit pixels: 'RGB' (H, W, 3), grey
    repeated and alpha dropped; 'L' (H, W), the grey channel or the integer
    luma (19595 R + 38470 G + 7471 B + 0x8000) >> 16."""
    if pixels.dtype != np.uint8:
        raise ValueError(f"{pixels.dtype} pixels: 'RGB' and 'L' views are of 8-bit images")
    px = pixels[:, :, None] if pixels.ndim == 2 else pixels
    c = px.shape[2]
    if mode == "RGB":
        return px[:, :, :3] if c >= 3 else np.repeat(px[:, :, :1], 3, axis=2)
    if mode == "L":
        if c < 3:
            return px[:, :, 0]
        rgb = px[:, :, :3].astype(np.uint32)
        luma = (19595 * rgb[..., 0] + 38470 * rgb[..., 1] + 7471 * rgb[..., 2] + 0x8000) >> 16
        return luma.astype(np.uint8)
    raise ValueError(f"unknown mode {mode!r}: 'RGB' or 'L'")


def _suffix(path) -> str:
    suffix = str(path).rsplit(".", 1)[-1].lower() if "." in str(path) else ""
    if suffix not in ("png", "jpg", "jpeg"):
        raise ValueError(f"{path}: images are read from .png, .jpg and .jpeg files")
    return suffix


def read_image(path, mode: str) -> np.ndarray:
    """The 'RGB' or 'L' view of a PNG or JPEG file (by suffix), as PIL's
    ``Image.open(path).convert(mode)`` gives it."""
    with open(path, "rb") as f:
        data = f.read()
    pixels = decode_png(data) if _suffix(path) == "png" else jpeg.decode_jpeg(data)
    return convert(pixels, mode)


def image_size(path) -> tuple[int, int]:
    """(width, height) of a PNG or JPEG file, from its header."""
    with open(path, "rb") as f:
        data = f.read() if _suffix(path) != "png" else f.read(24)
    return png_size(data) if _suffix(path) == "png" else jpeg.image_size(data)


# PIL's fixed-point precision of the resampling coefficients (8-bit images)
_PRECISION_BITS = 32 - 8 - 2


def _lanczos3(x: float) -> float:
    def sinc(v: float) -> float:
        if v == 0.0:
            return 1.0
        v = v * math.pi
        return math.sin(v) / v

    return sinc(x) * sinc(x / 3.0) if -3.0 <= x < 3.0 else 0.0


def _lanczos_coefficients(in_size: int, out_size: int):
    """PIL's ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` for one
    axis: (first source index of each output (out,), integer taps (out,
    ksize)). The arithmetic is PIL's, in double, one output at a time."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 3.0 * filterscale
    ss = 1.0 / filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    taps = np.zeros((out_size, ksize), np.int64)
    first = np.zeros(out_size, np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        n = min(int(center + support + 0.5), in_size) - xmin
        w = [_lanczos3((x + xmin - center + 0.5) * ss) for x in range(n)]
        total = 0.0
        for v in w:
            total += v
        for x, v in enumerate(w):
            k = v / total if total != 0.0 else v
            taps[xx, x] = int((-0.5 if k < 0 else 0.5) + k * (1 << _PRECISION_BITS))
        first[xx] = xmin
    return first, taps


def _lanczos_pass(px: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    first, taps = _lanczos_coefficients(px.shape[axis], out_size)
    src = np.moveaxis(px, axis, 0).astype(np.int64)
    # taps past a row's support are 0: pad so that every tap index exists
    src = np.concatenate([src, np.zeros((taps.shape[1],) + src.shape[1:], np.int64)])
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    col = (-1,) + (1,) * (src.ndim - 1)
    for k in range(taps.shape[1]):
        acc += src[first + k] * taps[:, k].reshape(col)
    return np.moveaxis(np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8), 0, axis)


def resize_lanczos(pixels: np.ndarray, width: int, height: int) -> np.ndarray:
    """PIL's ``Image.resize((width, height), Image.LANCZOS)`` of uint8 (H, W)
    or (H, W, C) pixels: the horizontal pass, rounded to uint8, then the
    vertical pass, each only where that size changes."""
    if pixels.dtype != np.uint8:
        raise ValueError(f"{pixels.dtype} pixels: the LANCZOS resizer takes uint8")
    out = pixels
    if width != pixels.shape[1]:
        out = _lanczos_pass(out, 1, width)
    if height != pixels.shape[0]:
        out = _lanczos_pass(out, 0, height)
    return out


def _pil_nearest_index(in_size: int, out_size: int) -> np.ndarray:
    # PIL's affine scaling walks the source coordinate by repeated addition
    # from the first pixel centre; cumsum adds in the same order
    a = in_size / out_size
    steps = np.full(out_size, a)
    steps[0] = a * 0.5
    return np.minimum(np.cumsum(steps).astype(np.int64), in_size - 1)


def resize_nearest(pixels: np.ndarray, width: int, height: int) -> np.ndarray:
    """PIL's ``Image.resize((width, height), Image.NEAREST)``: each output
    pixel takes the source pixel under its centre."""
    return pixels[_pil_nearest_index(pixels.shape[0], height)][
        :, _pil_nearest_index(pixels.shape[1], width)]


def _cv_nearest_index(in_size: int, out_size: int) -> np.ndarray:
    inv = 1.0 / (out_size / in_size)
    return np.minimum(np.floor(np.arange(out_size) * inv).astype(np.int64), in_size - 1)


def resize_nearest_cv(arr: np.ndarray, width: int, height: int) -> np.ndarray:
    """OpenCV's ``cv2.resize(arr, (width, height),
    interpolation=cv2.INTER_NEAREST)``: output x takes source floor(x *
    in / out)."""
    return arr[_cv_nearest_index(arr.shape[0], height)][
        :, _cv_nearest_index(arr.shape[1], width)]


def _cv_linear_weights(in_size: int, out_size: int):
    scale = 1.0 / (out_size / in_size)
    f = ((np.arange(out_size) + 0.5) * scale - 0.5).astype(np.float32)
    lo = np.floor(f).astype(np.int64)
    f = f - lo.astype(np.float32)
    # OpenCV clamps at the borders: the edge pixel with weight 1
    left, right = lo < 0, lo >= in_size - 1
    f[left | right] = 0.0
    lo[left] = 0
    lo[right] = in_size - 1
    return lo, np.minimum(lo + 1, in_size - 1), np.float32(1.0) - f, f


def resize_linear_cv(arr: np.ndarray, width: int, height: int) -> np.ndarray:
    """OpenCV's ``cv2.resize(arr, (width, height),
    interpolation=cv2.INTER_LINEAR)`` of float32 (H, W) or (H, W, C) data
    (optical flow): half-pixel-centre bilinear weights in float32, the
    horizontal pass then the vertical."""
    a = np.asarray(arr, np.float32)
    x0, x1, xa, xb = _cv_linear_weights(a.shape[1], width)
    y0, y1, ya, yb = _cv_linear_weights(a.shape[0], height)
    row = (1, -1) + (1,) * (a.ndim - 2)
    col = (-1,) + (1,) * (a.ndim - 1)
    rows = a[:, x0] * xa.reshape(row) + a[:, x1] * xb.reshape(row)
    return rows[y0] * ya.reshape(col) + rows[y1] * yb.reshape(col)
