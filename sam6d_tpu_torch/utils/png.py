"""PNG reading and writing with the standard library's zlib and numpy.

The card's machine has no PIL, so the port reads and writes the files of
the demo's contract (template and mask PNGs, the RGB frame, the 16-bit
depth PNG, the visualisation) itself.  Where the JAX package calls
`np.asarray(Image.open(path))` the port calls `read_png(path)`, and where
it calls `Image.fromarray(a).save(path)` the port calls
`write_png(path, a)`; the arrays are PIL's:

* colour types 0 / 2 / 4 / 6 (L, RGB, LA, RGBA) at 8 bits -> uint8
  (H, W), (H, W, 3), (H, W, 2), (H, W, 4);
* colour type 0 at 16 bits (depth) -> uint16 (H, W), the samples stored
  big-endian.

Interlaced (Adam7) and palette images raise `ValueError`, as does any
other bit depth: they are never decoded wrongly.

Scanlines are unfiltered with numpy.  None, Sub and Up rows are
vectorised a row at a time.  Average and Paeth read the pixel to their
left, which is itself being reconstructed, so an image with such rows is
reconstructed along anti-diagonals: a pixel depends only on its left,
upper and upper-left neighbours, which all lie on earlier diagonals, so
each of the W + H - 1 steps computes every pixel of one diagonal at once.

`write_png` writes 8-bit L and RGB and 16-bit L, every row with filter
None.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Colour type -> channels, for the types this codec reads.
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG file ends before its IEND chunk")


def _paeth(a, b, c):
    """The Paeth predictor of int16 arrays (PNG spec, section 9.4)."""
    pa = np.abs(b - c)
    pb = np.abs(a - c)
    pc = np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_rows(ftype, filt):
    """Rows of filter types 0-2 only: one vectorised step a row."""
    H = len(ftype)
    out = np.empty_like(filt)
    prev = np.zeros_like(filt[0])
    for y in range(H):
        row, f = filt[y], ftype[y]
        if f == 0:
            cur = row
        elif f == 1:
            cur = np.cumsum(row, axis=0, dtype=np.uint8)
        else:
            cur = row + prev
        out[y] = prev = cur
    return out


def _unfilter_diagonals(ftype, filt):
    """Any filter types: one step an anti-diagonal x + y = t."""
    H, W, bpp = filt.shape
    f16 = filt.astype(np.int16)
    # out[y + 1, x + 1] is pixel (y, x); row 0 and column 0 are the zero
    # neighbours outside the image.
    out = np.zeros((H + 1, W + 1, bpp), np.int16)
    ft = ftype.astype(np.int16)[:, None]
    for t in range(W + H - 1):
        ys = np.arange(max(0, t - W + 1), min(H, t + 1))
        xs = t - ys
        a = out[ys + 1, xs]
        b = out[ys, xs + 1]
        c = out[ys, xs]
        f = ft[ys]
        pred = np.where(f == 1, a, np.where(f == 2, b, np.where(
            f == 3, (a + b) >> 1, np.where(f == 4, _paeth(a, b, c), 0))))
        out[ys + 1, xs + 1] = (f16[ys, xs] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> the array PIL's `np.asarray(Image.open(...))` gives."""
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG file has no IHDR chunk")
    W, H, depth, ctype, compression, method, interlace = header
    if interlace:
        raise ValueError("interlaced (Adam7) PNG is not supported")
    if ctype == 3:
        raise ValueError("palette (colour type 3) PNG is not supported")
    if ctype not in _CHANNELS or compression or method:
        raise ValueError(f"unsupported PNG colour type {ctype} "
                         f"(compression {compression}, filter {method})")
    if depth != 8 and not (depth == 16 and ctype == 0):
        raise ValueError(f"unsupported PNG bit depth {depth} for colour "
                         f"type {ctype}")
    channels = _CHANNELS[ctype]
    bpp = channels * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (1 + W * bpp):
        raise ValueError(f"PNG data holds {raw.size} bytes, expected "
                         f"{H * (1 + W * bpp)}")
    raw = raw.reshape(H, 1 + W * bpp)
    ftype = raw[:, 0]
    if (ftype > 4).any():
        raise ValueError(f"PNG filter type {int(ftype.max())} is invalid")
    filt = raw[:, 1:].reshape(H, W, bpp)
    if (ftype <= 2).all():
        pixels = _unfilter_rows(ftype, filt)
    else:
        pixels = _unfilter_diagonals(ftype, filt)
    if depth == 16:
        pixels = pixels.reshape(H, W * 2).view(">u2").astype(np.uint16)
    return pixels.reshape(H, W) if channels == 1 else pixels


def encode_png(image: np.ndarray) -> bytes:
    """uint8 (H, W) or (H, W, 3), or uint16 (H, W) -> PNG bytes."""
    image = np.asarray(image)
    if image.dtype == np.uint8 and image.ndim == 2:
        ctype, depth = 0, 8
    elif image.dtype == np.uint8 and image.ndim == 3 and image.shape[2] == 3:
        ctype, depth = 2, 8
    elif image.dtype == np.uint16 and image.ndim == 2:
        ctype, depth = 0, 16
        image = image.astype(">u2")
    else:
        raise ValueError(f"cannot write a PNG of dtype {image.dtype} and "
                         f"shape {image.shape}")
    H, W = image.shape[:2]
    rows = np.ascontiguousarray(image).view(np.uint8).reshape(H, -1)
    raw = np.concatenate([np.zeros((H, 1), np.uint8), rows], axis=1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype,
                                         0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def write_png(path: str, image: np.ndarray) -> None:
    data = encode_png(image)
    with open(path, "wb") as f:
        f.write(data)
