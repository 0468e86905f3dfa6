"""An image's width from its file header, without decoding it.

The BOP scorer scales MSPD's pixel thresholds by the frame's width, which
the JAX package reads with PIL (`Image.open(p).size[0]`, a header-only
read) from rgb/*.png, rgb/*.jpg, depth/*.png or ITODD's gray/*.tif.  The
card's machine has no PIL, so this module reads the same field itself:

* PNG: the width of the IHDR chunk, which must come first;
* JPEG: the width of the first start-of-frame marker (SOF0-SOF15 but
  DHT, JPG and DAC), found by walking the marker segments (APPn, DQT,
  DHT, COM, ...) by their lengths;
* TIFF: tag 256 (ImageWidth) of the first image file directory, stored
  as SHORT or LONG, in either byte order (`II` or `MM`).

Anything else raises `ValueError`: a width is never guessed.
"""

from __future__ import annotations

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# SOFn markers: C0-CF except DHT (C4), JPG (C8) and DAC (CC).
_JPEG_SOF = set(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}
# Markers without a length field: TEM and RST0-7 (SOI and EOI end a walk).
_JPEG_BARE = {0x01, *range(0xD0, 0xD8)}


def _uint(data: bytes, order: str, size: int) -> int:
    if len(data) < size:
        raise ValueError("image header ends early")
    return int(np.frombuffer(data[:size], f"{order}u{size}")[0])


def _png_width(f) -> int:
    f.seek(8)
    chunk = f.read(12)
    if chunk[4:8] != b"IHDR":
        raise ValueError("PNG file does not start with its IHDR chunk")
    return _uint(chunk[8:12], ">", 4)


def _jpeg_width(f) -> int:
    f.seek(2)
    while True:
        b = f.read(1)
        if not b:
            raise ValueError("JPEG file has no start-of-frame marker")
        if b != b"\xff":
            raise ValueError("corrupt JPEG: expected a marker")
        marker = f.read(1)
        while marker == b"\xff":  # fill bytes
            marker = f.read(1)
        if not marker:
            raise ValueError("JPEG file has no start-of-frame marker")
        m = marker[0]
        if m in _JPEG_BARE:
            continue
        if m in (0xD8, 0xD9, 0xDA):  # SOI, EOI, or a scan before any frame
            raise ValueError("JPEG file has no start-of-frame marker")
        length = _uint(f.read(2), ">", 2)
        if m in _JPEG_SOF:
            body = f.read(5)  # precision, height, width
            return _uint(body[3:5], ">", 2)
        f.seek(length - 2, 1)


def _tiff_width(f, order: str) -> int:
    f.seek(2)
    if _uint(f.read(2), order, 2) != 42:
        raise ValueError("unsupported TIFF (not classic TIFF, e.g. BigTIFF)")
    f.seek(_uint(f.read(4), order, 4))
    n = _uint(f.read(2), order, 2)
    entries = f.read(12 * n)
    for i in range(n):
        e = entries[12 * i:12 * i + 12]
        if _uint(e[0:2], order, 2) != 256:
            continue
        kind = _uint(e[2:4], order, 2)
        if kind == 3:  # SHORT, left-justified in the value field
            return _uint(e[8:10], order, 2)
        if kind == 4:  # LONG
            return _uint(e[8:12], order, 4)
        raise ValueError(f"TIFF ImageWidth of field type {kind}")
    raise ValueError("TIFF file has no ImageWidth tag")


def image_width(path: str) -> int:
    """The width in pixels of a PNG, JPEG or TIFF file, from its header
    (what PIL's `Image.open(path).size[0]` gives)."""
    with open(path, "rb") as f:
        head = f.read(8)
        if head == _PNG_SIGNATURE:
            return _png_width(f)
        if head[:2] == b"\xff\xd8":
            return _jpeg_width(f)
        if head[:2] == b"II":
            return _tiff_width(f, "<")
        if head[:2] == b"MM":
            return _tiff_width(f, ">")
    raise ValueError(f"{path}: not a PNG, JPEG or TIFF file")
