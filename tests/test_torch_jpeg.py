"""The port's baseline JPEG decoder (`utils/jpeg.py`) against PIL's decode
(Pillow 12 through libjpeg-turbo: ISLOW IDCT, fancy upsampling), and the
numpy JPEG writer of `tests/helpers/jpeg_writer.py` that the MegaPose
trees use.

Tolerance: none.  Every file here decodes to PIL's array bit for bit:
files PIL writes at quality 50 / 75 / 95 with subsampling 4:4:4, 4:2:2
and 4:2:0, greyscale, restart intervals (`restart_marker_rows` /
`restart_marker_blocks`), sizes that are no multiple of the MCU (37 x 53,
1 x 1, 2 x 5, 9 x 3, 33 x 17) and 480 x 640 frames; and every file the
writer produces.  Progressive, arithmetic-coded and 12-bit files raise
ValueError.
"""

import io
import pathlib
import sys

import numpy as np
import pytest
from PIL import Image

from sam6d_tpu_torch.utils.jpeg import decode_jpeg, read_jpeg

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "helpers"))
import jpeg_writer  # noqa: E402

SIZES = [(37, 53), (1, 1), (2, 5), (9, 3), (33, 17), (16, 16), (120, 160)]


def textured(h, w, seed=0, noise=20.0):
    """Smooth colour waves plus noise: many non-zero AC coefficients,
    with chroma worth subsampling."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([128 + 100 * np.sin(x / 7.0 + c) * np.cos(y / 11.0)
                    for c in range(3)], axis=-1)
    img += rng.randn(h, w, 3) * noise
    return np.clip(img, 0, 255).astype(np.uint8)


def pil_bytes(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def assert_pil_equal(data: bytes):
    want = np.asarray(Image.open(io.BytesIO(data)))
    got = decode_jpeg(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality", [50, 75, 95])
def test_pil_files_decode_bit_for_bit(size, quality):
    img = textured(*size, seed=quality)
    for subsampling in (0, 1, 2):  # 4:4:4, 4:2:2, 4:2:0
        assert_pil_equal(pil_bytes(img, quality=quality,
                                   subsampling=subsampling))
    assert_pil_equal(pil_bytes(img[..., 1], quality=quality))  # greyscale


@pytest.mark.parametrize("restart", [{"restart_marker_rows": 1},
                                     {"restart_marker_blocks": 3}])
def test_restart_intervals_decode_bit_for_bit(restart):
    for size in ((37, 53), (120, 160), (8, 8)):
        img = textured(*size, seed=3)
        for subsampling in (0, 2):
            data = pil_bytes(img, quality=80, subsampling=subsampling,
                             **restart)
            assert b"\xff\xdd" in data  # a DRI segment
            assert_pil_equal(data)


def test_a_480x640_frame_decodes_bit_for_bit():
    img = textured(480, 640, seed=7)
    assert_pil_equal(pil_bytes(img, quality=95, subsampling=2))


@pytest.mark.parametrize("rows", [1, 17, 64, 100, 119, 120, 500])
def test_rows_stops_early_and_keeps_the_rows(rows):
    """The MegaPose loader decodes only down to the crop's bottom: the
    first `rows` rows equal the full decode's."""
    data = pil_bytes(textured(120, 160, seed=2), quality=95, subsampling=2)
    full = decode_jpeg(data)
    part = decode_jpeg(data, rows=rows)
    assert min(rows, 120) <= part.shape[0] <= 120
    np.testing.assert_array_equal(part, full[:part.shape[0]])
    if rows <= 64:
        assert part.shape[0] < 120


def test_unsupported_files_raise_naming_them(tmp_path):
    img = textured(32, 48)
    with pytest.raises(ValueError, match="progressive"):
        decode_jpeg(pil_bytes(img, quality=90, progressive=True))
    base = pil_bytes(img, quality=90)
    sof = base.index(b"\xff\xc0")
    with pytest.raises(ValueError, match="arithmetic"):
        decode_jpeg(base[:sof] + b"\xff\xc9" + base[sof + 2:])
    twelve = bytearray(base)
    twelve[sof + 4] = 12
    with pytest.raises(ValueError, match="12-bit"):
        decode_jpeg(bytes(twelve))
    with pytest.raises(ValueError, match="not a JPEG"):
        decode_jpeg(b"\x89PNG\r\n\x1a\n")
    with pytest.raises(ValueError, match="CMYK"):
        buf = io.BytesIO()
        Image.fromarray(np.dstack([img, img[..., :1]])).convert(
            "CMYK").save(buf, "JPEG")
        decode_jpeg(buf.getvalue())


def test_read_jpeg_reads_a_file(tmp_path):
    img = textured(37, 53)
    path = tmp_path / "a.jpg"
    Image.fromarray(img).save(path, quality=90)
    np.testing.assert_array_equal(read_jpeg(str(path)),
                                  np.asarray(Image.open(path)))


def test_writer_tables_are_libjpegs():
    """The writer's quality-scaled quantization tables and standard
    Huffman tables are the ones PIL (libjpeg) writes."""
    for quality in (50, 75, 95):
        im = Image.open(io.BytesIO(pil_bytes(textured(16, 16),
                                             quality=quality)))
        assert list(im.quantization[0]) == jpeg_writer.quant_table(
            jpeg_writer._LUMA_Q, quality).tolist()
        assert list(im.quantization[1]) == jpeg_writer.quant_table(
            jpeg_writer._CHROMA_Q, quality).tolist()
    data = pil_bytes(textured(16, 16), quality=75)
    for bits, vals in (jpeg_writer.DC_LUMA, jpeg_writer.AC_LUMA,
                       jpeg_writer.DC_CHROMA, jpeg_writer.AC_CHROMA):
        assert bytes(bits) + bytes(vals) in data


@pytest.mark.parametrize("subsampling", ["4:2:0", "4:4:4"])
@pytest.mark.parametrize("size", [(37, 53), (1, 1), (9, 3), (120, 160)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_writer_files_decode_in_pil_and_the_port(tmp_path, size, subsampling):
    img = textured(*size, seed=5, noise=4.0)
    path = tmp_path / "w.jpg"
    jpeg_writer.write_jpeg(str(path), img, 95, subsampling)
    with Image.open(path) as im:
        assert im.format == "JPEG" and im.mode == "RGB"
        assert im.layer[0][1:3] == ((2, 2) if subsampling == "4:2:0"
                                    else (1, 1))
        want = np.asarray(im)
    np.testing.assert_array_equal(read_jpeg(str(path)), want)
    # A faithful encoding: within the quantization noise of the source.
    assert np.abs(want.astype(int) - img).mean() < 6.0
