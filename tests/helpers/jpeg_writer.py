"""A baseline JPEG encoder in numpy, for writing test trees.

The card's machine has no PIL, so the MegaPose-layout trees that the
tests and `chip_smoke.py` write get their `.rgb.jpg` frames from here:
JFIF, baseline sequential Huffman coding with the standard tables of
ITU-T T.81 Annex K (quantization scaled by `quality` as libjpeg's
`jpeg_quality_scaling` scales it, Huffman tables K.3-K.6), 8-bit YCbCr,
4:2:0 or 4:4:4, one interleaved scan, no restart markers.  The forward
DCT is float64, so the files are a valid encoding of the image, not
libjpeg's byte stream.  Numpy only: nothing here imports PIL, JAX or the
package, and the whole bit stream is built with array operations (the
symbols of every block at once, then one bit array).
"""

from __future__ import annotations

import numpy as np

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_CHROMA_Q = np.full(64, 99)
_CHROMA_Q[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]

# (bits: codes of each length 1..16, values), T.81 K.3-K.6.
DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
             list(range(12)))
AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])
AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
    0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A,
    0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
    0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's jpeg_quality_scaling + jpeg_add_quant_table (baseline:
    entries clamped to [1, 255]); natural order."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int64)


def _codes(table):
    """(bits, values) -> per symbol (code, length) arrays of 256."""
    bits, vals = table
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for n in range(1, 17):
        for _ in range(bits[n - 1]):
            code_of[vals[k]], len_of[vals[k]] = code, n
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)
    c = np.where(k == 0, np.sqrt(1 / 8), np.sqrt(2 / 8))
    return c[:, None] * np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16)


def _blocks(plane: np.ndarray, bh: int, bw: int) -> np.ndarray:
    """(H, W) float plane, edge-padded to (8 bh, 8 bw) -> (bh, bw, 8, 8)."""
    H, W = plane.shape
    p = np.pad(plane, ((0, 8 * bh - H), (0, 8 * bw - W)), mode="edge")
    return p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)


def _size(v: np.ndarray) -> np.ndarray:
    """The JPEG size category: bits of |v| (0 for 0)."""
    return np.ceil(np.log2(np.abs(v) + 1)).astype(np.int64)


def _value_bits(v: np.ndarray, s: np.ndarray) -> np.ndarray:
    return np.where(v >= 0, v, v + (1 << s) - 1)


def _pack(codes: np.ndarray, lengths: np.ndarray) -> bytes:
    """Concatenate variable-length codes (MSB first), pad with 1 bits,
    stuff a 0x00 after every 0xFF byte."""
    total = int(lengths.sum())
    start = np.cumsum(lengths) - lengths
    owner = np.repeat(np.arange(len(codes)), lengths)
    shift = lengths[owner] - 1 - (np.arange(total) - start[owner])
    bits = ((codes[owner] >> shift) & 1).astype(np.uint8)
    bits = np.concatenate([bits, np.ones((-total) % 8, np.uint8)])
    out = np.packbits(bits)
    ff = np.flatnonzero(out == 0xFF)
    return np.insert(out, ff + 1, 0).tobytes()


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body


def encode_jpeg(image: np.ndarray, quality: int = 95,
                subsampling: str = "4:2:0") -> bytes:
    """uint8 (H, W, 3) RGB -> JPEG bytes (JFIF, baseline, YCbCr)."""
    img = np.asarray(image)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes uint8 (H, W, 3), got "
                         f"{img.dtype} {img.shape}")
    if subsampling not in ("4:2:0", "4:4:4"):
        raise ValueError(f"subsampling {subsampling!r}")
    H, W, _ = img.shape
    f = img.astype(np.float64)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    hv = 2 if subsampling == "4:2:0" else 1
    mcux, mcuy = -(-W // (8 * hv)), -(-H // (8 * hv))
    if hv == 2:  # 2x2 means over the edge-padded planes
        def down(p):
            p = np.pad(p, ((0, H % 2), (0, W % 2)), mode="edge")
            return p.reshape(p.shape[0] // 2, 2, p.shape[1] // 2, 2).mean(
                axis=(1, 3))
        cb, cr = down(cb), down(cr)
    qy = quant_table(_LUMA_Q, quality)
    qc = quant_table(_CHROMA_Q, quality)
    D = _dct_matrix()

    def quantized(plane, n_by, n_bx, q):
        blk = _blocks(plane - 128.0, n_by, n_bx)
        coef = D @ blk @ D.T  # (n_by, n_bx, 8, 8)
        return np.round(coef.reshape(n_by, n_bx, 64) / q).astype(np.int64)

    comps = [quantized(y, mcuy * hv, mcux * hv, qy),
             quantized(cb, mcuy, mcux, qc), quantized(cr, mcuy, mcux, qc)]
    # Blocks in scan order: per MCU, hv x hv luma blocks, then Cb, Cr.
    order, comp_id = [], []
    for my in range(mcuy):
        for mx in range(mcux):
            for by in range(hv):
                for bx in range(hv):
                    order.append(comps[0][my * hv + by, mx * hv + bx])
                    comp_id.append(0)
            order += [comps[1][my, mx], comps[2][my, mx]]
            comp_id += [1, 2]
    zz = np.stack(order)[:, _ZIGZAG]  # (n_blocks, 64) zigzag order
    comp_id = np.array(comp_id)
    chroma = (comp_id > 0).astype(np.int64)
    n = len(zz)

    dc = zz[:, 0].copy()
    for c in range(3):  # DC differences per component, in scan order
        sel = comp_id == c
        dc[sel] = np.diff(zz[sel, 0], prepend=0)
    tables = [(_codes(DC_LUMA), _codes(AC_LUMA)),
              (_codes(DC_CHROMA), _codes(AC_CHROMA))]

    def huff(kind, cls, sym):
        code = np.zeros(len(sym), np.int64)
        length = np.zeros(len(sym), np.int64)
        for t in (0, 1):
            sel = cls == t
            code[sel] = tables[t][kind][0][sym[sel]]
            length[sel] = tables[t][kind][1][sym[sel]]
        return code, length

    # Events (block, rank, code, length); code includes the value bits.
    s = _size(dc)
    code, length = huff(0, chroma, s)
    ev_block = [np.arange(n)]
    ev_rank = [np.zeros(n, np.int64)]
    ev_code = [(code << s) | _value_bits(dc, s)]
    ev_len = [length + s]

    blk, k = np.nonzero(zz[:, 1:])
    k = k + 1
    prev = np.zeros_like(k)
    same = np.flatnonzero(np.r_[False, blk[1:] == blk[:-1]])
    prev[same] = k[same - 1]
    run = k - prev - 1
    v = zz[blk, k]
    s = _size(v)
    zrl = run // 16
    code, length = huff(1, chroma[blk], (run % 16) * 16 + s)
    ev_block.append(blk)
    ev_rank.append(2 * k)
    ev_code.append((code << s) | _value_bits(v, s))
    ev_len.append(length + s)
    if zrl.any():  # 16-zero runs before the coefficient
        zb = np.repeat(blk, zrl)
        code, length = huff(1, chroma[zb], np.full(len(zb), 0xF0))
        ev_block.append(zb)
        ev_rank.append(np.repeat(2 * k - 1, zrl))
        ev_code.append(code)
        ev_len.append(length)
    last = np.zeros(n, np.int64)
    np.maximum.at(last, blk, k)
    eob = np.flatnonzero(last < 63)
    code, length = huff(1, chroma[eob], np.zeros(len(eob), np.int64))
    ev_block.append(eob)
    ev_rank.append(np.full(len(eob), 200))
    ev_code.append(code)
    ev_len.append(length)

    block_ = np.concatenate(ev_block)
    ord_ = np.lexsort((np.concatenate(ev_rank), block_))
    data = _pack(np.concatenate(ev_code)[ord_], np.concatenate(ev_len)[ord_])

    out = b"\xFF\xD8"
    out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for tq, q in ((0, qy), (1, qc)):
        out += _segment(0xDB, bytes([tq]) + bytes(q[_ZIGZAG].tolist()))
    samp = (hv << 4) | hv
    out += _segment(0xC0, bytes([8]) + H.to_bytes(2, "big")
                    + W.to_bytes(2, "big") + bytes([3, 1, samp, 0, 2, 0x11, 1,
                                                   3, 0x11, 1]))
    for tc, th, (bits, vals) in ((0, 0, DC_LUMA), (1, 0, AC_LUMA),
                                 (0, 1, DC_CHROMA), (1, 1, AC_CHROMA)):
        out += _segment(0xC4, bytes([(tc << 4) | th]) + bytes(bits)
                        + bytes(vals))
    out += _segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    return out + data + b"\xFF\xD9"


def write_jpeg(path: str, image: np.ndarray, quality: int = 95,
               subsampling: str = "4:2:0") -> None:
    with open(path, "wb") as f:
        f.write(encode_jpeg(image, quality, subsampling))
