"""Baseline JPEG decoding in numpy, as PIL decodes it.

The MegaPose loader of the JAX package reads `<key>.rgb.jpg` with
`np.asarray(Image.open(path))`; the card's machine has no PIL, so the
port decodes the file itself and aims at PIL's array bit for bit.  PIL
decodes through libjpeg-turbo with its defaults, which this module
follows:

* the ISLOW integer IDCT (`jidctint.c`: 13-bit constants, two passes,
  the column pass descaled by 11 bits, the row pass by 18), its output
  clamped to [0, 255] after the +128 level shift;
* "fancy" upsampling of subsampled chroma (`jdsample.c`): the triangle
  filter 3/4 : 1/4, horizontally with the biases +1 / +2 (h2v1, >> 2)
  and, for 4:2:0, vertically first then horizontally with the biases +8
  / +7 (h2v2, >> 4); edge rows and columns are replicated; planes of at
  most two samples' width are replicated instead, as libjpeg does;
* the fixed-point YCbCr -> RGB tables of `jdcolor.c` (16 fractional
  bits).

Supported: baseline and extended sequential Huffman coding with 8-bit
samples (SOF0 / SOF1), one component (greyscale, returned (H, W)) or
three (YCbCr, returned (H, W, 3)) in one scan, luma sampling factors
4:4:4, 4:2:2 and 4:2:0 with 1x1 chroma, restart intervals (DRI / RSTn),
any width and height.  Progressive, lossless, hierarchical,
arithmetic-coded, 12-bit, CMYK, Adobe-RGB and multi-scan files raise
`ValueError` naming what they are; nothing is decoded approximately.

The entropy decoder is the one sequential part: a Python loop over the
Huffman symbols that reads 16 bits at a time through 32-bit windows of
the byte stream and looks each code up in a 65536-entry table (for AC
codes whose value bits also fit in the 16, the table holds the value
too).  `rows` stops it after the MCU rows that the first `rows` image
rows need (and one more, the upsampler's context), which the MegaPose
loader uses: it knows the mask's bounding box before it reads the frame.
"""

from __future__ import annotations

import functools

import numpy as np

# Zigzag position -> natural (row-major) position in an 8x8 block.
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

_UNSUPPORTED_SOF = {
    0xC2: "progressive JPEG",
    0xC3: "lossless JPEG",
    0xC5: "differential sequential JPEG",
    0xC6: "differential progressive JPEG",
    0xC7: "differential lossless JPEG",
    0xC9: "arithmetic-coded JPEG",
    0xCA: "arithmetic-coded progressive JPEG",
    0xCB: "arithmetic-coded lossless JPEG",
    0xCD: "arithmetic-coded differential JPEG",
    0xCE: "arithmetic-coded differential progressive JPEG",
    0xCF: "arithmetic-coded differential lossless JPEG",
}


@functools.lru_cache(maxsize=16)
def _huffman_tables(bits: bytes, vals: bytes, ac: bool):
    """A DHT table -> a list of 65536 entries indexed by the next 16
    bits of the stream: (code length, symbol) for DC tables, (bits to
    consume, run, size, value or None) for AC tables (value None when
    the code and its value bits do not fit in 16 bits; consume then
    covers the code only).  Length 0 marks a bit pattern no code starts."""
    length = np.zeros(65536, np.int64)
    symbol = np.zeros(65536, np.int64)
    code, k = 0, 0
    for n in range(1, 17):
        for _ in range(bits[n - 1]):
            lo = code << (16 - n)
            length[lo:lo + (1 << (16 - n))] = n
            symbol[lo:lo + (1 << (16 - n))] = vals[k]
            code += 1
            k += 1
        if code > (1 << n):
            raise ValueError("corrupt JPEG: bad Huffman table")
        code <<= 1
    if not ac:
        return list(zip(length.tolist(), symbol.tolist()))
    run, size = symbol >> 4, symbol & 15
    fits = (size > 0) & (length + size <= 16) & (length > 0)
    peek = np.arange(65536, dtype=np.int64)
    raw = (peek >> np.maximum(16 - length - size, 0)) & ((1 << size) - 1)
    value = np.where(raw >= (1 << np.maximum(size - 1, 0)), raw,
                     raw - (1 << size) + 1)
    consume = np.where(fits, length + size, length)
    value = np.where(fits, value, 0).tolist()
    fits = fits.tolist()
    return [(c, r, s, v if f else None) for c, r, s, v, f in zip(
        consume.tolist(), run.tolist(), size.tolist(), value, fits)]


def _segments(data: np.ndarray, start: int):
    """The entropy-coded bytes of the scan starting at `start`: one array
    per restart interval, byte stuffing removed, up to the marker that
    ends the scan."""
    ff = np.flatnonzero(data[start:-1] == 0xFF) + start
    segments, seg_start = [], start
    for i in ff.tolist():
        nxt = data[i + 1]
        if i < seg_start or nxt == 0x00 or nxt == 0xFF:
            continue  # stuffed byte, or fill bytes before a marker
        seg = data[seg_start:i]
        # Drop the 0x00 after each 0xFF (stuffing), and fill bytes.
        pos = np.flatnonzero(seg == 0xFF)
        if pos.size:
            keep = np.ones(seg.size + 1, bool)
            keep[pos + 1] = False
            seg = seg[keep[:seg.size]]
        segments.append(seg)
        if 0xD0 <= nxt <= 0xD7:
            seg_start = i + 2
            continue
        return segments
    raise ValueError("corrupt JPEG: the scan has no end marker")


def _decode_segment(seg, blocks, n_mcu, coefs, dc_tabs, ac_tabs, bases):
    """Huffman-decode `n_mcu` MCUs of one restart interval into `coefs`
    (per component a flat list of zigzag coefficients).  `blocks` lists
    each MCU's blocks as (component, offset of the block's first
    coefficient from the MCU's), `bases` yields each MCU's offsets, one
    per component."""
    padded = np.concatenate([seg, np.zeros(8, np.uint8)]).astype(np.uint32)
    win = ((padded[:-3] << 24) | (padded[1:-2] << 16) | (padded[2:-1] << 8)
           | padded[3:]).tolist()
    pos = 0
    pred = [0] * len(coefs)
    for _ in range(n_mcu):
        mcu = next(bases)
        for c, off in blocks:
            out = coefs[c]
            base = mcu[c] + off
            # DC: the size category, then that many bits of difference.
            w = win[pos >> 3]
            n, s = dc_tabs[c][(w >> (16 - (pos & 7))) & 0xFFFF]
            if not n:
                raise ValueError("corrupt JPEG: bad Huffman code")
            pos += n
            if s:
                w = win[pos >> 3]
                v = (w >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                pos += s
                pred[c] += v if v >> (s - 1) else v - (1 << s) + 1
            out[base] = pred[c]
            # AC: (run, size) symbols until EOB or the 63rd coefficient.
            ac = ac_tabs[c]
            k = 1
            while k < 64:
                w = win[pos >> 3]
                n, r, s, v = ac[(w >> (16 - (pos & 7))) & 0xFFFF]
                if not n:
                    raise ValueError("corrupt JPEG: bad Huffman code")
                pos += n
                if not s:
                    if r != 15:
                        break  # EOB
                    k += 16  # ZRL
                    continue
                if v is None:
                    w = win[pos >> 3]
                    v = (w >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                    pos += s
                    if not v >> (s - 1):
                        v -= (1 << s) - 1
                k += r
                if k > 63:
                    raise ValueError("corrupt JPEG: AC run past the block")
                out[base + k] = v
                k += 1
    if pos > 8 * len(seg):
        raise ValueError("corrupt JPEG: entropy-coded data truncated")


# ISLOW IDCT constants (jidctint.c, CONST_BITS = 13).
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _idct_1d(x, shift: int):
    """jidctint.c's 1-D pass over the last axis of int64 (..., 8):
    outputs descaled by `shift` bits with rounding."""
    x0, x1, x2, x3, x4, x5, x6, x7 = (x[..., i] for i in range(8))
    z1 = (x2 + x6) * _F0541
    tmp2 = z1 - x6 * _F1847
    tmp3 = z1 + x2 * _F0765
    tmp0 = (x0 + x4) << 13
    tmp1 = (x0 - x4) << 13
    t10, t13 = tmp0 + tmp3, tmp0 - tmp3
    t11, t12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x7, x5, x3, x1
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1175
    t0, t1, t2, t3 = t0 * _F0298, t1 * _F2053, t2 * _F3072, t3 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    half = 1 << (shift - 1)
    out = np.stack([t10 + t3, t11 + t2, t12 + t1, t13 + t0,
                    t13 - t0, t12 - t1, t11 - t2, t10 - t3], axis=-1)
    return (out + half) >> shift


def _idct_islow(coef: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """(n, 64) natural-order coefficients, (64,) quantizer -> (n, 8, 8)
    uint8 samples."""
    x = (coef.astype(np.int64) * qtable.astype(np.int64)).reshape(-1, 8, 8)
    cols = _idct_1d(np.swapaxes(x, 1, 2), 13 - 2)  # (n, col, row)
    rows = _idct_1d(np.swapaxes(cols, 1, 2), 13 + 2 + 3)
    return np.clip(rows + 128, 0, 255).astype(np.uint8)


def _fancy_h2(plane: np.ndarray, bias_lo: int, bias_hi: int, shift: int):
    """Horizontal triangle upsampling x2 of int64 (H, w): each sample
    3/4 itself and 1/4 its left (even outputs) or right (odd outputs)
    neighbour, edges replicated, with libjpeg's biases."""
    p = np.pad(plane, ((0, 0), (1, 1)), mode="edge")
    mid = 3 * p[:, 1:-1]
    out = np.empty((plane.shape[0], 2 * plane.shape[1]), np.int64)
    out[:, 0::2] = (mid + p[:, :-2] + bias_lo) >> shift
    out[:, 1::2] = (mid + p[:, 2:] + bias_hi) >> shift
    return out


def _upsample(plane: np.ndarray, h: int, v: int) -> np.ndarray:
    """libjpeg-turbo's fancy upsampling of a chroma plane of its
    downsampled size by (h, v) in {(1, 1), (2, 1), (2, 2)}."""
    if (h, v) == (1, 1):
        return plane
    p = plane.astype(np.int64)
    if p.shape[1] <= 2:  # h2v1_upsample / h2v2_upsample: replication
        return np.repeat(np.repeat(p, h, axis=1), v, axis=0)
    if v == 1:
        return _fancy_h2(p, 1, 2, 2)
    q = np.pad(p, ((1, 1), (0, 0)), mode="edge")
    rows = np.empty((2 * p.shape[0], p.shape[1]), np.int64)
    rows[0::2] = 3 * p + q[:-2]  # the row above
    rows[1::2] = 3 * p + q[2:]  # the row below
    return _fancy_h2(rows, 8, 7, 4)


def _ycc_tables():
    """jdcolor.c's build_ycc_rgb_table (SCALEBITS = 16)."""
    x = np.arange(256, dtype=np.int64) - 128
    fix = lambda f: int(f * 65536 + 0.5)  # noqa: E731
    half = 1 << 15
    cr_r = (fix(1.40200) * x + half) >> 16
    cb_b = (fix(1.77200) * x + half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + half
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    y = y.astype(np.int64)
    cb = cb.astype(np.int64)
    cr = cr.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def _u16(data, i):
    return (int(data[i]) << 8) | int(data[i + 1])


def decode_jpeg(data: bytes, rows: int | None = None) -> np.ndarray:
    """JPEG bytes -> uint8 (H, W, 3) RGB or (H, W) greyscale, PIL's
    array.  With `rows`, decoding may stop early: the result then holds
    at least the first min(rows, H) rows (possibly more, never more than
    H), each equal to the full decode's."""
    a = np.frombuffer(data, np.uint8)
    if a.size < 4 or a[0] != 0xFF or a[1] != 0xD8:
        raise ValueError("not a JPEG file")
    qt, dc_t, ac_t = {}, {}, {}
    restart, frame, jfif, adobe = 0, None, False, None
    i = 2
    while True:
        while i < a.size and a[i] == 0xFF and i + 1 < a.size \
                and a[i + 1] == 0xFF:
            i += 1  # fill bytes
        if i + 4 > a.size or a[i] != 0xFF:
            raise ValueError("corrupt JPEG: expected a marker")
        marker = int(a[i + 1])
        if marker == 0xD9:
            raise ValueError("corrupt JPEG: no scan before EOI")
        length = _u16(a, i + 2)
        body = a[i + 4:i + 2 + length]
        i += 2 + length
        if marker in _UNSUPPORTED_SOF:
            raise ValueError(f"unsupported: {_UNSUPPORTED_SOF[marker]}")
        if marker == 0xDB:  # DQT
            j = 0
            while j < body.size:
                pq, tq = body[j] >> 4, body[j] & 15
                if pq:
                    vals = body[j + 1:j + 129].view(">u2")
                    j += 129
                else:
                    vals = body[j + 1:j + 65]
                    j += 65
                table = np.zeros(64, np.int64)
                table[ZIGZAG] = vals.astype(np.int64)
                qt[int(tq)] = table
        elif marker == 0xC4:  # DHT
            j = 0
            while j < body.size:
                tc, th = body[j] >> 4, body[j] & 15
                bits = bytes(body[j + 1:j + 17])
                n = sum(bits)
                vals = bytes(body[j + 17:j + 17 + n])
                (ac_t if tc else dc_t)[int(th)] = (bits, vals)
                j += 17 + n
        elif marker == 0xDD:  # DRI
            restart = _u16(body, 0)
        elif marker == 0xE0 and bytes(body[:5]) == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and bytes(body[:5]) == b"Adobe":
            adobe = int(body[11])
        elif marker in (0xC0, 0xC1):  # SOF0 / SOF1
            if body[0] != 8:
                raise ValueError(f"unsupported: {body[0]}-bit JPEG")
            H, W, nf = _u16(body, 1), _u16(body, 3), int(body[5])
            comps = [(int(body[6 + 3 * k]), int(body[7 + 3 * k]) >> 4,
                      int(body[7 + 3 * k]) & 15, int(body[8 + 3 * k]))
                     for k in range(nf)]
            frame = (H, W, comps)
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise ValueError("corrupt JPEG: scan before frame header")
            break
    H, W, comps = frame
    nf = len(comps)
    if nf == 4:
        raise ValueError("unsupported: CMYK / YCCK JPEG")
    if nf not in (1, 3):
        raise ValueError(f"unsupported: {nf}-component JPEG")
    if nf == 3:
        ids = tuple(c[0] for c in comps)
        if (adobe == 0 and not jfif) or (not jfif and adobe is None
                                         and ids == (82, 71, 66)):
            raise ValueError("unsupported: RGB-coded (untransformed) JPEG")
    if H == 0 or W == 0:
        raise ValueError("unsupported: JPEG with a DNL marker (height 0)")
    ns = int(body[0])
    if ns != nf:
        raise ValueError("unsupported: multi-scan sequential JPEG")
    scan = []
    for k in range(ns):
        cid, tabs = int(body[1 + 2 * k]), int(body[2 + 2 * k])
        idx = [c[0] for c in comps].index(cid)
        scan.append((idx, tabs >> 4, tabs & 15))
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    if nf == 1:  # a non-interleaved scan: one block per MCU
        hs, vs = [1], [1]
        cw = [-(-W * comps[0][1] // hmax)]
        ch = [-(-H * comps[0][2] // vmax)]
        mcux, mcuy = -(-cw[0] // 8), -(-ch[0] // 8)
        mcu_h = 8 * vmax // comps[0][2]
    else:
        hs = [c[1] for c in comps]
        vs = [c[2] for c in comps]
        if hs[1:] != [1, 1] or vs[1:] != [1, 1] or (hs[0], vs[0]) not in (
                (1, 1), (2, 1), (2, 2)):
            raise ValueError(f"unsupported: JPEG sampling factors "
                             f"{list(zip(hs, vs))}")
        cw = [-(-W * h // hmax) for h in hs]
        ch = [-(-H * v // vmax) for v in vs]
        mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
        mcu_h = 8 * vmax
    n_rows = mcuy if rows is None else min(mcuy, -(-rows // mcu_h) + 1)
    bw = [mcux * h for h in hs]
    blocks = [(c, 64 * (by * bw[c] + bx)) for c in range(nf)
              for by in range(vs[c]) for bx in range(hs[c])]
    coefs = [[0] * (64 * bw[c] * n_rows * vs[c]) for c in range(nf)]
    dc_tabs, ac_tabs = [None] * nf, [None] * nf
    for idx, td, ta in scan:
        if td not in dc_t or ta not in ac_t:
            raise ValueError("corrupt JPEG: scan names an undefined "
                             "Huffman table")
        dc_tabs[idx] = _huffman_tables(*dc_t[td], False)
        ac_tabs[idx] = _huffman_tables(*ac_t[ta], True)

    def bases():
        for my in range(n_rows):
            for mx in range(mcux):
                yield [64 * (my * vs[c] * bw[c] + mx * hs[c])
                       for c in range(nf)]

    segments = _segments(a, i)
    total = n_rows * mcux
    per = restart or total
    mcus = bases()
    for seg in segments:
        n = min(per, total)
        if n <= 0:
            break
        try:
            _decode_segment(seg, blocks, n, coefs, dc_tabs, ac_tabs, mcus)
        except IndexError:
            raise ValueError("corrupt JPEG: entropy-coded data truncated")
        total -= n
    if total > 0:
        raise ValueError("corrupt JPEG: fewer restart intervals than MCUs")

    planes = []
    for c in range(nf):
        q = qt.get(comps[c][3])
        if q is None:
            raise ValueError("corrupt JPEG: undefined quantization table")
        zz = np.asarray(coefs[c], np.int64).reshape(-1, 64)
        nat = np.zeros_like(zz)
        nat[:, ZIGZAG] = zz
        px = _idct_islow(nat, q)
        nby, nbx = n_rows * vs[c], bw[c]
        plane = px.reshape(nby, nbx, 8, 8).transpose(0, 2, 1, 3).reshape(
            nby * 8, nbx * 8)
        plane = plane[:min(ch[c], nby * 8), :cw[c]]
        if nf == 3:
            plane = _upsample(plane, hmax // hs[c], vmax // vs[c])
        planes.append(plane)
    # A truncated decode drops its last MCU row: the upsampler's context.
    out_h = H if n_rows == mcuy else (n_rows - 1) * mcu_h
    if nf == 1:
        return np.ascontiguousarray(planes[0][:out_h, :W])
    y, cb, cr = (p[:out_h, :W] for p in planes)
    return _ycc_to_rgb(y, cb, cr)


def read_jpeg(path: str, rows: int | None = None) -> np.ndarray:
    """`decode_jpeg` of a file (the array `np.asarray(Image.open(path))`
    gives for a baseline JPEG)."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), rows)
