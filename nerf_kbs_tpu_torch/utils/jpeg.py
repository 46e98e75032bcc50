"""Baseline JPEG in NumPy: a decoder and an encoder, no imaging package.

The decoder reads sequential Huffman-coded 8-bit files (SOF0 and SOF1), grey
or YCbCr (or RGB by the Adobe marker), one interleaved scan, chroma sampled
4:4:4, 4:2:2 or 4:2:0, with or without restart intervals. It computes what
libjpeg computes by default, step for step in integers: the 'islow' inverse
DCT, the 'fancy' (triangle) chroma upsampling and the fixed-point YCbCr ->
RGB tables, so its RGB is PIL's ``convert("RGB")`` of the same file.
Progressive, lossless, hierarchical, arithmetic-coded and 12-bit files, and
files with more than one scan, raise ValueError naming what they are.

Huffman decoding is table-driven: for each bit position of the entropy-coded
data, one 16-bit window gives every table's symbol and code length at once
(vectorised); the only Python loop walks the symbols, one table lookup each.

The encoder writes baseline files with the standard (Annex K) tables scaled
by ``quality`` as libjpeg scales them, 4:2:0 chroma for colour (as PIL
writes by default) and a JFIF header.
"""

from __future__ import annotations

import struct
from array import array

import numpy as np

# zigzag position k -> natural (row-major) index
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

_SOF_NAMES = {0xC2: "progressive", 0xC3: "lossless", 0xC5: "hierarchical (differential)",
              0xC6: "hierarchical progressive", 0xC7: "hierarchical lossless",
              0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded progressive",
              0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded hierarchical",
              0xCE: "arithmetic-coded hierarchical progressive",
              0xCF: "arithmetic-coded hierarchical lossless"}


def _segments(data: bytes):
    """(marker, payload, end offset) of each marker segment up to SOS (whose
    payload is its header) or EOI."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file")
    pos = 2
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"JPEG: no marker at byte {pos}")
        while data[pos] == 0xFF:  # fill bytes
            pos += 1
        marker = data[pos]
        pos += 1
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            continue
        if marker == 0xD9:
            yield marker, b"", pos
            return
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        yield marker, data[pos + 2:pos + length], pos + length
        pos += length


def image_size(data: bytes) -> tuple[int, int]:
    """(width, height) from the frame header (SOFn)."""
    for marker, body, _ in _segments(data):
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            h, w = struct.unpack(">HH", body[1:5])
            return w, h
        if marker == 0xDA:
            break
    raise ValueError("JPEG without a frame header")


# ---------------------------------------------------------------------------
# Huffman tables
# ---------------------------------------------------------------------------


def _canonical_codes(counts, symbols):
    """Code and length of each symbol of a table given as counts per length
    (16) and the symbols in order."""
    codes, lengths, code = [], [], 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            codes.append(code)
            lengths.append(length)
            code += 1
        code <<= 1
    return codes, lengths


def _lookup(counts, symbols):
    """(length, symbol) of the code that starts each 16-bit window; length 0
    where no code does."""
    length = np.zeros(1 << 16, np.int32)
    symbol = np.zeros(1 << 16, np.int32)
    for c, n, s in zip(*_canonical_codes(counts, symbols), symbols):
        lo = c << (16 - n)
        length[lo:lo + (1 << (16 - n))] = n
        symbol[lo:lo + (1 << (16 - n))] = s
    return length, symbol


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

# libjpeg's islow inverse DCT constants (13-bit fixed point)
_CONST_BITS, _PASS1_BITS = 13, 2
_F = {name: v for name, v in (
    ("0_298631336", 2446), ("0_390180644", 3196), ("0_541196100", 4433),
    ("0_765366865", 6270), ("0_899976223", 7373), ("1_175875602", 9633),
    ("1_501321110", 12299), ("1_847759065", 15137), ("1_961570560", 16069),
    ("2_053119869", 16819), ("2_562915447", 20995), ("3_072711026", 25172))}


def _idct_1d(x, shift):
    """One pass of jpeg_idct_islow over axis 1 of x (N, 8, M) int64: the
    eight outputs, each DESCALEd by ``shift`` bits."""
    z2, z3 = x[:, 2], x[:, 6]
    z1 = (z2 + z3) * _F["0_541196100"]
    tmp2 = z1 - z3 * _F["1_847759065"]
    tmp3 = z1 + z2 * _F["0_765366865"]
    tmp0 = (x[:, 0] + x[:, 4]) << _CONST_BITS
    tmp1 = (x[:, 0] - x[:, 4]) << _CONST_BITS
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[:, 7], x[:, 5], x[:, 3], x[:, 1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F["1_175875602"]
    t0 = t0 * _F["0_298631336"]
    t1 = t1 * _F["2_053119869"]
    t2 = t2 * _F["3_072711026"]
    t3 = t3 * _F["1_501321110"]
    z1 = z1 * -_F["0_899976223"]
    z2 = z2 * -_F["2_562915447"]
    z3 = z3 * -_F["1_961570560"] + z5
    z4 = z4 * -_F["0_390180644"] + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    half = 1 << (shift - 1)
    out = [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
           tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]
    return np.stack([(o + half) >> shift for o in out], axis=1)


def _range_limit() -> np.ndarray:
    """libjpeg's post-IDCT table, indexed by (value & 1023): value + 128
    clipped to [0, 255] for |value| < 512."""
    t = np.zeros(1024, np.uint8)
    t[:128] = np.arange(128, 256)
    t[128:512] = 255
    t[896:] = np.arange(128)
    return t


_LIMIT = _range_limit()


def idct_islow(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """(N, 64) natural-order coefficients and a (64,) natural-order
    quantisation table -> (N, 8, 8) uint8 samples, as jpeg_idct_islow."""
    x = (coef.astype(np.int64) * quant.astype(np.int64)).reshape(-1, 8, 8)
    ws = _idct_1d(x, _CONST_BITS - _PASS1_BITS)  # columns: axis 1 is the row index
    out = _idct_1d(ws.transpose(0, 2, 1), _CONST_BITS + _PASS1_BITS + 3)
    return _LIMIT[out.transpose(0, 2, 1) & 1023]


def _upsample_h2(p: np.ndarray, width: int) -> np.ndarray:
    """libjpeg's h2v1 fancy upsampling of the first ``width`` columns."""
    x = p[:, :width].astype(np.int32)
    left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
    out = np.empty((x.shape[0], 2 * width), np.int32)
    out[:, 0::2] = (3 * x + left + 1) >> 2
    out[:, 1::2] = (3 * x + right + 2) >> 2
    out[:, 0], out[:, -1] = x[:, 0], x[:, -1]
    return out


def _upsample_h2v2(p: np.ndarray, height: int, width: int) -> np.ndarray:
    """libjpeg's h2v2 fancy upsampling of the first ``height`` x ``width``
    samples: a vertical 3:1 column sum with the nearer and the farther row
    (the edge rows repeated), then 3:1 across columns."""
    x = p[:height, :width].astype(np.int32)
    up = np.concatenate([x[:1], x[:-1]], axis=0)
    down = np.concatenate([x[1:], x[-1:]], axis=0)
    out = np.empty((2 * height, 2 * width), np.int32)
    for r, nb in ((0, up), (1, down)):
        cs = 3 * x + nb
        left = np.concatenate([cs[:, :1], cs[:, :-1]], axis=1)
        right = np.concatenate([cs[:, 1:], cs[:, -1:]], axis=1)
        row = out[r::2]
        row[:, 0::2] = (3 * cs + left + 8) >> 4
        row[:, 1::2] = (3 * cs + right + 7) >> 4
        row[:, 0] = (4 * cs[:, 0] + 8) >> 4
        row[:, -1] = (4 * cs[:, -1] + 7) >> 4
    return out


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """libjpeg's ycc_rgb_convert (16-bit fixed point tables)."""
    def fix(v):
        return int(v * 65536 + 0.5)

    y = y.astype(np.int64)
    cb = cb.astype(np.int64) - 128
    cr = cr.astype(np.int64) - 128
    r = y + ((fix(1.40200) * cr + 32768) >> 16)
    g = y + ((-fix(0.34414) * cb + 32768 - fix(0.71414) * cr) >> 16)
    b = y + ((fix(1.77200) * cb + 32768) >> 16)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _scan_segments(data: bytes, start: int):
    """The entropy-coded data from ``start``: a list of byte strings, one per
    restart interval (RST markers removed, 0xFF00 unstuffed), and the offset
    of the marker that ends the scan."""
    buf = np.frombuffer(data, np.uint8)
    ff = np.flatnonzero(buf[start:-1] == 0xFF) + start
    nxt = buf[ff + 1]
    rst = ff[(nxt >= 0xD0) & (nxt <= 0xD7)]
    ends = ff[(nxt != 0) & ~((nxt >= 0xD0) & (nxt <= 0xD7)) & (nxt != 0xFF)]
    end = int(ends[0]) if ends.size else len(data)
    rst = rst[rst < end]
    bounds = [start] + [int(r) for r in rst] + [end]
    segs = []
    for i in range(len(bounds) - 1):
        a = bounds[i] + (2 if i else 0)
        segs.append(data[a:bounds[i + 1]].replace(b"\xff\x00", b"\xff"))
    return segs, end


def _walk(n_blocks: int, layout, packed, n: int):
    """Bit position, block and zigzag index (before the run) of every
    symbol of ``n_blocks`` blocks: one table lookup a symbol."""
    sym_pos, sym_block, sym_k = [], [], []
    p = 0
    for blk in range(n_blocks):
        dct, act = layout[blk]
        dc, ac = packed[dct], packed[act]
        e = dc[p]
        if not e & 63:
            raise ValueError("JPEG: bad Huffman code")
        sym_pos.append(p)
        sym_block.append(blk)
        sym_k.append(0)
        p += e & 63
        k = 1
        while k < 64:
            e = ac[p]
            if not e & 63:
                raise ValueError("JPEG: bad Huffman code")
            sym_pos.append(p)
            sym_block.append(blk)
            sym_k.append(k)
            p += e & 63
            k += e >> 6
        if 64 < k < 127:
            raise ValueError("JPEG: coefficients past the block's 64")
        if p > n:
            raise ValueError("JPEG: entropy-coded data ends inside a block")
    return sym_pos, sym_block, sym_k


def _decode_segment(seg: bytes, n_blocks: int, layout, dc_tabs, ac_tabs):
    """Huffman-decode ``n_blocks`` blocks of one restart interval. ``layout``
    gives, for each block in decode order, its (DC table, AC table) ids.
    Returns (DC differences (n_blocks,), AC positions (M,), AC values (M,))
    with positions as block * 64 + zigzag index."""
    bits = np.unpackbits(np.frombuffer(seg, np.uint8))
    n = bits.size
    bits = np.concatenate([bits, np.ones(48, np.uint8)])  # JPEG pads with 1 bits
    win = np.zeros(n + 17, np.int32)
    for i in range(16):
        win = (win << 1) | bits[i:i + n + 17]
    # per table: one packed entry a bit position, advance | (zigzag step << 6)
    packed, lens, syms = {}, {}, {}
    for key, (length, symbol) in list(dc_tabs.items()) + list(ac_tabs.items()):
        ln, sy = length[win], symbol[win]
        if key[0] == "dc":
            adv, step = ln + sy, np.ones_like(sy)
        else:
            adv = ln + (sy & 15)
            step = np.where(sy == 0, 127, np.where(sy == 0xF0, 16, (sy >> 4) + 1))
        adv = np.where(ln == 0, 0, adv)
        packed[key] = array("H", (adv | (step << 6)).astype(np.uint16).tobytes())
        lens[key], syms[key] = ln, sy

    try:
        sym_pos, sym_block, sym_k = _walk(n_blocks, layout, packed, n)
    except IndexError:
        raise ValueError("JPEG: entropy-coded data ends inside a block") from None
    pos = np.asarray(sym_pos, np.int64)
    block = np.asarray(sym_block, np.int64)
    k = np.asarray(sym_k, np.int64)
    dc_diff = np.zeros(n_blocks, np.int64)
    ac_at, ac_val = [], []
    for is_dc, tabs in ((True, dc_tabs), (False, ac_tabs)):
        for key in tabs:
            col = 0 if is_dc else 1
            sel = (k == 0) if is_dc else (k > 0)
            mine = np.array([layout[b][col] == key for b in range(n_blocks)])
            sel &= mine[block]
            ps, ln, sy = pos[sel], lens[key][pos[sel]], syms[key][pos[sel]]
            size = sy if is_dc else sy & 15
            raw = win[ps + ln] >> (16 - np.maximum(size, 1))
            val = np.where(raw < (1 << np.maximum(size - 1, 0)), raw - (1 << size) + 1, raw)
            val = np.where(size == 0, 0, val)
            if is_dc:
                dc_diff[block[sel]] = val
            else:
                nz = size > 0
                ac_at.append((block[sel] * 64 + k[sel] + (sy >> 4))[nz])
                ac_val.append(val[nz])
    ac_at = np.concatenate(ac_at) if ac_at else np.zeros(0, np.int64)
    ac_val = np.concatenate(ac_val) if ac_val else np.zeros(0, np.int64)
    return dc_diff, ac_at, ac_val


def decode_jpeg(data: bytes) -> np.ndarray:
    """Baseline JPEG bytes -> uint8 pixels: (H, W) grey or (H, W, 3) RGB.
    Raises ValueError on what the module docstring excludes."""
    quant, huff, frame, restart, adobe = {}, {}, None, 0, None
    scan_start = scan = None
    for marker, body, end in _segments(data):
        if marker == 0xDB:  # quantisation tables
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                n = 128 if pq else 64
                vals = np.frombuffer(body[i + 1:i + 1 + n], ">u2" if pq else np.uint8)
                table = np.zeros(64, np.int64)
                table[ZIGZAG] = vals
                quant[tq] = table
                i += 1 + n
        elif marker == 0xC4:  # Huffman tables
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = list(body[i + 1:i + 17])
                syms = list(body[i + 17:i + 17 + sum(counts)])
                huff[("dc" if tc == 0 else "ac", th)] = _lookup(counts, syms)
                i += 17 + sum(counts)
        elif marker in (0xC0, 0xC1):
            precision, h, w, nf = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                raise ValueError(f"{precision}-bit JPEG: only 8-bit samples are read")
            comps = [(body[6 + 3 * j], body[7 + 3 * j] >> 4, body[7 + 3 * j] & 15,
                      body[8 + 3 * j]) for j in range(nf)]
            frame = (h, w, comps)
        elif marker in _SOF_NAMES or marker == 0xCC:
            name = _SOF_NAMES.get(marker, "arithmetic-coded")
            raise ValueError(f"{name} JPEG: only baseline (sequential Huffman) files are read")
        elif marker == 0xDD:
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xEE and body[:5] == b"Adobe":
            adobe = body[11]
        elif marker == 0xDA:
            ns = body[0]
            scan = [(body[1 + 2 * j], body[2 + 2 * j] >> 4, body[2 + 2 * j] & 15)
                    for j in range(ns)]
            scan_start = end
            break
    if frame is None or scan is None:
        raise ValueError("JPEG without a frame or a scan")
    h, w, comps = frame
    if len(comps) not in (1, 3):
        raise ValueError(f"JPEG with {len(comps)} components: only grey and colour are read")
    if len(scan) != len(comps):
        raise ValueError("JPEG with more than one scan: only single-scan files are read")

    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    if len(comps) == 1:
        hmax = vmax = 1
        comps = [(comps[0][0], 1, 1, comps[0][3])]
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    tables = {cid: (td, ta) for cid, td, ta in scan}
    layout_mcu = []  # (component index, block row, block col) in an MCU
    for ci, (cid, hs, vs, _) in enumerate(comps):
        layout_mcu += [(ci, by, bx) for by in range(vs) for bx in range(hs)]
    per_mcu = len(layout_mcu)
    n_mcu = mcux * mcuy
    segs, end = _scan_segments(data, scan_start)
    interval = restart or n_mcu
    if len(segs) != -(-n_mcu // interval):
        raise ValueError(f"JPEG: {len(segs)} restart intervals, "
                         f"{-(-n_mcu // interval)} expected")
    dc_tabs = {("dc", t[0]): huff[("dc", t[0])] for t in tables.values()}
    ac_tabs = {("ac", t[1]): huff[("ac", t[1])] for t in tables.values()}
    blk_layout = [(("dc", tables[comps[ci][0]][0]), ("ac", tables[comps[ci][0]][1]))
                  for ci, _, _ in layout_mcu]

    n_blocks = n_mcu * per_mcu
    coef = np.zeros((n_blocks, 64), np.int64)
    dc_diff = np.zeros(n_blocks, np.int64)
    seg_of_block = np.zeros(n_blocks, np.int64)
    first = 0
    for si, seg in enumerate(segs):
        m = min(interval, n_mcu - si * interval)
        nb = m * per_mcu
        d, at, val = _decode_segment(seg, nb, blk_layout * m, dc_tabs, ac_tabs)
        dc_diff[first:first + nb] = d
        coef.reshape(-1)[first * 64 + at] = val
        seg_of_block[first:first + nb] = si
        first += nb
    # DC prediction: a running sum per component, reset at each restart
    comp_of_block = np.tile([ci for ci, _, _ in layout_mcu], n_mcu)
    for ci in range(len(comps)):
        sel = np.flatnonzero(comp_of_block == ci)
        cs = np.cumsum(dc_diff[sel])
        seg = seg_of_block[sel]
        starts = np.flatnonzero(np.r_[True, seg[1:] != seg[:-1]])
        base = np.repeat(np.r_[0, cs[starts[1:] - 1]], np.diff(np.r_[starts, sel.size]))
        coef[sel, 0] = cs - base

    natural = np.zeros_like(coef)
    natural[:, ZIGZAG] = coef
    planes = []
    mcu_idx = np.arange(n_blocks) // per_mcu
    in_mcu = np.tile(np.arange(per_mcu), n_mcu)
    for ci, (cid, hs, vs, tq) in enumerate(comps):
        sel = comp_of_block == ci
        px = idct_islow(natural[sel], quant[tq])
        lm = in_mcu[sel] - sum(c[1] * c[2] for c in comps[:ci])
        my, mx = mcu_idx[sel] // mcux, mcu_idx[sel] % mcux
        by, bx = my * vs + lm // hs, mx * hs + lm % hs
        plane = np.zeros((mcuy * vs * 8, mcux * hs * 8), np.uint8)
        plane.reshape(mcuy * vs, 8, mcux * hs, 8)[by, :, bx, :] = px
        planes.append(plane)
    if len(comps) == 1:
        return planes[0][:h, :w]
    full = []
    for (cid, hs, vs, _), plane in zip(comps, planes):
        fh, fw = hmax // hs, vmax // vs
        ch, cw = -(-h * vs // vmax), -(-w * hs // hmax)
        if (fh, fw) == (1, 1):
            up = plane
        elif (fh, fw) == (2, 1):
            up = _upsample_h2(plane[:ch], cw)
        elif (fh, fw) == (2, 2):
            up = _upsample_h2v2(plane, ch, cw)
        else:
            raise ValueError(f"JPEG chroma sampled {hs}x{vs} of {hmax}x{vmax}: only 4:4:4, "
                             "4:2:2 and 4:2:0 are read")
        full.append(up[:h, :w])
    if adobe == 0 or [c[0] for c in comps] == [82, 71, 66]:  # stored as RGB
        return np.stack(full, -1).astype(np.uint8)
    return _ycc_to_rgb(*full)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

_STD_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_STD_CHROMA_Q = np.full(64, 99)
_STD_CHROMA_Q.reshape(8, 8)[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66],
                                       [24, 26, 56, 99], [47, 66, 99, 99]]

_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))


def _ac_symbols(head: list) -> list:
    """A standard AC table's symbols: its listed head, then every other
    run/size symbol in increasing order."""
    every = [0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 11)]
    return head + sorted(set(every) - set(head))


_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], _ac_symbols([
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1,
    0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16]))
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], _ac_symbols([
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09,
    0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25,
    0xF1]))


def _quality_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's jpeg_quality_scaling of a table, clamped to 1..255."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((base * scale + 50) // 100, 1, 255)


def _code_table(spec) -> tuple[np.ndarray, np.ndarray]:
    codes, lengths = _canonical_codes(*spec)
    code = np.zeros(256, np.int64)
    length = np.zeros(256, np.int64)
    code[spec[1]] = codes
    length[spec[1]] = lengths
    return code, length


_DCT = np.array([[(np.sqrt(1 / 8) if u == 0 else np.sqrt(2 / 8))
                  * np.cos((2 * x + 1) * u * np.pi / 16) for x in range(8)] for u in range(8)])


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(H, W) with H, W multiples of 8 -> (H/8, W/8, 8, 8)."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def _size(v: np.ndarray) -> np.ndarray:
    """Bits of |v| (0 for 0)."""
    return np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)


def _entropy_code(zz: np.ndarray, comp: np.ndarray, tab: np.ndarray, tabs) -> bytes:
    """Huffman-code blocks (N, 64) of zigzag coefficients in scan order:
    block i is of component comp[i] (its DC predictor) and coded with the
    tables tabs[tab[i]]; returns the stuffed bytes, padded with 1 bits."""
    n = zz.shape[0]
    diff = zz[:, 0].copy()
    for c in np.unique(comp):
        sel = np.flatnonzero(comp == c)
        diff[sel] = np.diff(np.r_[0, zz[sel, 0]])
    keys, codes, lens = [], [], []

    def add(key, code, ln):
        keys.append(key)
        codes.append(code)
        lens.append(ln)

    dcs, dcl = np.stack([tabs[c][0][0] for c in range(len(tabs))]), np.stack(
        [tabs[c][0][1] for c in range(len(tabs))])
    acs, acl = np.stack([tabs[c][1][0] for c in range(len(tabs))]), np.stack(
        [tabs[c][1][1] for c in range(len(tabs))])
    s = _size(diff)
    vbits = np.where(diff < 0, diff + (1 << s) - 1, diff)
    add(np.arange(n) * 256, (dcs[tab, s] << s) | vbits, dcl[tab, s] + s)
    blk, k = np.nonzero(zz[:, 1:])
    k = k + 1
    v = zz[blk, k]
    prev = np.where(np.r_[True, blk[1:] != blk[:-1]], 0, np.r_[0, k[:-1]])
    run = k - prev - 1
    for z in range(3):  # runs of 16 zeros (ZRL), at most three in a block
        m = run >= 16 * (z + 1)
        add(blk[m] * 256 + k[m] * 4 + z, acs[tab[blk[m]], 0xF0], acl[tab[blk[m]], 0xF0])
    s = _size(v)
    sym = ((run % 16) << 4) | s
    vbits = np.where(v < 0, v + (1 << s) - 1, v)
    add(blk * 256 + k * 4 + 3, (acs[tab[blk], sym] << s) | vbits, acl[tab[blk], sym] + s)
    last = np.zeros(n, np.int64)
    np.maximum.at(last, blk, k)
    eob = np.flatnonzero(last < 63)
    add(eob * 256 + 255, acs[tab[eob], 0], acl[tab[eob], 0])
    key, code, ln = (np.concatenate(a) for a in (keys, codes, lens))
    order = np.argsort(key, kind="stable")
    code, ln = code[order], ln[order]
    item = np.repeat(np.arange(code.size), ln)
    shift = (np.repeat(ln, ln) - 1) - (np.arange(item.size) - np.repeat(np.cumsum(ln) - ln, ln))
    bits = ((code[item] >> shift) & 1).astype(np.uint8)
    bits = np.concatenate([bits, np.ones((-bits.size) % 8, np.uint8)])
    return np.packbits(bits).tobytes().replace(b"\xff", b"\xff\x00")


def _marker(tag: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, tag, len(body) + 2) + body


def _dht(tc: int, th: int, spec) -> bytes:
    return bytes([(tc << 4) | th]) + bytes(spec[0]) + bytes(spec[1])


def encode_jpeg(pixels: np.ndarray, quality: int = 97) -> bytes:
    """(H, W) grey or (H, W, 3) RGB uint8 -> baseline JPEG bytes (see the
    module docstring)."""
    px = np.asarray(pixels, np.uint8)
    grey = px.ndim == 2
    h, w = px.shape[:2]
    qs = [_quality_table(_STD_LUMA_Q, quality), _quality_table(_STD_CHROMA_Q, quality)]
    if grey:
        planes, samp = [px.astype(np.int64)], [(1, 1)]
    else:
        rgb = px.astype(np.int64)
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]

        def fix(v):
            return int(v * 65536 + 0.5)

        y = (fix(0.29900) * r + fix(0.58700) * g + fix(0.11400) * b + 32768) >> 16
        cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + (128 << 16) + 32767) >> 16
        cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + (128 << 16) + 32767) >> 16
        planes, samp = [y, cb, cr], [(2, 2), (1, 1), (1, 1)]
    hmax, vmax = samp[0]
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    blocks = []
    for (hs, vs), plane, ci in zip(samp, planes, range(len(planes))):
        # replicate the last column and row out to whole MCUs, then average
        # 2 x 2 for subsampled chroma (libjpeg's h2v2 with its 1, 2 bias)
        full = np.pad(plane, ((0, mcuy * vmax * 8 - h), (0, mcux * hmax * 8 - w)), mode="edge")
        if (hs, vs) != (hmax, vmax):
            bias = np.tile([1, 2], full.shape[1] // 4)
            full = (full[0::2, 0::2] + full[0::2, 1::2] + full[1::2, 0::2]
                    + full[1::2, 1::2] + bias) >> 2
        q = qs[min(ci, 1)]
        coef = _DCT @ (_blocks(full).astype(np.float64) - 128.0) @ _DCT.T
        zz = np.rint(coef.reshape(*coef.shape[:2], 64)[..., ZIGZAG] / q[ZIGZAG]).astype(np.int64)
        # (mcuy, vs, mcux, hs, 64): the blocks of each MCU, rows first
        blocks.append(zz.reshape(mcuy, vs, mcux, hs, 64).transpose(0, 2, 1, 3, 4)
                      .reshape(mcuy * mcux, vs * hs, 64))
    zz = np.concatenate(blocks, axis=1)
    per = [hs * vs for hs, vs in samp]
    comp = np.tile(np.repeat(np.arange(len(samp)), per), mcux * mcuy)
    tabs = [(_code_table(_DC_LUMA), _code_table(_AC_LUMA))]
    if not grey:
        tabs.append((_code_table(_DC_CHROMA), _code_table(_AC_CHROMA)))
    data = _entropy_code(zz.reshape(-1, 64), comp, np.minimum(comp, 1), tabs)

    out = [b"\xff\xd8", _marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    out.append(_marker(0xDB, b"".join(bytes([t]) + qs[t][ZIGZAG].astype(np.uint8).tobytes()
                                      for t in range(len(tabs)))))
    sof = struct.pack(">BHHB", 8, h, w, len(samp)) + b"".join(
        bytes([ci + 1, (hs << 4) | vs, min(ci, 1)]) for ci, (hs, vs) in enumerate(samp))
    out.append(_marker(0xC0, sof))
    dht = _dht(0, 0, _DC_LUMA) + _dht(1, 0, _AC_LUMA)
    if not grey:
        dht += _dht(0, 1, _DC_CHROMA) + _dht(1, 1, _AC_CHROMA)
    out.append(_marker(0xC4, dht))
    sos = bytes([len(samp)]) + b"".join(bytes([ci + 1, (min(ci, 1) << 4) | min(ci, 1)])
                                        for ci in range(len(samp))) + b"\x00\x3f\x00"
    out.append(_marker(0xDA, sos))
    out += [data, b"\xff\xd9"]
    return b"".join(out)
