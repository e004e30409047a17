"""Huffman-coded sequential JPEG: the markers and the entropy decoder.

What PIL decodes with libjpeg-turbo, split where the work is serial and
where it is not. This module is the serial half, on the host: it reads
the markers (DQT, DHT, SOF0/SOF1, SOS, DRI, APP0's JFIF and APP14's
Adobe transform flag), undoes the byte stuffing, splits each scan at its
restart markers (which reset the DC predictors) and Huffman-decodes every
8x8 block into int16 coefficients in natural order. The parallel half,
the dequantization and integer IDCT (kernel D1) and the upsampling and
colour conversion (kernel D2), runs on the card (`ops/image_decode.py`).

The decoder is table driven: every bit position of a scan's data gets
the 32 bits that start there (one numpy pass), and one lookup of the
first 16 of them gives a code's length and symbol and, where the code and
its extra bits fit in 16, the coefficient itself. Python still runs one
loop turn per coefficient, so this is correct but slow (ROADMAP Queue 1
item 30 is a host C++ decoder).

Covered: 8-bit samples, 1 or 3 components, 4:4:4, 4:2:2 (h2v1) and 4:2:0
(h2v2) chroma, interleaved and single-component scans, restart intervals.
Progressive, lossless and arithmetic-coded frames, 4-component (CMYK,
YCCK) files and other sampling factors raise `NotImplementedError`
naming themselves (`formats.uncovered`). What libjpeg refuses (12-bit
samples, hierarchical frames, 2 components, corrupt tables) raises
`UnidentifiedImageError`, as PIL's open or load does.
"""
from __future__ import annotations

import functools
import re
from dataclasses import dataclass

import numpy as np

from .formats import UnidentifiedImageError, uncovered

# the natural (row-major) index of the k-th coefficient in zigzag order;
# 16 extra entries catch a corrupt run past the block, as libjpeg's do
NATURAL = (
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63)

GREY, YCC, RGB = 0, 1, 2            # the colour transform D2 applies

_SOF_PROGRESSIVE = (0xC2, 0xCA)
_SOF_LOSSLESS = (0xC3, 0xCB)
_SOF_ARITHMETIC = 0xC9
_SOF_HIERARCHICAL = (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF)
# (max h / h, max v / v) of a component: the upsampling D2 does
_RATIOS = {(1, 1): "4:4:4", (2, 1): "4:2:2", (2, 2): "4:2:0"}
_STUFFED = re.compile(rb"\xff+\x00")
_RESTART = re.compile(rb"\xff+[\xd0-\xd7]")
_PAD = b"\x00" * 16                 # libjpeg reads zeros past a segment


@dataclass
class Component:
    ident: int
    h: int                          # sampling factors
    v: int
    tq: int                         # quantization table slot
    dw: int = 0                     # downsampled width and height
    dh: int = 0
    wb: int = 0                     # blocks per row and block rows,
    hb: int = 0                     # padded to whole MCUs
    block0: int = 0                 # first block in the image's coefs
    quant: np.ndarray = None        # (64,) natural order, latched


@dataclass
class JpegImage:
    """One decoded-to-coefficients image: what D1 and D2 need."""
    width: int
    height: int
    color: int                      # GREY, YCC or RGB
    components: list
    coefs: np.ndarray               # (blocks, 64) int16, natural order

    @property
    def n_blocks(self) -> int:
        return self.coefs.shape[0]


def _u16(b: bytes, i: int) -> int:
    return (b[i] << 8) | b[i + 1]


def _corrupt(what: str) -> UnidentifiedImageError:
    return UnidentifiedImageError(f"corrupt JPEG data: {what}")


@functools.lru_cache(maxsize=256)
def _tables(spec: bytes):
    """(DC table, AC table) lookups for one Huffman table (16 counts, then
    the symbols): each maps the next 16 bits to a code's outcome, None
    where no code matches. DC: (code length, extra bits). AC: (bits to
    consume, zigzag steps before the coefficient, its value, extra bits
    still to read): a code whose extra bits fit in the 16 bits carries
    its value and 0, one that does not carries its length alone and its
    extra bit count; an EOB steps 64 (past the block) and a ZRL 15 with a
    zero value."""
    counts, symbols = spec[:16], spec[16:]
    lengths = np.repeat(np.arange(1, 17), np.frombuffer(counts, np.uint8))
    if len(lengths) != len(symbols) or len(symbols) > 256:
        raise _corrupt("bogus Huffman table definition")
    codes, code, k = [], 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            codes.append((length, code, symbols[k]))
            code, k = code + 1, k + 1
        if code > (1 << length):
            raise _corrupt("bogus Huffman table definition")
        code <<= 1
    dc = [None] * 65536
    ac = [None] * 65536
    for length, code, sym in codes:
        start, n = code << (16 - length), 1 << (16 - length)
        dc[start:start + n] = [(length, sym)] * n
        run, size = sym >> 4, sym & 15
        if size == 0:
            # ZRL, else (any other run with no bits) the end of the block
            entry = (length, 15, 0, 0) if run == 15 else (length, 64, 0, 0)
            ac[start:start + n] = [entry] * n
        elif length + size > 16:
            ac[start:start + n] = [(length, run, 0, size)] * n
        else:
            bits = (np.arange(n) >> (16 - length - size)) & ((1 << size) - 1)
            vals = np.where(bits < (1 << (size - 1)),
                            bits - (1 << size) + 1, bits)
            ac[start:start + n] = [(length + size, run, v, 0)
                                   for v in vals.tolist()]
    return dc, ac


def _windows(buf: bytes) -> list:
    """win[i] = the 32 bits of `buf` that start at bit i (zeros past the
    end), for every bit position."""
    a = np.frombuffer(buf + _PAD, np.uint8).astype(np.uint64)
    n = len(buf) + len(_PAD) - 4
    w40 = ((a[:n] << np.uint64(32)) | (a[1:n + 1] << np.uint64(24))
           | (a[2:n + 2] << np.uint64(16)) | (a[3:n + 3] << np.uint64(8))
           | a[4:n + 4])
    shifts = np.arange(8, 0, -1, dtype=np.uint64)
    return ((w40[:, None] >> shifts[None, :])
            & np.uint64(0xFFFFFFFF)).ravel().tolist()


def _scan_data(data: bytes, p: int):
    """(the scan's restart intervals, unstuffed, and the offset of the
    marker that ends the scan), from the first byte after the SOS header."""
    q = p
    while True:
        q = data.find(b"\xff", q)
        if q < 0 or q + 1 >= len(data):
            raise _corrupt("the file ends inside a scan")
        r = q + 1
        while r < len(data) and data[r] == 0xFF:
            r += 1
        if r >= len(data):
            raise _corrupt("the file ends inside a scan")
        if data[r] == 0x00 or 0xD0 <= data[r] <= 0xD7:
            q = r + 1
            continue
        return [_STUFFED.sub(b"\xff", s)
                for s in _RESTART.split(data[p:q])], q


def _block_order(comps: list, mcux: int, mcuy: int):
    """(global block index, slot in the scan) of each block in the scan's
    coding order, and the blocks an MCU holds."""
    if len(comps) == 1:
        c = comps[0]
        wb = -(-c.dw // 8)
        hb = -(-c.dh // 8)
        rows = np.arange(hb)[:, None] * c.wb + np.arange(wb)[None, :]
        return (c.block0 + rows.ravel()), np.zeros(wb * hb, np.int64), 1
    per_mcu, slot = [], []
    for i, c in enumerate(comps):
        for v in range(c.v):
            for h in range(c.h):
                per_mcu.append((c, v, h))
                slot.append(i)
    my, mx = np.meshgrid(np.arange(mcuy), np.arange(mcux), indexing="ij")
    my, mx = my.ravel()[:, None], mx.ravel()[:, None]
    order = np.concatenate([
        c.block0 + (my * c.v + v) * c.wb + mx * c.h + h
        for c, v, h in per_mcu], axis=1)
    return (order.ravel(), np.tile(np.asarray(slot), mcux * mcuy),
            len(per_mcu))


def _decode_scan(segments: list, comps: list, dcs: list, acs: list,
                 order: np.ndarray, slots: np.ndarray, per_mcu: int,
                 restart: int, idx: list, val: list) -> None:
    """Huffman-decode one scan's blocks, appending each coefficient's
    position (block * 64 + natural index) and value."""
    buf = b"".join(segments)
    win = _windows(buf)
    starts, acc = [], 0
    for s in segments:
        starts.append(acc * 8)
        acc += len(s)
    per_interval = restart * per_mcu if restart else len(order)
    nat = NATURAL + (63,) * 16
    ia, va = idx.append, val.append
    order, slots = order.tolist(), slots.tolist()
    n_slots = len(comps)
    pos, preds, seg = 0, [0] * n_slots, 0
    try:
        for i in range(len(order)):
            if i and i % per_interval == 0:
                seg += 1
                if seg >= len(starts):
                    raise _corrupt("a restart marker is missing")
                pos, preds = starts[seg], [0] * n_slots
            c = slots[i]
            b = order[i] * 64
            w = win[pos]
            length, size = dcs[c][w >> 16]
            pos += length
            if size:
                r = win[pos] >> (32 - size)
                if r < (1 << (size - 1)):
                    r += 1 - (1 << size)
                pos += size
                preds[c] += r
            ia(b)
            va(preds[c])
            ac = acs[c]
            k = 1
            while True:
                nb, run, v, size = ac[win[pos] >> 16]
                if size:
                    v = win[pos + nb] >> (32 - size)
                    if v < (1 << (size - 1)):
                        v += 1 - (1 << size)
                    nb += size
                pos += nb
                k += run
                if k > 63:
                    break
                ia(b + nat[k])
                va(v)
                k += 1
                if k > 63:
                    break
    except (TypeError, IndexError):
        raise _corrupt("bad Huffman code") from None


def _frame(seg: bytes, marker: int) -> tuple:
    """(height, width, components) of a frame header, raising what PIL and
    libjpeg raise for frames they refuse and `NotImplementedError` for
    those they decode and the port does not."""
    if len(seg) < 6:
        raise _corrupt("short frame header")
    precision, height, width, nf = seg[0], _u16(seg, 1), _u16(seg, 3), seg[5]
    if precision != 8:
        raise UnidentifiedImageError(
            f"cannot handle {precision}-bit JPEG samples (PIL refuses them "
            f"too)")
    if nf not in (1, 3, 4):
        raise UnidentifiedImageError(f"cannot handle {nf}-component JPEG")
    if marker in _SOF_HIERARCHICAL:
        raise UnidentifiedImageError(
            "hierarchical JPEG (libjpeg, PIL's decoder, refuses it too)")
    if marker in _SOF_PROGRESSIVE:
        raise uncovered("progressive JPEG")
    if marker in _SOF_LOSSLESS:
        raise uncovered("lossless JPEG")
    if marker == _SOF_ARITHMETIC:
        raise uncovered("arithmetic-coded JPEG")
    if nf == 4:
        raise uncovered("4-component (CMYK or YCCK) JPEG")
    if len(seg) < 6 + 3 * nf:
        raise _corrupt("short frame header")
    if width == 0 or height == 0:
        raise UnidentifiedImageError("empty JPEG image (DNL not supported)")
    comps = [Component(seg[i], seg[i + 1] >> 4, seg[i + 1] & 15, seg[i + 2])
             for i in range(6, 6 + 3 * nf, 3)]
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    for c in comps:
        if not (1 <= c.h <= 4 and 1 <= c.v <= 4) or c.tq > 3:
            raise _corrupt("bogus sampling factors or table slot")
        if hmax % c.h or vmax % c.v:
            raise UnidentifiedImageError(
                "fractional JPEG sampling (libjpeg refuses it too)")
        if nf == 3 and (hmax // c.h, vmax // c.v) not in _RATIOS:
            raise uncovered(f"JPEG with {hmax // c.h}x{vmax // c.v} chroma "
                            f"subsampling")
    if nf == 1:
        comps[0].h = comps[0].v = hmax = vmax = 1
    mcux = -(-width // (8 * hmax))
    mcuy = -(-height // (8 * vmax))
    block0 = 0
    for c in comps:
        c.dw = -(-width * c.h // hmax)
        c.dh = -(-height * c.v // vmax)
        c.wb, c.hb = mcux * c.h, mcuy * c.v
        c.block0 = block0
        block0 += c.wb * c.hb
    return height, width, comps


def _color(comps: list, jfif: bool, adobe) -> int:
    """libjpeg's guess of the colour space (jdapimin.c
    default_decompress_parms), which PIL leaves to it."""
    if len(comps) == 1:
        return GREY
    if jfif:
        return YCC
    if adobe is not None:
        return RGB if adobe == 0 else YCC
    ids = tuple(c.ident for c in comps)
    return RGB if ids == (82, 71, 66) else YCC


def parse(data: bytes) -> JpegImage:
    """The markers and every scan of a JPEG file, to coefficients."""
    if not data.startswith(b"\xff\xd8"):
        raise UnidentifiedImageError("not a JPEG file")
    qt, dht = {}, {}
    restart, jfif, adobe = 0, False, None
    frame, idx, val, p = None, [], [], 2
    while True:
        p = data.find(b"\xff", p)          # libjpeg skips junk bytes
        while 0 <= p < len(data) - 1 and data[p + 1] == 0xFF:
            p += 1
        if p < 0 or p >= len(data) - 1:
            raise UnidentifiedImageError("image file is truncated")
        marker = data[p + 1]
        p += 2
        if marker == 0x00 or 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue                        # stuffed byte, RST or TEM
        if marker == 0xD9:
            break
        if marker == 0xD8:
            raise _corrupt("two SOI markers")
        if p + 2 > len(data):
            raise UnidentifiedImageError("image file is truncated")
        seg = data[p + 2:p + _u16(data, p)]
        end = p + _u16(data, p)
        if end > len(data) or end < p + 2:
            raise UnidentifiedImageError("image file is truncated")
        p = end
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            if frame is not None:
                raise _corrupt("two frame headers")
            frame = _frame(seg, marker)
        elif marker == 0xC4:
            i = 0
            while i < len(seg):
                n = 17 + sum(seg[i + 1:i + 17])
                if seg[i] >> 4 > 1 or seg[i] & 15 > 3 or i + n > len(seg):
                    raise _corrupt("bogus DHT")
                dht[(seg[i] >> 4, seg[i] & 15)] = bytes(seg[i + 1:i + n])
                i += n
        elif marker == 0xDB:
            i = 0
            while i < len(seg):
                wide, slot = seg[i] >> 4, seg[i] & 15
                n = 1 + 64 * (wide + 1)
                if slot > 3 or wide > 1 or i + n > len(seg):
                    raise _corrupt("bogus DQT")
                zz = np.frombuffer(seg[i + 1:i + n],
                                   ">u2" if wide else np.uint8)
                q = np.zeros(64, np.uint16)
                q[list(NATURAL)] = zz
                qt[slot] = q
                i += n
        elif marker == 0xDD:
            restart = _u16(seg, 0) if len(seg) >= 2 else 0
        elif marker == 0xE0:
            jfif = jfif or (len(seg) >= 14 and seg.startswith(b"JFIF\0"))
        elif marker == 0xEE:
            if len(seg) >= 12 and seg.startswith(b"Adobe"):
                adobe = seg[11]
        elif marker == 0xDA:
            if frame is None:
                raise _corrupt("a scan before the frame header")
            p = _scan(data, p, seg, frame, qt, dht, restart, idx, val)
    if frame is None or not idx:
        raise UnidentifiedImageError("a JPEG file with no image")
    height, width, comps = frame
    n_blocks = sum(c.wb * c.hb for c in comps)
    coefs = np.zeros(n_blocks * 64, np.int16)
    coefs[np.asarray(idx, np.int64)] = np.asarray(val, np.int64).astype(
        np.int16)
    for c in comps:
        if c.quant is None:
            raise _corrupt("a component no scan coded")
    return JpegImage(width, height, _color(comps, jfif, adobe), comps,
                     coefs.reshape(n_blocks, 64))


def _scan(data, p, seg, frame, qt, dht, restart, idx, val) -> int:
    """Decode the scan whose header is `seg`; returns the offset of the
    marker after its data."""
    height, width, comps = frame
    ns = seg[0] if seg else 0
    if ns < 1 or ns > 4 or len(seg) < 1 + 2 * ns + 3:
        raise _corrupt("bogus SOS")
    by_id = {c.ident: c for c in comps}
    chosen, dcs, acs = [], [], []
    for i in range(ns):
        c = by_id.get(seg[1 + 2 * i])
        if c is None:
            raise _corrupt("a scan names an unknown component")
        td, ta = seg[2 + 2 * i] >> 4, seg[2 + 2 * i] & 15
        if (0, td) not in dht or (1, ta) not in dht:
            raise _corrupt("a scan uses an undefined Huffman table")
        if c.quant is None:
            if c.tq not in qt:
                raise _corrupt("a component's quantization table is "
                               "undefined")
            c.quant = qt[c.tq].copy()        # latched, as libjpeg does
        chosen.append(c)
        dcs.append(_tables(dht[(0, td)])[0])
        acs.append(_tables(dht[(1, ta)])[1])
    ss, se, a = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
    if ss != 0 or se != 63 or a != 0:
        raise _corrupt("a sequential scan with progressive parameters")
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    order, slots, per_mcu = _block_order(
        chosen, -(-width // (8 * hmax)), -(-height // (8 * vmax)))
    segments, end = _scan_data(data, p)
    _decode_scan(segments, chosen, dcs, acs, order, slots, per_mcu,
                 restart, idx, val)
    return end
