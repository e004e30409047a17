"""PNG: the chunk walk and inflate on the host, the expansion to RGB.

What PIL's PNG plugin does, split as `image/jpeg.py` splits JPEG: the
serial half here on the host (the chunks, each one's CRC where PIL checks
it, the IDAT chunks joined and inflated with the stdlib's `zlib`, every
scanline's filter type checked), the scanline filters undone on the card
by kernel D3 (`ops/image_decode.py::png_unfilter`), then `expand` turns
the raw scanlines into RGB with torch ops on the decode's device.

PIL's rules, which `expand` and `parse` hold (Pillow 12's PNG plugin and
`convert("RGB")`):
- every colour type (0, 2, 3, 4, 6) at every legal bit depth, and the
  seven Adam7 passes of an interlaced image;
- 1-bit grey opens as mode "1" (0 or 255), 2-bit grey scales by 85, 4-bit
  by 17; 16-bit grey opens as "I;16", and its conversion clips to 255;
- 16-bit RGB, RGBA and LA keep each sample's most significant byte;
- LA and RGBA drop alpha with no compositing, and tRNS is ignored;
- a palette expands through PLTE, and an index past PLTE's entries (or
  any index, with no PLTE) reads black;
- gamma, sRGB and ICC chunks are ignored;
- an APNG decodes its default image (the IDAT chunks);
- the CRC of every chunk before the first IDAT is checked, and none after
  it (PIL's `_open` checks them; `load_read` and `load_end` skip them);
- image data that fills every scanline decodes even when the zlib stream
  or the file stops early after it; data that does not raises.
"""
from __future__ import annotations

import re
import struct
import zlib
from dataclasses import dataclass

import numpy as np
import torch

from .formats import PNG_MAGIC, UnidentifiedImageError, uncovered

# colour type -> channels; the bit depths PIL opens (its `_MODES`)
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7: (x0, y0, dx, dy) of each pass
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_IS_CID = re.compile(rb"\w\w\w\w").match


@dataclass
class PngImage:
    width: int
    height: int
    depth: int
    ctype: int
    palette: np.ndarray | None      # (256, 3) uint8, colour type 3
    data: bytes                     # the inflated, filtered scanlines
    passes: list                    # (x0, y0, dx, dy, w, h, row_bytes,
                                    #  offset in data)

    @property
    def bpp(self) -> int:
        """The filters' byte distance: bytes a pixel, at least 1."""
        return max(1, _CHANNELS[self.ctype] * self.depth // 8)


def _broken(what: str) -> UnidentifiedImageError:
    return UnidentifiedImageError(f"broken PNG file ({what})")


def _passes(width: int, height: int, bits: int, interlaced: bool) -> list:
    grid = ADAM7 if interlaced else ((0, 0, 1, 1),)
    out, off = [], 0
    for x0, y0, dx, dy in grid:
        w = max(0, -(-(width - x0) // dx))
        h = max(0, -(-(height - y0) // dy))
        row_bytes = (w * bits + 7) // 8
        if w == 0 or h == 0:
            w = h = row_bytes = 0
        out.append((x0, y0, dx, dy, w, h, row_bytes, off))
        off += h * (row_bytes + 1) if row_bytes else 0
    return out


def parse(data: bytes) -> PngImage:
    """The chunks of a PNG file, its scanlines inflated and their filter
    types checked."""
    if not data.startswith(PNG_MAGIC):
        raise UnidentifiedImageError("not a PNG file")
    p, header, palette, idat = 8, None, None, []
    n_frames = None
    while True:
        if p + 8 > len(data):
            raise _broken("truncated before the image data")
        length, cid = struct.unpack(">I", data[p:p + 4])[0], data[p + 4:p + 8]
        if not _IS_CID(cid):
            raise _broken(f"chunk {cid!r}")
        body = data[p + 8:p + 8 + length]
        if cid == b"IDAT":
            break
        if len(body) < length or p + 12 + length > len(data):
            raise _broken(f"truncated {cid!r}")
        crc = struct.unpack(">I", data[p + 8 + length:p + 12 + length])[0]
        if zlib.crc32(body, zlib.crc32(cid)) != crc:
            raise _broken(f"bad header checksum in {cid!r}")
        if cid == b"IHDR":
            if length < 13:
                raise _broken("truncated IHDR chunk")
            header = struct.unpack(">IIBBBBB", body[:13])
            if header[5]:
                raise _broken("unknown filter category")
        elif cid == b"PLTE":
            palette = body
        elif cid == b"acTL":
            n_frames = 1
        elif cid == b"fcTL" and header is not None and len(body) >= 26:
            w, h, x, y = struct.unpack(">IIII", body[4:20])
            if (w, h, x, y) != (header[0], header[1], 0, 0):
                raise uncovered("APNG whose default image is a frame "
                                "smaller than the canvas")
        elif cid == b"IEND":
            raise _broken("no image data")
        p += 12 + length
    if header is None:
        raise _broken("no IHDR chunk")
    width, height, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype]:
        raise UnidentifiedImageError(
            f"PNG colour type {ctype} at bit depth {depth}: PIL opens no "
            f"such mode")
    if width == 0 or height == 0:
        raise UnidentifiedImageError("a PNG image of no pixels")
    # the IDAT run (PIL reads consecutive IDAT chunks and checks none of
    # their CRCs); a file cut short inside it gives what it holds
    while p + 8 <= len(data) and data[p + 4:p + 8] == b"IDAT":
        length = struct.unpack(">I", data[p:p + 4])[0]
        idat.append(data[p + 8:p + 8 + length])
        p += 12 + length
    _after_idat(data, p, n_frames is not None)
    passes = _passes(width, height, depth * _CHANNELS[ctype], bool(interlace))
    need = max(off + h * (rb + 1) for *_, h, rb, off in passes) if any(
        q[6] for q in passes) else 0
    try:
        raw = zlib.decompressobj().decompress(b"".join(idat), need)
    except zlib.error as e:
        raise _broken(f"corrupt image data: {e}") from None
    if len(raw) < need:
        raise UnidentifiedImageError("image file is truncated")
    rows = [off + r * (rb + 1) for *_, h, rb, off in passes
            for r in range(h) if rb]
    filters = np.frombuffer(raw, np.uint8)[rows]
    if len(filters) and filters.max() > 4:
        raise _broken("unrecognized scanline filter type")
    table = None
    if ctype == 3:
        table = np.zeros((256, 3), np.uint8)
        if palette is not None:
            n = min(len(palette) // 3, 256)
            table[:n] = np.frombuffer(palette[:3 * n], np.uint8).reshape(n, 3)
    return PngImage(width, height, depth, ctype, table, raw, passes)


def _after_idat(data: bytes, p: int, animated: bool) -> None:
    """What PIL's `load_end` refuses after the image data: a chunk whose
    header is whole but whose data the file cuts short (an IEND, and an
    animation's next frame, end the walk; so does a cut header)."""
    while p + 8 <= len(data):
        length, cid = struct.unpack(">I", data[p:p + 4])[0], data[p + 4:p + 8]
        if not _IS_CID(cid) or cid == b"IEND" or (
                animated and cid == b"fcTL"):
            return
        if p + 8 + length > len(data):
            raise UnidentifiedImageError("image file is truncated")
        p += 12 + length


def expand(img: PngImage, raw: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) uint8 RGB from the image's unfiltered scanlines (`raw`,
    its passes end to end without their filter bytes), as PIL's mode and
    `convert("RGB")` give it, on `raw`'s device."""
    dev = raw.device
    ch = _CHANNELS[img.ctype]
    canvas = torch.zeros(img.height, img.width, ch, dtype=torch.int64,
                         device=dev)
    off = 0
    for x0, y0, dx, dy, w, h, rb, _ in img.passes:
        if not rb:
            continue
        rows = raw[off:off + h * rb].view(h, rb).to(torch.int64)
        off += h * rb
        if img.depth == 16:
            pairs = rows.view(h, w, ch, 2)
            s = (pairs[..., 0] << 8) | pairs[..., 1]
        elif img.depth == 8:
            s = rows.view(h, w, ch)
        else:
            d = img.depth
            shifts = torch.arange(8 - d, -1, -d, device=dev)
            s = ((rows[:, :, None] >> shifts) & ((1 << d) - 1)).view(
                h, -1)[:, :w, None]
        canvas[y0::dy, x0::dx] = s
    if img.ctype == 3:
        rgb = torch.from_numpy(img.palette).to(dev)[canvas[..., 0]]
        return rgb
    if img.depth == 16:
        # "I;16" clips; RGB, RGBA and LA keep the high byte
        canvas = canvas.clamp(max=255) if img.ctype == 0 else canvas >> 8
    elif img.depth < 8:
        canvas = canvas * {1: 255, 2: 85, 4: 17}[img.depth]
    if img.ctype in (0, 4):
        canvas = canvas[..., :1].expand(-1, -1, 3)
    else:
        canvas = canvas[..., :3]
    return canvas.to(torch.uint8).contiguous()
