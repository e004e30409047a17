"""Which decoder a file needs, from its first bytes.

The reference opens every file with PIL (`Image.open`), which tries each
of its plugins on the file's leading bytes. The port decodes PNG and
Huffman-coded sequential JPEG itself (`image/png.py`, `image/jpeg.py`), so
a file falls into one of three groups:

- covered: PNG, and JPEG (whose frame type `image/jpeg.py` checks in turn);
- known to PIL but not covered yet: `NotImplementedError` naming the
  format and ROADMAP Queue 1 item 29, in both `read_image_dir` and
  `read_images`. Skipping such a file would give a table the reference
  does not give;
- not an image: `UnidentifiedImageError`, an `OSError` as PIL's own is,
  which `read_image_dir` skips and `read_images` raises.

`SIGNATURES` lists what the port recognises of PIL's other formats. A
format that PIL recognises by something other than a fixed signature
(TGA, by its header's field values; Spider, by its float header) is taken
here for a non-image: a folder that holds one gives the reference one row
more (ROADMAP Queue 3 (ak)).
"""
from __future__ import annotations

import re
import struct

# the first bytes `sniff` reads
HEAD_BYTES = 128

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
JPEG_MAGIC = b"\xff\xd8\xff"

# ROADMAP Queue 1's item for the formats the decoders do not cover yet
UNCOVERED_ITEM = "ROADMAP Queue 1 item 29"


class UnidentifiedImageError(OSError):
    """Not an image the reference could open: PIL raises its own
    `UnidentifiedImageError` (an `OSError`) for such a file, or an error
    while it loads."""


def _riff(kind: bytes):
    return lambda h: h[:4] == b"RIFF" and h[8:12] == kind


def _dib(h: bytes) -> bool:
    # PIL's `_dib_accept`, then the bit depth its header reader takes
    if len(h) < 16:
        return False
    size = struct.unpack("<I", h[:4])[0]
    if size not in (12, 40, 52, 56, 64, 108, 124):
        return False
    bits = struct.unpack("<H", h[10:12] if size == 12 else h[14:16])[0]
    return bits in (1, 2, 4, 8, 16, 24, 32)


# the magic numbers PIL's PPM reader takes, then white space and the width
# (or a comment), so that a text file that starts "P1 " is no image
_PPM = re.compile(rb"P(?:[1-6fF]|yP)[ \t\n\r\v\f]+[0-9#]")


def _bmp(h: bytes) -> bool:
    # "BM", then a header size PIL's BMP reader takes
    return h[:2] == b"BM" and len(h) >= 18 and struct.unpack(
        "<I", h[14:18])[0] in (12, 40, 52, 56, 64, 108, 124)


def _sgi(h: bytes) -> bool:
    # the magic number, then the storage, bytes a sample and dimension
    # PIL's SGI reader takes
    return (len(h) >= 6 and h[:2] == b"\x01\xda" and h[2] in (0, 1)
            and h[3] in (1, 2) and struct.unpack(">H", h[4:6])[0] in (1, 2, 3))


def _pcx(h: bytes) -> bool:
    # PIL's `_accept`, then the bit depths and planes its reader takes
    return (len(h) >= 66 and h[0] == 10 and h[1] in (0, 2, 3, 5)
            and h[3] in (1, 2, 4, 8) and h[65] in (1, 3, 4))


def _fli(h: bytes) -> bool:
    # PIL's `_accept` and the zero word its `_open` checks
    return (len(h) >= 22
            and struct.unpack("<H", h[4:6])[0] in (0xAF11, 0xAF12)
            and struct.unpack("<H", h[14:16])[0] in (0, 3)
            and h[20:22] == b"\x00\x00")


# PIL's formats (`Image.open`'s plugins, with their `_accept` tests) that
# the port recognises and does not decode: (name, test of the head)
SIGNATURES = (
    ("GIF", lambda h: h[:6] in (b"GIF87a", b"GIF89a")),
    ("BMP", _bmp),
    ("TIFF", lambda h: h[:4] in (b"MM\x00\x2a", b"II\x2a\x00",
                                 b"MM\x00\x2b", b"II\x2b\x00")),
    ("WebP", _riff(b"WEBP")),
    ("ICO", lambda h: h[:4] == b"\x00\x00\x01\x00"),
    ("CUR", lambda h: h[:4] == b"\x00\x00\x02\x00"),
    ("ICNS", lambda h: h[:4] == b"icns"),
    ("PPM", _PPM.match),
    ("PSD", lambda h: h[:4] == b"8BPS"),
    ("JPEG 2000", lambda h: h[:4] == b"\xff\x4f\xff\x51"
     or h[:12] == b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"),
    ("QOI", lambda h: h[:4] == b"qoif"),
    ("DDS", lambda h: h[:4] == b"DDS "),
    ("AVIF", lambda h: h[4:8] == b"ftyp" and h[8:12] in (b"avif", b"avis")),
    ("SGI", _sgi),
    ("Sun raster", lambda h: h[:4] == b"\x59\xa6\x6a\x95"),
    ("EPS", lambda h: h[:4] in (b"%!PS", b"\xc5\xd0\xd3\xc6")),
    ("XBM", lambda h: h.lstrip()[:7] == b"#define"),
    ("XPM", lambda h: h[:9] == b"/* XPM */"),
    ("BLP", lambda h: h[:4] in (b"BLP1", b"BLP2")),
    ("FTEX", lambda h: h[:4] in (b"FTEX", b"FTEU")),
    ("MSP", lambda h: h[:4] in (b"DanM", b"LinS")),
    ("PIXAR", lambda h: h[:4] == b"\x80\xe8\x00\x00"),
    ("FLI", _fli),
    ("PCX", _pcx),
    ("DIB", _dib),
)


def sniff(head: bytes) -> str | None:
    """"PNG", "JPEG", the name of another format PIL knows, or None for a
    file that is not an image as far as the port can tell."""
    if head.startswith(PNG_MAGIC):
        return "PNG"
    if head.startswith(JPEG_MAGIC):
        return "JPEG"
    for name, test in SIGNATURES:
        if test(head):
            return name
    return None


def uncovered(what: str) -> NotImplementedError:
    """The error for an image the reference decodes and the port does not
    yet: it names the format (or the variant of a covered one)."""
    return NotImplementedError(
        f"{what} is not decoded by the port yet ({UNCOVERED_ITEM}); PIL, "
        f"which the reference decodes with, is not on the card's machine")
