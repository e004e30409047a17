"""Data sources: CSV and binary files -> Table.

Port of the reference's `io/sources.py` (role: the reference's data
sources, SURVEY.md §2.6: io/binary/BinaryFileFormat.scala and the CSV
ingestion its examples lean on).

`read_csv` parses as the reference's native path does
(`native/kernels.cpp::parse_csv_floats`, the one it takes wherever a C++
compiler is present): each field is C's `strtof` bounded to the field,
so a number is one correctly rounded float32 (never a float64 rounded
again to float32), `inf`/`nan`/hex forms parse, trailing blanks are
allowed, and a column turns to text as soon as one non-empty field is
not wholly a number (a date's "2024-01-01" parses its prefix 2024, and
makes its column text). Text columns are re-read with numpy's
`genfromtxt`, as the reference re-reads them.

`read_images` decodes PNG and Huffman-coded sequential JPEG without PIL
(`image/decode.py`), to PIL's pixels bit for bit, and with `size`
resizes as PIL's `resize` does (BICUBIC, antialiased). It catches
nothing: a file that is not an image raises an `OSError`, as PIL's
`UnidentifiedImageError` is one, and a format PIL decodes and the port
does not yet raises `NotImplementedError` naming it.
"""
from __future__ import annotations

import glob as _glob
import re
from fractions import Fraction

import numpy as np

from ..core import Table

# strtof's grammar after its leading white space (C locale), longest
# match first: hex, decimal, infinity, nan with its optional n-char tail
_NUMBER = re.compile(
    rb"[+-]?(?:0[xX](?:[0-9a-fA-F]+\.?[0-9a-fA-F]*|\.[0-9a-fA-F]+)"
    rb"(?:[pP][+-]?[0-9]+)?"
    rb"|(?:[0-9]+\.?[0-9]*|\.[0-9]+)(?:[eE][+-]?[0-9]+)?"
    rb"|[iI][nN][fF](?:[iI][nN][iI][tT][yY])?"
    rb"|[nN][aA][nN](?:\([0-9A-Za-z_]*\))?)")
_C_SPACE = b" \t\n\v\f\r"      # isspace in the C locale: strtof skips it
_TRAILING = b" \r\t"          # what parse_csv_floats allows after a number
_F32_TOP = 2.0 ** 128         # the first power of two past float32's range
# glibc reads a "nan(chars)" tail as strtoull(chars, 0) into the quiet
# NaN's 22 payload bits, when the whole tail is one number
_NAN_TAIL = ((re.compile(rb"0[xX][0-9a-fA-F]+"), 16, 2),
             (re.compile(rb"0[0-7]*"), 8, 0),
             (re.compile(rb"[1-9][0-9]*"), 10, 0))


def _nan(token: bytes) -> np.float32:
    """strtof's NaN of a "nan" or "nan(chars)" token: the quiet NaN, its
    sign, and the tail's number in the payload."""
    payload = 0
    tail = token[token.find(b"(") + 1:-1] if token.endswith(b")") else b""
    for pattern, base, skip in _NAN_TAIL:
        if pattern.fullmatch(tail):
            payload = min(int(tail[skip:] or b"0", base), 2 ** 64 - 1)
            break
    bits = 0x7FC00000 | (payload & 0x3FFFFF)
    if token[:1] == b"-":
        bits |= 0x80000000
    return np.array([bits], np.uint32).view(np.float32)[0]


def _exact(token: bytes) -> Fraction:
    """The exact rational value of a finite decimal or hex token."""
    text = token.decode()
    sign = -1 if text[0] == "-" else 1
    body = text.lstrip("+-")
    if body[:2] in ("0x", "0X"):
        mant, _, exp = body[2:].replace("P", "p").partition("p")
        whole, _, frac = mant.partition(".")
        num = int((whole + frac) or "0", 16)
        return sign * Fraction(num) * Fraction(2) ** (
            int(exp or "0") - 4 * len(frac))
    return sign * Fraction(body)


def _to_f32(token: bytes) -> np.float32:
    """strtof of a whole token: the float32 nearest its exact value, ties
    to even. The token goes through float64 first; that double rounding
    differs from one rounding only when the float64 lies exactly half way
    between two float32s, and then the exact value decides."""
    low = token.lower().lstrip(b"+-")
    sign = np.float32(-1.0 if token[:1] == b"-" else 1.0)
    if low.startswith(b"nan"):
        return _nan(token)
    if low.startswith(b"inf"):
        return sign * np.float32(np.inf)
    d = (float.fromhex(token.decode()) if b"x" in low
         else float(token))
    with np.errstate(over="ignore"):
        f = np.float32(d)
        if not np.isfinite(d):
            return f
        a = abs(d)
        below = np.float32(a) if float(np.float32(a)) <= a else \
            np.nextafter(np.float32(a), np.float32(0))
        above = np.nextafter(below, np.float32(np.inf))
    top = _F32_TOP if np.isinf(above) else float(above)
    mid = (float(below) + top) / 2
    if a != mid:
        return f
    exact = abs(_exact(token))
    if exact == Fraction(mid):
        return f                  # a true tie: ties to even, as the cast
    out = above if exact > Fraction(mid) else below
    return np.float32(-out if d < 0 else out)


def _parse_field(field: bytes):
    """(value, clean) of one field as `parse_csv_floats` reads it: NaN
    and clean for a blank field, the number and clean for a field that
    is wholly one, NaN and not clean otherwise."""
    start = len(field) - len(field.lstrip(_C_SPACE))
    m = _NUMBER.match(field, start)
    if m is None:
        # no conversion: blank (of the allowed blanks) stays clean
        return np.float32(np.nan), not field.strip(_TRAILING)
    if field[m.end():].strip(_TRAILING):
        return np.float32(np.nan), False   # prefix-numeric text
    return _to_f32(m.group()), True


def _parse_rows(raw: bytes, cols: int, skip_rows: int) -> tuple:
    """((rows, cols) float32, (cols,) clean flags): the native parser's
    loop. Empty lines are skipped, a short row's missing fields are NaN,
    fields past `cols` are ignored."""
    lines = raw.split(b"\n")
    if raw.endswith(b"\n"):
        lines.pop()
    rows, clean = [], np.ones(cols, bool)
    for line in lines[skip_rows:]:
        if not line:
            continue
        row = np.full(cols, np.nan, np.float32)
        for c, field in enumerate(line.split(b",", cols)[:cols]):
            row[c], ok = _parse_field(field)
            clean[c] &= ok
        rows.append(row)
    mat = np.stack(rows) if rows else np.zeros((0, cols), np.float32)
    return mat, clean


def read_csv(path: str, npartitions: int = 1) -> Table:
    """Header-aware CSV -> Table: float32 columns where every field is a
    number (or blank), text (object) columns otherwise (module
    docstring)."""
    with open(path, "rb") as f:
        raw = f.read()
    header, _, _ = raw.partition(b"\n")
    names = [h.strip().decode() for h in header.split(b",")]
    cols = len(names)
    mat, clean = _parse_rows(raw, cols, skip_rows=1)

    data = {}
    text_cols = [j for j in range(cols)
                 if not clean[j] or np.isnan(mat[:, j]).all()]
    if text_cols:  # re-read only the non-numeric columns as strings
        str_mat = np.genfromtxt(path, delimiter=",", skip_header=1,
                                dtype=str, usecols=text_cols)
        str_mat = str_mat.reshape(mat.shape[0], len(text_cols))
    for j, name in enumerate(names):
        if j in text_cols:
            data[name] = str_mat[:, text_cols.index(j)].astype(object)
        else:
            data[name] = mat[:, j]
    return Table(data, npartitions)


def read_binary_files(pattern: str, npartitions: int = 1) -> Table:
    """Glob files into a Table of (path, bytes) — the reference's
    BinaryFileFormat (io/binary/BinaryFileFormat.scala) reader shape."""
    paths = sorted(_glob.glob(pattern, recursive=True))
    blobs = np.empty(len(paths), dtype=object)
    for i, p in enumerate(paths):
        with open(p, "rb") as f:
            blobs[i] = f.read()
    return Table({"path": np.asarray(paths, dtype=object), "bytes": blobs},
                 npartitions)


def read_images(pattern: str, size: tuple = None, npartitions: int = 1,
                device=None) -> Table:
    """Glob image files into (path, image) with images decoded to
    (H, W, C) float32 arrays — the reference's ImageFileFormat
    (io/image/ImageFileFormat.scala). `size=(H, W)` resizes on load, making
    the image column a single stackable (N, H, W, C) array; without it the
    column is per-row object arrays. The files decode on `device` (None:
    the card)."""
    from ..device import resolve_device
    from ..image.decode import decode_files, image_column

    paths = sorted(_glob.glob(pattern, recursive=True))
    _, imgs = decode_files(paths, resolve_device(device), size=size)
    image_col = image_column([im.astype(np.float32) for im in imgs],
                             size is not None)
    return Table({"path": np.asarray(paths, dtype=object),
                  "image": image_col}, npartitions)
