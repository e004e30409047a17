"""Regenerate the image-decoder fixtures in tests/data/images/ and their
digests (expected.json).

PIL writes what it can write; `write_png` below writes what it cannot
(16-bit RGB, RGBA and LA, 2- and 4-bit grey, palettes below 8 bits with
tRNS, Adam7 interlacing, several IDAT chunks, all five scanline filters),
from seeded numpy content. `expected.json` holds, for every file, the
shape and the SHA-256 of PIL's `convert("RGB")` bytes, and the SHA-256 of
the float32 bytes the reference's `read_images(size=(224, 224))` gives
(`np.asarray(im.convert("RGB").resize((224, 224)), np.float32)`).

`write_png` and `field` need only numpy and zlib, so the CPU parity tests
import them to write their own cases; the rest needs PIL.

Run: python tests/data/make_image_fixtures.py
"""
import hashlib
import json
import os
import struct
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "images")
RESIZE = (224, 224)

_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(cid: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + cid + body
            + struct.pack(">I", zlib.crc32(body, zlib.crc32(cid))))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _pack_rows(samples: np.ndarray, depth: int) -> list:
    """(h, w * channels) samples -> each row's bytes, big-endian, MSB
    first below 8 bits."""
    if depth == 16:
        return [r.astype(">u2").tobytes() for r in samples]
    if depth == 8:
        return [r.astype(np.uint8).tobytes() for r in samples]
    per = 8 // depth
    rows = []
    for r in samples:
        n = -(-len(r) // per)
        padded = np.zeros(n * per, np.int64)
        padded[:len(r)] = r
        padded = padded.reshape(n, per)
        byte = np.zeros(n, np.int64)
        for k in range(per):
            byte |= padded[:, k] << (8 - depth * (k + 1))
        rows.append(byte.astype(np.uint8).tobytes())
    return rows


def _filtered(rows: list, bpp: int, rng, only) -> bytes:
    """Each row behind a filter byte: `only`, or one drawn from `rng`."""
    out, prev = bytearray(), bytes(len(rows[0]))
    for row in rows:
        f = int(rng.integers(0, 5)) if only is None else only
        out.append(f)
        for i, x in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[f]
            out.append((x - pred) & 255)
        prev = row
    return bytes(out)


def write_png(path: str, samples: np.ndarray, depth: int, ctype: int,
              interlace: bool = False, palette: bytes = None,
              trns: bytes = None, n_idat: int = 1, seed: int = 0,
              only: int = None) -> None:
    """A PNG of (H, W, channels) integer `samples` at `depth` bits, colour
    type `ctype`, every row behind a seeded filter (or filter `only`),
    with a gAMA chunk (ignored by the decoders), the given PLTE and tRNS,
    and the zlib stream split over `n_idat` IDAT chunks."""
    rng = np.random.default_rng(seed)
    h, w = samples.shape[:2]
    bpp = max(1, _CHANNELS[ctype] * depth // 8)
    data = b""
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            data += _filtered(_pack_rows(sub.reshape(sub.shape[0], -1),
                                         depth), bpp, rng, only)
    z = zlib.compress(data, 9)
    cuts = np.linspace(0, len(z), n_idat + 1).astype(int)
    out = (b"\x89PNG\r\n\x1a\n"
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                         0, int(interlace)))
           + _chunk(b"gAMA", struct.pack(">I", 45455)))
    if palette is not None:
        out += _chunk(b"PLTE", palette)
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    for a, b in zip(cuts[:-1], cuts[1:]):
        out += _chunk(b"IDAT", z[a:b])
    with open(path, "wb") as f:
        f.write(out + _chunk(b"IEND", b""))


def field(h: int, w: int, seed: int, texture: float = 8.0) -> np.ndarray:
    """(h, w, 3) uint8: a seeded smooth colour field plus texture."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    ph = rng.uniform(0, 2 * np.pi, (3, 2))
    img = np.stack([128 + 90 * np.sin(x / (37 + 9 * c) + ph[c, 0])
                    * np.cos(y / (29 + 7 * c) + ph[c, 1]) for c in range(3)],
                   -1)
    img += rng.normal(0, texture, img.shape)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def _small_pngs(out):
    """Every colour type at every bit depth PIL opens, some interlaced."""
    from PIL import Image
    rng = np.random.default_rng(7)
    h, w = 23, 37
    pix = field(h, w, 1)
    for depth in (1, 2, 4, 8, 16):
        for inter in (False, True):
            s = rng.integers(0, 1 << depth, (h, w, 1))
            if depth == 16:
                s[0, :8, 0] = (0, 1, 255, 256, 300, 4095, 65535, 255)
            write_png(f"{out}/grey{depth}{'_adam7' if inter else ''}.png",
                      s, depth, 0, inter, seed=depth)
    for depth in (8, 16):
        write_png(f"{out}/rgb{depth}_adam7.png",
                  rng.integers(0, 1 << depth, (h, w, 3)), depth, 2, True,
                  n_idat=3, seed=20 + depth)
        write_png(f"{out}/rgb{depth}.png",
                  rng.integers(0, 1 << depth, (h, w, 3)), depth, 2,
                  n_idat=2, seed=30 + depth)
        write_png(f"{out}/la{depth}{'_adam7' if depth == 16 else ''}.png",
                  rng.integers(0, 1 << depth, (h, w, 2)), depth, 4,
                  depth == 16, seed=40 + depth)
        write_png(f"{out}/rgba{depth}{'_adam7' if depth == 8 else ''}.png",
                  rng.integers(0, 1 << depth, (h, w, 4)), depth, 6,
                  depth == 8, seed=50 + depth)
    for depth in (1, 2, 4, 8):
        n = (1 << depth) - 1 if depth < 8 else 200
        write_png(f"{out}/palette{depth}{'_adam7' if depth == 4 else ''}.png",
                  rng.integers(0, 1 << depth, (h, w, 1)), depth, 3,
                  depth == 4, palette=rng.integers(0, 256, 3 * n).astype(
                      np.uint8).tobytes(),
                  trns=bytes(range(0, 250, 50)), seed=60 + depth)
    Image.fromarray(pix).save(f"{out}/pil_rgb.png")
    Image.fromarray(pix).quantize(16).save(f"{out}/pil_p.png")
    Image.fromarray(pix[..., 0]).convert("1").save(f"{out}/pil_1.png")
    Image.fromarray(np.dstack([pix[..., :1], pix[..., 2:]])).save(
        f"{out}/pil_la.png")
    Image.fromarray(np.dstack([pix, pix[..., :1]])).save(
        f"{out}/pil_rgba.png")
    frames = [Image.fromarray(field(h, w, s)) for s in (2, 3)]
    frames[0].save(f"{out}/apng.png", save_all=True,
                   append_images=frames[1:], duration=100)


def _small_jpegs(out):
    """4:4:4, 4:2:2, 4:2:0 and grey at three qualities and odd sizes,
    Huffman tables optimized, restart intervals."""
    from PIL import Image
    h, w = 23, 37
    pix = Image.fromarray(field(h, w, 4))
    for sub, name in ((0, "444"), (1, "422"), (2, "420")):
        for q in (10, 75, 95):
            pix.save(f"{out}/j{name}_q{q}.jpg", quality=q, subsampling=sub)
    pix.convert("L").save(f"{out}/jgrey_q75.jpg", quality=75)
    pix.save(f"{out}/j420_optimize.jpg", quality=80, optimize=True)
    pix.save(f"{out}/j420_restart.jpg", quality=80, restart_marker_blocks=2)
    pix.save(f"{out}/j422_restart_rows.jpg", quality=80, subsampling=1,
             restart_marker_rows=1)
    for hw in ((1, 1), (2, 2), (17, 9), (64, 48)):
        Image.fromarray(field(*hw, 5)).save(
            f"{out}/j420_{hw[0]}x{hw[1]}.jpg", quality=85, subsampling=2)


def _photos(out):
    """500 x 375 (ImageNet's typical shape): 4 JPEGs and 2 PNGs."""
    from PIL import Image
    h, w = 375, 500
    for sub, name in ((2, "420"), (0, "444")):
        for q in (75, 90):
            Image.fromarray(field(h, w, 10 + q + sub)).save(
                f"{out}/photo_{name}_q{q}.jpg", quality=q, subsampling=sub)
    Image.fromarray(field(h, w, 11, texture=1.0)).save(
        f"{out}/photo_rgb.png")
    rgba = np.dstack([field(h, w, 12, texture=1.0),
                      np.full((h, w, 1), 200, np.uint8)])
    write_png(f"{out}/photo_rgba_adam7.png", rgba, 8, 6, True, only=4)


def _digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def expected(out) -> dict:
    """Each file's shape and the digests of PIL's RGB bytes and of the
    reference's read_images(size=(224, 224)) float32 bytes."""
    from PIL import Image
    table = {}
    for name in sorted(os.listdir(out)):
        if name == "expected.json":
            continue
        with Image.open(os.path.join(out, name)) as im:
            rgb = im.convert("RGB")
            a = np.asarray(rgb)
            r = np.asarray(rgb.resize((RESIZE[1], RESIZE[0])), np.float32)
        table[name] = dict(shape=list(a.shape), rgb_sha256=_digest(a),
                           resized_sha256=_digest(r))
    return table


def main():
    os.makedirs(OUT, exist_ok=True)
    for name in os.listdir(OUT):
        os.remove(os.path.join(OUT, name))
    _small_pngs(OUT)
    _small_jpegs(OUT)
    _photos(OUT)
    with open(os.path.join(OUT, "expected.json"), "w") as f:
        json.dump(dict(resize=list(RESIZE), files=expected(OUT)), f,
                  indent=1, sort_keys=True)


if __name__ == "__main__":
    main()
