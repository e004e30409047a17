"""The port's image decoders (`read_image_dir`, `read_images`) against the
JAX package's, which decode with PIL.

Both read the same files, written into `tmp_path` from seeded numpy
content by PIL or, where PIL cannot write them (16-bit RGB, RGBA and LA,
2- and 4-bit grey, Adam7, palettes below 8 bits, several IDATs), by the
small PNG writer of tests/data/make_image_fixtures.py. Paths and pixels
must be equal bit for bit: every covered stage is integer arithmetic.
The port runs on the CPU (`device="cpu"`), so each kernel's plain version
runs; each plain version is also held against a scalar oracle written
from libjpeg's and Pillow's C (`jidctint.c`, `jdsample.c`, `jdcolor.c`,
`Resample.c`) and the PNG specification's filters.
"""
import os
import struct
import sys
import zlib

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

from mmlspark_tpu.image import ops as ref_ops
from mmlspark_tpu.io import sources as ref_sources
from mmlspark_tpu_torch.image import decode, formats
from mmlspark_tpu_torch.image import ops as port_ops
from mmlspark_tpu_torch.image import resample
from mmlspark_tpu_torch.io import sources as port_sources
from mmlspark_tpu_torch.ops import image_decode as kern
from mmlspark_tpu_torch.telemetry import names as tnames
from mmlspark_tpu_torch.telemetry import profiler

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "data"))
from make_image_fixtures import field, write_png  # noqa: E402

sys.path.pop(0)

_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
PNG_CASES = [(c, d) for c, ds in _DEPTHS.items() for d in ds]


def _same_dir(path, pattern=""):
    a = ref_ops.read_image_dir(str(path), pattern)
    b = port_ops.read_image_dir(str(path), pattern, device="cpu")
    assert list(a["path"]) == list(b["path"])
    assert a["image"].dtype == b["image"].dtype
    if a["image"].dtype == object:
        assert len(a["image"]) == len(b["image"])
        for x, y in zip(a["image"], b["image"]):
            assert x.dtype == y.dtype == np.uint8
            np.testing.assert_array_equal(x, y)
    else:
        np.testing.assert_array_equal(a["image"], b["image"])
    return b


def _same_images(pattern, size=None):
    a = ref_sources.read_images(pattern, size=size)
    b = port_sources.read_images(pattern, size=size, device="cpu")
    assert list(a["path"]) == list(b["path"])
    if size is not None:
        assert b["image"].dtype == np.float32
        np.testing.assert_array_equal(a["image"], b["image"])
    else:
        for x, y in zip(a["image"], b["image"]):
            assert x.dtype == y.dtype == np.float32
            np.testing.assert_array_equal(x, y)
    return b


def _png(path, ctype, depth, interlace, h=13, w=17, seed=0, n_idat=1):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 1 << depth, (h, w, _CHANNELS[ctype]))
    pal = trns = None
    if ctype == 0 and depth == 16:
        s[0, :5, 0] = np.array([0, 255, 256, 300, 65535])[:w]  # clips
    if ctype == 3:
        n = max(1, (1 << depth) - 2)                # indices past PLTE
        pal = rng.integers(0, 256, 3 * n).astype(np.uint8).tobytes()
        trns = bytes(range(0, 200, 40))
    write_png(str(path), s, depth, ctype, interlace, pal, trns, n_idat, seed)


# ------------------------------------------------------------------- PNG
@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("ctype, depth", PNG_CASES)
def test_png_every_colour_type_and_depth(tmp_path, ctype, depth, interlace):
    _png(tmp_path / "a.png", ctype, depth, interlace, seed=ctype * 17 + depth,
         n_idat=1 + depth % 3)
    _same_dir(tmp_path)
    _same_images(str(tmp_path / "*.png"))


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P", "1"])
def test_png_written_by_pil(tmp_path, mode):
    img = Image.fromarray(field(19, 31, 3))
    img = img.quantize(12) if mode == "P" else img.convert(mode)
    img.save(tmp_path / "a.png")
    _same_dir(tmp_path)


def test_apng_decodes_its_default_image(tmp_path):
    frames = [Image.fromarray(field(9, 14, s)) for s in (1, 2, 3)]
    frames[0].save(tmp_path / "a.png", save_all=True,
                   append_images=frames[1:])
    _same_dir(tmp_path)


@settings(max_examples=25, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(h=st.integers(1, 19), w=st.integers(1, 19),
       case=st.sampled_from(PNG_CASES), interlace=st.booleans(),
       seed=st.integers(0, 2 ** 16))
def test_png_hypothesis(tmp_path_factory, h, w, case, interlace, seed):
    d = tmp_path_factory.mktemp("png")
    _png(d / "a.png", *case, interlace, h, w, seed)
    _same_dir(d)


# ------------------------------------------------------------------ JPEG
@pytest.mark.parametrize("quality", [10, 75, 95])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_jpeg_sampling_and_quality(tmp_path, subsampling, quality):
    Image.fromarray(field(23, 37, quality)).save(
        tmp_path / "a.jpg", quality=quality, subsampling=subsampling)
    _same_dir(tmp_path)
    _same_images(str(tmp_path / "*.jpg"))


@pytest.mark.parametrize("kw", [
    dict(quality=75), dict(quality=80, optimize=True),
    dict(quality=80, restart_marker_blocks=1),
    dict(quality=90, subsampling=1, restart_marker_rows=1)],
    ids=["grey", "optimize", "restart_blocks", "restart_rows"])
def test_jpeg_tables_and_restarts(tmp_path, kw):
    img = Image.fromarray(field(29, 41, 5))
    (img.convert("L") if len(kw) == 1 else img).save(tmp_path / "a.jpg",
                                                       **kw)
    _same_dir(tmp_path)


@pytest.mark.parametrize("hw", [(1, 1), (2, 2), (2, 3), (9, 17), (16, 48),
                                (33, 65)])
def test_jpeg_odd_sizes_at_420(tmp_path, hw):
    Image.fromarray(field(*hw, sum(hw))).save(tmp_path / "a.jpg",
                                              quality=85, subsampling=2)
    _same_dir(tmp_path)


def test_jpeg_adobe_rgb_and_component_ids(tmp_path):
    """A 3-component JPEG stored as RGB (Adobe transform 0) is copied,
    not converted, as libjpeg decides from APP14."""
    Image.fromarray(field(16, 24, 9)).save(tmp_path / "a.jpg", quality=90,
                                           keep_rgb=True)
    _same_dir(tmp_path)


# ---------------------------------------------------------------- resize
@pytest.mark.parametrize("size", [(224, 224), (8, 5), (1, 1), (60, 90),
                                  (23, 37)],
                         ids=["shrink-enlarge", "shrink", "1x1", "enlarge",
                              "same"])
def test_read_images_resized(tmp_path, size):
    for i, (h, w) in enumerate([(23, 37), (1, 1), (40, 12)]):
        Image.fromarray(field(h, w, i)).save(tmp_path / f"a{i}.png")
        Image.fromarray(field(h, w, i + 5)).save(tmp_path / f"b{i}.jpg",
                                                 quality=80)
    t = _same_images(str(tmp_path / "*"), size=size)
    assert t["image"].shape == (6,) + size + (3,)


# ---------------------------------------------------------- folder rules
def test_folder_rules(tmp_path):
    Image.fromarray(field(10, 12, 0)).save(tmp_path / "a.png")
    Image.fromarray(field(10, 12, 1)).save(tmp_path / "b.jpg")
    Image.fromarray(field(7, 5, 2)).save(tmp_path / "c.png")
    (tmp_path / "d.txt").write_text("a text file, no image")
    whole = (tmp_path / "a.png").read_bytes()
    (tmp_path / "e.png").write_bytes(whole[:len(whole) // 2])  # truncated
    (tmp_path / "sub").mkdir()
    Image.fromarray(field(4, 4, 3)).save(tmp_path / "sub" / "f.png")
    t = _same_dir(tmp_path)
    assert [os.path.basename(p) for p in t["path"]] == ["a.png", "b.jpg",
                                                        "c.png"]
    assert t["image"].dtype == object            # mixed shapes
    _same_dir(tmp_path, pattern="png")
    for name in ("d.txt", "e.png"):
        with pytest.raises(OSError):
            ref_sources.read_images(str(tmp_path / name))
        with pytest.raises(OSError):
            port_sources.read_images(str(tmp_path / name), device="cpu")


def test_read_images_globs_recursively(tmp_path):
    (tmp_path / "x" / "y").mkdir(parents=True)
    for i, d in enumerate(("", "x", "x/y")):
        Image.fromarray(field(6, 5 + i, i)).save(tmp_path / d / f"{i}.png")
    t = _same_images(str(tmp_path / "**" / "*.png"))
    assert len(t["path"]) == 3 and t["image"].dtype == object


def test_same_shapes_stack(tmp_path):
    for i in range(3):
        Image.fromarray(field(6, 9, i)).save(tmp_path / f"{i}.png")
    assert _same_dir(tmp_path)["image"].shape == (3, 6, 9, 3)


@pytest.mark.parametrize("fmt, name", [
    ("GIF", "GIF"), ("BMP", "BMP"), ("WEBP", "WebP"), ("TIFF", "TIFF"),
    ("PPM", "PPM"), ("ICO", "ICO")])
def test_uncovered_formats_raise_naming_themselves(tmp_path, fmt, name):
    Image.fromarray(field(16, 16, 1)).save(tmp_path / "a.img", format=fmt)
    assert len(ref_ops.read_image_dir(str(tmp_path))["path"]) == 1
    with pytest.raises(NotImplementedError, match=name):
        port_ops.read_image_dir(str(tmp_path), device="cpu")
    with pytest.raises(NotImplementedError, match="item 29"):
        port_sources.read_images(str(tmp_path / "*"), device="cpu")


@pytest.mark.parametrize("kw, name", [
    (dict(progressive=True), "progressive"),
    (dict(mode="CMYK"), "CMYK")])
def test_uncovered_jpeg_variants_raise(tmp_path, kw, name):
    img = Image.fromarray(field(16, 16, 2))
    if kw.pop("mode", None):
        img = img.convert("CMYK")
    img.save(tmp_path / "a.jpg", quality=80, **kw)
    assert len(ref_ops.read_image_dir(str(tmp_path))["path"]) == 1
    with pytest.raises(NotImplementedError, match=name):
        port_ops.read_image_dir(str(tmp_path), device="cpu")


def test_png_chunk_crc_and_filter_errors_skip(tmp_path):
    """A bad CRC before the image data and an unknown filter type: PIL
    cannot load either, so both packages skip them."""
    _png(tmp_path / "good.png", 2, 8, False)
    data = bytearray((tmp_path / "good.png").read_bytes())
    bad_crc = bytearray(data)
    bad_crc[29] ^= 0xFF                    # IHDR's CRC
    (tmp_path / "crc.png").write_bytes(bytes(bad_crc))
    ihdr = data[:33]
    raw = b"".join(b"\x07" + bytes(17 * 3) for _ in range(13))
    body = zlib.compress(raw)
    chunk = (struct.pack(">I", len(body)) + b"IDAT" + body
             + struct.pack(">I", zlib.crc32(body, zlib.crc32(b"IDAT"))))
    (tmp_path / "filter.png").write_bytes(bytes(ihdr) + chunk)
    t = _same_dir(tmp_path)
    assert [os.path.basename(p) for p in t["path"]] == ["good.png"]


def test_sniff_signatures():
    assert formats.sniff(b"\x89PNG\r\n\x1a\n....") == "PNG"
    assert formats.sniff(b"\xff\xd8\xff\xe0") == "JPEG"
    assert formats.sniff(b"GIF87a") == "GIF"
    assert formats.sniff(b"RIFF\0\0\0\0WEBP") == "WebP"
    assert formats.sniff(b"P6\n4 4\n255\n") == "PPM"
    for text in (b"P1 is a paper", b"Python", b"hello", b""):
        assert formats.sniff(text) is None


def test_decode_regions_are_registered(tmp_path):
    """The host and card halves of a decode are profile regions."""
    assert profiler._region_of(tnames.IMAGE_DECODE_HOST) == \
        "image.decode.host"
    assert profiler._region_of(tnames.IMAGE_DECODE_CARD) == \
        "image.decode.card"
    assert profiler.REGIONS + profiler.PORT_REGIONS == profiler.REGIONS + (
        "image.decode.host", "image.decode.card")


# ----------------------------------------- plain kernels against oracles
_FIX = (2446, 3196, 4433, 6270, 7373, 9633, 12299, 15137, 16069, 16819,
        20995, 25172)


def _c_shift(v, n):
    """C's DESCALE: add half, shift right arithmetically."""
    return (v + (1 << (n - 1))) >> n


def _c_idct_1d(x, n):
    (f0298, f0390, f0541, f0765, f0899, f1175, f1501, f1847, f1961, f2053,
     f2562, f3072) = _FIX
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * f0541
    tmp2 = z1 + z3 * (-f1847)
    tmp3 = z1 + z2 * f0765
    tmp0 = (x[0] + x[4]) * 8192
    tmp1 = (x[0] - x[4]) * 8192
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, \
        tmp1 - tmp2
    tmp0, tmp1, tmp2, tmp3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = tmp0 + tmp3, tmp1 + tmp2, tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * f1175
    tmp0, tmp1, tmp2, tmp3 = tmp0 * f0298, tmp1 * f2053, tmp2 * f3072, \
        tmp3 * f1501
    z1, z2, z3, z4 = z1 * -f0899, z2 * -f2562, z3 * -f1961, z4 * -f0390
    z3 += z5
    z4 += z5
    tmp0 += z1 + z3
    tmp1 += z2 + z4
    tmp2 += z2 + z3
    tmp3 += z1 + z4
    out = [tmp10 + tmp3, tmp11 + tmp2, tmp12 + tmp1, tmp13 + tmp0,
           tmp13 - tmp0, tmp12 - tmp1, tmp11 - tmp2, tmp10 - tmp3]
    return [_c_shift(v, n) for v in out]


def _c_range_limit(v):
    """libjpeg's prepare_range_limit_table, indexed at v & 0x3FF from
    sample_range_limit + CENTERJSAMPLE."""
    i = v & 1023
    if i < 128:
        return i + 128
    if i < 512:
        return 255
    if i < 896:
        return 0
    return i - 896


def _c_idct_block(coef, q):
    ws = [[0] * 8 for _ in range(8)]
    for col in range(8):
        out = _c_idct_1d([int(coef[k * 8 + col]) * int(q[k * 8 + col])
                          for k in range(8)], 11)
        for k in range(8):
            ws[k][col] = out[k]
    return [[_c_range_limit(v) for v in _c_idct_1d(ws[r], 18)]
            for r in range(8)]


def test_idct_plain_equals_jidctint():
    rng = np.random.default_rng(0)
    n = 12
    coefs = rng.integers(-60, 60, (n, 64)).astype(np.int16)
    coefs[:, 0] = rng.integers(-1024, 1024, n)
    coefs[3] = 0
    coefs[4, 1:] = 0
    coefs[5] = rng.integers(-2000, 2000, 64)   # sums past the range: wrap
    quant = rng.integers(1, 100, (2, 64)).astype(np.int32)
    block_plane = np.repeat([0, 1], [4, 8]).astype(np.int64)
    planes = np.array([(0, 2, 0), (4 * 64, 4, 4)], np.int64)
    got = kern.jpeg_idct(torch.from_numpy(coefs), torch.from_numpy(quant),
                         torch.from_numpy(block_plane),
                         torch.from_numpy(planes), 12 * 64).numpy()
    for b in range(n):
        p = block_plane[b]
        off, wb, b0 = planes[p]
        j = b - b0
        by, bx = j // wb, j % wb
        want = np.array(_c_idct_block(coefs[b], quant[p]), np.uint8)
        rows = off + (by * 8 + np.arange(8))[:, None] * wb * 8 + bx * 8 \
            + np.arange(8)[None, :]
        np.testing.assert_array_equal(got[rows], want)


def _c_upsample(plane, dw, dh, hf, vf, h, w):
    """jdsample.c's fullsize/h2v1/h2v2 fancy upsamplers (libjpeg-turbo,
    whose SIMD versions stand the last sample in past the width), with
    jdmainct.c's context rows: the first row above the top, the last real
    row below the bottom."""
    rows = [[int(v) for v in plane[r]] for r in range(plane.shape[0])]
    out = np.zeros((h, w), np.int64)
    for y in range(h):
        for x in range(w):
            if hf == 1:
                out[y, x] = rows[y][x]
                continue
            i = x // 2
            if vf == 1:
                cur = rows[y][i]
                if x % 2 == 0:
                    out[y, x] = cur if i == 0 else (
                        3 * cur + rows[y][i - 1] + 1) >> 2
                else:
                    out[y, x] = cur if i == dw - 1 else (
                        3 * cur + rows[y][i + 1] + 2) >> 2
                continue
            r = y // 2
            r2 = min(r + 1, dh - 1) if y % 2 else max(r - 1, 0)

            def cs(k):
                return 3 * rows[r][k] + rows[r2][k]
            if x % 2 == 0:
                out[y, x] = (4 * cs(i) + 8) >> 4 if i == 0 else (
                    3 * cs(i) + cs(i - 1) + 8) >> 4
            else:
                out[y, x] = (4 * cs(i) + 7) >> 4 if i == dw - 1 else (
                    3 * cs(i) + cs(i + 1) + 7) >> 4
    return out


def _c_ycc_rgb(y, cb, cr):
    """jdcolor.c's ycc_rgb_convert through its tables."""
    def fix(v):
        return int(v * 65536 + 0.5)
    x_cb, x_cr = cb - 128, cr - 128
    r = y + ((fix(1.40200) * x_cr + 32768) >> 16)
    g = y + ((-fix(0.34414) * x_cb + 32768 - fix(0.71414) * x_cr) >> 16)
    b = y + ((fix(1.77200) * x_cb + 32768) >> 16)
    return [np.clip(c, 0, 255) for c in (r, g, b)]


@pytest.mark.parametrize("hf, vf, h, w", [(1, 1, 5, 7), (2, 1, 5, 7),
                                          (2, 2, 7, 9), (2, 2, 2, 2),
                                          (2, 2, 6, 1)])
def test_color_plain_equals_jdsample_jdcolor(hf, vf, h, w):
    rng = np.random.default_rng(hf * 10 + vf + h)
    dw, dh = -(-w // hf), -(-h // vf)
    stride, rows = 8 * -(-dw // 8), 8 * -(-dh // 8)
    y = rng.integers(0, 256, (8 * -(-h // 8), 8 * -(-w // 8)))
    cb, cr = rng.integers(0, 256, (2, rows, stride))
    planes = np.concatenate([y.ravel(), cb.ravel(), cr.ravel()]).astype(
        np.uint8)
    info = [0, h, w, 1, 0, y.shape[1], w, h, 1, 1,
            y.size, stride, dw, dh, hf, vf,
            y.size + cb.size, stride, dw, dh, hf, vf]
    got = kern.jpeg_color(torch.from_numpy(planes),
                          torch.tensor([info], dtype=torch.int64),
                          h * w * 3).numpy().reshape(h, w, 3)
    want = _c_ycc_rgb(y[:h, :w], _c_upsample(cb, dw, dh, hf, vf, h, w),
                      _c_upsample(cr, dw, dh, hf, vf, h, w))
    np.testing.assert_array_equal(got, np.stack(want, -1))


def _spec_unfilter(rows, bpp):
    """The PNG specification's reconstruction, byte by byte."""
    out, prev = [], [0] * (len(rows[0]) - 1)
    for row in rows:
        f, cur = row[0], []
        for i, x in enumerate(row[1:]):
            a = cur[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            paeth = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            cur.append((x + (0, a, b, (a + b) // 2, paeth)[f]) & 255)
        out += cur
        prev = cur
    return out


def test_unfilter_plain_equals_spec():
    rng = np.random.default_rng(4)
    shapes = [(5, 12, 3), (1, 4, 4), (7, 16, 8), (6, 9, 1), (3, 2, 2)]
    data, info, want, in_off, out_off = [], [], [], 0, 0
    for h, rb, bpp in shapes:
        rows = [[int(rng.integers(0, 5))] + rng.integers(0, 256, rb).tolist()
                for _ in range(h)]
        data += [v for r in rows for v in r]
        info.append((in_off, out_off, h, rb, bpp))
        want += _spec_unfilter(rows, bpp)
        in_off += h * (rb + 1)
        out_off += h * rb
    got = kern.png_unfilter(torch.tensor(data, dtype=torch.uint8),
                            torch.tensor(info, dtype=torch.int64), out_off)
    np.testing.assert_array_equal(got.numpy(), np.array(want, np.uint8))


def _pillow_pass(src, bounds, kk, vertical, row0, out_rows):
    """Resample.c's ImagingResample{Horizontal,Vertical}_8bpc: ss starts at
    1 << (PRECISION_BITS - 1), clip8 shifts and clamps."""
    h, w, _ = src.shape
    n = len(bounds)
    out = np.zeros((n, w, 3) if vertical else (out_rows, n, 3), np.uint8)
    for j, (xmin, xmax) in enumerate(bounds):
        for o in range(w if vertical else out_rows):
            for ch in range(3):
                ss = 1 << 21
                for t in range(xmax):
                    v = src[xmin + t, o, ch] if vertical else \
                        src[row0 + o, xmin + t, ch]
                    ss += int(v) * int(kk[j, t])
                v = 255 if ss >= 1 << 30 else (0 if ss <= 0 else ss >> 22)
                if vertical:
                    out[j, o, ch] = v
                else:
                    out[o, j, ch] = v
    return out


@pytest.mark.parametrize("in_hw, out_hw", [((9, 13), (4, 20)),
                                           ((5, 3), (1, 1))])
def test_resample_plain_equals_pillow_passes(in_hw, out_hw):
    rng = np.random.default_rng(in_hw[0])
    src = rng.integers(0, 256, in_hw + (3,)).astype(np.uint8)
    passes = resample.plan(*in_hw, *out_hw)
    img = torch.from_numpy(src)
    want = src
    for axis in ("h", "v"):
        a = decode.resample_inputs([img], [passes], axis, "cpu")
        flat = kern.resample(a["images"], a["info"], a["bounds"], a["coefs"],
                             a["vertical"], a["total"])
        _, h, w = a["outs"][0]
        img = flat.view(h, w, 3)
        q = passes[axis]
        want = _pillow_pass(want, q["bounds"], q["coefs"], axis == "v",
                            q.get("row0", 0), q.get("rows", 0))
        np.testing.assert_array_equal(img.numpy(), want)
    pil = Image.fromarray(src).resize(out_hw[::-1])
    np.testing.assert_array_equal(img.numpy(), np.asarray(pil))


def test_wrappers_count_no_launch_on_the_cpu(tmp_path):
    Image.fromarray(field(10, 12, 0)).save(tmp_path / "a.jpg")
    Image.fromarray(field(10, 12, 1)).save(tmp_path / "b.png")
    kern.reset_launches()
    port_sources.read_images(str(tmp_path / "*"), size=(4, 4), device="cpu")
    assert set(kern.launches.values()) == {0}
