"""Decode a batch of image files into RGB, for `read_image_dir` and
`read_images`.

The host half (region `image.decode.host`) reads each file, sorts it by
its signature (`formats.sniff`) and parses it: a PNG's chunks inflated
(`png.parse`), a JPEG's scans Huffman-decoded (`jpeg.parse`). The card
half (region `image.decode.card`) takes the whole batch through each
kernel once: every JPEG block through D1 and every JPEG through D2, every
PNG pass through D3 (then `png.expand`), and with `size` every image that
is not already that size through D4's horizontal pass and then its
vertical pass, as Pillow's `resize` runs them. The images come back to
the host as uint8 numpy arrays in the files' order.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import image_decode as kern
from ..telemetry import names as tnames
from ..utils.tracing import annotate
from . import jpeg, png, resample
from .formats import HEAD_BYTES, UnidentifiedImageError, sniff, uncovered


def parse_file(path: str):
    """A `png.PngImage` or `jpeg.JpegImage` of the file; raises
    `NotImplementedError` for a format PIL knows that the port does not
    decode yet and an `OSError` for anything else it cannot decode."""
    with open(path, "rb") as f:
        data = f.read()
    kind = sniff(data[:HEAD_BYTES])
    if kind == "PNG":
        return png.parse(data)
    if kind == "JPEG":
        return jpeg.parse(data)
    if kind is None:
        raise UnidentifiedImageError(f"cannot identify image file {path!r}")
    raise uncovered(kind)


def _to(dev, a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def jpeg_inputs(images: list, dev) -> dict:
    """D1's and D2's inputs for a batch of `jpeg.JpegImage`s, on `dev`:
    the coefficients end to end, each plane's quantization table and
    place, and each image's row of D2's table."""
    planes, quant, block_plane, color, coefs = [], [], [], [], []
    plane_off = block_base = out_off = 0
    for img in images:
        hmax = max(c.h for c in img.components)
        vmax = max(c.v for c in img.components)
        row = [out_off, img.height, img.width, img.color]
        for c in img.components:
            block_plane.append(np.full(c.wb * c.hb, len(planes), np.int64))
            planes.append((plane_off, c.wb, block_base + c.block0))
            quant.append(c.quant.astype(np.int32))
            row += [plane_off, c.wb * 8, c.dw, c.dh, hmax // c.h, vmax // c.v]
            plane_off += c.wb * 8 * c.hb * 8
        color.append(row + [0] * (kern.COLOR_COLS - len(row)))
        coefs.append(img.coefs)
        block_base += img.n_blocks
        out_off += img.height * img.width * 3
    return dict(coefs=_to(dev, np.concatenate(coefs)),
                quant=_to(dev, np.stack(quant)),
                block_plane=_to(dev, np.concatenate(block_plane)),
                planes=_to(dev, np.asarray(planes, np.int64)),
                plane_bytes=plane_off,
                color=_to(dev, np.asarray(color, np.int64)),
                rgb_bytes=out_off, rows=color)


def _jpegs(images: list, dev) -> list:
    """D1 then D2 over every JPEG: one (H, W, 3) uint8 view each."""
    a = jpeg_inputs(images, dev)
    planes = kern.jpeg_idct(a["coefs"], a["quant"], a["block_plane"],
                            a["planes"], a["plane_bytes"])
    rgb = kern.jpeg_color(planes, a["color"], a["rgb_bytes"])
    return [rgb[r[0]:r[0] + r[1] * r[2] * 3].view(r[1], r[2], 3)
            for r in a["rows"]]


def png_inputs(images: list, dev) -> dict:
    """D3's inputs for a batch of `png.PngImage`s, on `dev`: the inflated
    scanlines end to end and one row per pass, with each image's span of
    D3's output."""
    passes, spans, in_off, out_off = [], [], 0, 0
    for img in images:
        start = out_off
        for *_, h, rb, off in img.passes:
            if rb:
                passes.append((in_off + off, out_off, h, rb, img.bpp))
                out_off += h * rb
        spans.append((start, out_off))
        in_off += len(img.data)
    data = torch.frombuffer(bytearray(b"".join(i.data for i in images)),
                            dtype=torch.uint8)
    return dict(data=data.to(dev), passes=_to(dev, np.asarray(
        passes, np.int64).reshape(-1, len(kern.PNG_PASS))),
        raw_bytes=out_off, spans=spans)


def _pngs(images: list, dev) -> list:
    """D3 over every pass of every PNG, then each one's expansion."""
    a = png_inputs(images, dev)
    raw = kern.png_unfilter(a["data"], a["passes"], a["raw_bytes"])
    return [png.expand(img, raw[s:e])
            for img, (s, e) in zip(images, a["spans"])]


def resample_inputs(srcs: list, plans: list, axis: str, dev) -> dict:
    """D4's inputs for one pass (`axis` "h" or "v") over the (H, W, 3)
    uint8 images `srcs` with their `resample.plan`s, on `dev`."""
    rows, bounds, coefs, outs = [], [], [], []
    in_off = out_off = n_bounds = n_coefs = 0
    for img, p in zip(srcs, plans):
        q = p[axis]
        h, w = img.shape[:2]
        if axis == "h":
            out_h, out_w, row0 = q["rows"], len(q["bounds"]), q["row0"]
        else:
            out_h, out_w, row0 = len(q["bounds"]), w, 0
        rows.append((in_off, out_off, h, w, out_h, out_w, row0, n_bounds,
                     n_coefs, q["ksize"]))
        outs.append((out_off, out_h, out_w))
        bounds.append(q["bounds"])
        coefs.append(q["coefs"].reshape(-1))
        in_off += h * w * 3
        out_off += out_h * out_w * 3
        n_bounds += len(q["bounds"])
        n_coefs += q["coefs"].size
    return dict(images=torch.cat([s.reshape(-1) for s in srcs]).to(dev),
                info=_to(dev, np.asarray(rows, np.int64)),
                bounds=_to(dev, np.concatenate(bounds)),
                coefs=_to(dev, np.concatenate(coefs)), vertical=axis == "v",
                total=out_off, outs=outs)


def _resample_pass(srcs: list, plans: list, axis: str, dev) -> list:
    """One D4 launch over every image whose plan has the `axis` pass."""
    a = resample_inputs(srcs, plans, axis, dev)
    flat = kern.resample(a["images"], a["info"], a["bounds"], a["coefs"],
                         a["vertical"], a["total"])
    return [flat[o:o + h * w * 3].view(h, w, 3) for o, h, w in a["outs"]]


def _resize(images: list, size: tuple, dev) -> list:
    """Pillow's `resize((w, h))` of every image, BICUBIC, two passes."""
    out_h, out_w = size
    out = list(images)
    plans = {i: resample.plan(*im.shape[:2], out_h, out_w)
             for i, im in enumerate(images) if im.shape[:2] != (out_h, out_w)}
    for axis in ("h", "v"):
        todo = [i for i, p in plans.items() if axis in p]
        if todo:
            done = _resample_pass([out[i] for i in todo],
                                  [plans[i] for i in todo], axis, dev)
            for i, im in zip(todo, done):
                out[i] = im
    return out


def image_column(images: list, stack: bool) -> np.ndarray:
    """The readers' image column: one stacked array, or an object column
    of the images."""
    if stack and images:
        return np.stack(images)
    col = np.empty(len(images), dtype=object)
    for i, im in enumerate(images):
        col[i] = im
    return col


def decode_files(paths: list, device, size: tuple = None,
                 skip_invalid: bool = False) -> tuple:
    """(the paths decoded, their (H, W, 3) uint8 numpy images) of the
    files at `paths`, in order, on `device`'s kernels. With
    `skip_invalid`, a file that is not an image the reference could
    decode is left out (read_image_dir); without it, it raises. A format
    PIL decodes and the port does not raises `NotImplementedError`
    either way. `size=(H, W)` resizes as Pillow does."""
    kept, parsed = [], []
    with annotate(tnames.IMAGE_DECODE_HOST):
        for p in paths:
            try:
                parsed.append(parse_file(p))
            except OSError:
                if not skip_invalid:
                    raise
                continue
            kept.append(p)
    if not parsed:
        return kept, []
    with annotate(tnames.IMAGE_DECODE_CARD):
        images = [None] * len(parsed)
        for kind, fn in ((jpeg.JpegImage, _jpegs), (png.PngImage, _pngs)):
            idx = [i for i, im in enumerate(parsed) if isinstance(im, kind)]
            if idx:
                for i, im in zip(idx, fn([parsed[i] for i in idx], device)):
                    images[i] = im
        if size is not None:
            images = _resize(images, tuple(size), device)
        flat = torch.cat([im.reshape(-1) for im in images]).cpu().numpy()
    out, off = [], 0
    for im in images:
        n = im.numel()
        out.append(flat[off:off + n].reshape(im.shape))
        off += n
    return kept, out
