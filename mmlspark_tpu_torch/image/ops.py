"""Image stages: resize, unroll, augment and the OpenCV stage DSL, in torch.

Port of `mmlspark_tpu/image/ops.py`:
- `ResizeImageTransformer`: the reference's `jax.image.resize(...,
  method="bilinear")`, whose antialias is on: when it downsamples, the
  triangle kernel widens by the inverse scale. The weights are built on
  the host as jax's `compute_weight_mat` builds them, in float32, and
  applied on the stage's device as two banded products, each summed over
  its nonzero taps in one fixed order with a rounding after every multiply
  and add, so the card and the CPU give the same bits. The output is
  `clip(0, 255)` cast to uint8, which truncates, as the reference's
  `astype(np.uint8)` does.
- `UnrollImage`, `ImageSetAugmenter`: the reference's numpy arithmetic,
  op for op, on the stage's device.
- `ImageTransformer`: the reference runs cv2 per image; the chip machine
  has no cv2, so each op is written here in torch. Crop, flip, threshold
  and the colour conversions give cv2's bits (its uint8 gray conversion is
  fixed point, reproduced in integers); resize (cv2's INTER_LINEAR:
  half-pixel centres, edges clamped), blur and gaussian (borders
  BORDER_REFLECT_101) compute in float32 and round, and may differ from
  cv2's fixed-point results by one level.
- `read_image_dir` decodes without PIL, which the chip machine lacks:
  PNG and Huffman-coded sequential JPEG (`image/decode.py`), to PIL's
  pixels bit for bit. A file that is not an image is skipped, as the
  reference skips what PIL cannot open; a format PIL decodes and the port
  does not yet raises `NotImplementedError` naming it.

Stages take a numpy column (stacked (N, H, W[, C]) or an object column of
images) or a tensor column, and return numpy columns, as the reference
does.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..core import HasInputCol, HasOutputCol, Param, Table, Transformer
from ..device import resolve_device


def read_image_dir(path: str, pattern: str = "", decode=True,
                   device=None) -> Table:
    """Directory of images -> Table(path, image) with uint8 (N, H, W, 3)
    images when shapes agree, else an object column (reference:
    spark.read.image). The names are `os.listdir`'s, sorted, kept when
    they hold `pattern`; the directory is not recursed into. The files
    decode on `device` (None: the card); non-images are skipped like
    dropInvalid."""
    from .decode import decode_files, image_column
    dev = resolve_device(device)
    names = [n for n in sorted(os.listdir(path))
             if not pattern or pattern in n]
    paths, imgs = decode_files([os.path.join(path, n) for n in names], dev,
                               skip_invalid=True)
    arr = image_column(imgs, all(i.shape == imgs[0].shape for i in imgs))
    return Table({"path": np.asarray(paths, dtype=object), "image": arr})


def _to_batch(col):
    """Accept (N,H,W,C) stacked, an object column of (H,W,C) arrays, or a
    tensor column (returned as it is)."""
    if isinstance(col, torch.Tensor):
        return col
    if col.dtype == object:
        return np.stack([np.asarray(v) for v in col])
    return col


def _as_tensor(imgs, device) -> torch.Tensor:
    if isinstance(imgs, torch.Tensor):
        return imgs.to(device)
    return torch.from_numpy(np.ascontiguousarray(imgs)).to(device)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


# -- the antialiased bilinear resize ------------------------------------------

def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """The (in_size, out_size) float32 weights of jax's bilinear resize
    along one axis (`jax/_src/image/scale.py::compute_weight_mat` with the
    triangle kernel, antialias on, translation 0), in its order of float32
    operations."""
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = np.float32(max(inv_scale, 1.0))
    sample_f = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5))
                * np.float32(inv_scale) - np.float32(0.5))
    x = np.abs(sample_f[np.newaxis, :]
               - np.arange(in_size, dtype=np.float32)[:, np.newaxis]) \
        / kernel_scale
    weights = np.maximum(np.float32(0), np.float32(1) - np.abs(x))
    total = weights.sum(axis=0, keepdims=True, dtype=np.float32)
    weights = np.where(
        np.abs(total) > np.float32(1000.0 * np.finfo(np.float32).eps),
        weights / np.where(total != 0, total, np.float32(1)),
        np.float32(0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[np.newaxis, :], weights,
                    np.float32(0)).astype(np.float32)


def _taps(in_size: int, out_size: int):
    """`resize_weights` as taps: (T, out) input indices and weights, each
    output's nonzero weights in ascending input order, padded with weight
    0 at index 0."""
    w = resize_weights(in_size, out_size)
    nz = [np.flatnonzero(w[:, j]) for j in range(out_size)]
    n_taps = max(1, max(len(i) for i in nz))
    idx = np.zeros((n_taps, out_size), np.int64)
    wt = np.zeros((n_taps, out_size), np.float32)
    for j, rows in enumerate(nz):
        idx[:len(rows), j] = rows
        wt[:len(rows), j] = w[rows, j]
    return idx, wt


def _resample(x: torch.Tensor, dim: int, out_size: int) -> torch.Tensor:
    """One axis of the resize: sum_t w[t, j] * x[idx[t, j]] over the taps
    in order, a separate rounding after each multiply and each add."""
    idx, wt = _taps(x.shape[dim], out_size)
    shape = [1] * x.ndim
    shape[dim] = out_size
    acc = None
    for t in range(idx.shape[0]):
        term = (x.index_select(dim, torch.from_numpy(idx[t]).to(x.device))
                * torch.from_numpy(wt[t]).to(x.device).view(shape))
        acc = term if acc is None else acc + term
    return acc


def resize_float(imgs: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(N, H, W, C) images -> (N, height, width, C) float32, before the
    uint8 cast; an axis whose size is unchanged is left alone, as in jax."""
    x = imgs.float()
    if x.shape[1] != height:
        x = _resample(x, 1, height)
    if x.shape[2] != width:
        x = _resample(x, 2, width)
    return x


def resize_images(imgs: torch.Tensor, height: int,
                  width: int) -> torch.Tensor:
    """The reference's resize on `imgs`' device: uint8 (N, height, width,
    C), `clip(0, 255)` then a truncating cast."""
    return resize_float(imgs, height, width).clamp(0, 255).to(torch.uint8)


def prepare_images(imgs, height: int, width: int, scale: float,
                   device) -> torch.Tensor:
    """A batch of images -> (n, height, width, C) float32 on `device`:
    resized to uint8 when the shape differs, then times `scale` (the
    featurizer's and the transfer stages' input, reference
    `image_featurizer.py:146-156`, `transfer.py:197-208`)."""
    x = _as_tensor(imgs, device)
    if tuple(x.shape[1:3]) != (height, width):
        x = resize_images(x, height, width)
    return x.float() * scale


class ResizeImageTransformer(Transformer, HasInputCol, HasOutputCol):
    width = Param("width", "target width", 224)
    height = Param("height", "target height", 224)
    device = Param("device", "torch device to resize on (None = the card)",
                   None)

    def __init__(self, **kw):
        kw.setdefault("input_col", "image")
        kw.setdefault("output_col", "image")
        super().__init__(**kw)

    def _transform(self, t: Table) -> Table:
        x = _as_tensor(_to_batch(t[self.input_col]),
                       resolve_device(self.device))
        out = resize_images(x, self.height, self.width)
        return t.with_column(self.output_col, _host(out))


class UnrollImage(Transformer, HasInputCol, HasOutputCol):
    """(N,H,W,C) -> (N, C*H*W) CHW-order float vectors, RGB->BGR like the
    reference's CNTK convention, with optional scaling/normalization."""
    to_bgr = Param("to_bgr", "swap to BGR channel order", True)
    scale = Param("scale", "multiply pixel values (e.g. 1/255)", 1.0)
    mean = Param("mean", "per-channel mean to subtract (len C)", None)
    std = Param("std", "per-channel std to divide (len C)", None)
    device = Param("device", "torch device to unroll on (None = the card)",
                   None)

    def __init__(self, **kw):
        kw.setdefault("input_col", "image")
        kw.setdefault("output_col", "features")
        super().__init__(**kw)

    def _transform(self, t: Table) -> Table:
        dev = resolve_device(self.device)
        imgs = _as_tensor(_to_batch(t[self.input_col]), dev).float()
        if self.to_bgr:
            imgs = imgs.flip(-1)
        imgs = imgs * self.scale
        if self.mean is not None:
            imgs = imgs - torch.as_tensor(np.asarray(self.mean, np.float32),
                                          device=dev)
        if self.std is not None:
            imgs = imgs / torch.as_tensor(np.asarray(self.std, np.float32),
                                          device=dev)
        n, h, w, c = imgs.shape
        chw = imgs.permute(0, 3, 1, 2)  # CHW like UnrollImage.scala
        return t.with_column(self.output_col,
                             _host(chw.reshape(n, c * h * w)))


def _flip(imgs, axis: int):
    if isinstance(imgs, torch.Tensor):
        return imgs.flip(axis)
    return np.flip(imgs, axis)


class ImageSetAugmenter(Transformer, HasInputCol, HasOutputCol):
    flip_left_right = Param("flip_left_right", "add LR-flipped copies", True)
    flip_up_down = Param("flip_up_down", "add UD-flipped copies", False)

    def __init__(self, **kw):
        kw.setdefault("input_col", "image")
        kw.setdefault("output_col", "image")
        super().__init__(**kw)

    def _transform(self, t: Table) -> Table:
        imgs = _to_batch(t[self.input_col])
        tables = [t.with_column(self.output_col, imgs)]
        other = {n: t[n] for n in t.columns if n != self.output_col}
        if self.flip_left_right:
            tables.append(Table({**other, self.output_col: _flip(imgs, 2)},
                                t.npartitions))
        if self.flip_up_down:
            tables.append(Table({**other, self.output_col: _flip(imgs, 1)},
                                t.npartitions))
        aligned = [tb.select(tables[0].columns) for tb in tables]
        return Table.concat_all(aligned)


# -- the OpenCV stage DSL -----------------------------------------------------

# cv2's fixed-point RGB -> gray weights for uint8: 0.299, 0.587 and 0.114
# at 15 fractional bits, rounded half up (equal to cv2 on all 2^24 colours)
_GRAY_SHIFT = 15
_GRAY_RGB = (9798, 19235, 3735)
_THRESH_TYPES = (0, 1, 2, 3, 4)
# cv2.getGaussianKernel's table for sigma <= 0 (imgproc/src/smooth.dispatch.cpp)
_SMALL_GAUSSIAN = {1: [1.0], 3: [0.25, 0.5, 0.25],
                   5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
                   7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875,
                       0.109375, 0.03125]}


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W) or (N, H, W, C) -> (N, C, H, W)."""
    return x.unsqueeze(1) if x.ndim == 3 else x.permute(0, 3, 1, 2)


def _from_nchw(y: torch.Tensor, ndim: int) -> torch.Tensor:
    return y[:, 0] if ndim == 3 else y.permute(0, 2, 3, 1)


def _round_u8(y: torch.Tensor) -> torch.Tensor:
    return torch.round(y).clamp(0, 255).to(torch.uint8)


def _cv_resize(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """cv2.INTER_LINEAR: half-pixel centres, source coordinates clamped
    at the edges, rounded to the input's dtype."""
    y = F.interpolate(_nchw(x).float(), size=(height, width),
                      mode="bilinear", align_corners=False)
    y = _from_nchw(y, x.ndim)
    return _round_u8(y) if x.dtype == torch.uint8 else y.to(x.dtype)


def _separable(x: torch.Tensor, kx: np.ndarray, ky: np.ndarray):
    """Correlate with the separable kernel ky (rows) x kx (columns),
    borders reflected without the edge (BORDER_REFLECT_101), anchor at the
    kernel's centre (k // 2), in float32."""
    y = _nchw(x).float()
    c = y.shape[1]
    lx, ly = len(kx) // 2, len(ky) // 2
    y = F.pad(y, (lx, len(kx) - 1 - lx, ly, len(ky) - 1 - ly),
              mode="reflect")
    wx = torch.as_tensor(np.asarray(kx, np.float32), device=x.device)
    wy = torch.as_tensor(np.asarray(ky, np.float32), device=x.device)
    y = F.conv2d(y, wx.view(1, 1, 1, -1).expand(c, 1, 1, -1), groups=c)
    y = F.conv2d(y, wy.view(1, 1, -1, 1).expand(c, 1, -1, 1), groups=c)
    y = _from_nchw(y, x.ndim)
    return _round_u8(y) if x.dtype == torch.uint8 else y.to(x.dtype)


def _gaussian_kernel(k: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel(k, sigma) in float64: its fixed table for an
    odd k up to 7 when sigma <= 0, else the sampled gaussian (with the
    sigma cv2 derives from k when sigma <= 0)."""
    if sigma <= 0 and k in _SMALL_GAUSSIAN:
        return np.asarray(_SMALL_GAUSSIAN[k])
    if sigma <= 0:
        sigma = 0.3 * ((k - 1) * 0.5 - 1) + 0.8
    x = np.arange(k, dtype=np.float64) - (k - 1) * 0.5
    w = np.exp(-(x * x) / (2 * sigma * sigma))
    return w / w.sum()


def _gray(x: torch.Tensor) -> torch.Tensor:
    """cv2.COLOR_RGB2GRAY: uint8 in cv2's fixed point, other dtypes in
    float with the same weights."""
    if x.dtype == torch.uint8:
        r, g, b = (x[..., i].to(torch.int32) for i in range(3))
        y = (r * _GRAY_RGB[0] + g * _GRAY_RGB[1] + b * _GRAY_RGB[2]
             + (1 << (_GRAY_SHIFT - 1))) >> _GRAY_SHIFT
        return y.to(torch.uint8)
    xf = x.float()
    return (xf[..., 0] * 0.299 + xf[..., 1] * 0.587
            + xf[..., 2] * 0.114).to(x.dtype)


def _threshold(x: torch.Tensor, thresh: float, max_val: float,
               kind: int) -> torch.Tensor:
    """cv2.threshold for types 0-4; on uint8 the threshold is floored and
    max_val rounded, as cv2 does."""
    if kind not in _THRESH_TYPES:
        raise ValueError(f"threshold_type {kind!r}: the port supports "
                         f"cv2's types {_THRESH_TYPES} (no OTSU/TRIANGLE)")
    cut = x
    if x.dtype == torch.uint8:
        thresh = math.floor(thresh)
        max_val = min(max(int(np.rint(max_val)), 0), 255)
        cut = x.to(torch.int32)     # a negative threshold stays negative
    above = cut > thresh
    top = torch.full_like(x, max_val)
    zero = torch.zeros_like(x)
    if kind == 0:
        return torch.where(above, top, zero)
    if kind == 1:
        return torch.where(above, zero, top)
    if kind == 2:
        low = max(thresh, 0) if x.dtype == torch.uint8 else thresh
        return torch.where(above, torch.full_like(x, low), x)
    if kind == 3:
        return torch.where(above, x, zero)
    return torch.where(above, zero, x)


def _apply_op(x: torch.Tensor, op: str, kw: dict) -> torch.Tensor:
    """One DSL op on a batch of same-shaped images (N, H, W[, C])."""
    if op == "resize":
        return _cv_resize(x, kw["height"], kw["width"])
    if op == "crop":
        h, w = x.shape[1:3]
        ch, cw = kw["height"], kw["width"]
        top = max((h - ch) // 2, 0)
        left = max((w - cw) // 2, 0)
        return x[:, top:top + ch, left:left + cw]
    if op == "color":
        if kw["format"] == "gray":
            return _gray(x)
        if kw["format"] == "bgr":
            return x.flip(-1)
        raise KeyError(kw["format"])
    if op == "flip":
        code = kw["flip_code"]
        dims = (1,) if code == 0 else (2,) if code > 0 else (1, 2)
        return x.flip(dims)
    if op == "blur":
        return _separable(x, np.full(kw["width"], 1.0 / kw["width"]),
                          np.full(kw["height"], 1.0 / kw["height"]))
    if op == "threshold":
        return _threshold(x, kw["threshold"], kw["max_val"],
                          kw["threshold_type"])
    if op == "gaussian":
        k = _gaussian_kernel(kw["aperture_size"], kw["sigma"])
        return _separable(x, k, k)
    raise ValueError(f"unknown ImageTransformer op {op!r}")


class ImageTransformer(Transformer, HasInputCol, HasOutputCol):
    """Ordered OpenCV stage DSL (reference: opencv/ImageTransformer.scala):

        ImageTransformer().resize(224, 224).center_crop(200, 200)
            .color_format("gray").flip(1).blur(5, 5)
            .threshold(127, 255).gaussian_kernel(3, 1.0)
    """
    stages = Param("stages", "ordered list of (op, kwargs) pairs", None)
    device = Param("device", "torch device to transform on (None = the "
                             "card)", None)

    def __init__(self, **kw):
        kw.setdefault("input_col", "image")
        kw.setdefault("output_col", "image")
        super().__init__(**kw)
        if self.stages is None:
            self.set(stages=[])

    # fluent builders (reference: ImageTransformer.scala:282-380)
    def _add(self, op: str, **kwargs):
        self.set(stages=list(self.stages or []) + [[op, kwargs]])
        return self

    def resize(self, height: int, width: int):
        return self._add("resize", height=height, width=width)

    def center_crop(self, height: int, width: int):
        return self._add("crop", height=height, width=width)

    def color_format(self, fmt: str):
        return self._add("color", format=fmt)

    def flip(self, flip_code: int = 1):
        return self._add("flip", flip_code=flip_code)

    def blur(self, height: int, width: int):
        return self._add("blur", height=height, width=width)

    def threshold(self, threshold: float, max_val: float = 255.0,
                  threshold_type: int = 0):
        return self._add("threshold", threshold=threshold, max_val=max_val,
                         threshold_type=threshold_type)

    def gaussian_kernel(self, aperture_size: int, sigma: float):
        return self._add("gaussian", aperture_size=aperture_size, sigma=sigma)

    def _run(self, x: torch.Tensor) -> np.ndarray:
        for op, kw in (self.stages or []):
            x = _apply_op(x, op, kw)
        return _host(x)

    def _transform(self, t: Table) -> Table:
        dev = resolve_device(self.device)
        col = t[self.input_col]
        if isinstance(col, torch.Tensor) or col.dtype != object:
            # a stacked batch: every op runs on the whole batch at once
            return t.with_column(self.output_col,
                                 self._run(_as_tensor(col, dev)))
        out = [self._run(_as_tensor(np.asarray(img)[None], dev))[0]
               for img in col]
        if out and all(o.shape == out[0].shape for o in out):
            stacked: np.ndarray = np.stack(out)
            return t.with_column(self.output_col, stacked)
        ragged = np.empty(len(out), dtype=object)
        for i, o in enumerate(out):
            ragged[i] = o
        return t.with_column(self.output_col, ragged)
