"""Pillow's resampling windows and weights, for `read_images(size=)`.

The reference resizes with `im.resize((w, h))`: for an RGB image Pillow's
default filter is BICUBIC (a = -0.5), its support widened by the scale
when shrinking (antialiased), with no `reducing_gap`. This module copies
`Resample.c`'s `precompute_coeffs` in float64, in its order of
operations, and its `normalize_coeffs_8bpc` to int32 with 22 fractional
bits; kernel D4 (`ops/image_decode.py::resample`) applies them. The
horizontal pass runs first, over only the rows the vertical pass reads
(`ImagingResampleInner`); each pass rounds and clips to uint8.

This is not `image/ops.py`'s `resize_weights`, which is jax's bilinear
for `ResizeImageTransformer`.
"""
from __future__ import annotations

import functools
import math

import numpy as np

from ..ops.image_decode import PRECISION_BITS

BICUBIC_SUPPORT = 2.0


def _bicubic(x: float) -> float:
    a = -0.5
    if x < 0.0:
        x = -x
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def precompute_coeffs(in_size: int, out_size: int):
    """(ksize, (out_size, 2) int32 windows of (first tap, taps), and
    (out_size, ksize) int32 weights) of one axis, box (0, in_size)."""
    scale = filterscale = in_size / out_size
    if filterscale < 1.0:
        filterscale = 1.0
    support = BICUBIC_SUPPORT * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    bounds = np.zeros((out_size, 2), np.int32)
    kk = np.zeros((out_size, ksize), np.float64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        ws = [_bicubic((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in ws:
            ww += w
        for x, w in enumerate(ws):
            kk[xx, x] = w / ww if ww != 0.0 else w
        bounds[xx] = (xmin, xmax)
    return ksize, bounds, _normalize_8bpc(kk)


def _normalize_8bpc(kk: np.ndarray) -> np.ndarray:
    """`normalize_coeffs_8bpc`: round half away from zero (C's (int) cast
    of +-0.5 + w * 2^22)."""
    scaled = kk * float(1 << PRECISION_BITS)
    return np.where(kk < 0, np.trunc(-0.5 + scaled),
                    np.trunc(0.5 + scaled)).astype(np.int32)


@functools.lru_cache(maxsize=64)
def plan(in_h: int, in_w: int, out_h: int, out_w: int) -> dict:
    """The passes Pillow runs for one image (`ImagingResampleInner`): each
    a dict of the axis's windows and weights; the horizontal pass covers
    input rows [row0, row0 + rows), and the vertical pass's windows are
    shifted to start at row0 when the horizontal pass ran. Cached: a
    folder's images share a few sizes; callers only read it."""
    need_h = out_w != in_w
    need_v = out_h != in_h
    ks_h, b_h, k_h = precompute_coeffs(in_w, out_w)
    ks_v, b_v, k_v = precompute_coeffs(in_h, out_h)
    row0 = int(b_v[0, 0])
    row_end = int(b_v[-1, 0] + b_v[-1, 1])
    passes = {}
    if need_h:
        passes["h"] = dict(ksize=ks_h, bounds=b_h, coefs=k_h, row0=row0,
                           rows=row_end - row0)
        b_v = b_v.copy()
        b_v[:, 0] -= row0
    if need_v:
        passes["v"] = dict(ksize=ks_v, bounds=b_v, coefs=k_v)
    return passes
