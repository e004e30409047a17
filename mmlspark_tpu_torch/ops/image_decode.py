"""The image decoders' four kernels: wrappers, and a plain version of each.

Four integer functions that decode and resize a batch of image files on
the card (`image/decode.py` calls them, `image/jpeg.py` and `image/png.py`
make their inputs on the host):

- D1 `jpeg_idct` (`csrc/image_decode.cu::jpeg_idct_islow`): every 8x8
  block of every JPEG of the batch dequantized and inverse-transformed by
  libjpeg's integer ISLOW IDCT (`jidctint.c`: 13 constant bits, 2 pass-1
  bits, DESCALE rounding, the sample masked with 0x3FF before its range
  table, so an out-of-range sum wraps as libjpeg's does), into the
  components' MCU-padded uint8 planes;
- D2 `jpeg_color` (`::jpeg_upsample_ycc_rgb`): libjpeg-turbo's fancy
  upsampling (h2v1, and h2v2's triangle filter with its +8/+7 biases;
  the last real sample replicated past a component's downsampled width,
  and its last real row below it, as `jdmainct.c`'s context rows are),
  then `jdcolor.c`'s integer YCbCr -> RGB (grey replicated, Adobe RGB
  copied), cropped to each image's (H, W, 3);
- D3 `png_unfilter` (`::png_unfilter`): PNG's five scanline filters over
  every image (every Adam7 pass) of the batch;
- D4 `resample` (`csrc/resample.cu::resample_bicubic_u8`): one pass of
  Pillow's fixed-point resampling (`Resample.c`, 8 bits a channel), with
  the windows and int32 weights `image/resample.py` makes: the sum starts
  at 1 << 21 and is shifted right by 22, then clipped to 0-255.

Each takes the whole batch in one launch: the images lie end to end in
flat uint8 buffers, and an int64 table gives each image (or plane, or
pass) its offsets and sizes. All four are integer arithmetic, so a
kernel's output equals its plain version's bit for bit.

None of them replaces a TPU kernel: the reference decodes with PIL on the
host. Each is bound by the bytes it moves (a few integer operations a
byte), and is written simply: one thread per block row (D1, the 8x8
transpose in shared memory), per output pixel (D2) or per output sample
(D4); D3 is one block per image pass that walks its anti-diagonals (a
thread per row of a band of rows; a byte's left, upper and upper-left
neighbours are done one and two steps before it), since the Avg and
Paeth filters chain along a row.

The tensor's device chooses the implementation: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises. Nothing falls
back. `launches` counts each kernel where its wrapper launches it.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = {"jpeg_idct_islow": 0, "jpeg_upsample_ycc_rgb": 0,
            "png_unfilter": 0, "resample_bicubic_u8": 0}

# the columns of the per-image tables (int64)
# D2: per image, then per component (3; unused ones zero)
COLOR_IMAGE = ("out_off", "height", "width", "color")
COLOR_COMP = ("plane_off", "stride", "dw", "dh", "hf", "vf")
COLOR_COLS = len(COLOR_IMAGE) + 3 * len(COLOR_COMP)
# D3: per image pass
PNG_PASS = ("in_off", "out_off", "rows", "row_bytes", "bpp")
# D4: per image
RESAMPLE_IMAGE = ("in_off", "out_off", "in_h", "in_w", "out_h", "out_w",
                  "row0", "bound_off", "coef_off", "ksize")

PRECISION_BITS = 32 - 8 - 2         # Pillow's 8-bit resample weights

_P = ctypes.c_void_p
_libs: dict = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _library(name: str):
    lib = _libs.get(name)
    if lib is None:
        lib = _build.load(name)
        if name == "image_decode":
            lib.jpeg_idct_launch.argtypes = [_P] * 5 + [
                ctypes.c_longlong, ctypes.c_int, _P]
            lib.jpeg_color_launch.argtypes = [_P] * 3 + [ctypes.c_int, _P]
            lib.png_unfilter_launch.argtypes = [_P] * 3 + [ctypes.c_int, _P]
            for fn in ("jpeg_idct_launch", "jpeg_color_launch",
                       "png_unfilter_launch"):
                getattr(lib, fn).restype = ctypes.c_int
        else:
            lib.resample_launch.argtypes = [_P] * 5 + [
                ctypes.c_int, ctypes.c_int, _P]
            lib.resample_launch.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: the kernel launch failed "
                           f"(cudaError_t {err})")


def _same_device(*ts) -> torch.device:
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError("the decoders take contiguous tensors")
    return dev


def _stream(dev: torch.device):
    return torch.cuda.current_stream(dev).cuda_stream


# -- D1: dequantize + ISLOW IDCT ---------------------------------------------

# jidctint.c's FIX_* constants at CONST_BITS = 13
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _idct_1d(x: list, shift: int) -> list:
    """One pass of jidctint.c over eight int64 tensors, descaled by
    `shift` bits (DESCALE: add half, shift right arithmetically)."""
    z1 = (x[2] + x[6]) * _F0541
    tmp2 = z1 + x[6] * -_F1847
    tmp3 = z1 + x[2] * _F0765
    tmp0 = (x[0] + x[4]) << 13
    tmp1 = (x[0] - x[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1175
    t0, t1, t2, t3 = t0 * _F0298, t1 * _F2053, t2 * _F3072, t3 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    t0, t1 = t0 + z1 + z3, t1 + z2 + z4
    t2, t3 = t2 + z2 + z3, t3 + z1 + z4
    half = 1 << (shift - 1)
    return [(v + half) >> shift for v in (
        tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
        tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def _range_limit(v: torch.Tensor) -> torch.Tensor:
    """libjpeg's post-IDCT range table at `v & 0x3FF`: the low 10 bits as
    a signed sample, +128, clamped."""
    s = ((v & 1023) ^ 512) - 512
    return (s + 128).clamp(0, 255)


def _idct_plain(coefs, quant, block_plane, planes, total):
    n = coefs.shape[0]
    dq = (coefs.to(torch.int64) * quant.to(torch.int64)[block_plane]).view(
        n, 8, 8)
    # pass 1 over the columns (x[k] = row k), pass 2 over the rows
    ws = torch.stack(_idct_1d([dq[:, k, :] for k in range(8)], 11), dim=1)
    out = torch.stack(_idct_1d([ws[:, :, k] for k in range(8)], 18), dim=2)
    out = _range_limit(out).to(torch.uint8)
    info = planes[block_plane]
    j = torch.arange(n, device=coefs.device) - info[:, 2]
    wb = info[:, 1]
    by, bx = j // wb, j % wb
    yy = torch.arange(8, device=coefs.device)
    dest = (info[:, 0, None, None]
            + (by[:, None, None] * 8 + yy[None, :, None]) * (wb * 8)[
                :, None, None]
            + bx[:, None, None] * 8 + yy[None, None, :])
    flat = torch.zeros(total, dtype=torch.uint8, device=coefs.device)
    flat[dest.reshape(-1)] = out.reshape(-1)
    return flat


def jpeg_idct(coefs: torch.Tensor, quant: torch.Tensor,
              block_plane: torch.Tensor, planes: torch.Tensor,
              total: int) -> torch.Tensor:
    """D1: (blocks, 64) int16 coefficients in natural order, (planes, 64)
    int32 quantization tables, each block's plane (int64) and the
    planes' (out_off, blocks per row, first block) int64 rows -> the
    flat uint8 buffer of `total` bytes holding every padded plane."""
    dev = _same_device(coefs, quant, block_plane, planes)
    if coefs.dtype != torch.int16 or coefs.dim() != 2 or coefs.shape[1] != 64:
        raise ValueError("coefs must be (blocks, 64) int16")
    if quant.dtype != torch.int32 or planes.dtype != torch.int64 \
            or block_plane.dtype != torch.int64:
        raise ValueError("quant is int32; block_plane and planes int64")
    if dev.type == "cpu":
        return _idct_plain(coefs, quant, block_plane, planes, total)
    if dev.type != "cuda":
        raise ValueError(f"jpeg_idct runs on the CPU or a card, not {dev}")
    out = torch.empty(total, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        _check(_library("image_decode").jpeg_idct_launch(
            coefs.data_ptr(), quant.data_ptr(), block_plane.data_ptr(),
            planes.data_ptr(), out.data_ptr(), coefs.shape[0],
            planes.shape[0], _stream(dev)), "jpeg_idct_islow")
    launches["jpeg_idct_islow"] += 1
    return out


# -- D2: fancy upsampling + colour conversion --------------------------------

def _fix(x: float) -> int:
    return int(x * 65536 + 0.5)


# jdcolor.c's build_ycc_rgb_table at SCALEBITS = 16
_CR_R, _CB_B, _CR_G, _CB_G = _fix(1.40200), _fix(1.77200), _fix(0.71414), \
    _fix(0.34414)


def _upsampled(planes, off, stride, dw, dh, hf, vf, h, w):
    """One component at full size (h, w), int64, as libjpeg-turbo's
    fullsize, h2v1 or h2v2 fancy upsampler gives it."""
    dev = planes.device
    rows = planes[off:off + stride * max(dh, 1)].view(-1, stride).to(
        torch.int64)
    ys = torch.arange(h, device=dev)
    xs = torch.arange(w, device=dev)
    if hf == 1:
        return rows[ys][:, xs]
    i = xs >> 1
    left, right = (i - 1).clamp(min=0), (i + 1).clamp(max=dw - 1)
    if vf == 1:
        cur = rows[ys]
        even = torch.where(i == 0, cur[:, i], (3 * cur[:, i] + cur[:, left]
                                               + 1) >> 2)
        odd = torch.where(i == dw - 1, cur[:, i],
                          (3 * cur[:, i] + cur[:, right] + 2) >> 2)
    else:
        r = ys >> 1
        other = torch.where((ys & 1) == 1, (r + 1).clamp(max=dh - 1),
                            (r - 1).clamp(min=0))
        cs = 3 * rows[r] + rows[other]
        even = torch.where(i == 0, (4 * cs[:, i] + 8) >> 4,
                           (3 * cs[:, i] + cs[:, left] + 8) >> 4)
        odd = torch.where(i == dw - 1, (4 * cs[:, i] + 7) >> 4,
                          (3 * cs[:, i] + cs[:, right] + 7) >> 4)
    return torch.where((xs & 1) == 1, odd, even)


def _color_plain(planes, info, total):
    out = torch.zeros(total, dtype=torch.uint8, device=planes.device)
    n_img = len(COLOR_IMAGE)
    for row in info.tolist():
        out_off, h, w, color = row[:n_img]
        comps = [row[n_img + 6 * c:n_img + 6 * c + 6]
                 for c in range(1 if color == 0 else 3)]
        s = [_upsampled(planes, *c, h, w) for c in comps]
        if color == 0:
            rgb = [s[0]] * 3
        elif color == 2:
            rgb = s
        else:
            y, cb, cr = s[0], s[1] - 128, s[2] - 128
            rgb = [y + ((_CR_R * cr + 32768) >> 16),
                   y + ((-_CB_G * cb + 32768 - _CR_G * cr) >> 16),
                   y + ((_CB_B * cb + 32768) >> 16)]
        img = torch.stack(rgb, dim=-1).clamp(0, 255).to(torch.uint8)
        out[out_off:out_off + h * w * 3] = img.reshape(-1)
    return out


def jpeg_color(planes: torch.Tensor, info: torch.Tensor,
               total: int) -> torch.Tensor:
    """D2: the planes D1 wrote and one int64 row per image (`COLOR_IMAGE`
    then `COLOR_COMP` for each of 3 components) -> the flat uint8 buffer
    of `total` bytes holding every image's (H, W, 3) RGB."""
    dev = _same_device(planes, info)
    if planes.dtype != torch.uint8 or info.dtype != torch.int64 \
            or info.dim() != 2 or info.shape[1] != COLOR_COLS:
        raise ValueError(f"planes is uint8, info (images, {COLOR_COLS}) "
                         f"int64")
    if dev.type == "cpu":
        return _color_plain(planes, info, total)
    if dev.type != "cuda":
        raise ValueError(f"jpeg_color runs on the CPU or a card, not {dev}")
    out = torch.empty(total, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        _check(_library("image_decode").jpeg_color_launch(
            planes.data_ptr(), info.data_ptr(), out.data_ptr(),
            info.shape[0], _stream(dev)), "jpeg_upsample_ycc_rgb")
    launches["jpeg_upsample_ycc_rgb"] += 1
    return out


# -- D3: PNG scanline filters ------------------------------------------------

def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = (p - a).abs(), (p - b).abs(), (p - c).abs()
    return torch.where((pa <= pb) & (pa <= pc), a,
                       torch.where(pb <= pc, b, c))


def _unfilter_one(data, in_off, rows, row_bytes, bpp):
    """One image pass, walked by anti-diagonals r + x (x in pixels of
    `bpp` bytes): every filter reads only cells of earlier diagonals."""
    dev = data.device
    px = row_bytes // bpp
    block = data[in_off:in_off + rows * (row_bytes + 1)].view(
        rows, row_bytes + 1).to(torch.int64)
    ftype = block[:, 0]
    filt = block[:, 1:].reshape(rows, px, bpp)
    # zero row above and zero column to the left
    out = torch.zeros(rows + 1, px + 1, bpp, dtype=torch.int64, device=dev)
    for d in range(rows + px - 1):
        r = torch.arange(max(0, d - px + 1), min(rows - 1, d) + 1,
                         device=dev)
        x = d - r
        a, b, c = out[r + 1, x], out[r, x + 1], out[r, x]
        f = ftype[r, None]
        raw = filt[r, x]
        pred = torch.where(f == 1, a, torch.where(
            f == 2, b, torch.where(f == 3, (a + b) >> 1, torch.where(
                f == 4, _paeth(a, b, c), torch.zeros_like(a)))))
        out[r + 1, x + 1] = (raw + pred) & 255
    return out[1:, 1:].reshape(-1).to(torch.uint8)


def _unfilter_plain(data, info, total):
    out = torch.zeros(total, dtype=torch.uint8, device=data.device)
    for in_off, out_off, rows, row_bytes, bpp in info.tolist():
        if rows and row_bytes:
            out[out_off:out_off + rows * row_bytes] = _unfilter_one(
                data, in_off, rows, row_bytes, bpp)
    return out


def png_unfilter(data: torch.Tensor, info: torch.Tensor,
                 total: int) -> torch.Tensor:
    """D3: the inflated IDAT bytes of every image pass (each row's filter
    byte, then its bytes) and one int64 row per pass (`PNG_PASS`) -> the
    flat uint8 buffer of `total` bytes holding the raw scanlines. Filter
    types are checked on the host before (`image/png.py`)."""
    dev = _same_device(data, info)
    if data.dtype != torch.uint8 or info.dtype != torch.int64 \
            or info.dim() != 2 or info.shape[1] != len(PNG_PASS):
        raise ValueError(f"data is uint8, info (passes, {len(PNG_PASS)}) "
                         f"int64")
    if dev.type == "cpu":
        return _unfilter_plain(data, info, total)
    if dev.type != "cuda":
        raise ValueError(f"png_unfilter runs on the CPU or a card, not {dev}")
    out = torch.empty(total, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        _check(_library("image_decode").png_unfilter_launch(
            data.data_ptr(), info.data_ptr(), out.data_ptr(), info.shape[0],
            _stream(dev)), "png_unfilter")
    launches["png_unfilter"] += 1
    return out


# -- D4: one pass of Pillow's 8-bit resample ---------------------------------

def _resample_plain(images, info, bounds, coefs, vertical, total):
    out = torch.zeros(total, dtype=torch.uint8, device=images.device)
    dev = images.device
    for (in_off, out_off, in_h, in_w, out_h, out_w, row0, bound_off,
         coef_off, ksize) in info.tolist():
        src = images[in_off:in_off + in_h * in_w * 3].view(
            in_h, in_w, 3).to(torch.int64)
        n_out = out_h if vertical else out_w
        b = bounds[bound_off:bound_off + n_out].to(torch.int64)
        k = coefs[coef_off:coef_off + n_out * ksize].view(
            n_out, ksize).to(torch.int64)
        taps = torch.arange(ksize, device=dev)
        used = taps[None, :] < b[:, 1:2]
        pos = (b[:, 0:1] + taps[None, :]).where(used, 0)
        kk = k.where(used, 0)
        if vertical:
            # (out_h, ksize, in_w, 3)
            acc = (src[pos] * kk[:, :, None, None]).sum(1)
        else:
            rows = src[row0:row0 + out_h]
            acc = (rows[:, pos] * kk[None, :, :, None]).sum(2)
        acc = (acc + (1 << (PRECISION_BITS - 1))) >> PRECISION_BITS
        out[out_off:out_off + out_h * out_w * 3] = acc.clamp(0, 255).to(
            torch.uint8).reshape(-1)
    return out


def resample(images: torch.Tensor, info: torch.Tensor, bounds: torch.Tensor,
             coefs: torch.Tensor, vertical: bool, total: int) -> torch.Tensor:
    """D4: one pass (horizontal, or vertical) of Pillow's resample over
    every image of the flat uint8 `images` buffer: one int64 row per image
    (`RESAMPLE_IMAGE`), each output position's (first tap, taps) int32
    window in `bounds` and its `ksize` int32 weights in `coefs` -> the
    flat uint8 buffer of `total` bytes."""
    dev = _same_device(images, info, bounds, coefs)
    if images.dtype != torch.uint8 or info.dtype != torch.int64 \
            or info.dim() != 2 or info.shape[1] != len(RESAMPLE_IMAGE) \
            or bounds.dtype != torch.int32 or coefs.dtype != torch.int32:
        raise ValueError("images uint8, info int64, bounds and coefs int32")
    if dev.type == "cpu":
        return _resample_plain(images, info, bounds, coefs, vertical, total)
    if dev.type != "cuda":
        raise ValueError(f"resample runs on the CPU or a card, not {dev}")
    out = torch.empty(total, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        _check(_library("resample").resample_launch(
            images.data_ptr(), info.data_ptr(), bounds.data_ptr(),
            coefs.data_ptr(), out.data_ptr(), info.shape[0], int(vertical),
            _stream(dev)), "resample_bicubic_u8")
    launches["resample_bicubic_u8"] += 1
    return out
