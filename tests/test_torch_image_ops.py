"""Port parity: the image stages (`mmlspark_tpu_torch.image`) against the
JAX package's, on the CPU, and the `ImageTransformer` ops against cv2.

Tolerances:
- resize weights within 2 float32 ulps (2.4e-7 relative) of jax's
  `compute_weight_mat` (the column sums may add in another order);
- resized floats within 1e-4 of the float64 resize with jax's weights;
  within 5e-3 of `jax.image.resize` itself, whose CPU einsum is off the
  float64 result by up to 3.5e-3 at 300 x 200 -> 224 (measured); the
  uint8 output equal to the reference's wherever the reference's float is
  more than 5e-3 from an integer (the truncating cast flips there), and
  never more than one level off;
- UnrollImage and ImageSetAugmenter equal;
- ImageTransformer against cv2: crop, flip, threshold and the colour
  conversions equal (gray on all 2^24 colours); resize, blur and gaussian
  within one level (cv2 rounds in fixed point, the port in float32).
"""
import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat

import mmlspark_tpu.core as ref_core
import mmlspark_tpu_torch.core as port_core
from mmlspark_tpu.image import ops as ref_ops
from mmlspark_tpu_torch.image import ops as port_ops

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_NEAR = 5e-3


def _images(shape, seed=3):
    imgs = np.random.default_rng(seed).integers(0, 256, size=shape).astype(
        np.uint8)
    imgs[0, :, :shape[2] // 2] = 128      # flat regions: sums near integers
    return imgs


@pytest.mark.parametrize("n_in, n_out", [(256, 224), (300, 224), (500, 224),
                                         (32, 16), (32, 24), (7, 3),
                                         (32, 224), (224, 256), (16, 32)])
def test_resize_weights_match_jax(n_in, n_out):
    want = np.asarray(compute_weight_mat(n_in, n_out, n_out / n_in, 0.0,
                                         _fill_triangle_kernel, True))
    got = port_ops.resize_weights(n_in, n_out)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=0)
    assert ((got == 0) == (want == 0)).all()


@pytest.mark.parametrize("shape, size", [((4, 32, 32, 3), (16, 24)),
                                         ((2, 256, 256, 3), (224, 224)),
                                         ((2, 300, 200, 3), (224, 224)),
                                         ((3, 20, 30, 3), (40, 10)),
                                         ((2, 16, 16, 3), (32, 32)),
                                         ((2, 32, 48, 3), (32, 24))])
def test_resize_matches_reference(shape, size):
    imgs = _images(shape)
    h, w = size
    ref = np.asarray(jax.image.resize(
        jnp.asarray(imgs.astype(np.float32)), (shape[0], h, w, 3),
        method="bilinear"))
    exact = imgs.astype(np.float64)
    if shape[1] != h:
        exact = np.einsum("nhwc,hH->nHwc", exact, np.asarray(
            compute_weight_mat(shape[1], h, h / shape[1], 0.0,
                               _fill_triangle_kernel, True), np.float64))
    if shape[2] != w:
        exact = np.einsum("nhwc,wW->nhWc", exact, np.asarray(
            compute_weight_mat(shape[2], w, w / shape[2], 0.0,
                               _fill_triangle_kernel, True), np.float64))
    got = port_ops.resize_float(torch.from_numpy(imgs), h, w).numpy()
    assert np.abs(got - exact).max() < 1e-4
    assert np.abs(got - ref).max() < _NEAR
    out = port_ops.ResizeImageTransformer(height=h, width=w,
                                          device="cpu").transform(
        port_core.Table({"image": imgs}))["image"]
    want = ref_ops.ResizeImageTransformer(height=h, width=w).transform(
        ref_core.Table({"image": imgs}))["image"]
    assert out.dtype == np.uint8 and out.shape == want.shape
    near = np.abs(ref - np.round(ref)) < _NEAR
    np.testing.assert_array_equal(out[~near], want[~near])
    assert np.abs(out.astype(int) - want).max() <= 1


def test_resize_truncates_and_accepts_other_columns():
    """clip then a truncating cast, as numpy's astype(uint8); an object
    column and a tensor column give the stacked batch's result."""
    x = torch.tensor([[[[10.0], [11.0]]]])         # (1, 1, 2, 1)
    y = port_ops.resize_float(x, 1, 3)             # upsample 2 -> 3
    assert y[0, 0, 1, 0] == 10.5
    assert port_ops.resize_images(x, 1, 3)[0, 0, 1, 0] == 10
    imgs = _images((3, 20, 20, 3))
    stage = port_ops.ResizeImageTransformer(height=8, width=8, device="cpu")
    want = stage.transform(port_core.Table({"image": imgs}))["image"]
    col = np.empty(3, dtype=object)
    for i in range(3):
        col[i] = imgs[i]
    for column in (col, torch.from_numpy(imgs)):
        got = stage.transform(port_core.Table({"image": column}))["image"]
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [dict(scale=1.0),
                                dict(scale=1 / 255, mean=[0.1, 0.2, 0.3],
                                     std=[0.5, 0.6, 0.7]),
                                dict(to_bgr=False, scale=0.5)])
def test_unroll_matches_reference(kw):
    imgs = _images((4, 8, 6, 3))
    want = ref_ops.UnrollImage(**kw).transform(
        ref_core.Table({"image": imgs}))["features"]
    got = port_ops.UnrollImage(device="cpu", **kw).transform(
        port_core.Table({"image": imgs}))["features"]
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lr, ud", [(True, True), (True, False),
                                    (False, True)])
def test_augmenter_matches_reference(lr, ud):
    imgs = _images((3, 5, 4, 3))
    cols = {"image": imgs, "label": np.arange(3).astype(np.float32)}
    want = ref_ops.ImageSetAugmenter(flip_left_right=lr,
                                     flip_up_down=ud).transform(
        ref_core.Table(cols))
    got = port_ops.ImageSetAugmenter(flip_left_right=lr,
                                     flip_up_down=ud).transform(
        port_core.Table(cols))
    assert got.columns == want.columns
    for c in want.columns:
        np.testing.assert_array_equal(got[c], want[c])


def _dsl(module, build, device=None):
    it = module.ImageTransformer(**({"device": device} if device else {}))
    return build(it)


_EXACT = {
    "crop": lambda m: m.center_crop(20, 30),
    "crop_past_edge": lambda m: m.center_crop(60, 30),
    "gray": lambda m: m.color_format("gray"),
    "bgr": lambda m: m.color_format("bgr"),
    "flip_ud": lambda m: m.flip(0),
    "flip_lr": lambda m: m.flip(1),
    "flip_both": lambda m: m.flip(-1),
    "binary": lambda m: m.threshold(127, 255),
    "binary_inv": lambda m: m.threshold(100.5, 200.4, 1),
    "trunc": lambda m: m.threshold(90, 255, 2),
    "tozero": lambda m: m.threshold(90, 255, 3),
    "tozero_inv": lambda m: m.threshold(90, 255, 4),
    "negative_threshold": lambda m: m.threshold(-3, 255, 2),
    "gray_then_threshold": lambda m: m.color_format("gray").threshold(127,
                                                                      255),
}
_ONE_LEVEL = {
    "resize_down": lambda m: m.resize(24, 24),
    "resize_up": lambda m: m.resize(70, 33),
    "blur_3": lambda m: m.blur(3, 3),
    "blur_5x4": lambda m: m.blur(5, 4),
    "gaussian_3": lambda m: m.gaussian_kernel(3, 1.0),
    "gaussian_5_table": lambda m: m.gaussian_kernel(5, 0.0),
    "gaussian_7": lambda m: m.gaussian_kernel(7, 2.5),
    "chain": lambda m: m.resize(24, 24).center_crop(20, 20).flip(1)
                        .blur(3, 3),
}


@pytest.mark.parametrize("name", sorted(_EXACT) + sorted(_ONE_LEVEL))
def test_image_transformer_ops_against_cv2(name):
    build = _EXACT.get(name) or _ONE_LEVEL[name]
    imgs = _images((3, 48, 40, 3), seed=11)
    want = _dsl(ref_ops, build).transform(
        ref_core.Table({"image": imgs}))["image"]
    got = _dsl(port_ops, build, "cpu").transform(
        port_core.Table({"image": imgs}))["image"]
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= (0 if name in _EXACT else 1), diff.max()


def test_gray_is_cv2_on_every_colour():
    v = np.arange(256)
    rgb = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(
        1, 4096, 4096, 3).astype(np.uint8)
    got = port_ops._gray(torch.from_numpy(rgb))[0].numpy()
    np.testing.assert_array_equal(got, cv2.cvtColor(rgb[0],
                                                    cv2.COLOR_RGB2GRAY))


def test_image_transformer_ragged_column_and_errors():
    """Images of several shapes run one at a time and come back as an
    object column; an unknown op names itself."""
    col = np.empty(2, dtype=object)
    col[0] = _images((1, 10, 12, 3))[0]
    col[1] = _images((1, 14, 9, 3), seed=4)[0]
    got = port_ops.ImageTransformer(device="cpu").flip(1).transform(
        port_core.Table({"image": col}))["image"]
    assert got.dtype == object
    for g, img in zip(got, col):
        np.testing.assert_array_equal(g, cv2.flip(img, 1))
    bad = port_ops.ImageTransformer(device="cpu", stages=[["warp", {}]])
    with pytest.raises(ValueError, match="warp"):
        bad.transform(port_core.Table({"image": _images((1, 4, 4, 3))}))
    with pytest.raises(ValueError, match="OTSU"):
        port_ops.ImageTransformer(device="cpu").threshold(
            0, 255, 8).transform(port_core.Table(
                {"image": _images((1, 4, 4, 3))}))
    with pytest.raises(NotImplementedError, match="item 21"):
        port_ops.read_image_dir("/nonexistent")
