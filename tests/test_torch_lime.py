"""Port parity: LIME (`lime/`: the batched lasso, SLIC superpixels,
TabularLIME, ImageLIME, TextLIME).

The same seeded inputs go through both packages, JAX on the CPU and the
port with `device="cpu"`. Inner models are the reference's fitted linear
models carried across with `linear_from_reference`. Tolerances:
- perturbations, superpixel label maps, masks and masked documents equal
  the reference's bit for bit (numpy draws on both sides);
- lasso coefficients within `_LASSO_RTOL` of the largest row norm of the
  reference's solution: both solve in f32 (LU for lambda == 0, 200 ISTA
  steps otherwise), and the lambda == 0 system's conditioning follows the
  column scales (ROADMAP Queue 3 (ah));
- a linear model's explanation recovers its weights within
  `_RECOVER_RTOL` of max |w| (the 1e-6 ridge jitter and f32).
"""
import numpy as np
import pytest
import torch

from mmlspark_tpu.core import PipelineModel as RefPipelineModel
from mmlspark_tpu.core import Table as RefTable
from mmlspark_tpu.core import Transformer as RefTransformer
from mmlspark_tpu.featurize import TextFeaturizer as RefText
from mmlspark_tpu.image import UnrollImage as RefUnroll
from mmlspark_tpu.lime import ImageLIME as RefImageLIME
from mmlspark_tpu.lime import TabularLIME as RefTabularLIME
from mmlspark_tpu.lime import TextLIME as RefTextLIME
from mmlspark_tpu.lime import batched_lasso as ref_lasso
from mmlspark_tpu.lime import mask_image as ref_mask
from mmlspark_tpu.lime import slic_superpixels as ref_slic
from mmlspark_tpu.models.linear import LinearRegression as RefLinReg
from mmlspark_tpu.models.linear import LogisticRegression as RefLogReg
from mmlspark_tpu_torch.core import PipelineModel, Table, Transformer
from mmlspark_tpu_torch.core.serialize import load_stage, save_stage
from mmlspark_tpu_torch.featurize import TextFeaturizer
from mmlspark_tpu_torch.image import UnrollImage
from mmlspark_tpu_torch.lime import (ImageLIME, SuperpixelTransformer,
                                     TabularLIME, TextLIME, batched_lasso,
                                     mask_image, slic_superpixels)
from mmlspark_tpu_torch.models.linear import linear_from_reference

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_LASSO_RTOL = 1e-5
_RECOVER_RTOL = 1e-3


class _RefRecorder(RefTransformer):
    """Records the inputs an inner model is given, then scores them."""

    def __init__(self, inner=None, **kw):
        super().__init__(**kw)
        self.inner, self.seen = inner, []

    def _transform(self, t):
        self.seen.append(t)
        return self.inner.transform(t)


class _Recorder(Transformer):
    def __init__(self, inner=None, **kw):
        super().__init__(**kw)
        self.inner, self.seen = inner, []

    def _transform(self, t):
        self.seen.append(t)
        return self.inner.transform(t)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert (a.dtype, a.shape) == (b.dtype, b.shape)
    if a.dtype == object:
        assert a.tolist() == b.tolist()
    else:
        assert a.tobytes() == b.tobytes()


def _close(got, want, rtol=_LASSO_RTOL):
    scale = np.linalg.norm(want, axis=-1).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("lam", [0.0, 0.01, 0.3])
def test_batched_lasso_matches_reference(lam):
    rng = np.random.default_rng(0)
    b, s, d = 6, 400, 10
    x = rng.normal(size=(b, s, d)) * rng.uniform(0.2, 3.0, size=d)
    w = rng.normal(size=(b, d)) * (rng.random((b, d)) < 0.6)
    y = np.einsum("bsd,bd->bs", x, w) + 0.05 * rng.normal(size=(b, s))
    want = ref_lasso(x, y, lam)
    got = batched_lasso(x, y, lam, device="cpu")
    assert got.dtype == np.float32 and got.shape == (b, d)
    _close(got, want)
    np.testing.assert_array_equal(batched_lasso(x, y, lam, device="cpu"),
                                  got)
    if lam == 0.3:
        assert (got == 0).sum() > 0     # the l1 step zeroes coefficients


def test_tabular_lime_matches_reference_and_recovers_weights(tmp_path):
    rng = np.random.default_rng(1)
    n, d = 200, 6
    x = rng.normal(size=(n, d)) * np.array([1, 2, 3, 0.5, 1, 4.0])
    y = (rng.random(n) < 1 / (1 + np.exp(-x @ rng.normal(size=d)))
         ).astype(np.float64)
    rt = RefTable({"features": x.astype(np.float32), "label": y})
    ref_lr = RefLogReg(max_iter=60).fit(rt)
    ref_lin = RefLinReg().fit(RefTable({"features": x.astype(np.float32),
                                        "label": x @ np.arange(d)}))
    rows = x[:5]
    for ref_inner, pred_col in ((ref_lr, "probabilities"),
                                (ref_lin, "prediction")):
        for lam in (0.0, 0.001):
            kw = dict(input_col="features", prediction_col=pred_col,
                      n_samples=300, seed=9, regularization=lam)
            rrec = _RefRecorder(ref_inner)
            prec = _Recorder(linear_from_reference(ref_inner,
                                                   device="cpu"))
            ref = RefTabularLIME(model=rrec, **kw).fit(rt)
            got = TabularLIME(model=prec, device="cpu", **kw).fit(
                Table({"features": x.astype(np.float32)}))
            np.testing.assert_array_equal(got._column_stds,
                                          ref._column_stds)
            want = ref.transform(RefTable({"features": rows}))["output"]
            out = got.transform(Table({"features": rows}))["output"]
            _same(prec.seen[0]["features"], rrec.seen[0]["features"])
            _close(out, np.asarray(want))
            if pred_col == "prediction" and lam == 0.0:
                w = np.asarray(ref_inner._w)
                np.testing.assert_allclose(
                    out, np.broadcast_to(w, out.shape), rtol=0,
                    atol=_RECOVER_RTOL * np.abs(w).max())
    save_stage(got, str(tmp_path / "lime"))
    back = load_stage(str(tmp_path / "lime"))
    np.testing.assert_array_equal(back._column_stds, got._column_stds)


def test_tabular_lime_requires_model():
    m = TabularLIME(input_col="features", device="cpu").fit(
        Table({"features": np.zeros((3, 2))}))
    with pytest.raises(ValueError, match="model"):
        m.transform(Table({"features": np.zeros((3, 2))}))


def test_superpixels_and_masks_match_reference():
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 255, size=(40, 36, 3)).astype(np.float32)
    img[:, 18:] += 60.0
    for cell in (8.0, 12.0):
        want = ref_slic(img, cell_size=cell)
        got = slic_superpixels(img, cell_size=cell)
        _same(got, want)
        states = rng.random(int(got.max()) + 1) < 0.5
        _same(mask_image(img, got, states), ref_mask(img, want, states))
    out = SuperpixelTransformer(input_col="image", cell_size=8.0).transform(
        Table({"image": img[None]}))
    _same(out["superpixels"][0], ref_slic(img, cell_size=8.0))


def test_image_lime_matches_reference():
    rng = np.random.default_rng(3)
    imgs = rng.uniform(0, 255, size=(2, 24, 24, 3)).astype(np.float32)
    flat = RefUnroll(input_col="image", output_col="features").transform(
        RefTable({"image": imgs}))["features"]
    w = rng.normal(size=flat.shape[1])
    ref_lin = RefLinReg(reg_param=1e-3).fit(RefTable(
        {"features": np.asarray(flat, np.float32),
         "label": np.asarray(flat) @ w}))
    ref_inner = _RefRecorder(
        RefPipelineModel(stages=[RefUnroll(input_col="image",
                                           output_col="features"),
                                 ref_lin]))
    inner = _Recorder(PipelineModel(stages=[
        UnrollImage(input_col="image", output_col="features",
                    device="cpu"),
        linear_from_reference(ref_lin, device="cpu")]))
    kw = dict(input_col="image", cell_size=8.0, n_samples=120, seed=4,
              sampling_fraction=0.5)
    for lam in (0.0, 0.05):
        want = RefImageLIME(model=ref_inner, regularization=lam, **kw
                            ).transform(RefTable({"image": imgs}))
        got = ImageLIME(model=inner, regularization=lam, device="cpu", **kw
                        ).transform(Table({"image": imgs}))
        for a, b in zip(inner.seen[-2:], ref_inner.seen[-2:]):
            _same(a["image"], b["image"])
        for i in range(len(imgs)):
            _same(got["superpixels"][i], np.asarray(want["superpixels"][i]))
            _close(got["output"][i], np.asarray(want["output"][i]))


def test_text_lime_matches_reference():
    rng = np.random.default_rng(5)
    vocab = [f"w{i}" for i in range(40)]
    docs = np.array([" ".join(rng.choice(vocab, 25)) for _ in range(300)],
                    dtype=object)
    kw = dict(input_col="text", output_col="tf", num_features=1 << 10,
              dense_output=True)
    ref_tf = RefText(**kw).fit(RefTable({"text": docs}))
    feats = np.asarray(ref_tf.transform(RefTable({"text": docs}))["tf"])
    ref_lin = RefLinReg(reg_param=1e-2, features_col="tf").fit(RefTable(
        {"tf": feats, "label": feats @ rng.normal(size=feats.shape[1])}))
    tf = TextFeaturizer(device="cpu", **kw).fit(Table({"text": docs}))
    ref_inner = _RefRecorder(
        RefPipelineModel(stages=[ref_tf, ref_lin]))
    inner = _Recorder(PipelineModel(stages=[
        tf, linear_from_reference(ref_lin, device="cpu")]))
    lkw = dict(input_col="text", n_samples=150, seed=6)
    for lam in (0.0, 0.01):
        want = RefTextLIME(model=ref_inner, regularization=lam, **lkw
                           ).transform(RefTable({"text": docs[:2]}))
        got = TextLIME(model=inner, regularization=lam, device="cpu", **lkw
                       ).transform(Table({"text": docs[:2]}))
        for a, b in zip(inner.seen[-2:], ref_inner.seen[-2:]):
            _same(a["text"], b["text"])
        for i in range(2):
            assert list(got["tokens"][i]) == list(want["tokens"][i])
            _close(got["output"][i], np.asarray(want["output"][i]))
