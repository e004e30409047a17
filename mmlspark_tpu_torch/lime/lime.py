"""LIME: local interpretable model-agnostic explanations.

Role-equivalent to the reference's lime/LIME.scala (TabularLIME:169-226,
ImageLIME:262-340) and TextLIME.scala:20-89, re-designed TPU-first:

- The reference explodes perturbations into DataFrame rows and re-aggregates
  them with a custom partition-local aggregator (LIMEUtils.localAggregateBy,
  LIME.scala:60-110). Here perturbations for ALL rows are stacked into ONE
  batch, scored by the inner model in one call (MXU-sized work instead of
  n_rows tiny calls), and the per-row local models are solved by one vmapped
  lasso (lime/lasso.py).
- Sampling uses a seeded numpy generator: explanations are reproducible,
  which the reference's Rand.gaussian UDFs are not.

Port of `mmlspark_tpu/lime/lime.py`: perturbations and masks are drawn
with numpy exactly as the reference draws them (bit-identical), the
stacked rows go through the inner model in one `transform` on the inner
model's own device, and the local lasso runs on the stage's `device`
(None = the card).
"""
from __future__ import annotations

import numpy as np

from ..core import Estimator, Model, Param, Table, Transformer
from ..core.params import (HasInputCol, HasOutputCol, HasPredictionCol,
                           HasSeed, in_range)
from .lasso import batched_lasso
from .superpixel import SuperpixelTransformer, mask_image


class _LIMEParams(HasInputCol, HasOutputCol, HasPredictionCol, HasSeed):
    model = Param("model", "inner model to locally approximate", None)
    n_samples = Param("n_samples", "perturbations per row", 1000,
                      validator=in_range(1))
    sampling_fraction = Param("sampling_fraction",
                              "fraction of features/superpixels kept on",
                              0.3, validator=in_range(0.0, 1.0))
    regularization = Param("regularization", "lasso lambda", 0.0,
                           validator=in_range(0.0))
    device = Param("device", "torch device of the local lasso (None = the "
                   "card)", None)


def _score_with_model(model: Transformer, feats: np.ndarray, input_col: str,
                      prediction_col: str) -> np.ndarray:
    out = model.transform(Table({input_col: feats}))
    pred = np.asarray(out[prediction_col], np.float64)
    if pred.ndim > 1:  # multiclass scores: explain the last column
        pred = pred[..., -1]
    return pred


class TabularLIME(Estimator, _LIMEParams):
    """Fits per-column stds for gaussian perturbation (reference:
    TabularLIME.fit, LIME.scala:176-196 — a StandardScaler in disguise)."""

    def _fit(self, t: Table) -> "TabularLIMEModel":
        x = np.asarray(t[self.input_col], np.float64)
        if x.ndim != 2:
            raise ValueError(
                f"TabularLIME input {self.input_col!r} must be (n, d)")
        m = TabularLIMEModel(**{p: getattr(self, p) for p in (
            "input_col", "output_col", "prediction_col", "model",
            "n_samples", "sampling_fraction", "regularization", "seed",
            "device")})
        m._column_stds = x.std(axis=0)
        return m


class TabularLIMEModel(Model, _LIMEParams):
    """Per row: perturb features with N(0, column_std), score the inner model
    on the whole stacked batch, fit all local models in one vmapped lasso
    (reference: TabularLIMEModel.transform, LIME.scala:203-246)."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self._column_stds = None

    def _get_state(self):
        return {"column_stds": np.asarray(self._column_stds)}

    def _set_state(self, s):
        self._column_stds = np.asarray(s["column_stds"])

    def _transform(self, t: Table) -> Table:
        if self.model is None:
            raise ValueError("TabularLIME: model param is not set")
        x = np.asarray(t[self.input_col], np.float64)
        n, d = x.shape
        s = self.n_samples
        rng = np.random.default_rng(self.seed)
        noise = rng.normal(size=(n, s, d)) * self._column_stds
        perturbed = x[:, None, :] + noise                     # (n, s, d)
        preds = _score_with_model(self.model, perturbed.reshape(n * s, d),
                                  self.input_col, self.prediction_col)
        coefs = batched_lasso(perturbed, preds.reshape(n, s),
                              self.regularization, device=self.device)
        return t.with_column(self.output_col, coefs.astype(np.float64))


class ImageLIME(Transformer, _LIMEParams):
    """Superpixel-mask LIME for images (reference: ImageLIME,
    LIME.scala:262-340): segment each image, sample boolean superpixel
    states, score masked images, and explain with a lasso over the states."""
    cell_size = Param("cell_size", "superpixel size", 16.0)
    modifier = Param("modifier", "superpixel color weight", 130.0)
    superpixel_col = Param("superpixel_col", "label-map output column",
                           "superpixels")
    n_samples = Param("n_samples", "perturbations per image", 900,
                      validator=in_range(1))

    def _transform(self, t: Table) -> Table:
        if self.model is None:
            raise ValueError("ImageLIME: model param is not set")
        spt = SuperpixelTransformer(
            input_col=self.input_col, output_col=self.superpixel_col,
            cell_size=self.cell_size, modifier=self.modifier)
        t = spt.transform(t)
        rng = np.random.default_rng(self.seed)
        imgs = t[self.input_col]
        sps = t[self.superpixel_col]
        s = self.n_samples
        coefs = np.empty(len(t), dtype=object)
        for i in range(len(t)):
            img = np.asarray(imgs[i])
            labels = sps[i]
            k = int(labels.max()) + 1
            states = rng.random((s, k)) < self.sampling_fraction
            masked = np.stack([mask_image(img, labels, st) for st in states])
            preds = _score_with_model(self.model, masked, self.input_col,
                                      self.prediction_col)
            w = batched_lasso(states[None].astype(np.float64),
                              preds[None], self.regularization,
                              device=self.device)[0]
            coefs[i] = w.astype(np.float64)
        return t.with_column(self.output_col, coefs)


class TextLIME(Transformer, _LIMEParams):
    """Word-mask LIME for text (reference: TextLIME.scala:20-89): tokens are
    the interpretable units; masks drop words; the local model weights say
    which words drove the prediction."""
    token_col = Param("token_col", "output column for the tokens explained",
                      "tokens")
    n_samples = Param("n_samples", "perturbations per document", 1000,
                      validator=in_range(1))

    def _transform(self, t: Table) -> Table:
        if self.model is None:
            raise ValueError("TextLIME: model param is not set")
        rng = np.random.default_rng(self.seed)
        texts = t[self.input_col]
        s = self.n_samples
        coefs = np.empty(len(t), dtype=object)
        toks_out = np.empty(len(t), dtype=object)
        for i in range(len(t)):
            tokens = str(texts[i]).split()
            k = max(len(tokens), 1)
            states = rng.random((s, k)) < self.sampling_fraction
            docs = np.array([" ".join(tok for tok, on in zip(tokens, st) if on)
                             for st in states], dtype=object)
            preds = _score_with_model(self.model, docs, self.input_col,
                                      self.prediction_col)
            w = batched_lasso(states[None].astype(np.float64),
                              preds[None], self.regularization,
                              device=self.device)[0]
            coefs[i] = w.astype(np.float64)
            toks_out[i] = np.array(tokens, dtype=object)
        return t.with_columns({self.output_col: coefs,
                               self.token_col: toks_out})
