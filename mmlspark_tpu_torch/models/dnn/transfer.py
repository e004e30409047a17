"""Transfer-learning fine-tune estimator, the training side of
ImageFeaturizer, in torch.

Port of `mmlspark_tpu/models/dnn/transfer.py`: a zoo backbone (resnet18 /
resnet50) trained on labelled images with Adam, on the stage's device.

- mode="head": the backbone is frozen; every image is featurized once and
  a fresh linear head trains on the cached features (reference
  `:114-121`).
- mode="full": every variable trains, the backbone at `learning_rate *
  backbone_lr_scale`, the head at `learning_rate` (`:141-149`). As in the
  reference, the backbone's trainable tree is the whole variable tree:
  BN's running statistics feed the loss through the inference-form BN,
  receive gradients and are updated by Adam like the weights.
- The batches are the reference's: `np.random.default_rng(seed)
  .permutation` each epoch, padded by repeating the leading rows
  (`:160-171`). The per-epoch loss is the last batch's.
- The head's initial weights are a standard normal draw times
  1 / sqrt(d). The reference draws from jax's threefry, which torch does
  not reproduce (ROADMAP Queue 3 (b)); the port draws from a
  `torch.Generator(seed)` through `_head_draw`, which a parity test may
  replace with the reference's draw.

Images are resized and scaled on the device per batch
(`image.ops.prepare_images`); the fitted model's state is the reference's
(the backbone's numpy tree, `head_w`, `head_b`, `losses`), so a
`DeepTransferModel` saved by either package loads in the other.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...core import Estimator, Model, Param, Table
from ...core.params import HasInputCol, HasLabelCol, in_range, one_of
from ...device import exact_f32, resolve_device
from ...image.ops import _to_batch, prepare_images
from . import resnet as zoo
from .payload import _treedef_from_str, _treedef_to_str
from .transformer import _flatten


def _make_backbone(model_name: str, num_classes: int, dtype,
                   cut: str = "features"):
    """Zoo backbone — the ONE constructor (and zoo registry) for fit and
    transform so train/serve can never diverge."""
    maker = {"resnet18": zoo.resnet18, "resnet50": zoo.resnet50}[model_name]
    return maker(num_classes=num_classes, dtype=getattr(torch, dtype),
                 cut=cut)


def _head_draw(seed: int, d: int, c: int) -> np.ndarray:
    """The head's unscaled (d, c) standard normal draw."""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randn(d, c, generator=gen).numpy()


def _prep_batch(stage, imgs, lo: int, hi: int, dev) -> torch.Tensor:
    """Rows lo:hi of the images -> the backbone's scaled NCHW f32 input."""
    x = prepare_images(imgs[lo:hi], stage.image_height, stage.image_width,
                       stage.scale, dev)
    return x.permute(0, 3, 1, 2)


def _trainable(state: dict) -> list:
    """The state's tensors as leaves that take gradients."""
    leaves = _flatten(state)
    for t in leaves:
        t.requires_grad_(True)
    return leaves


class DeepTransferClassifier(Estimator, HasInputCol, HasLabelCol):
    """Fine-tune a zoo backbone (resnet18/resnet50) on labeled images.

    mode="head": freeze the backbone, train a fresh linear head on pooled
    features (the reference's transfer recipe, on device). mode="full":
    update every weight (backbone at a reduced LR)."""
    model_name = Param("model_name", "zoo backbone", "resnet18",
                       validator=one_of("resnet18", "resnet50"))
    num_classes = Param("num_classes", "output classes", 10,
                        validator=in_range(2))
    mode = Param("mode", "head (frozen backbone) or full fine-tune", "head",
                 validator=one_of("head", "full"))
    epochs = Param("epochs", "passes over the data", 5, validator=in_range(1))
    batch_size = Param("batch_size", "minibatch rows", 32,
                       validator=in_range(1))
    learning_rate = Param("learning_rate", "head learning rate", 1e-2)
    backbone_lr_scale = Param("backbone_lr_scale",
                              "backbone LR = learning_rate * this (full "
                              "mode)", 0.1)
    image_height = Param("image_height", "resize target", 32)
    image_width = Param("image_width", "resize target", 32)
    scale = Param("scale", "pixel scaling", 1.0 / 255.0)
    dtype = Param("dtype", "backbone compute dtype", "bfloat16")
    seed = Param("seed", "init + shuffle seed", 0)
    prediction_col = Param("prediction_col", "output label column",
                           "prediction")
    probabilities_col = Param("probabilities_col", "class probabilities",
                              "probabilities")
    device = Param("device", "torch device to train on (None = the card)",
                   None)

    def __init__(self, variables=None, **kw):
        kw.setdefault("input_col", "image")
        super().__init__(**kw)
        self._variables = variables  # optional pretrained backbone weights

    def _init_variables(self):
        """User-supplied warm start, or a fresh seeded init — computed per
        call, never cached on the estimator (a refit after
        set(model_name=) must not reuse another architecture's weights)."""
        if self._variables is not None:
            return self._variables
        full = _make_backbone(self.model_name, self.num_classes, self.dtype,
                              cut="logits")
        return zoo.init_resnet(
            full, (self.image_height, self.image_width, 3), self.seed)

    def _features(self, feat_model, state, imgs, dev) -> torch.Tensor:
        """Every image's backbone features, f32, in batches."""
        bs, n = int(self.batch_size), len(imgs)
        with torch.no_grad():
            return torch.cat([feat_model(state, _prep_batch(
                self, imgs, lo, lo + bs, dev)) for lo in range(0, n, bs)])

    def _fit(self, t: Table) -> "DeepTransferModel":
        dev = resolve_device(self.device)
        feat_model = _make_backbone(self.model_name, self.num_classes,
                                    self.dtype)
        imgs = _to_batch(t[self.input_col])
        y_np = np.asarray(t[self.label_col]).astype(np.int64)
        y = torch.as_tensor(y_np, device=dev)
        n, c = len(y_np), int(self.num_classes)
        rng = np.random.default_rng(self.seed)

        full = self.mode == "full"
        state = zoo.resnet_params_from_numpy(self._init_variables(), dev)
        if not full:
            # frozen backbone: featurize every image ONCE, then train the
            # head on cached features
            x = self._features(feat_model, state, imgs, dev)
            d = x.shape[-1]
        else:
            with torch.no_grad():
                d = feat_model(state, _prep_batch(self, imgs, 0, 1,
                                                  dev)).shape[-1]
        w0 = np.array(_head_draw(self.seed, d, c), np.float32)
        head = {"w": torch.as_tensor(w0, device=dev) * (1.0 / np.sqrt(d)),
                "b": torch.zeros(c, device=dev)}

        def loss_fn(xb, yb):
            if full:
                feats = feat_model(state, xb)
            else:
                feats = xb  # xb already IS the cached features
            logits = feats.float() @ head["w"] + head["b"]
            return F.cross_entropy(logits, yb)

        groups = [{"params": _trainable(head), "lr": self.learning_rate}]
        if full:
            groups.insert(0, {"params": _trainable(state),
                              "lr": self.learning_rate
                              * self.backbone_lr_scale})
        opt = torch.optim.Adam(groups)

        bs = int(self.batch_size)
        pad = (-n) % bs
        losses = []
        for _ in range(int(self.epochs)):
            order = rng.permutation(n)
            if pad:  # repeat leading rows so every batch is full-shape
                order = np.concatenate([order, order[:pad]])
            for lo in range(0, len(order), bs):
                sel = order[lo:lo + bs]
                if full:
                    xb = prepare_images(imgs[sel], self.image_height,
                                        self.image_width, self.scale,
                                        dev).permute(0, 3, 1, 2)
                else:
                    xb = x[torch.as_tensor(sel, device=dev)]
                # the backward's convolutions too run f32 as f32
                with exact_f32():
                    loss = loss_fn(xb, y[torch.as_tensor(sel, device=dev)])
                    opt.zero_grad(set_to_none=True)
                    loss.backward()
                opt.step()
            losses.append(float(loss.detach()))

        m = DeepTransferModel(**{p: getattr(self, p) for p in (
            "model_name", "num_classes", "input_col", "image_height",
            "image_width", "scale", "dtype", "prediction_col",
            "probabilities_col")})
        if self.is_set("device"):
            m.set(device=self.device)
        m._variables = zoo.resnet_params_to_numpy(state)
        m._head = {"w": head["w"].detach().cpu().numpy(),
                   "b": head["b"].detach().cpu().numpy()}
        m._losses = losses
        return m


class DeepTransferModel(Model, HasInputCol):
    model_name = Param("model_name", "zoo backbone", "resnet18")
    num_classes = Param("num_classes", "output classes", 10)
    image_height = Param("image_height", "resize target", 32)
    image_width = Param("image_width", "resize target", 32)
    scale = Param("scale", "pixel scaling", 1.0 / 255.0)
    dtype = Param("dtype", "backbone compute dtype", "bfloat16")
    batch_size = Param("batch_size", "inference minibatch", 64)
    prediction_col = Param("prediction_col", "output label column",
                           "prediction")
    probabilities_col = Param("probabilities_col", "class probabilities",
                              "probabilities")
    device = Param("device", "torch device to score on (None = the card)",
                   None)

    def __init__(self, **kw):
        super().__init__(**kw)
        self._variables = None
        self._head = None
        self._losses = []

    @property
    def training_losses(self):
        return list(self._losses)

    def _get_state(self):
        leaves = _flatten(self._variables)
        state = {"treedef": _treedef_to_str(self._variables),
                 "n_leaves": len(leaves),
                 "head_w": self._head["w"], "head_b": self._head["b"],
                 "losses": np.asarray(self._losses, np.float64)}
        for i, leaf in enumerate(leaves):
            state[f"leaf_{i}"] = np.asarray(leaf)
        return state

    def _set_state(self, s):
        n = int(np.asarray(s["n_leaves"]))
        leaves = [np.asarray(s[f"leaf_{i}"]) for i in range(n)]
        self._variables = _treedef_from_str(str(s["treedef"]), leaves)
        self._head = {"w": np.asarray(s["head_w"]),
                      "b": np.asarray(s["head_b"])}
        self._losses = np.asarray(s["losses"]).tolist()

    def _transform(self, t: Table) -> Table:
        dev = resolve_device(self.device)
        feat_model = _make_backbone(self.model_name, self.num_classes,
                                    self.dtype)
        state = zoo.resnet_params_from_numpy(self._variables, dev)
        w = torch.as_tensor(np.asarray(self._head["w"], np.float32),
                            device=dev)
        b = torch.as_tensor(np.asarray(self._head["b"], np.float32),
                            device=dev)
        imgs = _to_batch(t[self.input_col])
        bs = int(self.batch_size)
        with torch.no_grad():
            probs = torch.cat([torch.softmax(
                feat_model(state, _prep_batch(self, imgs, lo, lo + bs, dev))
                .float() @ w + b, dim=-1)
                for lo in range(0, len(imgs), bs)]).cpu().numpy()
        return t.with_columns({
            self.probabilities_col: probs,
            self.prediction_col: probs.argmax(-1).astype(np.float32)})
