"""ImageFeaturizer: transfer-learning featurization through a deep net.

Port of `mmlspark_tpu/models/dnn/image_featurizer.py` (reference role:
image/ImageFeaturizer.scala:40-215): resize when the images' shape is not
the model's, scale, then the zoo ResNet (`resnet18` / `resnet50`) or a
foreign ONNX graph, with the head cut off (`cut_output_layers=1`, pooled
features) or kept (logits). The model comes from the zoo, from
`variables` (the reference's numpy tree), from a `downloader.ModelSchema`
(`set_model`) or from ONNX bytes.

Each batch runs on the stage's device from the raw images on: the resize
(`image.ops.prepare_images`), the NHWC -> NCHW transpose at the network's
boundary, and the network in `dtype`, through a `DNNModel` whose batches
are padded to `batch_size`. The ONNX route casts the graph's f32 weights
to the compute dtype once. The state is the reference's: the variables'
leaves, or the ONNX bytes alone when the weights are the graph's own
(`:69-83`), so a stage saved by either package loads in the other.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...core import HasInputCol, HasOutputCol, Model, Param, Table
from ...device import resolve_device
from ...image.ops import _to_batch, prepare_images
from . import resnet as zoo
from .model import DNNModel, params_to_device
from .payload import _treedef_from_str, _treedef_to_str
from .transformer import _flatten

_ZOO = {"resnet18": zoo.resnet18, "resnet50": zoo.resnet50}


def _input_dtype(imgs) -> str:
    """uint8 images travel to the device as uint8; anything else as the
    f32 the reference casts it to."""
    dt = imgs.dtype
    return "uint8" if dt in (np.uint8, torch.uint8) else "float32"


class ImageFeaturizer(Model, HasInputCol, HasOutputCol):
    cut_output_layers = Param(
        "cut_output_layers",
        "1 = drop the classifier head and emit pooled features (transfer "
        "learning); 0 = full model logits", 1)
    image_height = Param("image_height", "resize target", 224)
    image_width = Param("image_width", "resize target", 224)
    batch_size = Param("batch_size", "inference minibatch", 32)
    scale = Param("scale", "pixel scaling", 1.0 / 255.0)
    dtype = Param("dtype", "on-device compute dtype", "bfloat16")
    model_name = Param("model_name", "zoo model (resnet18|resnet50) or "
                                     "'onnx' (use onnx_model=)", "resnet18")
    device = Param("device", "torch device to featurize on (None = the "
                             "card)", None)

    def __init__(self, model_name: str = "resnet18", variables=None,
                 num_classes: int = 1000, seed: int = 0,
                 onnx_model=None, **kw):
        """onnx_model: ONNX bytes or a path — scores a FOREIGN model
        through the importer (models/dnn/onnx_import.py) instead of the
        zoo, with the same layer-cut semantics. ONNX graphs are NCHW, as
        the port's networks are; the NHWC image batches are transposed at
        the boundary."""
        kw.setdefault("input_col", "image")
        kw.setdefault("output_col", "features")
        super().__init__(**kw)
        self._onnx_bytes = None
        if onnx_model is not None:
            if isinstance(onnx_model, str):
                with open(onnx_model, "rb") as f:
                    onnx_model = f.read()
            self._onnx_bytes = bytes(onnx_model)
            model_name = "onnx"
        self.set(model_name=model_name)
        self._variables = variables
        self._variables_from_onnx = False
        self._num_classes = num_classes
        self._seed = seed
        self._dnn: Optional[DNNModel] = None

    def set_model(self, schema) -> "ImageFeaturizer":
        """Accept a downloader ModelSchema (reference: setModel,
        ImageFeaturizer.scala:81-85)."""
        self.set(model_name=schema.name)
        if schema.variables is not None:
            self._variables = schema.variables
        self._dnn = None
        return self

    def _get_state(self):
        state = {}
        if self._onnx_bytes is not None:
            state["onnx_bytes"] = np.frombuffer(self._onnx_bytes, np.uint8)
            if self._variables_from_onnx:
                # the weights are exactly load_onnx(bytes): storing the
                # leaves too would double the artifact
                return state
        if self._variables is None:
            return state
        leaves = _flatten(self._variables)
        state.update({"treedef": _treedef_to_str(self._variables),
                      "n_leaves": len(leaves)})
        for i, leaf in enumerate(leaves):
            state[f"leaf_{i}"] = np.asarray(leaf)
        return state

    def _set_state(self, s):
        if "onnx_bytes" in s:
            self._onnx_bytes = np.asarray(s["onnx_bytes"],
                                          np.uint8).tobytes()
        n = int(np.asarray(s.get("n_leaves", 0)))
        if n:
            leaves = [np.asarray(s[f"leaf_{i}"]) for i in range(n)]
            self._variables = _treedef_from_str(str(s["treedef"]), leaves)
        self._dnn = None

    def _prep(self, xb):
        """Raw NHWC images -> the network's NCHW input on their device."""
        x = prepare_images(xb, self.image_height, self.image_width,
                           self.scale, xb.device)
        return x.permute(0, 3, 1, 2)

    def _build(self, dev: torch.device):
        dtype = getattr(torch, self.dtype)
        if self.model_name == "onnx":
            if self._onnx_bytes is None:
                raise ValueError(
                    "model_name='onnx' requires the onnx_model= bytes "
                    "(they are serialized with the stage)")
            from .onnx_import import load_onnx
            raw_apply, params = load_onnx(
                self._onnx_bytes,
                cut="features" if self.cut_output_layers else None)
            # remember whether the params came straight from the bytes:
            # serializing both would double the artifact for information
            # load_onnx reconstructs deterministically
            self._variables_from_onnx = self._variables is None
            if self._variables is None:
                self._variables = params
            state = {k: v.to(dtype) if isinstance(v, torch.Tensor)
                     and v.dtype == torch.float32 else v
                     for k, v in params_to_device(self._variables,
                                                  dev).items()}

            def apply_fn(p, xb):
                return raw_apply(p, self._prep(xb).to(dtype)).float()
        else:
            cut = "features" if self.cut_output_layers else "logits"
            maker = _ZOO[self.model_name]
            model = maker(num_classes=self._num_classes, dtype=dtype,
                          cut=cut)
            if self._variables is None:
                # the FULL model's variables (head included) serve both
                # cut settings
                self._variables = zoo.init_resnet(
                    model, (self.image_height, self.image_width, 3),
                    self._seed)
            state = zoo.resnet_params_from_numpy(self._variables, dev)

            def apply_fn(v, xb):
                return model(v, self._prep(xb))
        self._dnn = DNNModel(apply_fn=apply_fn, params=state,
                             input_col="__img_in",
                             output_col=self.output_col,
                             batch_size=self.batch_size, device=dev)

    def _transform(self, t: Table) -> Table:
        dev = resolve_device(self.device)
        if self._dnn is None or self._dnn.device != dev:
            self._build(dev)
        imgs = _to_batch(t[self.input_col])
        self._dnn.set(input_dtype=_input_dtype(imgs))
        out = self._dnn.transform(Table({"__img_in": imgs}))
        return t.with_column(self.output_col, out[self.output_col])
