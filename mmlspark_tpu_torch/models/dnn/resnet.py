"""The ResNet family in torch: the model zoo behind ImageFeaturizer.

Port of `mmlspark_tpu/models/dnn/resnet.py` (ResNet-v1, He et al. 2015;
reference role: image/ImageFeaturizer.scala:40-215 scoring downloaded
CNTK graphs). The modules keep the flax modules' structure and names:

- the stem: 7x7 stride-2 conv, BN, ReLU, then a 3x3 stride-2 max pool
  with (1, 1) padding, padded with -inf (reference `:96-101`);
- `BasicBlock` / `BottleneckBlock` with a 1x1 projection shortcut only
  where the block changes the shape (`:42-46`, `:74-79`);
- a global mean, then the f32 output; `cut="features"` returns the pooled
  vector (`:108-112`), "logits" the head's scores.

The port computes NCHW; the stages transpose the NHWC images at their
boundary. The modules hold no weights: `forward(variables, x)` takes the
port's state, the reference's tree (`{"params", "batch_stats"}`, names
as flax's) of tensors with OIHW conv kernels and `(in, out)` Dense
kernels. `resnet_params_from_numpy` takes the reference's numpy tree
(HWIO kernels) to that state on a device, `resnet_params_to_numpy` goes
back. BN is flax's inference form: the running statistics, epsilon 1e-5,
computed in f32 and cast to the compute dtype. In bf16 the f32 weights
are cast to bf16 at every call, as `nn.Conv(dtype=bf16)` does; in f32
every convolution runs with cuDNN's TF32 off (`device.exact_f32`).

`init_resnet` draws seeded random weights (flax's initialisers: lecun
normal kernels, unit BN) from a `torch.Generator`, the offline stand-in
for downloaded weights; its draws differ from the reference's threefry
ones. `load_torch_state_dict` maps a torchvision-convention state dict
onto the reference's numpy tree.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...device import exact_f32

# flax.linen.BatchNorm's default epsilon
BN_EPSILON = 1e-5
# jax.nn.initializers.lecun_normal: a normal truncated at 2 standard
# deviations, scaled so the variance is 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def _dtype(dtype) -> torch.dtype:
    """A torch dtype, or its name ("float32", "bfloat16")."""
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, dtype)


def _conv(x, kernel, stride: int, padding: int, dtype):
    return F.conv2d(x.to(dtype), kernel.to(dtype), stride=stride,
                    padding=padding)


def _bn(x, p, s, dtype):
    """flax's BatchNorm with running statistics: (x - mean) * (rsqrt(var +
    eps) * scale) + bias in f32, then cast to the compute dtype."""
    shp = (1, -1, 1, 1)
    mul = torch.rsqrt(s["var"] + BN_EPSILON) * p["scale"]
    y = (x.float() - s["mean"].view(shp)) * mul.view(shp) \
        + p["bias"].view(shp)
    return y.to(dtype)


class BasicBlock(nn.Module):
    def __init__(self, filters: int, stride: int = 1, dtype=torch.float32):
        super().__init__()
        self.filters, self.stride, self.dtype = filters, stride, _dtype(dtype)

    def forward(self, p, s, x):
        residual = x
        y = _conv(x, p["conv1"]["kernel"], self.stride, 1, self.dtype)
        y = F.relu(_bn(y, p["bn1"], s["bn1"], self.dtype))
        y = _conv(y, p["conv2"]["kernel"], 1, 1, self.dtype)
        y = _bn(y, p["bn2"], s["bn2"], self.dtype)
        if residual.shape != y.shape:
            residual = _conv(residual, p["downsample_conv"]["kernel"],
                             self.stride, 0, self.dtype)
            residual = _bn(residual, p["downsample_bn"], s["downsample_bn"],
                           self.dtype)
        return F.relu(y + residual.to(self.dtype))

    def layers(self, cin: int) -> dict:
        """{conv name: (kh, kw, in, out)} of this block, and its BNs."""
        out = {"conv1": (3, 3, cin, self.filters),
               "conv2": (3, 3, self.filters, self.filters)}
        if self.stride != 1 or cin != self.filters:
            out["downsample_conv"] = (1, 1, cin, self.filters)
        return out


class BottleneckBlock(nn.Module):
    def __init__(self, filters: int, stride: int = 1, dtype=torch.float32):
        super().__init__()
        self.filters, self.stride, self.dtype = filters, stride, _dtype(dtype)

    def forward(self, p, s, x):
        residual = x
        y = _conv(x, p["conv1"]["kernel"], 1, 0, self.dtype)
        y = F.relu(_bn(y, p["bn1"], s["bn1"], self.dtype))
        y = _conv(y, p["conv2"]["kernel"], self.stride, 1, self.dtype)
        y = F.relu(_bn(y, p["bn2"], s["bn2"], self.dtype))
        y = _conv(y, p["conv3"]["kernel"], 1, 0, self.dtype)
        y = _bn(y, p["bn3"], s["bn3"], self.dtype)
        if residual.shape != y.shape:
            residual = _conv(residual, p["downsample_conv"]["kernel"],
                             self.stride, 0, self.dtype)
            residual = _bn(residual, p["downsample_bn"], s["downsample_bn"],
                           self.dtype)
        return F.relu(y + residual.to(self.dtype))

    def layers(self, cin: int) -> dict:
        f = self.filters
        out = {"conv1": (1, 1, cin, f), "conv2": (3, 3, f, f),
               "conv3": (1, 1, f, 4 * f)}
        if self.stride != 1 or cin != 4 * f:
            out["downsample_conv"] = (1, 1, cin, 4 * f)
        return out


class ResNet(nn.Module):
    """NCHW ResNet-v1. `cut='features'` returns pooled features (the
    ImageFeaturizer layer-cut); 'logits' returns class scores."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype=torch.float32, cut: str = "logits"):
        super().__init__()
        if cut not in ("logits", "features"):
            raise ValueError(f"cut must be 'logits' or 'features', got "
                             f"{cut!r}")
        self.stage_sizes = list(stage_sizes)
        self.num_classes, self.num_filters = num_classes, num_filters
        self.dtype, self.cut = _dtype(dtype), cut
        self.blocks = nn.ModuleDict()
        for i, n_blocks in enumerate(self.stage_sizes):
            for j in range(n_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                self.blocks[f"stage{i}_block{j}"] = block_cls(
                    num_filters * 2 ** i, stride, dtype=self.dtype)

    def forward(self, variables, x):
        p, s = variables["params"], variables["batch_stats"]
        dtype = self.dtype
        with exact_f32():
            x = _conv(x, p["conv_init"]["kernel"], 2, 3, dtype)
            x = F.relu(_bn(x, p["bn_init"], s["bn_init"], dtype))
            x = F.max_pool2d(x, 3, stride=2, padding=1)
            for name, block in self.blocks.items():
                x = block(p[name], s[name], x)
        # global average pool -> (N, C): f32 sums, the compute dtype's
        # result, as jnp.mean gives
        x = x.float().mean(dim=(2, 3)).to(dtype)
        if self.cut == "features":
            return x.float()
        head = p["head"]
        x = x @ head["kernel"].to(dtype) + head["bias"].to(dtype)
        return x.float()

    def layer_shapes(self) -> dict:
        """The reference's variable tree with each leaf's shape (kernels
        HWIO, Dense (in, out))."""
        c = self.num_filters
        params = {"conv_init": {"kernel": (7, 7, 3, c)},
                  "bn_init": {"scale": (c,), "bias": (c,)}}
        stats = {"bn_init": {"mean": (c,), "var": (c,)}}
        cin = c
        for name, block in self.blocks.items():
            params[name], stats[name] = {}, {}
            for conv, shape in block.layers(cin).items():
                params[name][conv] = {"kernel": shape}
                bn = conv.replace("conv", "bn")
                params[name][bn] = {"scale": (shape[3],),
                                    "bias": (shape[3],)}
                stats[name][bn] = {"mean": (shape[3],), "var": (shape[3],)}
                cout = shape[3]
            cin = cout
        params["head"] = {"kernel": (cin, self.num_classes),
                          "bias": (self.num_classes,)}
        return {"params": params, "batch_stats": stats}


def resnet18(num_classes: int = 1000, dtype=torch.float32,
             cut="logits") -> ResNet:
    return ResNet(stage_sizes=[2, 2, 2, 2], block_cls=BasicBlock,
                  num_classes=num_classes, dtype=dtype, cut=cut)


def resnet50(num_classes: int = 1000, dtype=torch.float32,
             cut="logits") -> ResNet:
    return ResNet(stage_sizes=[3, 4, 6, 3], block_cls=BottleneckBlock,
                  num_classes=num_classes, dtype=dtype, cut=cut)


def _map(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def init_resnet(model: ResNet, image_shape=(224, 224, 3), seed: int = 0):
    """Seeded random variables in the reference's numpy layout: kernels
    from a truncated normal of variance 1 / fan_in, BN scale 1, bias 0,
    mean 0, var 1, Dense bias 0. `image_shape` is the reference's
    argument; the variables do not depend on it."""
    gen = torch.Generator().manual_seed(int(seed))

    def draw(path, shape):
        kind = path[-1]
        if kind == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
            t = torch.nn.init.trunc_normal_(
                torch.empty(shape), std=std, a=-2 * std, b=2 * std,
                generator=gen)
            return t.numpy()
        fill = 1.0 if kind in ("scale", "var") else 0.0
        return np.full(shape, fill, np.float32)
    return _map(model.layer_shapes(), draw)


def resnet_params_from_numpy(variables, device) -> dict:
    """The reference's numpy tree (HWIO conv kernels) -> the port's state:
    f32 tensors on `device`, conv kernels OIHW."""
    def move(path, leaf):
        arr = np.asarray(leaf)
        t = torch.as_tensor(np.array(arr, np.float32), device=device)
        if path[-1] == "kernel" and arr.ndim == 4:
            t = t.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
        return t
    return _map(variables, move)


def resnet_params_to_numpy(state) -> dict:
    """The port's state -> the reference's numpy tree (HWIO kernels)."""
    def back(path, t):
        if path[-1] == "kernel" and t.ndim == 4:
            t = t.permute(2, 3, 1, 0)
        return np.ascontiguousarray(t.detach().cpu().numpy())
    return _map(state, back)


def _torch_key(fk: tuple) -> str:
    """('params','stage0_block1','conv1','kernel') -> 'layer1.1.conv1.weight'
    (reference `load_torch_state_dict`'s mapping)."""
    col, *path = fk
    name = ".".join(path)
    name = name.replace("conv_init.kernel", "conv1.weight")
    for i in range(4):
        name = name.replace(f"stage{i}_block", f"layer{i+1}.")
    name = (name.replace("downsample_conv.kernel", "downsample.0.weight")
                .replace("head.kernel", "fc.weight")
                .replace("head.bias", "fc.bias")
                .replace(".kernel", ".weight")
                .replace(".scale", ".weight"))  # BN gamma
    if col == "batch_stats":
        name = (name.replace(".mean", ".running_mean")
                    .replace(".var", ".running_var"))
    name = (name.replace("bn_init", "bn1")
                .replace("downsample_bn", "downsample.1"))
    return name.replace("..", ".")


def load_torch_state_dict(model: ResNet, state_dict: dict,
                          image_shape=(224, 224, 3)):
    """Map a torchvision-convention ResNet state_dict (OIHW convs) onto the
    reference's numpy variables (HWIO convs)."""
    def take(fk, shape):
        tk = _torch_key(fk)
        if tk not in state_dict:
            raise KeyError(f"no torch weight for {fk} (looked for {tk!r})")
        w = state_dict[tk]
        w = w.detach().cpu().numpy() if isinstance(w, torch.Tensor) \
            else np.asarray(w)
        if fk[-1] == "kernel" and w.ndim == 4:
            w = w.transpose(2, 3, 1, 0)      # OIHW -> HWIO
        elif fk[-1] == "kernel" and w.ndim == 2:
            w = w.T
        if w.shape != tuple(shape):
            raise ValueError(f"{fk}: torch {w.shape} vs flax {tuple(shape)}")
        return w.astype(np.float32)
    return _map(model.layer_shapes(), take)
