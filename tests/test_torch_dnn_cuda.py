"""The deep-net image path on the card against the port's plain CPU path:
the resize, the ResNet zoo, the ONNX importer, the featurizer, DNNModel's
torch.export round trip and transfer learning.

Every test here carries the `gpu` marker and skips without a card. This
file imports neither jax nor the JAX package, so it also runs where only
the port is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_dnn_cuda.py

Tolerances: the resize is equal bit for bit (both devices sum its taps
in one order with a rounding after each multiply and add); f32 networks
within 1e-4 of the CPU's largest |output|, with PyTorch's process-wide
cuDNN TF32 flag left ON, so the check fails unless the port scopes TF32
off itself; bf16 within 3e-2 of the card's own f32 (tests/
test_torch_dnn_resnet.py's bound).
"""
import os

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch import Table
from mmlspark_tpu_torch.image import ops
from mmlspark_tpu_torch.models.dnn import resnet as rn
from mmlspark_tpu_torch.models.dnn.image_featurizer import ImageFeaturizer
from mmlspark_tpu_torch.models.dnn.model import DNNModel, params_to_device
from mmlspark_tpu_torch.models.dnn.onnx_import import load_onnx
from mmlspark_tpu_torch.models.dnn.transfer import DeepTransferClassifier

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
_F32_TOL = 1e-4
_BF16_TOL = 3e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def tf32_on():
    """PyTorch's default: cuDNN may run f32 convolutions in TF32."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    yield
    torch.backends.cudnn.allow_tf32 = before


def _rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _images(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=shape).astype(
        np.uint8)


@pytest.mark.gpu
@pytest.mark.parametrize("shape, size", [((4, 256, 256, 3), (224, 224)),
                                         ((3, 300, 200, 3), (224, 224)),
                                         ((2, 32, 32, 3), (224, 224)),
                                         ((5, 33, 47, 3), (16, 24))])
def test_resize_is_the_cpu_s_bit_for_bit(cuda_device, shape, size):
    imgs = torch.from_numpy(_images(shape))
    for fn in (ops.resize_float, ops.resize_images):
        card = fn(imgs.to(cuda_device), *size).cpu()
        cpu = fn(imgs, *size)
        assert torch.equal(card, cpu), fn.__name__


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_resnet_on_the_card(cuda_device, tf32_on, name):
    v = rn.init_resnet(getattr(rn, name)(num_classes=10), seed=1)
    x = torch.from_numpy(np.random.default_rng(2).random(
        (4, 3, 64, 64)).astype(np.float32))
    for cut in ("logits", "features"):
        f32 = getattr(rn, name)(num_classes=10, cut=cut)
        want = f32(rn.resnet_params_from_numpy(v, "cpu"), x).numpy()
        state = rn.resnet_params_from_numpy(v, cuda_device)
        got = f32(state, x.to(cuda_device)).cpu().numpy()
        assert _rel_err(got, want) < _F32_TOL, (cut, _rel_err(got, want))
        bf16 = getattr(rn, name)(num_classes=10, cut=cut, dtype="bfloat16")
        half = bf16(state, x.to(cuda_device)).cpu().numpy()
        assert _rel_err(half, got) < _BF16_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("name, x_key", [("mlp", "x1"), ("convnet", "x2")])
def test_onnx_fixtures_on_the_card(cuda_device, tf32_on, name, x_key):
    exp = np.load(os.path.join(DATA, "onnx_expected.npz"))
    apply_fn, params = load_onnx(os.path.join(DATA, f"{name}.onnx"))
    x = torch.from_numpy(exp[x_key])
    want = apply_fn(params_to_device(params, "cpu"), x).numpy()
    got = apply_fn(params_to_device(params, cuda_device),
                   x.to(cuda_device)).cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_featurizer_and_dnn_model_round_trip(cuda_device, tf32_on, tmp_path):
    """ImageFeaturizer at 224 from 256 x 256 uint8 images (the resize runs
    on the card) against the same stage on the CPU; then a DNNModel saved
    on the card as a torch.export program and loaded: equal outputs."""
    imgs = _images((6, 256, 256, 3), seed=3)
    kw = dict(model_name="resnet18", image_height=224, image_width=224,
              batch_size=4, dtype="float32", seed=0)
    want = ImageFeaturizer(device="cpu", **kw).transform(
        Table({"image": imgs}))["features"]
    got = ImageFeaturizer(**kw).transform(Table({"image": imgs}))["features"]
    assert _rel_err(got, want) < _F32_TOL
    apply_fn, params = load_onnx(os.path.join(DATA, "convnet.onnx"))
    x = np.load(os.path.join(DATA, "onnx_expected.npz"))["x2"]
    m = DNNModel(apply_fn=apply_fn, params=params, batch_size=4)
    out = m.transform(Table({"features": x}))["scores"]
    m.save(str(tmp_path / "m"))
    back = DNNModel.load(str(tmp_path / "m"))
    assert back._apply_fn is None
    np.testing.assert_array_equal(
        back.transform(Table({"features": x}))["scores"], out)


@pytest.mark.gpu
def test_transfer_head_fit_on_the_card(cuda_device):
    """Head mode on the card against the same fit on the CPU: losses
    within 1e-4, predictions equal."""
    rng = np.random.default_rng(4)
    y = (np.arange(24) % 3).astype(np.float32)
    imgs = rng.normal(0.45, 0.1, size=(24, 40, 40, 3))
    for c in range(3):
        imgs[y == c, ..., c] += 0.35
    imgs = (np.clip(imgs, 0, 1) * 255).astype(np.uint8)
    t = Table({"image": imgs, "label": y})
    kw = dict(model_name="resnet18", num_classes=3, epochs=3, batch_size=8,
              learning_rate=1e-2, dtype="float32")
    cpu = DeepTransferClassifier(device="cpu", **kw).fit(t)
    card = DeepTransferClassifier(**kw).fit(t)
    np.testing.assert_allclose(card.training_losses, cpu.training_losses,
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(card.transform(t)["prediction"],
                                  cpu.transform(t)["prediction"])
